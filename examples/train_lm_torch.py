"""End-to-end training example on the port: a reduced TinyLlama-family
model for a few hundred steps with checkpointing, through the port's
launcher (twin of examples/train_lm.py).

    PYTHONPATH=src python examples/train_lm_torch.py [--steps 200] \
        [--device cpu] [--ckpt-dir DIR]

The same launcher trains the full configs on the card
(``python -m repro_torch.launch.train --arch ...`` without ``--smoke``).
A second run on the same ``--ckpt-dir`` resumes from its last checkpoint.
"""
import argparse
import pathlib
import sys

from repro_torch.launch import train

CKPT_DIR = pathlib.Path(__file__).resolve().parents[1] / "build" / \
    "train_lm_torch_ckpt"
CKPT_EVERY = 50


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--ckpt-dir", default=str(CKPT_DIR))
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    return train.main([
        "--arch", args.arch, "--smoke",
        "--steps", str(args.steps),
        "--batch", "8", "--seq", "128",
        "--ckpt-dir", args.ckpt_dir,
        "--ckpt-every", str(CKPT_EVERY), "--log-every", "10",
        "--device", args.device,
    ])


if __name__ == "__main__":
    sys.exit(main())
