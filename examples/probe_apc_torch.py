"""APC inside the LM framework on the port: fit a linear probe on hidden
states with the paper's distributed solver (``optim/apc_head.py``)
instead of SGD (twin of examples/probe_apc.py).

A reduced qwen3-family model (random weights from a seed) produces the
features H; the probe target is a synthetic linear functional of H plus
noise.  APC solves the ridge normal equations distributed over m = 4
row-blocks and matches the closed form.

    PYTHONPATH=src python examples/probe_apc_torch.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch import configs
from repro_torch import device as dev
from repro_torch.models import model, sharding
from repro_torch.optim import apc_head


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    device = dev.resolve(ap.parse_args(argv).device)
    cfg = configs.get_smoke("qwen3-4b")
    params = sharding.init_tree(model.model_abstract(cfg),
                                torch.Generator(device=device).manual_seed(0),
                                torch.float32, device)
    B, S = 8, 64
    toks = torch.randint(0, cfg.vocab_size, (B, S), device=device,
                         generator=torch.Generator(device=device)
                         .manual_seed(1))
    with torch.inference_mode():
        logits = model.forward(cfg, params, {"tokens": toks})
    # the features: the logits' first 64 columns, standardized
    H = logits[..., :64].reshape(B * S, 64).double().cpu().numpy()
    H = (H - H.mean(0)) / (H.std(0) + 1e-9)
    rng = np.random.default_rng(2)
    w_true = rng.standard_normal(64)
    y = H @ w_true + 0.01 * rng.standard_normal(H.shape[0])

    # Hidden activations of an untrained LM are heavily correlated across
    # positions, so the probe needs real ridge regularization — lam also
    # sets kappa(X) and hence APC's iteration count.
    lam = 10.0
    w, residuals = apc_head.fit_probe(H, y, m=4, lam=lam, iters=2000,
                                      device=device)
    Ht = torch.as_tensor(H, device=device)
    yt = torch.as_tensor(y, device=device)
    A, b = apc_head.normal_system(Ht, yt, lam)
    w_ref = np.linalg.solve(A.cpu().numpy(), b.cpu().numpy())
    err = float(np.linalg.norm(w.cpu().numpy() - w_ref) /
                np.linalg.norm(w_ref))
    print(f"probe fit over {H.shape[0]} tokens, 64 features, m=4 workers")
    print(f"APC residual history: {residuals[0]:.2e} -> {residuals[-1]:.2e}")
    print(f"deviation from closed-form ridge solution: {err:.3e}")
    print(f"probe MSE: {apc_head.probe_loss(Ht, yt, w):.4e}")
    assert err < 1e-3


if __name__ == "__main__":
    main()
