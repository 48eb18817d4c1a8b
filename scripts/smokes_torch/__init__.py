# Standalone smoke scripts of the PyTorch port — invoked as files
# (python scripts/smokes_torch/x.py [--device cpu]) by scripts/ci_torch.sh,
# never imported.
