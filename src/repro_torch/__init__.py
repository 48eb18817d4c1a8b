"""repro_torch — the PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

The module layout mirrors ``repro`` so each module's counterpart is easy
to find: ``core`` (block systems, dense block ops, spectral analysis, the
APC building blocks), ``data`` (the seeded generators), ``solvers`` (the
registry, the solve drivers and the APC solver), ``kernels`` (the
hand-written CUDA ``apc_gather``/``apc_scatter`` pair, with their plain
PyTorch versions) and ``launch`` (the solve driver CLI).

The package imports torch and numpy only — never jax, and nothing of
``repro``.  Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"`` (see :mod:`repro_torch.device`).
"""
