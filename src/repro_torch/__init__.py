"""repro_torch — the PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

The module layout mirrors ``repro`` so each module's counterpart is easy
to find: ``core`` (block systems, dense block ops, spectral analysis, the
APC building blocks, preconditioning), ``data`` (the seeded generators),
``solvers`` (the registry, ``solve``/``solve_many`` and the reference's
eight solvers), ``kernels`` (the hand-written CUDA kernels
``apc_gather``, ``apc_scatter``, ``cimmino_gather`` and
``cimmino_scatter``, with their plain PyTorch versions) and ``launch``
(the solve CLI).

The package imports torch and numpy only — never jax, and nothing of
``repro``.  Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"`` (see :mod:`repro_torch.device`).
"""
