"""repro_torch — the PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

The module layout mirrors ``repro`` so each module's counterpart is easy
to find: ``core`` (dense and block-sparse systems and block ops,
spectral analysis, the APC building blocks, preconditioning), ``data``
(the seeded generators, dense, sparse and least-squares), ``solvers``
(the registry, ``solve``/``solve_many``, the capability matrix and the
reference's eight solvers), ``kernels`` (the hand-written CUDA kernels
``apc_gather``, ``apc_scatter``, ``cimmino_gather``, ``cimmino_scatter``,
``sparse_gather``, ``sparse_cimmino_gather`` and ``sparse_scatter``,
with their plain PyTorch versions) and ``launch`` (the solve CLI).

The package imports torch and numpy only — never jax, and nothing of
``repro``.  Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"`` (see :mod:`repro_torch.device`).
"""
