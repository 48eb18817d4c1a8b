"""Hand-written CUDA kernels for the per-iteration hot spot of the
projection family.

block_projection.py — builds ``csrc/block_projection.cu`` (``apc_gather``,
  ``apc_scatter``, ``cimmino_gather``, ``cimmino_scatter`` and, for
  sparse systems, ``sparse_gather``, ``sparse_cimmino_gather`` and
  ``sparse_scatter``, for sm_90a) at first use, binds it with ctypes and
  launches it, counting launches.
ops.py — the public ops ``proj_gather``/``proj_scatter``/
  ``block_projection``, ``cimmino_gather``/``cimmino_scatter``/
  ``cimmino_update`` and ``sparse_proj_update``/``sparse_cimmino_update``
  with a worker axis, dispatching on the tensors' device (CUDA ->
  kernel, CPU -> the plain PyTorch versions beside them).

Modules here never build or import anything for the GPU at import time.
"""
