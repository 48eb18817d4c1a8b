"""Hand-written CUDA kernels for the per-iteration hot spot of APC.

block_projection.py — builds ``csrc/block_projection.cu`` (``apc_gather``
  and ``apc_scatter`` for sm_90a) at first use, binds it with ctypes and
  launches it, counting launches.
ops.py — the public ops ``proj_gather``/``proj_scatter``/
  ``block_projection`` with a worker axis, dispatching on the tensors'
  device (CUDA -> kernel, CPU -> the plain PyTorch versions beside them).

Modules here never build or import anything for the GPU at import time.
"""
