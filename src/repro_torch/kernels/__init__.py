"""Kernels of the serving path: CUDA sources in ``../csrc``, plain-torch
versions beside each, and ``ops`` to dispatch by device."""
