"""PyTorch/CUDA port of ``repro``: greedy continuous-batching serving.

The JAX package ``repro`` is the reference; this package imports neither
JAX nor anything of ``repro``.  Public functions keep ``repro``'s names and
layouts (stacked ``(L, ...)`` params, the ``(L, B, S, KV, hd)`` slot pool)
so every module has an obvious counterpart.  Entry points run on CUDA
unless the caller asks for the CPU; attention kernels dispatch on the
tensor's device (``kernels/ops.py``).
"""
