"""PyTorch / CUDA port of the ProFe simulator (``repro``) for an NVIDIA H100.

Mirrors ``repro``'s layout module for module.  The hot kernels of the
main path are hand-written CUDA C++ under ``csrc/``, built at first use
into the repository's ``build/`` directory and bound with ``ctypes``
(``kernels/build.py``).  Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``; on the CPU every kernel wrapper runs its plain
PyTorch version instead.
"""
