"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version.  ``ops.py`` in each package dispatches: CPU tensors run the
plain version, CUDA tensors launch the kernel or raise."""
