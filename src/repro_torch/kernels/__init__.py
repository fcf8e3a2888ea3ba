"""Hand-written Hopper kernels of the port, one directory each:
``kernel.py`` binds the CUDA source in ``repro_torch/csrc/``, ``ops.py`` is
the checked wrapper (kernel for CUDA tensors, plain version for CPU
tensors) and ``ref.py`` is the plain PyTorch version."""
