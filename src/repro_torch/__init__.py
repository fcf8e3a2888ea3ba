"""SageSched on PyTorch and CUDA: the port of ``repro`` to one NVIDIA
H100.

Mirrors ``repro`` module for module (``repro_torch.X`` is the
counterpart of ``repro.X``).  Host-side scheduling code keeps its numpy;
the model runs in PyTorch, and every Pallas kernel on the ported path is
a CUDA kernel written for Hopper (``repro_torch/csrc``).  Entry points run
on the card unless the caller passes ``device="cpu"``.  Never imports
JAX or ``repro``.
"""

__version__ = "0.1.0"
