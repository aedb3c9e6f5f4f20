"""PyTorch/CUDA port of the dynamic-DNN runtime (reference: the ``repro``
JAX package, which this package never imports).

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; the hand-written Hopper kernels live in
``repro_torch.kernels`` and are built from ``kernels/csrc`` at first use.
"""
from repro_torch.device import resolve_device
