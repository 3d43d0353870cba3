"""PyTorch/CUDA port of the reflected-diffusion GTO halo pipeline.

The package mirrors the JAX package's module layout (``config``,
``ops``, ``sde``, ``models``, ``sampling``, ``training``, ``benchmark``)
in PyTorch idiom: ``nn.Module``s in NCHW with the reference state-dict
names, explicit devices and explicit ``torch.Generator``s.  Hand-written
CUDA kernels live in ``csrc/`` and are built with ``nvcc`` at first use.
"""
from .device import resolve_device  # noqa: F401
