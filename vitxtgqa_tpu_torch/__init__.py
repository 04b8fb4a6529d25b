"""PyTorch + CUDA port of vitxtgqa_tpu for NVIDIA Hopper (H100).

The JAX package ``vitxtgqa_tpu`` stays the reference; this package mirrors
its module layout (``ops/masks.py``, ``ops/attention.py``,
``models/common.py``, ...) so each counterpart is easy to find.  It imports
``torch`` and never ``jax``/``flax``/``optax``.

Hand-written Hopper kernels live in ``csrc/*.cu``; ``ops/_build.py``
compiles them with nvcc on first use and binds them with ctypes.  Each
kernel wrapper runs its kernel on CUDA tensors and its plain PyTorch
version on CPU tensors (the CPU tests and the on-card oracle).
"""

from vitxtgqa_tpu_torch.options import Options

__all__ = ["Options"]
