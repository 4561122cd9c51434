"""esp-audio-libs-tpu-torch: the PyTorch + CUDA port of esp-audio-libs-tpu.

A second package beside ``esp_audio_libs_tpu`` (the JAX reference). It
carries the same sub-package layout and module names:

- ``runtime``  ctypes loaders: the shared native host library
               (``build/libeal_host.so``, filter design and phase grids) and
               the hand-written CUDA kernels (``csrc/*.cu``, built with nvcc
               at first use)
- ``ops``      PCM quantization, host biquad design, the banded polyphase
               contraction and its kernel wrappers
- ``models``   the user-facing ``Resampler`` (fast mode)

It imports ``torch``, ``numpy`` and ``ctypes`` and never ``jax``. Kernel
wrappers run their plain PyTorch version for CPU tensors only; a CUDA tensor
launches the kernel or raises.
"""

__version__ = "0.1.0"

from . import models, ops, runtime  # noqa: F401
