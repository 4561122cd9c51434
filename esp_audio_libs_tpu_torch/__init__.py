"""esp-audio-libs-tpu-torch: the PyTorch + CUDA port of esp-audio-libs-tpu.

A second package beside ``esp_audio_libs_tpu`` (the JAX reference). It
carries the same sub-package layout and module names:

- ``runtime``  ctypes loaders: the shared native host library
               (``build/libeal_host.so``: filter design, phase grids, the
               FLAC and MP3 front-ends), the MP3 tables and the hand-written
               CUDA kernels (``csrc/*.cu``, built with nvcc at first use);
               dispatch slicing and the escape sideband
- ``ops``      PCM quantization, biquad design and application, the
               recurrence solvers, the banded and exact polyphase
               contractions, FLAC LPC restoration, the MP3 dequantizer,
               IMDCT and subband synthesis, the DSP primitives
               (``ops.dsp``), and their kernel wrappers
- ``models``   the user-facing ``Resampler`` (exact and fast mode),
               ``BatchedResample``, ``FLACDecoder``, ``BatchedFLACDecoder``,
               ``MP3Decoder``, ``BatchedMP3Decoder`` and the WAV parser
- ``parallel`` the stream mesh (the batch axis split over devices, one
               kernel launch per shard) and sequence parallelism (one long
               stream's time axis split over devices)
- ``cli``      the file and serving tools (``python -m
               esp_audio_libs_tpu_torch.cli.<name>``)
- ``utils``    the WAV, FLAC and MP3 result enums, debug-mode NaN/Inf checks
               and host staging pools

It imports ``torch``, ``numpy`` and ``ctypes`` and never ``jax``. Kernel
wrappers run their plain PyTorch version for CPU tensors only; a CUDA tensor
launches the kernel or raises.
"""

__version__ = "0.1.0"

from . import models, ops, parallel, runtime, utils  # noqa: F401
