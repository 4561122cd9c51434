"""Batched PCM quantization ops (packed int8/16/24/32 LE <-> float32).

PyTorch counterpart of esp_audio_libs_tpu/ops/quantization.py (reference:
src/quantization_utils.cpp:6-94). Byte reinterpretation uses
``Tensor.view(dtype)`` on little-endian hosts and devices.

Bit-exactness notes
-------------------
* ``int_to_float``: one f32 multiply by the host-computed glibc ``powf``
  gain factor (src/quantization_utils.cpp:8,11,18).
* ``float_to_int``: ``floorf(x * scalar + 0.5f)`` with the multiply and the
  add rounded separately (eager PyTorch never contracts them into an FMA),
  then the x86 ``cvttss2si`` cast emulated explicitly: an out-of-range or
  NaN float becomes INT_MIN. A plain ``.to(torch.int32)`` of such a float is
  not defined the same way on the CPU and on CUDA.
* Integer assembly of 32-bit samples runs in int64 and wraps to int32
  explicitly (the JAX reference wraps in int32).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools

import numpy as np
import torch

__all__ = [
    "bytes_per_sample",
    "gain_factor",
    "unpack_pcm",
    "pack_pcm",
    "unpack_pcm16_planar2",
    "unpack_pcm16_planar2_raw",
    "unpack_pcm16_raw",
    "pack_pcm16_interleave2",
    "int_to_float",
    "float_to_int",
    "quantized_to_float",
    "float_to_quantized",
]

_INT_MIN = -2147483648
_F_TWO31 = 2147483648.0
_F_BELOW_TWO31 = 2147483520.0   # largest f32 below 2^31


@functools.lru_cache(None)
def _libm():
    lib = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    lib.powf.restype = ctypes.c_float
    lib.powf.argtypes = [ctypes.c_float, ctypes.c_float]
    return lib


def bytes_per_sample(bits: int) -> int:
    """Packed bytes per sample. Reference packs 1/2/3/4 bytes for
    bits in (0,8], (8,16], (16,24], (24,32] (src/quantization_utils.cpp:10-46)."""
    if not 1 <= bits <= 32:
        raise ValueError(f"bits must be in [1, 32], got {bits}")
    return (max(bits, 2) + 7) // 8 if bits > 8 else 1


def gain_factor(bits: int, gain_db: float) -> np.float32:
    """f32 ``powf(10, db/20) / 2^(8B-1)`` exactly as the reference computes it."""
    gain = _libm().powf(np.float32(10.0), np.float32(np.float32(gain_db) / np.float32(20.0)))
    denom = np.float32(1 << (bytes_per_sample(bits) * 8 - 1))
    return np.float32(np.float32(gain) / denom)


# ----------------------------------------------------------------- unpack/pack


def _wrap_int32(v: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wrap-around, explicitly."""
    return (((v + 2**31) % 2**32) - 2**31).to(torch.int32)


def unpack_pcm(data: torch.Tensor, bits: int) -> torch.Tensor:
    """uint8 ``[..., n*B]`` little-endian packed PCM -> int32 ``[..., n]``.

    <=8-bit samples are unsigned with a -128 bias (src/quantization_utils.cpp:13-14);
    wider samples are little-endian two's complement sign-extended from their
    top byte (:21-24, :30-34, :40-45).
    """
    nbytes = bytes_per_sample(bits)
    if data.dtype != torch.uint8:
        raise TypeError(f"expected uint8 packed data, got {data.dtype}")
    *lead, total = data.shape
    if total % nbytes:
        raise ValueError(f"trailing dim {total} not divisible by {nbytes} bytes/sample")
    data = data.contiguous()
    if nbytes == 1:
        return data.to(torch.int32) - 128
    if nbytes == 2:
        return data.view(torch.int16).to(torch.int32)
    b = data.reshape(*lead, total // nbytes, nbytes)
    lo = b.to(torch.int64)
    sx = b.view(torch.int8).to(torch.int64)     # (int32_t)(signed char) casts
    if nbytes == 3:
        return (lo[..., 0] + lo[..., 1] * 256 + sx[..., 2] * 65536).to(torch.int32)
    # nbytes == 4: the reference sign-extends BOTH byte 2 and byte 3
    # (src/quantization_utils.cpp:40-44), so a set sign bit in byte 2 loses
    # 2^24 relative to a plain LE int32 read. Preserved for bit-exactness.
    return _wrap_int32(lo[..., 0] + lo[..., 1] * 256 + sx[..., 2] * 65536
                       + sx[..., 3] * 16777216)


def pack_pcm(samples: torch.Tensor, bits: int) -> torch.Tensor:
    """int32 ``[..., n]`` -> uint8 ``[..., n*B]`` little-endian packed PCM:
    the low ``B`` bytes of each sample.

    Assumes samples already carry the reference's storage convention
    (left-justified within B bytes and +128 bias applied for 8-bit) as
    produced by :func:`float_to_int`.
    """
    nbytes = bytes_per_sample(bits)
    *lead, n = samples.shape
    le = samples.to(torch.int32).contiguous().view(torch.uint8).reshape(*lead, n, 4)
    return le[..., :nbytes].reshape(*lead, n * nbytes)


def unpack_pcm16_planar2_raw(data: torch.Tensor) -> torch.Tensor:
    """uint8 ``[..., frames*4]`` interleaved stereo s16 -> RAW int16
    ``[..., 2, frames]`` (no widening, no gain): the feed of the fused int16
    kernel, which folds the gain factor into its weight tiles."""
    *lead, total = data.shape
    s = data.contiguous().view(torch.int16).reshape(*lead, total // 4, 2)
    return s.transpose(-1, -2).contiguous()


def unpack_pcm16_planar2(data: torch.Tensor) -> torch.Tensor:
    """uint8 ``[..., frames*4]`` interleaved stereo s16 -> int32
    ``[..., 2, frames]``. Values identical to unpack_pcm + reshape/transpose."""
    return unpack_pcm16_planar2_raw(data).to(torch.int32)


def unpack_pcm16_raw(data: torch.Tensor) -> torch.Tensor:
    """uint8 ``[..., frames*2]`` mono s16 -> RAW int16 ``[..., frames]``."""
    return data.contiguous().view(torch.int16)


def pack_pcm16_interleave2(samples: torch.Tensor) -> torch.Tensor:
    """int32 ``[..., 2, T]`` (16-bit storage convention) -> uint8
    ``[..., T*4]`` interleaved stereo (inverse of unpack_pcm16_planar2)."""
    *lead, _, T = samples.shape
    le = samples.to(torch.int32).transpose(-1, -2).contiguous().view(torch.uint8)
    return le.reshape(*lead, T, 2, 4)[..., :2].reshape(*lead, T * 4)


# -------------------------------------------------------------- int <-> float


def int_to_float(samples: torch.Tensor, factor) -> torch.Tensor:
    """int samples -> f32 via a single f32 multiply (the reference's only
    per-sample float op, src/quantization_utils.cpp:14,23,33,44). ``factor``
    is an f32 value, so the product is the correctly rounded f32 product
    whether the scalar is applied in f32 or in f64."""
    return samples.to(torch.float32) * float(np.float32(factor))


def float_to_int(x: torch.Tensor, bits: int) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 -> storage-convention int32 samples + per-sample clipped mask.

    Mirrors src/quantization_utils.cpp:50-94: round-half-up via
    ``floorf(x*scalar + 0.5f)``, symmetric clip with counting, 32-bit clip
    decided on the raw input, left-justify by ``(32-bits)%8`` and +128 offset
    for <=8-bit output.
    """
    scalar = float(np.float32((1 << bits) / 2.0))
    offset = 128 if bits <= 8 else 0
    high_clip = (1 << (bits - 1)) - 1
    low_clip = ~high_clip
    left_shift = (32 - bits) % 8

    # two eager ops: the product is rounded before the add (:61)
    y = torch.floor(torch.mul(x, scalar).add(0.5))
    if bits < 32:
        # x86 cvttss2si: NaN or |y| >= 2^31 converts to INT_MIN, so hugely
        # positive inputs clip to NEGATIVE full scale (:61)
        in_range = (y >= -_F_TWO31) & (y < _F_TWO31)
        cast = torch.where(in_range, y, 0.0).to(torch.int32)
        out = torch.where(in_range, cast, _INT_MIN)
        clipped = (out > high_clip) | (out < low_clip)
        out = out.clamp(low_clip, high_clip)
    else:
        # For 32-bit the reference tests the float input directly (:70-78);
        # the clip branch overrides every lane whose y leaves int32 range,
        # and a NaN lane (no clip) converts to 0 as in the JAX reference.
        nan = torch.isnan(y)
        clip_hi = x >= 1.0
        clip_lo = x < -1.0
        clipped = clip_hi | clip_lo
        safe = torch.where(nan, 0.0, y.clamp(-_F_TWO31, _F_BELOW_TWO31)).to(torch.int32)
        out = torch.where(clip_hi, high_clip, torch.where(clip_lo, low_clip, safe))
        out = out.to(torch.int32)
    if left_shift:
        out = out * (1 << left_shift)
    if offset:
        out = out + offset
    return out.to(torch.int32), clipped


# ------------------------------------------------------- packed-byte wrappers


def quantized_to_float(data: torch.Tensor, bits: int, gain_db: float = 0.0) -> torch.Tensor:
    """Packed uint8 ``[..., n*B]`` -> f32 ``[..., n]`` with dB gain.

    Batched equivalent of the reference
    ``quantization_utils::quantized_to_float`` (src/quantization_utils.cpp:6-48).
    """
    return int_to_float(unpack_pcm(data, bits), gain_factor(bits, gain_db))


def float_to_quantized(x: torch.Tensor, bits: int) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 ``[..., n]`` -> (packed uint8 ``[..., n*B]``, clipped sample count,
    an int64 scalar tensor).

    Batched equivalent of the reference
    ``quantization_utils::float_to_quantized`` (src/quantization_utils.cpp:50-94).
    """
    samples, clipped = float_to_int(x, bits)
    return pack_pcm(samples, bits), clipped.sum()
