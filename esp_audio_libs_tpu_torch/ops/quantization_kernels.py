"""Wrapper of the hand-written CUDA kernel that quantizes and packs the
resampler's stereo 16-bit output, its plain PyTorch version and its launch
count.

``quantize_pack16_cuda`` (csrc/pcm_quantize16.cu) does in one pass what
:func:`quantize_pack16_plain` does with eager ops: ``float_to_int(x, 16)``
(ops/quantization.py), the per-stream clip count over the first ``gen``
frames and ``pack_pcm16_interleave2``, writing the packed frames and the
counts into the caller's buffers. The bytes and counts are the same bit for
bit, NaN, infinities and the x86 cast's INT_MIN included.

A wrapper given CPU tensors runs the plain version. Given CUDA tensors it
launches the kernel on the current stream or raises; there is no fallback.
Any other device raises. ``quantize_pack16_cuda.launches`` counts kernel
launches only.
"""

from __future__ import annotations

import torch

from ..runtime import kernels
from . import quantization as q
from .polyphase_kernels import _raise_on, _route

__all__ = ["quantize_pack16_cuda", "quantize_pack16_plain", "reset_launch_counts"]


def quantize_pack16_plain(x: torch.Tensor, gen: int):
    """f32 ``[B, 2, T]`` -> (uint8 ``[B, T*4]`` interleaved little-endian s16
    frames, int64 ``[B]`` clipped samples of both channels over the first
    ``gen`` frames)."""
    samples, clipped = q.float_to_int(x, 16)
    return (q.pack_pcm16_interleave2(samples),
            clipped[..., :gen].sum((1, 2), dtype=torch.int64))


def _check(x: torch.Tensor, gen: int, out, clips):
    """The shapes the kernel takes; returns (B, T)."""
    if x.dtype != torch.float32 or x.dim() != 3 or x.shape[1] != 2:
        raise ValueError(f"x must be f32 [B, 2, T], got {x.dtype} {tuple(x.shape)}")
    B, _, T = x.shape
    if gen < 0:
        raise ValueError(f"gen = {gen} < 0")
    if out.dtype != torch.uint8 or tuple(out.shape) != (B, T * 4):
        raise ValueError(f"out must be uint8 [{B}, {T * 4}], got {out.dtype} {tuple(out.shape)}")
    if clips.dtype != torch.int64 or tuple(clips.shape) != (B,):
        raise ValueError(f"clips must be int64 [{B}], got {clips.dtype} {tuple(clips.shape)}")
    return B, T


def quantize_pack16_cuda(x: torch.Tensor, gen: int, out: torch.Tensor, clips: torch.Tensor):
    """Quantize f32 ``[B, 2, T]`` to stereo s16 and pack it, as
    :func:`quantize_pack16_plain`, into ``out`` (uint8 ``[B, T*4]``, any row
    pitch) and ``clips`` (int64 ``[B]``). Returns (out, clips). On the card
    ``x``'s samples must be contiguous (any stream and channel stride),
    ``out``'s rows contiguous and 4-byte aligned, and ``clips`` contiguous;
    ``ValueError`` otherwise."""
    B, T = _check(x, gen, out, clips)
    if _route(x, out, clips) == "cpu":
        packed, counts = quantize_pack16_plain(x, gen)
        out.copy_(packed)
        clips.copy_(counts)
        return out, clips
    if B and T and x.stride(2) != 1:
        raise ValueError("x's samples must be contiguous")
    if B and T and (out.stride(1) != 1 or out.stride(0) % 4 or out.data_ptr() % 4):
        raise ValueError("out's rows must be contiguous and 4-byte aligned")
    if B and clips.stride(0) != 1:
        raise ValueError("clips must be contiguous")
    with kernels.launch_on(x.device) as lib:
        rc = lib.eal_quantize_pack16(
            x.data_ptr(), x.stride(0), x.stride(1), out.data_ptr(), out.stride(0) // 4,
            clips.data_ptr(), B, T, min(gen, T), torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(rc, "quantize_pack16")
    quantize_pack16_cuda.launches += 1
    return out, clips


quantize_pack16_cuda.launches = 0


def reset_launch_counts() -> None:
    quantize_pack16_cuda.launches = 0
