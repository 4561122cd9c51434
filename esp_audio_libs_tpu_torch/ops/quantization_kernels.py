"""Wrappers of the hand-written CUDA kernels at the two ends of the
resampler's stereo 16-bit path, their plain PyTorch versions and their
launch counts.

``quantize_pack16_cuda`` (csrc/pcm_quantize16.cu) does in one pass what
:func:`quantize_pack16_plain` does with eager ops: ``float_to_int(x, 16)``
(ops/quantization.py), the per-stream clip count over the first ``gen``
frames and ``pack_pcm16_interleave2``, writing the packed frames and the
counts into the caller's buffers. The bytes and counts are the same bit for
bit, NaN, infinities and the x86 cast's INT_MIN included.

``unpack16_extend_cuda`` (csrc/pcm_unpack16.cu) does in one pass what
:func:`unpack16_extend_plain` does with eager ops: a chunk's interleaved
stereo s16 bytes, read in place at any row pitch and byte offset, through
``unpack_pcm16_planar2`` and ``int_to_float`` into one f32 slab behind the
carried history and padded with zeros, the slab the resampler's contraction
reads. The floats are the same bit for bit.

A wrapper given CPU tensors runs the plain version. Given CUDA tensors it
launches the kernel on the current stream or raises; there is no fallback.
Any other device raises. Each wrapper's ``.launches`` counts kernel launches
only.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..runtime import kernels
from . import quantization as q
from .polyphase_kernels import _raise_on, _route

__all__ = ["quantize_pack16_cuda", "quantize_pack16_plain", "reset_launch_counts",
           "unpack16_extend_cuda", "unpack16_extend_plain"]


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


def unpack16_extend_plain(data: torch.Tensor, frames: int, factor, hist=None,
                          length: int | None = None) -> torch.Tensor:
    """uint8 ``[B, >= frames*4]`` interleaved stereo s16 -> the f32 slab
    ``[B, 2, length]``: ``hist`` (f32 ``[B, 2, H]``; None: H = 0), then the
    first ``frames`` frames of ``data`` times the f32 ``factor``
    (``int_to_float(unpack_pcm16_planar2(...))``), then zeros to ``length``
    (None: H + frames)."""
    x = q.int_to_float(q.unpack_pcm16_planar2(data[:, :frames * 4]), factor)
    if hist is not None:
        x = torch.cat([hist, x], dim=-1)
    return x if length is None else F.pad(x, (0, length - x.shape[-1]))


def _check_unpack(data: torch.Tensor, frames: int, hist, length):
    """The operands the kernel takes; returns (B, H, L)."""
    if data.dtype != torch.uint8 or data.dim() != 2:
        raise ValueError(f"data must be uint8 [B, bytes], got {data.dtype} {tuple(data.shape)}")
    B = data.shape[0]
    if frames < 0 or data.shape[1] < frames * 4:
        raise ValueError(f"data rows of {data.shape[1]} bytes hold no {frames} stereo s16 frames")
    H = 0
    if hist is not None:
        if hist.dtype != torch.float32 or hist.dim() != 3 or tuple(hist.shape[:2]) != (B, 2):
            raise ValueError(f"hist must be f32 [{B}, 2, H], got {hist.dtype} {tuple(hist.shape)}")
        H = hist.shape[2]
    L = H + frames if length is None else length
    if L < H + frames:
        raise ValueError(f"length {L} < history {H} + frames {frames}")
    return B, H, L


def unpack16_extend_cuda(data: torch.Tensor, frames: int, factor, hist=None,
                         length: int | None = None) -> torch.Tensor:
    """The slab of :func:`unpack16_extend_plain`, f32 ``[B, 2, length]``
    contiguous. On the card ``data`` is read in place, at any row pitch and
    byte offset (bytes within a row contiguous), and ``hist`` at any
    strides; one kernel launch writes the whole slab."""
    B, H, L = _check_unpack(data, frames, hist, length)
    if _route(data, *(() if hist is None else (hist,))) == "cpu":
        return unpack16_extend_plain(data, frames, factor, hist, length)
    if frames and data.stride(1) != 1:   # the kernel reads a row's bytes in order
        data = data[:, :frames * 4].contiguous()
    out = torch.empty((B, 2, L), dtype=torch.float32, device=data.device)
    h = (0, 0, 0, 0) if hist is None or H == 0 else (hist.data_ptr(), *hist.stride())
    with kernels.launch_on(data.device) as lib:
        rc = lib.eal_unpack16_extend(
            data.data_ptr(), data.stride(0), frames, float(factor),
            *h, H, out.data_ptr(), L, B, torch.cuda.current_stream(data.device).cuda_stream)
    _raise_on(rc, "unpack16_extend")
    unpack16_extend_cuda.launches += 1
    return out


unpack16_extend_cuda.launches = 0


def reset_launch_counts() -> None:
    quantize_pack16_cuda.launches = 0
    unpack16_extend_cuda.launches = 0
