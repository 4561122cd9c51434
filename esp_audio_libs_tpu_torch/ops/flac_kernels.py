"""Wrapper of the hand-written CUDA FLAC frame kernel, its plain PyTorch
version and its launch count.

``flac_frame_cuda`` (csrc/flac_frame.cu) replaces the JAX package's device
back-end of a FLAC frame bucket, ``_frame_kernel_body`` and
``_frame_kernel_esc`` (esp_audio_libs_tpu/models/flac.py:40-94) with the
``lax.scan`` of esp_audio_libs_tpu/ops/lpc.py:43-156. It is XLA there, not
Pallas; on the card it is one kernel, because eager PyTorch would launch a
few ops per sample. In one pass it does the escape fixup, the LPC/fixed
restoration, the wasted-bits shift, stereo decorrelation, the interleave
and the byte packing. Its plain version is :func:`flac_frame_plain`
(built on ops/lpc.py).

A wrapper given CPU tensors runs the plain version. Given CUDA tensors it
launches the kernel on the current stream or raises; there is no fallback.
Any other device raises. ``flac_frame_cuda.launches`` counts kernel
launches only.
"""

from __future__ import annotations

import torch

from ..runtime import kernels
from . import lpc
from .polyphase_kernels import _raise_on, _route

__all__ = ["ORDER_CLASSES", "flac_frame_cuda", "flac_frame_plain", "pack_params",
           "reset_launch_counts"]

ORDER_CLASSES = (4, 8, 12, 16, 32)
_RES_DTYPES = (torch.int8, torch.int16, torch.int32)


def pack_params(depth: int, mode32: bool) -> tuple[int, int, int]:
    """(bytes per sample, left shift, bias) of the output packing: the
    left-justified 32-bit mode shifts by ``32 - depth``; the native depths
    take ``ceil(depth / 8)`` bytes, shifted up to a byte boundary, with the
    unsigned bias of 128 at 8 bits (reference flac_decoder.cpp:245-258)."""
    if not 1 <= depth <= 32:
        raise ValueError(f"sample depth {depth} outside [1, 32]")
    if mode32:
        return 4, 32 - depth, 0
    return (depth + 7) // 8, (8 - depth % 8) % 8, 128 if depth == 8 else 0


def flac_frame_plain(data, coeffs, order, shift, wasted, chan_assign, *, depth: int,
                     nch: int, mode32: bool, use64: bool = True,
                     max_order: int = lpc.MAX_ORDER, esc_pos=None, esc_val=None):
    """Plain version of the frame kernel, the counterpart of
    ``_frame_kernel_body`` (with ``esc_pos``/``esc_val``, of
    ``_frame_kernel_esc``).

    data: int8/int16/int32 ``[F, C, T]`` warm-ups + residuals; coeffs int32
    ``[F, C, 32]``; order/shift/wasted int32 ``[F, C]``; chan_assign int32
    ``[F]``. The escape sideband (int32 flat positions into ``data`` and
    int32 values) overwrites the widened plane; positions out of range are
    dropped. Returns packed PCM uint8 ``[F, T * C * bytes_per_sample]``.
    """
    x = data.to(torch.int32, copy=esc_pos is not None)
    if esc_pos is not None:
        flat = x.reshape(-1)
        keep = (esc_pos >= 0) & (esc_pos < flat.numel())
        flat.index_put_((esc_pos[keep].long(),), esc_val[keep].to(torch.int32))
        x = flat.reshape(data.shape)
    y = lpc.lpc_restore(x, coeffs, order, shift, use64=use64, max_order=max_order).long()
    y = lpc.wrap32(y << wasted.long().clamp(max=32)[..., None])
    if nch == 2:
        y = lpc.decorrelate(y.to(torch.int32), chan_assign).long()
    inter = y.transpose(-1, -2).reshape(*y.shape[:-2], -1)                # [F, T*C]
    nbytes, lshift, bias = pack_params(depth, mode32)
    samples = lpc.wrap32((inter + bias) << lshift)
    parts = [((samples >> (8 * k)) & 0xFF).to(torch.uint8) for k in range(nbytes)]
    return torch.stack(parts, dim=-1).reshape(*inter.shape[:-1], -1)


def _check_int32(name: str, t: torch.Tensor, shape: tuple) -> None:
    if t.dtype != torch.int32 or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous int32 {list(shape)}, got "
                         f"{t.dtype} {list(t.shape)}")


def flac_frame_cuda(data, coeffs, order, shift, wasted, chan_assign, *, depth: int,
                    nch: int, mode32: bool, use64: bool = True,
                    max_order: int = lpc.MAX_ORDER, esc_pos=None, esc_val=None):
    """The FLAC frame kernel: escape fixup, restoration, wasted-bits shift,
    decorrelation, interleave and byte packing of ``F`` frames in one
    launch. Arguments and result as :func:`flac_frame_plain`. On the card,
    ``max_order`` must be one of ``ORDER_CLASSES`` and cover every order,
    the escape sideband needs an int8 plane and must be sorted by position
    (as a row of ``runtime.transport.escape_sideband_blocked`` is), and every tensor
    must be contiguous."""
    extra = () if esc_pos is None else (esc_pos, esc_val)
    if _route(data, coeffs, order, shift, wasted, chan_assign, *extra) == "cpu":
        return flac_frame_plain(data, coeffs, order, shift, wasted, chan_assign, depth=depth,
                                nch=nch, mode32=mode32, use64=use64, max_order=max_order,
                                esc_pos=esc_pos, esc_val=esc_val)
    if data.dtype not in _RES_DTYPES or data.dim() != 3 or not data.is_contiguous():
        raise ValueError(f"data must be contiguous int8/int16/int32 [F, C, T], got "
                         f"{data.dtype} {list(data.shape)}")
    F, C, T = data.shape
    if C != nch or not 1 <= C <= 8:
        raise ValueError(f"data has {C} channels, nch={nch} (1..8 supported)")
    if max_order not in ORDER_CLASSES:
        raise ValueError(f"max_order {max_order} is not one of {ORDER_CLASSES}")
    if F * C * T >= 2 ** 31:
        raise ValueError("a bucket of 2^31 samples or more does not fit int32 positions")
    _check_int32("coeffs", coeffs, (F, C, 32))
    for name, t in (("order", order), ("shift", shift), ("wasted", wasted)):
        _check_int32(name, t, (F, C))
    _check_int32("chan_assign", chan_assign, (F,))
    n_esc = 0
    if esc_pos is not None:
        if data.dtype != torch.int8:
            raise ValueError("the escape sideband rides an int8 plane")
        n_esc = esc_pos.numel()
        _check_int32("esc_pos", esc_pos, (n_esc,))
        _check_int32("esc_val", esc_val, (n_esc,))
    nbytes, lshift, bias = pack_params(depth, mode32)
    out = torch.empty((F, T * C * nbytes), dtype=torch.uint8, device=data.device)
    if F == 0 or T == 0:
        return out
    with kernels.launch_on(data.device) as lib:
        rc = lib.eal_flac_frame(
            data.data_ptr(), _RES_DTYPES.index(data.dtype),
            esc_pos.data_ptr() if n_esc else None, esc_val.data_ptr() if n_esc else None, n_esc,
            coeffs.data_ptr(), order.data_ptr(), shift.data_ptr(), wasted.data_ptr(),
            chan_assign.data_ptr(), out.data_ptr(), F, C, T, nbytes, lshift, bias,
            int(bool(use64)), int(max_order), torch.cuda.current_stream(data.device).cuda_stream)
    _raise_on(rc, "flac_frame")
    flac_frame_cuda.launches += 1
    return out


flac_frame_cuda.launches = 0


def reset_launch_counts() -> None:
    flac_frame_cuda.launches = 0
