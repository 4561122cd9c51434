"""Wrappers of the hand-written CUDA kernels for the banded polyphase
contraction; the counterpart of esp_audio_libs_tpu/ops/polyphase_pallas.py.

For each kernel: the wrapper, its plain PyTorch version and a launch count.

* ``polyphase_banded_cuda`` (csrc/polyphase_banded.cu) replaces
  ``polyphase_banded_pallas``; its plain version is
  ops/polyphase.py::polyphase_banded.
* ``polyphase_fused16_cuda`` (csrc/polyphase_fused16.cu) replaces
  ``polyphase_fused16_pallas``; its plain version is
  :func:`polyphase_fused16_plain`.

A wrapper given CPU tensors runs the plain version. Given CUDA tensors it
launches the kernel on the current stream or raises; there is no fallback.
Any other device raises. ``<wrapper>.launches`` counts kernel launches only.
"""

from __future__ import annotations

import torch

from ..runtime import kernels
from .polyphase import polyphase_banded

__all__ = ["polyphase_banded_cuda", "polyphase_fused16_cuda",
           "polyphase_fused16_plain", "reset_launch_counts"]


def _route(*tensors: torch.Tensor) -> str:
    """'cpu' or 'cuda' for a set of tensors on one device; raises otherwise."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devs))}")
    kind = devs.pop().type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device type {kind!r}: expected cpu or cuda")
    return kind


def _check_weights(Wt: torch.Tensor) -> int:
    """Validate Wt f32 [nt, K, 128] with a dense [K, 128] block per tile (the
    tile stride may be 0: one shared block); return the tile stride."""
    if Wt.dtype != torch.float32 or Wt.dim() != 3 or Wt.shape[2] != 128:
        raise ValueError(f"Wt must be f32 [nt, K, 128], got {Wt.dtype} {tuple(Wt.shape)}")
    if Wt.stride(2) != 1 or Wt.stride(1) != 128:
        raise ValueError("each Wt tile must be a dense row-major [K, 128] block")
    return Wt.stride(0)


def _check_starts(starts: torch.Tensor, nt: int) -> None:
    if starts.dtype != torch.int32 or starts.shape != (nt,) or not starts.is_contiguous():
        raise ValueError(f"starts must be contiguous int32 [{nt}], got "
                         f"{starts.dtype} {tuple(starts.shape)}")


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


def polyphase_banded_cuda(xext: torch.Tensor, Wt: torch.Tensor, starts: torch.Tensor,
                          *, T: int) -> torch.Tensor:
    """Banded contraction ``out[..., t] = sum_k x[..., starts[t//128]+k] *
    Wt[t//128, k, t%128]`` for ``t < T``.

    xext: f32 ``[..., L]``; Wt: f32 ``[nt, K, 128]``; starts: int32 ``[nt]``
    with ``start + K <= L``. Returns f32 ``[..., T]``.
    """
    if _route(xext, Wt, starts) == "cpu":
        return polyphase_banded(xext, Wt, starts, T=T)
    nt, K, _ = Wt.shape
    tile_stride = _check_weights(Wt)
    _check_starts(starts, nt)
    if xext.dtype != torch.float32 or not xext.is_contiguous():
        raise ValueError(f"xext must be contiguous f32, got {xext.dtype}")
    if not 0 < T <= nt * 128:
        raise ValueError(f"T={T} outside (0, {nt * 128}]")
    *lead, L = xext.shape
    M = xext.numel() // L
    out = torch.empty((*lead, T), dtype=torch.float32, device=xext.device)
    rc = kernels.library().eal_polyphase_banded(
        xext.data_ptr(), Wt.data_ptr(), starts.data_ptr(), out.data_ptr(),
        M, L, nt, K, tile_stride, T, torch.cuda.current_stream(xext.device).cuda_stream)
    _raise_on(rc, "polyphase_banded")
    polyphase_banded_cuda.launches += 1
    return out


polyphase_banded_cuda.launches = 0


def _quantize16(y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The fused kernel's epilogue in plain PyTorch: round-half-up with the
    product and the add separately rounded, x86 cast emulation (NaN or
    |y| >= 2^31 -> INT_MIN), clip to int16 with a clip mask."""
    y = torch.floor(torch.mul(y, 32768.0).add(0.5))
    bad = torch.isnan(y) | (y >= 2147483648.0) | (y < -2147483648.0)
    yc = torch.where(bad, -2147483648.0, y)
    clipped = (yc > 32767.0) | (yc < -32768.0)
    return yc.clamp(-32768.0, 32767.0).to(torch.int16), clipped.to(torch.int8)


def polyphase_fused16_plain(x2: torch.Tensor, Wt: torch.Tensor, starts: torch.Tensor):
    """Plain version of the fused kernel: the banded contraction of the raw
    int16 slabs in f32, then the 16-bit quantize epilogue."""
    nt = Wt.shape[0]
    y = polyphase_banded(x2.to(torch.float32), Wt, starts, T=nt * 128)
    return _quantize16(y)


def polyphase_fused16_cuda(x2: torch.Tensor, Wt: torch.Tensor, starts: torch.Tensor):
    """Fused resample + 16-bit quantize.

    Args:
      x2: RAW int16 samples ``[M, L]`` (history + chunk, gain NOT applied).
      Wt: f32 ``[nt, K, 128]`` weight tiles with the PCM gain factor folded in.
      starts: int32 ``[nt]`` tile starts.
    Returns: (samples int16 ``[M, nt*128]``, clip mask int8 ``[M, nt*128]``).
    Columns past the real output count carry values the caller ignores.
    """
    if _route(x2, Wt, starts) == "cpu":
        return polyphase_fused16_plain(x2, Wt, starts)
    nt, K, _ = Wt.shape
    tile_stride = _check_weights(Wt)
    _check_starts(starts, nt)
    if x2.dtype != torch.int16 or x2.dim() != 2 or not x2.is_contiguous():
        raise ValueError(f"x2 must be contiguous int16 [M, L], got {x2.dtype} {tuple(x2.shape)}")
    M, L = x2.shape
    out = torch.empty((M, nt * 128), dtype=torch.int16, device=x2.device)
    clip = torch.empty((M, nt * 128), dtype=torch.int8, device=x2.device)
    rc = kernels.library().eal_polyphase_fused16(
        x2.data_ptr(), Wt.data_ptr(), starts.data_ptr(), out.data_ptr(), clip.data_ptr(),
        M, L, nt, K, tile_stride, torch.cuda.current_stream(x2.device).cuda_stream)
    _raise_on(rc, "polyphase_fused16")
    polyphase_fused16_cuda.launches += 1
    return out, clip


polyphase_fused16_cuda.launches = 0


def reset_launch_counts() -> None:
    polyphase_banded_cuda.launches = 0
    polyphase_fused16_cuda.launches = 0
