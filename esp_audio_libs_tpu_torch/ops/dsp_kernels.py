"""Wrapper of the hand-written CUDA kernel for the exact f32 dot product,
its plain PyTorch version and its launch count.

``csrc/dotprod_exact.cu`` replaces the ``lax.scan`` of
``dotprod_f32(exact=True)`` (esp_audio_libs_tpu/ops/dsp.py:32-51; XLA there,
not Pallas; eager PyTorch would launch one add per column):
``out[r] = (((+0 + a[r,0]*b[r,0]) + a[r,1]*b[r,1]) + ...)`` along the last
axis, each product and each sum rounded on its own, left to right, with
subnormals flushed as the JAX package flushes them (ops/scan.py). No
PyTorch reduction keeps that order (``sum``, ``cumsum`` and ``einsum``
reassociate). Plain version :func:`dotprod_exact_plain`.

A wrapper given CPU tensors runs the plain version. Given CUDA tensors it
launches the kernel on the current stream or raises; there is no fallback.
Any other device raises. ``dotprod_exact_cuda.launches`` counts kernel
launches only.
"""

from __future__ import annotations

import torch

from ..runtime import kernels
from .polyphase_kernels import _raise_on, _route
from .scan import ftz

__all__ = ["dotprod_exact_cuda", "dotprod_exact_plain", "reset_launch_counts"]


def dotprod_exact_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of the exact dot over the last axis: the flushed
    products first (no product depends on a sum), then one flushed add per
    column over all rows at once. a, b: f32 ``[..., n]`` (broadcast against
    each other). Returns f32 ``[...]``; +0 where n = 0."""
    a, b = torch.broadcast_tensors(a.to(torch.float32), b.to(torch.float32))
    prod = ftz(ftz(a) * ftz(b)).movedim(-1, 0)
    acc = torch.zeros(a.shape[:-1], dtype=torch.float32, device=a.device)
    for p in prod:
        acc = ftz(acc + p)
    return acc


def _rows(t: torch.Tensor, R: int, n: int):
    """``t`` as R rows of n elements with unit column stride: (tensor, pitch
    in elements). A view where the layout allows, else a contiguous copy."""
    rows = t.reshape(R, n)
    if (rows.stride(1) != 1 and n > 1) or rows.stride(0) < n:
        rows = rows.contiguous()
    return rows, rows.stride(0)


def dotprod_exact_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The exact dot over the last axis. Arguments and result as
    :func:`dotprod_exact_plain`; on the card ``a`` and ``b`` must be f32.
    Rows need no alignment (tensor copies where every row of both operands
    starts 16-byte aligned, 4-byte copies otherwise)."""
    if _route(a, b) == "cpu":
        return dotprod_exact_plain(a, b)
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError(f"a and b must be f32, got {a.dtype} and {b.dtype}")
    a, b = torch.broadcast_tensors(a, b)
    if a.dim() < 1:
        raise ValueError("a and b need a last (summed) axis")
    *lead, n = a.shape
    out = torch.empty(lead, dtype=torch.float32, device=a.device)
    if out.numel() == 0:
        return out
    if n >= 2 ** 31:
        raise ValueError(f"n = {n} does not fit int32")
    ra, lda = _rows(a, out.numel(), n)
    rb, ldb = _rows(b, out.numel(), n)
    with kernels.launch_on(a.device) as lib:
        rc = lib.eal_dotprod_exact(
            ra.data_ptr(), lda, rb.data_ptr(), ldb, out.data_ptr(), out.numel(), n,
            torch.cuda.current_stream(a.device).cuda_stream)
    _raise_on(rc, "dotprod_exact")
    dotprod_exact_cuda.launches += 1
    return out


dotprod_exact_cuda.launches = 0


def reset_launch_counts() -> None:
    dotprod_exact_cuda.launches = 0
