"""Batched DSP primitives: the counterpart of esp_audio_libs_tpu/ops/dsp.py,
the reference's L1 kernel layer (the esp-dsp subset, reference
include/dsp.h:45-116) over ``[..., n]`` batches.

The ANSI semantics are kept exactly: the f32 accumulation order, int32
intermediates, arithmetic shifts and int16 wraparound, so results equal the
JAX package's bit for bit. The functions run where their tensors lie:

- :func:`dotprod_f32`  reference src/dsp/dsps_dotprod_f32_ansi.c:17-25.
  Exact: the hand kernel csrc/dotprod_exact.cu on CUDA tensors, its plain
  version on CPU tensors (ops/dsp_kernels.py).
- :func:`biquad_f32`   reference src/dsp/dsps_biquad_f32_ansi.c:17-25
  (Direct Form II, coef = {b0, b1, b2, a1, a2}, state w[2]). Exact: the
  state recurrence is ``iir2_sequential`` (csrc/biquad_exact.cu on CUDA
  tensors), the output taps torch ops.
- :func:`add_s16`      reference src/dsp/dsps_add_s16_ansi.c:10-27
- :func:`mulc_s16`     reference src/dsp/dsps_mulc_s16_ansi.c:19-31
- :func:`mix_s16`      the two chained: per-stream volume, left-fold sum.

Exact f32 forms follow the JAX package's subnormal rule (ops/scan.py): every
subnormal operand and result is a zero of its own sign.
"""

from __future__ import annotations

import torch

from .dsp_kernels import dotprod_exact_cuda
from .scan import exact_mul, ftz, iir2_scan, iir2_sequential

__all__ = ["dotprod_f32", "biquad_f32", "add_s16", "mulc_s16", "mix_s16"]


def dotprod_f32(a: torch.Tensor, b: torch.Tensor, *, exact: bool = True) -> torch.Tensor:
    """``acc = sum_i a[..., i] * b[..., i]`` over the last axis, in f32.

    exact=True keeps the ANSI kernel's order (dsps_dotprod_f32_ansi.c:19-22):
    ``((+0 + a0*b0) + a1*b1) + ...``, one rounded multiply and one rounded
    add per step. exact=False is one ``einsum`` in full f32 (TF32 off): the
    fast form, in another summation order.
    """
    a = torch.as_tensor(a).to(torch.float32)
    b = torch.as_tensor(b).to(torch.float32)
    if exact:
        return dotprod_exact_cuda(a, b)
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return torch.einsum("...i,...i->...", a, b)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow


def biquad_f32(x: torch.Tensor, coef: torch.Tensor, w: torch.Tensor, *, exact: bool = True):
    """Direct-Form-II biquad over the last (time) axis, batched.

    Reference per-sample recurrence (dsps_biquad_f32_ansi.c:18-24)::

        d0   = x[i] - coef[3]*w0 - coef[4]*w1
        y[i] = coef[0]*d0 + coef[1]*w0 + coef[2]*w1
        w1 = w0 ; w0 = d0

    Args:
      x:    f32 ``[..., T]``.
      coef: f32 ``[5]`` = {b0, b1, b2, a1, a2} (shared) or ``[..., 5]``.
      w:    f32 ``[..., 2]`` filter state (w0, w1).
      exact: every op rounded on its own in the C order (the state
        recurrence in one kernel launch on the card); otherwise the state
        recurrence as a log2(T)-pass scan and the same 3-tap FIR.

    Returns: (y ``[..., T]``, new w ``[..., 2]`` = (d[T-1], d[T-2])).
    """
    x = torch.as_tensor(x).to(torch.float32)
    lead = x.shape[:-1]
    coef = torch.as_tensor(coef, device=x.device).to(torch.float32).expand(*lead, 5)
    b0, b1, b2, a1, a2 = coef.unbind(-1)
    w = torch.as_tensor(w, device=x.device).to(torch.float32)
    w0, w1 = w[..., 0].expand(lead), w[..., 1].expand(lead)

    if exact:
        d, (d_last, d_prev) = iir2_sequential(x, a1, a2, w0, w1)
    else:
        d, _ = iir2_scan(x, a1, a2, w0, w1)
    # the output taps read d one and two steps back, the state before t = 0
    d1 = torch.cat([w0[..., None], d[..., :-1]], dim=-1)
    d2 = torch.cat([w1[..., None], d1[..., :-1]], dim=-1)
    if exact:
        y = ftz(ftz(exact_mul(b0[..., None], d) + exact_mul(b1[..., None], d1))
                + exact_mul(b2[..., None], d2))
        return y, torch.stack([d_last, d_prev], dim=-1)
    y = b0[..., None] * d + b1[..., None] * d1 + b2[..., None] * d2
    return y, torch.stack([d[..., -1], d1[..., -1]], dim=-1)


def _shift_right(acc: torch.Tensor, shift) -> torch.Tensor:
    """Arithmetic right shift of int32 ``acc`` by ``shift`` (an int or an
    integer tensor). A count outside [0, 31] fills with the sign bit, as
    XLA's shift does (the JAX package's semantics); the count is clamped
    here so that no device sees an out-of-range shift."""
    if isinstance(shift, torch.Tensor):
        s = shift.to(device=acc.device, dtype=torch.int32)
        return acc >> torch.where((s < 0) | (s > 31), 31, s)
    s = int(shift)
    return acc >> (s if 0 <= s <= 31 else 31)


def add_s16(a: torch.Tensor, b: torch.Tensor, shift=0) -> torch.Tensor:
    """int16 add with an int32 accumulator and an arithmetic right shift:
    ``int16((int32(a) + int32(b)) >> shift)`` with C wraparound
    (dsps_add_s16_ansi.c:23-26). ``shift`` is an int or a tensor."""
    acc = torch.as_tensor(a).to(torch.int32) + torch.as_tensor(b).to(torch.int32)
    return _shift_right(acc, shift).to(torch.int16)


def mulc_s16(x: torch.Tensor, c) -> torch.Tensor:
    """Q15 multiply by a constant: ``int16((int32(x) * C) >> 15)``
    (dsps_mulc_s16_ansi.c:26-29)."""
    x = torch.as_tensor(x)
    acc = x.to(torch.int32) * torch.as_tensor(c, device=x.device).to(torch.int32)
    return (acc >> 15).to(torch.int16)


def mix_s16(x: torch.Tensor, gains_q15, shift=0) -> torch.Tensor:
    """Volume-scale and mix ``S`` int16 streams into one: the chained kernel
    calls ::

        y[s] = mulc_s16(x[s], gains_q15[s])                 # per-stream volume
        acc  = y[0]; acc = add_s16(acc, y[s], shift) for s = 1 .. S-1

    bit for bit, int16 wraparound included (``shift`` 0 wraps on overflow
    as the reference does). ``x`` is ``[S, ..., n]`` int16, ``gains_q15``
    ``[S]`` (Q15: unity is about 32767).
    """
    x = torch.as_tensor(x).to(torch.int16)
    gains = torch.as_tensor(gains_q15, device=x.device).to(torch.int32).reshape(
        (x.shape[0],) + (1,) * (x.dim() - 1))
    scaled = ((x.to(torch.int32) * gains) >> 15).to(torch.int16)
    acc = scaled[0]
    for y in scaled[1:]:
        acc = add_s16(acc, y, shift)
    return acc
