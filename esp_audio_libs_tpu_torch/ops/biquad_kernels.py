"""Wrappers of the hand-written CUDA kernel for the exact sequential f32
recurrences, their plain PyTorch versions and their launch counts.

``csrc/biquad_exact.cu`` replaces two ``lax.scan`` loops of the JAX package
(XLA there, not Pallas; eager PyTorch would launch a dozen ops per sample):

* ``biquad_df1_cuda``: the exact DF-I biquad of ``biquad_apply(exact=True)``
  (esp_audio_libs_tpu/ops/biquad.py:197-223), second- or first-order, with
  the ``valid_len`` freeze. Plain version :func:`biquad_df1_plain`.
* ``iir2_sequential_cuda``: ``y = (f - p1*y1) - p2*y2`` of
  esp_audio_libs_tpu/ops/scan.py:41-61, its own specialisation (the DF-I
  step fed (1, 0, 0) would not give ``f`` for NaN, inf or -0). Plain
  version :func:`iir2_sequential_plain`.

Every product, sum and difference is rounded on its own, in the C
reference's order, with subnormals flushed as the JAX package flushes them
(ops/scan.py). A wrapper given CPU tensors runs the plain version. Given
CUDA tensors it launches the kernel on the current stream or raises; there
is no fallback. Any other device raises. ``<wrapper>.launches`` counts
kernel launches only.
"""

from __future__ import annotations

import torch

from ..runtime import kernels
from .polyphase_kernels import _raise_on, _route
from .scan import ftz

__all__ = ["biquad_df1_cuda", "biquad_df1_plain", "iir2_sequential_cuda",
           "iir2_sequential_plain", "reset_launch_counts"]


def _valid_steps(valid_len, T: int) -> int:
    """The number of steps that advance the carry: ``valid_len`` clamped to [0, T]."""
    return T if valid_len is None else min(max(int(valid_len), 0), T)


def biquad_df1_plain(x, coeffs, state, *, first_order: bool = False, valid_len=None):
    """Plain version of the exact DF-I biquad over the last axis.

    ``y = ((((x*a0) + i1*a1) + i2*a2) - b1*o1) - b2*o2`` per sample (the
    first-order branch drops the a2 and b2 terms), each op rounded and
    flushed on its own. Samples at t >= valid_len do not advance the carry;
    their outputs are still computed from the frozen carry, as the JAX
    scan computes them. The input side of each step depends on no output,
    so it is computed for all t at once with the same ops; only the output
    recurrence loops over t.

    x: f32 ``[..., T]``; coeffs: f32 ``[5]`` or ``[..., 5]``
    {a0, a1, a2, b1, b2}; state: (in_d1, in_d2, out_d1, out_d2), each
    ``[...]``. Returns (y ``[..., T]``, new state).
    """
    x = x.to(torch.float32)
    *lead, T = x.shape
    c = ftz(coeffs.to(torch.float32).expand(*lead, 5))
    a0, a1, a2, b1, b2 = (c[..., i] for i in range(5))
    in_d1, in_d2, out_d1, out_d2 = (s.to(torch.float32).expand(*lead) for s in state)
    vl = _valid_steps(valid_len, T)

    # the carried inputs as step t sees them (frozen from vl on): ext[t + 2] = x[t]
    ext = torch.cat([in_d2[..., None], in_d1[..., None], x], dim=-1)
    tc = torch.arange(T, device=x.device).clamp(max=vl)
    fx, f1, f2 = ftz(x), ftz(ext[..., tc + 1]), ftz(ext[..., tc])
    acc = ftz(ftz(fx * a0[..., None]) + ftz(f1 * a1[..., None]))
    if not first_order:
        acc = ftz(acc + ftz(f2 * a2[..., None]))
    acc = acc.movedim(-1, 0).contiguous()                     # [T, ...]

    o1, o2 = ftz(out_d1), ftz(out_d2)
    ys = []
    for t in range(vl):
        y = ftz(acc[t] - ftz(b1 * o1))
        if not first_order:
            y = ftz(y - ftz(b2 * o2))
        ys.append(y)
        o2, o1 = o1, y
    tail = ftz(acc[vl:] - ftz(b1 * o1))
    if not first_order:
        tail = ftz(tail - ftz(b2 * o2))
    y = torch.cat([torch.stack(ys), tail]) if ys else tail
    y = y.movedim(0, -1)

    # the new carry: copies of the last valid inputs and outputs (or the
    # state itself where fewer than two steps were valid), bits unchanged
    outs = torch.cat([out_d2[..., None], out_d1[..., None], y[..., :vl]], dim=-1)
    new_state = (ext[..., vl + 1], ext[..., vl], outs[..., vl + 1], outs[..., vl])
    return y.contiguous(), tuple(s.contiguous() for s in new_state)


def iir2_sequential_plain(f, p1, p2, y1, y2):
    """Plain version of ``y[t] = (f[t] - p1*y[t-1]) - p2*y[t-2]``, each op
    rounded and flushed on its own. f: f32 ``[..., T]``; p1, p2, y1, y2:
    ``[...]``. Returns (y ``[..., T]``, (y_last, y_prev))."""
    f = f.to(torch.float32)
    *lead, T = f.shape
    p1, p2 = (ftz(p.to(torch.float32).expand(*lead)) for p in (p1, p2))
    y1, y2 = (s.to(torch.float32).expand(*lead) for s in (y1, y2))
    ft = ftz(f).movedim(-1, 0)
    c1, c2 = ftz(y1), ftz(y2)
    ys = []
    for t in range(T):
        y = ftz(ftz(ft[t] - ftz(p1 * c1)) - ftz(p2 * c2))
        ys.append(y)
        c2, c1 = c1, y
    y = torch.stack(ys, dim=-1) if ys else f.clone()
    hist = torch.cat([y2[..., None], y1[..., None], y], dim=-1)
    return y, (hist[..., -1].contiguous(), hist[..., -2].contiguous())


def _lanes(t: torch.Tensor, lead, n: int) -> torch.Tensor:
    """``t`` broadcast to ``lead`` as a contiguous f32 ``[n]`` vector."""
    return t.to(torch.float32).expand(*lead).reshape(n).contiguous()


def _check_x(x: torch.Tensor, name: str):
    if x.dtype != torch.float32 or x.dim() < 1:
        raise ValueError(f"{name} must be f32 [..., T], got {x.dtype} {tuple(x.shape)}")
    *lead, T = x.shape
    n = 1
    for d in lead:
        n *= d
    if T >= 2 ** 31:
        raise ValueError(f"T = {T} does not fit int32")
    return lead, T, n


def biquad_df1_cuda(x, coeffs, state, *, first_order: bool = False, valid_len=None):
    """The exact DF-I biquad (second- or first-order, optional
    ``valid_len``). Arguments and result as :func:`biquad_df1_plain`; on the
    card ``x`` must be f32 (any layout: it is made contiguous)."""
    if _route(x, coeffs, *state) == "cpu":
        return biquad_df1_plain(x, coeffs, state, first_order=first_order, valid_len=valid_len)
    lead, T, n = _check_x(x, "x")
    if coeffs.shape[-1] != 5:
        raise ValueError(f"coeffs must be [..., 5], got {tuple(coeffs.shape)}")
    if coeffs.dim() == 1:
        coef, coef_stride = coeffs.to(torch.float32).contiguous(), 0
    else:
        coef, coef_stride = coeffs.to(torch.float32).expand(*lead, 5).reshape(n, 5).contiguous(), 5
    st_in = torch.stack([_lanes(s, lead, n) for s in state])                 # [4, n]
    if n == 0 or T == 0:
        return x.new_empty((*lead, T)), tuple(s.reshape(lead) for s in st_in)
    xc = x.contiguous()
    y = torch.empty_like(xc)
    st_out = torch.empty_like(st_in)
    with kernels.launch_on(x.device) as lib:
        rc = lib.eal_biquad_df1(
            xc.data_ptr(), y.data_ptr(), coef.data_ptr(), coef_stride, st_in.data_ptr(),
            st_out.data_ptr(), n, T, _valid_steps(valid_len, T), int(bool(first_order)),
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(rc, "biquad_df1")
    biquad_df1_cuda.launches += 1
    return y, tuple(s.reshape(lead) for s in st_out)


biquad_df1_cuda.launches = 0


def iir2_sequential_cuda(f, p1, p2, y1, y2):
    """``y[t] = (f[t] - p1*y[t-1]) - p2*y[t-2]``. Arguments and result as
    :func:`iir2_sequential_plain`."""
    if _route(f, p1, p2, y1, y2) == "cpu":
        return iir2_sequential_plain(f, p1, p2, y1, y2)
    lead, T, n = _check_x(f, "f")
    p = torch.stack([_lanes(p1, lead, n), _lanes(p2, lead, n)])            # [2, n]
    st_in = torch.stack([_lanes(y1, lead, n), _lanes(y2, lead, n)])
    if n == 0 or T == 0:
        return f.new_empty((*lead, T)), (st_in[0].reshape(lead), st_in[1].reshape(lead))
    fc = f.contiguous()
    y = torch.empty_like(fc)
    st_out = torch.empty_like(st_in)
    with kernels.launch_on(f.device) as lib:
        rc = lib.eal_iir2_sequential(
            fc.data_ptr(), y.data_ptr(), p.data_ptr(), st_in.data_ptr(), st_out.data_ptr(), n, T,
            torch.cuda.current_stream(f.device).cuda_stream)
    _raise_on(rc, "iir2_sequential")
    iir2_sequential_cuda.launches += 1
    return y, (st_out[0].reshape(lead), st_out[1].reshape(lead))


iir2_sequential_cuda.launches = 0


def reset_launch_counts() -> None:
    biquad_df1_cuda.launches = 0
    iir2_sequential_cuda.launches = 0
