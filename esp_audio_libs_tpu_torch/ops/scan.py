"""Shared recurrence solvers for IIR filters, and the exact-mode f32 rules.

The counterpart of esp_audio_libs_tpu/ops/scan.py. The ART resampler's DF-I
biquad and the DSP biquad reduce to the second-order linear recurrence

    y[i] = f[i] - p1*y[i-1] - p2*y[i-2]

solved either sequentially, each product and difference rounded on its own
(the C reference's order), or as a log2(T)-pass scan of 2x2 affine maps
``s_i = A s_{i-1} + u_i`` with ``s = (y[i], y[i-1])`` (the fast form).

**Subnormals.** The JAX package's exact paths run with subnormals flushed:
XLA on the CPU (its test platform) sets flush-to-zero and
denormals-are-zero, and the TPU has no subnormals. Every f32 result below
2^-126 in magnitude becomes a zero of its own sign, and every subnormal
operand of an arithmetic op counts as such a zero; a plain copy keeps its
bits. The port follows that rule on both devices: the CUDA kernels use the
``.ftz`` PTX forms, the plain versions :func:`ftz` around each op. (The C
reference underflows gradually; ROADMAP Queue 3.)
"""

from __future__ import annotations

import torch

__all__ = ["TINY", "ftz", "exact_mul", "iir2_scan", "iir2_sequential"]

TINY = 2.0 ** -126      # the smallest normal f32


def ftz(x: torch.Tensor) -> torch.Tensor:
    """Flush subnormal values to a zero of their own sign (NaN and inf pass)."""
    return torch.where(x.abs() < TINY, x * 0.0, x)


def exact_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32 multiply with its own IEEE rounding, subnormals flushed.

    The JAX version goes through f64 because XLA on the CPU contracts f32
    mul + add chains into FMAs. An eager PyTorch op never contracts with
    another, so this is a plain f32 multiply; the flush of its operands and
    of its result is the JAX package's subnormal rule (module docstring).
    """
    return ftz(ftz(a) * ftz(b))


def iir2_sequential(f: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor,
                    y1: torch.Tensor, y2: torch.Tensor):
    """Order-exact sequential solve of ``y[i] = (f[i] - p1*y[i-1]) - p2*y[i-2]``.

    One multiply and one subtract per term, left to right, each rounded and
    flushed on its own: the C reference's order. (XLA on the CPU contracts
    the JAX version's two mul-subs into FMAs; the TPU does not.)

    Args:
      f: f32 ``[..., T]`` forcing sequence.
      p1, p2: ``[...]`` recurrence coefficients.
      y1, y2: ``[...]`` initial state (y[-1], y[-2]).
    Returns: (y ``[..., T]``, (y_last, y_prev)). CPU tensors run the plain
    loop, CUDA tensors the kernel of csrc/biquad_exact.cu; other devices raise.
    """
    from .biquad_kernels import iir2_sequential_cuda   # that module builds on this one
    return iir2_sequential_cuda(f, p1, p2, y1, y2)


def _combine(e, g):
    """The affine map g after e (g later in time), as six components."""
    e11, e12, e21, e22, eu1, eu2 = e
    g11, g12, g21, g22, gu1, gu2 = g
    return (
        g11 * e11 + g12 * e21,
        g11 * e12 + g12 * e22,
        g21 * e11 + g22 * e21,
        g21 * e12 + g22 * e22,
        g11 * eu1 + g12 * eu2 + gu1,
        g21 * eu1 + g22 * eu2 + gu2,
    )


def iir2_scan(f: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor, y1: torch.Tensor,
              y2: torch.Tensor, valid_len: int | None = None):
    """Parallel solve of the same recurrence: log2(T) doubling passes over
    the six affine components (an inclusive Hillis-Steele scan).

    Same signature and returns as :func:`iir2_sequential`; results agree to
    f32 rounding (another association order). With ``valid_len``, elements
    at t >= valid_len are identity maps: the recurrence freezes there, so the
    returned state is (y[valid-1], y[valid-2]) and outputs beyond valid_len
    are unspecified.
    """
    f = f.to(torch.float32)
    shape = f.shape
    T = shape[-1]

    def bcast(v):
        return v.to(torch.float32)[..., None].expand(shape)

    m11, m12 = bcast(-p1), bcast(-p2)
    m21 = torch.ones(shape, dtype=torch.float32, device=f.device)
    m22 = torch.zeros(shape, dtype=torch.float32, device=f.device)
    u1 = f.clone()
    u2 = torch.zeros_like(f)
    # fold the initial state s_{-1} = (y1, y2) into element 0's offset
    u1[..., 0] += -p1 * y1 - p2 * y2
    u2[..., 0] += y1
    if valid_len is not None:
        invalid = torch.arange(T, device=f.device) >= valid_len
        m11 = torch.where(invalid, 1.0, m11)
        m12 = torch.where(invalid, 0.0, m12)
        m21 = torch.where(invalid, 0.0, m21)
        m22 = torch.where(invalid, 1.0, m22)
        u1 = torch.where(invalid, 0.0, u1)
    elems = (m11, m12, m21, m22, u1, u2)
    shift = 1
    while shift < T:
        later = _combine([c[..., :-shift] for c in elems], [c[..., shift:] for c in elems])
        elems = tuple(torch.cat([c[..., :shift], n], dim=-1) for c, n in zip(elems, later))
        shift *= 2
    y = elems[4]
    # s_T = (y[last], y[last-1]): the second affine component carries the
    # penultimate state, valid under freezing too
    return y, (y[..., -1], elems[5][..., -1])
