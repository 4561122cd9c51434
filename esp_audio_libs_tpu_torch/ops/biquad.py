"""ART biquad filters: RBJ-style design, the impulse-response helpers the
fast resampler folds into its filterbank, and batched Direct-Form-I
application over ``[..., T]``.

The counterpart of esp_audio_libs_tpu/ops/biquad.py (reference:
src/resample/art_biquad.cpp:16-93). The host half is numpy; ``biquad_apply``
runs on the tensors' device in three forms: exact (the sequential kernel of
csrc/biquad_exact.cu, bit-exact), the associative scan (ops/scan.py) and the
truncated impulse response as a Toeplitz matmul. Coefficient layout matches
the reference struct ``BiquadCoefficients`` {a0, a1, a2, b1, b2}.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .scan import iir2_scan

__all__ = ["biquad_lowpass", "biquad_highpass", "biquad_init", "biquad_apply", "BiquadState",
           "fir_len_for", "biquad_impulse", "fold_biquad_into_filterbank"]


def biquad_lowpass(frequency: float) -> np.ndarray:
    """2nd-order lowpass design, Q = sqrt(0.5)
    (reference src/resample/art_biquad.cpp:16-25). Returns f32[5] {a0,a1,a2,b1,b2}.

    Design math runs in float64 exactly as the C double math, truncating to
    f32 on store (the C struct fields are float).
    """
    Q = math.sqrt(0.5)
    K = math.tan(math.pi * frequency)
    norm = 1.0 / (1.0 + K / Q + K * K)
    a0 = K * K * norm
    # a1 = 2 * filter->a0 AFTER a0 was truncated to float (art_biquad.cpp:21-22)
    return np.array([a0, 2 * float(np.float32(a0)), a0, 2.0 * (K * K - 1.0) * norm,
                     (1.0 - K / Q + K * K) * norm], dtype=np.float32)


def biquad_highpass(frequency: float) -> np.ndarray:
    """2nd-order highpass design (reference src/resample/art_biquad.cpp:29-38)."""
    Q = math.sqrt(0.5)
    K = math.tan(math.pi * frequency)
    norm = 1.0 / (1.0 + K / Q + K * K)
    a0 = norm
    a1 = -2.0 * norm
    # a2 = filter->a0 after a0 was truncated to float
    return np.array([a0, a1, float(np.float32(a0)), 2.0 * (K * K - 1.0) * norm,
                     (1.0 - K / Q + K * K) * norm], dtype=np.float32)


def biquad_init(coeffs: np.ndarray, gain: float = 1.0) -> np.ndarray:
    """Fold gain into the numerator (reference art_biquad.cpp:43-51)."""
    c = np.asarray(coeffs, np.float32).copy()
    g = np.float32(gain)
    c[0] = np.float32(c[0] * g)
    c[1] = np.float32(c[1] * g)
    c[2] = np.float32(c[2] * g)
    return c


class BiquadState:
    """Per-stream DF-I state: (in_d1, in_d2, out_d1, out_d2), each ``[...]``."""

    @staticmethod
    def zeros(shape=(), *, device, dtype=torch.float32):
        """Four zero tensors of ``shape`` on ``device`` (named explicitly:
        the state lives where the samples it filters live)."""
        return tuple(torch.zeros(shape, dtype=dtype, device=device) for _ in range(4))


def fir_len_for(coeffs: np.ndarray, tol: float = 1e-9, cap: int = 2048) -> int | None:
    """Impulse-response truncation length for the folded fast path.

    The IIR tail decays like r^k with r the pole radius (r = sqrt(b2) for a
    complex pair). Returns a multiple of 128, or None when the poles are too
    close to the unit circle for truncation to be profitable.
    """
    b2 = float(abs(coeffs[4]))
    b1 = float(abs(coeffs[3]))
    r = max(np.sqrt(b2) if b2 > 0 else 0.0, b1 / 2.0)
    r = min(max(r, 1e-6), 0.999999)
    k = int(np.ceil(np.log(tol) / np.log(r))) if r > tol else 64
    k = ((max(k, 64) + 127) // 128) * 128
    return k if k <= cap else None


def biquad_impulse(coeffs, K: int) -> np.ndarray:
    """f64 impulse response of the DF-I biquad, truncated at K taps.

    Coefficients are first rounded to f32 (the reference stores them as
    float, include/art_biquad.h), then the recurrence runs in f64.
    """
    a0, a1, a2, b1, b2 = (float(np.float32(c)) for c in np.asarray(coeffs).reshape(-1)[:5])
    h = np.zeros(K, np.float64)
    x1 = x2 = y1 = y2 = 0.0
    xin = 1.0
    for i in range(K):
        y = a0 * xin + a1 * x1 + a2 * x2 - b1 * y1 - b2 * y2
        h[i] = y
        x2, x1, xin = x1, xin, 0.0
        y2, y1 = y1, y
    return h


def fold_biquad_into_filterbank(filters_np, coeffs, fir_len: int, *, half: int,
                                stages: int = 2):
    """Compose a pre-filter biquad cascade with the sinc filterbank (LTI).

    ``out[t] = sum_j h[j] x[n-j]`` feeding ``sum_k f[k] x'[win0+k]``
    collapses to ``sum_m g[m] x[win0 - (Lh-1) + m]`` with
    ``g = convolve(f, reversed(h))``, so the polyphase contraction does the
    lowpassing and the biquad stages vanish.

    Returns (folded f32 ``[F+1, taps + Lh - 1]``, direct_row f32 — the mode-0
    "copy" output must itself be lowpassed — and the window-start offset
    Lh - 1 to subtract from win0 / add to the history length).
    """
    h1 = biquad_impulse(coeffs, fir_len)
    h = h1
    for _ in range(stages - 1):
        h = np.convolve(h, h1)
    Lh = len(h)
    rows = np.asarray(filters_np, np.float64)
    folded = np.stack([np.convolve(r, h[::-1]) for r in rows]).astype(np.float32)
    direct = np.zeros(folded.shape[1], np.float32)
    direct[half - 1: half - 1 + Lh] = h[::-1].astype(np.float32)
    return folded, direct, Lh - 1


def biquad_apply(x: torch.Tensor, coeffs: torch.Tensor, state, *, exact: bool = True,
                 first_order: bool = False, fir_len: int | None = None, valid_len=None):
    """Batched DF-I biquad over the last (time) axis.

    Reference per-sample op order (src/resample/art_biquad.cpp:84-90)::

        sum = (x*a0) + (in_d1*a1) + (in_d2*a2) - (b1*out_d1) - (b2*out_d2)

    Args:
      x: f32 ``[..., T]``.
      coeffs: f32 ``[5]`` (or broadcastable ``[..., 5]``) {a0,a1,a2,b1,b2},
        gain-folded by :func:`biquad_init`, on x's device.
      state: (in_d1, in_d2, out_d1, out_d2), each ``[...]``.
      exact: the sequential form, bit-exact (each op rounded on its own,
        subnormals flushed as the JAX package flushes them): the kernel of
        csrc/biquad_exact.cu for CUDA tensors, its plain version for CPU
        tensors (ops/biquad_kernels.py). Otherwise a fast form.
      first_order: the reference's shortcut when a2 == b2 == 0
        (art_biquad.cpp:49-50, 74-82): drops the a2/b2 terms, which changes
        the f32 rounding, so it mirrors the C branch exactly.
      fir_len: fast form only: truncate the impulse response at this length
        (:func:`fir_len_for`) and apply it as a blocked Toeplitz matmul
        instead of the associative scan; coefficients must be shared by the
        whole batch (row 0's are used). Error ~ pole_radius^fir_len.
      valid_len: optional int; samples at t >= valid_len do not advance the
        state. The exact form still computes their outputs from the frozen
        state, as the JAX scan does; the fast forms leave them unspecified.

    Returns: (y ``[..., T]``, new_state).
    """
    x = x.to(torch.float32)
    if exact:
        from .biquad_kernels import biquad_df1_cuda   # that module builds on ops/scan.py
        return biquad_df1_cuda(x, coeffs, state, first_order=first_order, valid_len=valid_len)
    lead = x.shape[:-1]
    c = coeffs.to(torch.float32).expand(*lead, 5)
    a0, a1, a2, b1, b2 = (c[..., i] for i in range(5))
    in_d1, in_d2, out_d1, out_d2 = (s.to(torch.float32).expand(lead) for s in state)
    if fir_len is not None:
        return _biquad_conv(x, coeffs, (in_d1, in_d2, out_d1, out_d2), fir_len, valid_len)

    # FIR forcing f[i] = a0*x[i] + a1*x[i-1] + a2*x[i-2] (elementwise), then
    # the IIR y[i] = f[i] - b1*y[i-1] - b2*y[i-2] by the associative scan
    x1 = torch.cat([in_d1[..., None], x[..., :-1]], dim=-1)
    x2 = torch.cat([in_d2[..., None], x1[..., :-1]], dim=-1)
    if first_order:
        f = a0[..., None] * x + a1[..., None] * x1
        y, (yl, yp) = iir2_scan(f, b1, torch.zeros_like(b2), out_d1, out_d2, valid_len)
    else:
        f = a0[..., None] * x + a1[..., None] * x1 + a2[..., None] * x2
        y, (yl, yp) = iir2_scan(f, b1, b2, out_d1, out_d2, valid_len)
    if valid_len is None:
        new_in = (x[..., -1], x1[..., -1])
    else:
        new_in = (_take_t(x, valid_len - 1, in_d1), _take_t(x, valid_len - 2, in_d2))
    return y, (*new_in, yl, yp)


def _take_t(x: torch.Tensor, t: int, fallback: torch.Tensor) -> torch.Tensor:
    """x[..., t] (t clamped to T - 1); t < 0 returns the carried fallback."""
    return x[..., min(t, x.shape[-1] - 1)] if t >= 0 else fallback


def _biquad_conv(x, coeffs, state, K: int, valid_len):
    """Truncated-impulse-response biquad: one Toeplitz matmul per block.

    The constant-coefficient IIR is LTI, so ``y = conv(x, h_total) +
    transient(state)``, with ``h_total`` the impulse response truncated at K
    and the transient a state-weighted sum of four K-long unit responses.
    The K-step impulse scan depends only on the shared coefficients (row 0,
    as the JAX version takes them): it runs once, on the host in f32, not
    over the batch. The convolution is one f32 ``torch.matmul`` over blocks
    of ``max(512, K)`` outputs (full f32 while TF32 is off, its default).
    """
    in_d1, in_d2, out_d1, out_d2 = state
    T = x.shape[-1]
    lead = x.shape[:-1]
    dev = x.device
    a0, a1, a2, b1, b2 = (np.float32(v) for v in coeffs.detach().reshape(-1, 5)[0].cpu().numpy())

    # impulse response of the pure IIR: h[0] = 1, h[i] = -b1 h[i-1] - b2 h[i-2]
    h = np.zeros(K, np.float32)
    h1, h2 = np.float32(1.0), np.float32(0.0)
    h[0] = h1
    for i in range(1, K):
        hn = np.float32(np.float32(-b1 * h1) - np.float32(b2 * h2))
        h[i] = hn
        h1, h2 = hn, h1
    h1s = np.concatenate([[np.float32(0.0)], h[:-1]]).astype(np.float32)      # h[i-1]
    h2s = np.concatenate([[np.float32(0.0)], h1s[:-1]]).astype(np.float32)    # h[i-2]
    h_total = a0 * h + a1 * h1s + a2 * h2s
    # unit responses to each initial-state component
    g = torch.as_tensor(np.stack([a1 * h + a2 * h1s, a2 * h, -b1 * h - b2 * h1s, -b2 * h]),
                        device=dev)                                            # [4, K]
    transient = (in_d1[..., None] * g[0] + in_d2[..., None] * g[1]
                 + out_d1[..., None] * g[2] + out_d2[..., None] * g[3])      # [..., K]

    M = x[..., 0].numel()
    xf = x.reshape(M, T)
    Tb = max(512, K)   # block size; the overlap trick needs K - 1 <= Tb
    nb = -(-T // Tb)
    # left-pad K-1 (causal history is zero; the transient carries the
    # state), right-pad to (nb + 1) * Tb
    xp = torch.nn.functional.pad(xf, (K - 1, (nb + 1) * Tb - (K - 1) - T))
    blocks = xp.reshape(M, nb + 1, Tb)
    xw = torch.cat([blocks[:, :-1, :], blocks[:, 1:, : K - 1]], dim=-1)       # [M, nb, Tb+K-1]
    # Toeplitz: H[r, j] = h_total[j + K - 1 - r] where in range
    r = np.arange(K - 1 + Tb)[:, None]
    j = np.arange(Tb)[None, :]
    idx = j + (K - 1) - r
    H = np.where((idx >= 0) & (idx < K), h_total[np.clip(idx, 0, K - 1)], np.float32(0.0))
    y = torch.matmul(xw, torch.as_tensor(H.astype(np.float32), device=dev))
    y = y.reshape(*lead, nb * Tb)[..., :T]
    m = min(K, T)
    y[..., :m] += transient[..., :m]

    if valid_len is None:
        return y, (x[..., -1], _take_t(x, T - 2, in_d1), y[..., -1], _take_t(y, T - 2, out_d1))
    return y, (_take_t(x, valid_len - 1, in_d1), _take_t(x, valid_len - 2, in_d2),
               _take_t(y, valid_len - 1, out_d1), _take_t(y, valid_len - 2, out_d2))
