"""Block-banded fast polyphase contraction (device side), plain PyTorch.

PyTorch counterpart of the fast path of esp_audio_libs_tpu/ops/polyphase.py.
A chunk's phase-grid schedule becomes block-banded weight tiles: outputs are
grouped into tiles of 128 columns, each tile's windows span a contiguous
``K``-sample slab of the input anchored at ``starts[i]``, and

    out[m, 128 i + j] = sum_k x[m, starts[i] + k] * Wt[i, k, j]

``polyphase_banded`` here is the plain version of that contraction (slab
gather + f32 ``bmm``); ops/polyphase_kernels.py holds the hand-written CUDA
kernel and its wrapper. On the GPU kernel starts need no 128-alignment, so
the port has only the unaligned geometry (the JAX ``banded_K(aligned=False)``).

``polyphase_apply`` applies a chunk schedule the way exact mode and
``BatchedResample`` do: the exact form through the ordered-dot kernel
(ops/polyphase_kernels.py::polyphase_exact_cuda), the fast form as one dense
f32 matmul.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["TILE", "banded_K", "banded_weights_device", "build_banded_weights",
           "polyphase_apply", "polyphase_banded"]

TILE = 128   # output columns per weight tile; the CUDA kernels are built for it


def banded_K(ratio: float, taps_p: int) -> int:
    """Static slab width: a tile of ``TILE`` outputs spans at most
    ``(TILE-1)/ratio`` window starts plus the (possibly biquad-folded) tap
    count; rounded up to 128."""
    span = int(np.ceil((TILE - 1) / float(ratio))) + taps_p + 8
    return ((span + 127) // 128) * 128


def build_banded_weights(filters_np, win0x, idx1, idx2, weight, mode, *,
                         half, direct_row=None, valid_len=None, tile=128,
                         L=None):
    """Host-side schedule compression: block-banded weight tiles.

    A copy of the JAX package's host builder: outputs are grouped into tiles
    of ``tile`` columns; each tile's windows span only
    ``O(tile*ratio + taps)`` input samples, so its weights fit a small dense
    ``[K, tile]`` block anchored at ``starts[i]``, the operands of
    :func:`polyphase_banded`. The port builds the same tiles on the device
    per chunk (:func:`banded_weights_device`); this numpy form is the
    reference's public API and a cross-check of it.

    Args:
      filters_np: f32 ``[F+1, taps']`` numpy filterbank (possibly biquad-folded).
      win0x: int ``[T]`` window starts in xext coordinates (>= 0, monotonic).
      idx1, idx2, weight, mode: the phase-grid arrays (numpy).
      half: taps//2 of the ORIGINAL filterbank (direct-copy tap position).
      direct_row: optional f32 ``[taps']`` row for mode-0 outputs (used when a
        pre-filter is folded in: a "copy" must still be lowpassed); defaults
        to a unit tap at half-1.
      valid_len: outputs at t >= valid_len get all-zero rows (padded slots).
      L: xext time length; when given, tile starts are clamped to L - K so a
        slab never runs past the input (offsets are computed against the
        clamped starts, so clamping stays aligned).
    Returns: (Wt f32 ``[nt, K, tile]``, starts int32 ``[nt]``).
    """
    T = len(win0x)
    V = T if valid_len is None else min(int(valid_len), T)
    tapsp = filters_np.shape[1]
    w = weight[:V].astype(np.float32)
    f1 = filters_np[idx1[:V]]
    f2 = filters_np[idx2[:V]]
    feff = np.where((mode[:V] == 2)[:, None],
                    f2 * w[:, None] + f1 * (np.float32(1.0) - w)[:, None],
                    f1).astype(np.float32)
    if direct_row is None:
        direct_row = np.zeros(tapsp, np.float32)
        direct_row[half - 1] = 1.0
    feff[mode[:V] == 0] = direct_row

    nt = -(-T // tile)
    starts = np.zeros(nt, np.int64)
    span = tapsp
    for i in range(nt):
        t0 = min(i * tile, V - 1) if V else 0
        starts[i] = win0x[t0]
        last = min((i + 1) * tile, V) - 1
        if last >= t0:
            span = max(span, int(win0x[last]) + tapsp - int(starts[i]))
    K = ((span + 127) // 128) * 128
    if L is not None:
        if L < K:
            raise ValueError(f"xext length {L} shorter than slab width {K}")
        starts = np.minimum(starts, L - K)
    Wt = np.zeros((nt, K, tile), np.float32)
    for t in range(V):
        i, j = divmod(t, tile)
        o = int(win0x[t]) - int(starts[i])
        if o + tapsp > K:   # possible only after clamping; widen would be needed
            raise ValueError("band exceeds slab after start clamping")
        Wt[i, o:o + tapsp, j] = feff[t]
    return Wt, starts.astype(np.int32)


def banded_weights_device(filters, direct_row, win0x, idx1, idx2, weight, mode,
                          gen: int, *, K: int, taps_p: int, L: int):
    """Build the block-banded weight tiles on the device.

    Per output: two filterbank row gathers and an f32 lerp (the same
    separately rounded ops as the reference's subsample_interpolate), then an
    indexed write of the ``taps_p`` row at its in-tile offset. (The JAX
    version rotates rows into place with a barrel shifter because TPU
    scatters serialize; the values placed are identical.)

    Args:
      filters: f32 ``[F+1, taps_p]``. direct_row: f32 ``[taps_p]`` mode-0 row.
      win0x/idx1/idx2/weight/mode: ``[T]`` grid tensors, T a multiple of TILE;
        entries at t >= gen are ignored.
      gen: valid-output count. K/taps_p/L: slab width, row length and xext's
        time length (for start clamping).
    Returns: (Wt f32 ``[nt, K, TILE]``, starts int32 ``[nt]``).
    """
    T = win0x.shape[0]
    nt = T // TILE
    dev = filters.device
    valid = torch.arange(T, device=dev) < gen

    f1 = filters[idx1.long()]
    f2 = filters[idx2.long()]
    w = weight.to(torch.float32)[:, None]
    lerp = f2 * w + f1 * (1.0 - w)
    feff = torch.where((mode == 2)[:, None], lerp, f1)
    feff = torch.where((mode == 0)[:, None], direct_row[None, :], feff)
    feff = torch.where(valid[:, None], feff, 0.0)           # zero padded slots

    starts = torch.clamp(win0x.reshape(nt, TILE)[:, 0], max=L - K).to(torch.int32)
    offs = (win0x.reshape(nt, TILE) - starts[:, None]).clamp(0, K - taps_p)

    t = torch.arange(T, device=dev)
    rows = offs.reshape(T, 1).long() + torch.arange(taps_p, device=dev)
    Wt = torch.zeros((nt, K, TILE), dtype=torch.float32, device=dev)
    Wt[(t // TILE)[:, None], rows, (t % TILE)[:, None]] = feff
    return Wt, starts


def polyphase_banded(xext, Wt, starts, *, T: int):
    """Plain banded contraction: gather per-tile input slabs, contract in f32.

    xext: f32 ``[..., L]``; Wt: f32 ``[nt, K, tile]`` (a tile stride of 0, a
    broadcast weight block, is fine); starts: int32 ``[nt]`` with
    ``start + K <= L``. Returns f32 ``[..., T]``.
    """
    nt, K, tile = Wt.shape
    *lead, L = xext.shape
    x2 = xext.reshape(-1, L)
    cols = starts.long()[:, None] + torch.arange(K, device=xext.device)   # [nt, K]
    slabs = x2[:, cols].permute(1, 0, 2)                                   # [nt, M, K]
    out = torch.bmm(slabs, Wt)                                             # [nt, M, tile]
    out = out.permute(1, 0, 2).reshape(*lead, nt * tile)
    return out[..., :T]


def polyphase_apply(xext, filters, win0x, idx1, idx2, weight, mode, *, half: int,
                    exact: bool = True, compute_second: bool = True):
    """Apply one chunk schedule to a batch of streams (the counterpart of
    esp_audio_libs_tpu/ops/polyphase.py:200-276).

    Args:
      xext: f32 ``[..., L]``, history + new samples.
      filters: f32 ``[F+1, taps]`` filterbank.
      win0x: int32 ``[T]`` window starts in xext coordinates.
      idx1, idx2: int32 ``[T]`` filterbank rows; weight: f32 ``[T]`` lerp
        weights; mode: ``[T]`` 0 direct, 1 single, 2 lerp.
      half: taps // 2.
      exact: ordered per-tap accumulation, each op rounded on its own
        (bit-exact; the kernel of csrc/polyphase_exact.cu on the card, its
        plain version on the CPU) or the fast form: the schedule as a dense
        ``[L, T]`` weight matrix (lerp folded, mode-0 outputs a unit tap) and
        one f32 ``torch.matmul``, which runs in full f32 while
        ``torch.backends.cuda.matmul.allow_tf32`` is False (its default).
      compute_second: skip the second dot when the schedule has no mode-2
        entries (no SUBSAMPLE_INTERPOLATE).

    Returns: f32 ``[..., T]``.
    """
    if exact:
        from .polyphase_kernels import polyphase_exact_cuda   # that module builds on this one
        return polyphase_exact_cuda(xext, filters, win0x, idx1, idx2, weight, mode,
                                    half=half, compute_second=compute_second)
    xext = xext.to(torch.float32)
    L, T = xext.shape[-1], win0x.shape[0]
    taps = filters.shape[-1]
    dev = xext.device
    w = weight.to(torch.float32)[:, None]
    f1 = filters[idx1.long()]
    f2 = filters[idx2.long()]
    feff = torch.where((mode == 2)[:, None], f2 * w + f1 * (1.0 - w), f1)   # [T, taps]
    unit = torch.zeros((T, taps), dtype=torch.float32, device=dev)
    unit[:, half - 1] = 1.0
    feff = torch.where((mode == 0)[:, None], unit, feff)
    rows = win0x.long()[None, :] + torch.arange(taps, device=dev)[:, None]   # [taps, T]
    cols = torch.arange(T, device=dev)[None, :].expand(taps, T)
    # a write outside xext is dropped, as in JAX: it lands in a spare row
    rows = torch.where((rows >= 0) & (rows < L), rows, L)
    W = torch.zeros((L + 1, T), dtype=torch.float32, device=dev)
    W[rows, cols] = feff.T
    return torch.matmul(xext, W[:L])
