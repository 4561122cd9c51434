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
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["TILE", "banded_K", "banded_weights_device", "polyphase_banded"]

TILE = 128   # output columns per weight tile; the CUDA kernels are built for it


def banded_K(ratio: float, taps_p: int) -> int:
    """Static slab width: a tile of ``TILE`` outputs spans at most
    ``(TILE-1)/ratio`` window starts plus the (possibly biquad-folded) tap
    count; rounded up to 128."""
    span = int(np.ceil((TILE - 1) / float(ratio))) + taps_p + 8
    return ((span + 127) // 128) * 128


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
