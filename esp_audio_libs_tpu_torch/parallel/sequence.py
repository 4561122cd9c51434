"""Sequence parallelism: one long stream's time axis split over devices.

The counterpart of esp_audio_libs_tpu/parallel/sequence.py. The reference
processes audio strictly in order with small carried state (biquad taps, the
resampler's ring buffer). Split over a time mesh instead:

- :func:`sequence_parallel_resample`: the fast resample path is a pure FIR
  once the biquad cascade is folded into the filterbank (ops/biquad.py), so
  each output's window touches a bounded input span. Outputs go to the
  device that owns their window start; each device takes its segment, a
  left halo (the previous segment's right edge; zeros on the first device,
  which is the zero history) and a right halo (the next segment's left
  edge, also absorbing the padding to a multiple of 128), builds its banded
  weights and launches the banded contraction kernel on its own segment.
  The JAX package moves each halo with one ``lax.ppermute``; here each is a
  copy of the neighbour's edge to the segment's device.
- :func:`sequence_parallel_iir2`: exact mode's order-2 recurrence. The
  segments run in device order, each through the exact sequential kernel
  (csrc/biquad_exact.cu on the card), starting from the exact state the
  previous segment handed over: bit-identical to one sequential solve.
- :func:`lpc_companion_scan`: shift-0 LPC restoration as an associative
  scan of (K+1)x(K+1) int64 affine maps, bit-identical to the sequential
  restoration; a time-split input scans each segment on its own device and
  composes the segments' carries in order.

A time mesh is a :class:`~.mesh.StreamMesh` read along the time axis; an
explicit device list may repeat a device, as for the stream mesh.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import lpc
from ..ops.polyphase import banded_weights_device
from ..ops.polyphase_kernels import polyphase_banded_cuda
from ..ops.scan import iir2_sequential
from .mesh import Sharded, StreamMesh, shard_streams, stream_mesh

__all__ = ["time_mesh", "sequence_parallel_resample", "sequence_parallel_iir2",
           "lpc_companion_scan"]


def time_mesh(devices=None) -> StreamMesh:
    """A 1-D mesh to split the time axis of few very long streams over (as
    :func:`~.mesh.stream_mesh`, which splits the batch axis)."""
    return stream_mesh(devices)


def sequence_parallel_resample(x, filters_np, direct_row, grid, mesh: StreamMesh, *,
                               taps_p: int, K: int, halo: int, tile: int = 128):
    """Resample one long chunk with its time axis split over ``mesh``.

    Args:
      x: f32 ``[B, ch, T_in]`` raw input (a tensor, or :class:`~.mesh.Sharded`
        along axis 2 over ``mesh``), T_in divisible by the mesh size.
      filters_np: f32 ``[F+1, taps_p]`` (possibly biquad-folded) filterbank.
      direct_row: f32 ``[taps_p]`` mode-0 row.
      grid: host phase grid for the WHOLE chunk, with any fold offset already
        applied to ``win0`` (window starts may be negative: zero history).
      halo: halo width, >= taps_p (both the history reach-back on the left
        and the window overhang on the right).
      K: slab width (``ops.polyphase.banded_K``).
    Returns: (y f32 ``[B, ch, D*To]`` as :class:`~.mesh.Sharded` along axis
      2, counts int ``[D]``): device d's outputs are ``y[..., d*To : d*To +
      counts[d]]``, its slots past ``counts[d]`` are zero, and the devices'
      outputs in order are the ``grid.output_generated`` valid samples.
    """
    D = mesh.size
    B, ch, T_in = x.shape
    assert T_in % D == 0, (T_in, D)
    assert halo >= taps_p, (halo, taps_p)
    T_loc = T_in // D
    # the right halo absorbs the padding that makes L_loc a multiple of 128
    halo_r = halo + (-(T_loc + 2 * halo)) % 128
    L_loc = T_loc + halo + halo_r
    assert L_loc >= K, (L_loc, K)
    assert T_loc >= halo_r, (T_loc, halo_r)

    gen = int(grid.output_generated)
    win0 = grid.win0[:gen].astype(np.int64)

    # host: each output goes to the device owning its window START (win0 is
    # monotone, so the devices' output ranges are contiguous and in order)
    owner = np.clip(win0 // T_loc, 0, D - 1)
    counts = np.bincount(owner, minlength=D)
    To = max(-(-int(counts.max()) // tile) * tile, tile)

    win0_l = np.zeros((D, To), np.int64)
    g_i1 = np.zeros((D, To), grid.idx1.dtype)
    g_i2 = np.zeros((D, To), grid.idx2.dtype)
    g_w = np.zeros((D, To), grid.weight.dtype)
    g_m = np.zeros((D, To), np.int32)
    pos = 0
    for d in range(D):
        n = int(counts[d])
        sl = slice(pos, pos + n)
        win0_l[d, :n] = win0[sl] - d * T_loc + halo
        win0_l[d, n:] = win0_l[d, n - 1] if n else 0
        g_i1[d, :n] = grid.idx1[sl]
        g_i2[d, :n] = grid.idx2[sl]
        g_w[d, :n] = grid.weight[sl]
        g_m[d, :n] = grid.mode[sl]
        pos += n
    assert win0_l[counts > 0].min() >= 0, "halo too small for history reach-back"
    assert (win0_l + taps_p).max() <= L_loc, "halo too small for window overhang"

    xs = shard_streams(x, mesh, axis=2)
    consts = {dev: (torch.as_tensor(np.asarray(filters_np, np.float32), device=dev),
                    torch.as_tensor(np.asarray(direct_row, np.float32), device=dev))
              for dev in mesh.distinct()}
    parts = []
    for d, dev in enumerate(mesh.devices):
        x_loc = xs.parts[d]
        lh = (xs.parts[d - 1][..., -halo:].to(dev) if d > 0
              else x_loc.new_zeros((B, ch, halo)))
        rh = (xs.parts[d + 1][..., :halo_r].to(dev) if d + 1 < D
              else x_loc.new_zeros((B, ch, halo_r)))
        xext = torch.cat([lh, x_loc, rh], dim=-1)                     # [B, ch, L_loc]
        grid_d = [torch.as_tensor(a[d], device=dev)
                  for a in (win0_l.astype(np.int32), g_i1, g_i2, g_w, g_m)]
        Wt, starts = banded_weights_device(*consts[dev], *grid_d, int(counts[d]),
                                           K=K, taps_p=taps_p, L=L_loc)
        parts.append(polyphase_banded_cuda(xext, Wt, starts, T=To))
    return Sharded(parts, 2, mesh), counts


def sequence_parallel_iir2(f, p1, p2, y1, y2, mesh: StreamMesh):
    """Exact-mode sequence parallelism for the order-2 recurrence
    ``y[t] = (f[t] - p1*y[t-1]) - p2*y[t-2]`` (the biquad denominator form,
    ``ops.scan.iir2_sequential``): the time axis splits over ``mesh``, and
    each device solves its segment with the sequential kernel once the
    exact outgoing state of the segment before it has arrived.

    Output and final state are bit-identical to one sequential solve: every
    sample's ``(f - p1*y1) - p2*y2`` runs with the operands that the
    sequential order gives it; the split moves where a segment is computed,
    never the math. The segments run one after another (state passing is
    sequential in exact mode).

    Args:
      f: f32 ``[B, T]`` forcing (a tensor, or :class:`~.mesh.Sharded` along
        axis 1), T divisible by the mesh size.
      p1, p2: scalar f32 coefficients (tensors or numbers).
      y1, y2: f32 ``[B]`` initial state (y[-1], y[-2]).
    Returns: (y ``[B, T]`` :class:`~.mesh.Sharded` along axis 1, (y_last
      ``[B]``, y_prev ``[B]``) on the last device).
    """
    B, T = f.shape
    assert T % mesh.size == 0, (T, mesh.size)
    fs = shard_streams(f, mesh, axis=1)
    s1, s2 = torch.as_tensor(y1), torch.as_tensor(y2)
    parts = []
    for d, dev in enumerate(mesh.devices):
        coef = [torch.as_tensor(p, dtype=torch.float32).to(dev) for p in (p1, p2)]
        y, (s1, s2) = iir2_sequential(fs.parts[d], *coef, s1.to(dev), s2.to(dev))
        parts.append(y)
    return Sharded(parts, 1, mesh), (s1, s2)


def _compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The affine map ``b`` after ``a`` (``b @ a`` over the last two axes),
    as explicit component products: an int64 matmul would lower to ``bmm``,
    which has no integer kernel on CUDA. Wraps mod 2^64."""
    n = a.shape[-1]
    out = b[..., :, 0:1] * a[..., 0:1, :]
    for j in range(1, n):
        out = out + b[..., :, j:j + 1] * a[..., j:j + 1, :]
    return out


def _companion_maps(data, coeffs, order, K: int, t0: int) -> torch.Tensor:
    """The step maps ``M_i`` ``[T, ..., K+1, K+1]`` int64 of samples ``t0 ..
    t0 + T - 1``: rows 0..K-2 shift the window up, row K-1 is the new sample
    (the aligned coefficients, zero during warm-up, plus x[i] in the affine
    column), row K keeps the affine 1."""
    T = data.shape[-1]
    batch = data.shape[:-1]
    dev = data.device
    order_b = order.long()[..., None]
    # c_aligned[j] multiplies window slot j (slot j holds y[i-K+j]): the
    # alignment of ops/lpc.py's sequential window
    j_idx = torch.arange(K, device=dev) - (K - order_b)                        # [..., K]
    valid = (j_idx >= 0) & (j_idx < order_b)
    j_safe = j_idx.clamp(0, coeffs.shape[-1] - 1).expand(*batch, K)
    c_aligned = torch.where(
        valid, torch.gather(coeffs.long().expand(*batch, coeffs.shape[-1]), -1, j_safe), 0)
    x_t = data.long().movedim(-1, 0)                                           # [T, ...]
    i_t = torch.arange(t0, t0 + T, device=dev).reshape((T,) + (1,) * len(batch))
    warm = i_t < order.long()                                                  # [T, ...]
    M = torch.zeros((T, *batch, K + 1, K + 1), dtype=torch.int64, device=dev)
    for r in range(K - 1):
        M[..., r, r + 1] = 1
    M[..., K - 1, :K] = torch.where(warm[..., None], 0, c_aligned.expand(T, *batch, K))
    M[..., K - 1, K] = x_t
    M[..., K, K] = 1
    return M


def _prefix(M: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix compositions ``P_t = M_t ... M_0`` over axis 0, by
    log2(T) doubling passes (a Hillis-Steele scan)."""
    shift = 1
    while shift < M.shape[0]:
        M = torch.cat([M[:shift], _compose(M[:-shift], M[shift:])], dim=0)
        shift *= 2
    return M


def _restored(P: torch.Tensor, K: int) -> torch.Tensor:
    """Samples from prefix maps: the state starts as the affine unit vector,
    so y[i] is the affine column of P_i's row K-1; back to ``[..., T]`` int32."""
    return lpc.wrap32(P[..., K - 1, K]).to(torch.int32).movedim(0, -1).contiguous()


def lpc_companion_scan(data, coeffs, order, *, max_order: int = 4):
    """Order-k companion-matrix LPC restoration as an associative scan, exact
    for ``shift == 0`` predictors (every fixed-prediction subframe, and LPC
    subframes whose quantization shift is zero; reference
    flac_decoder.cpp:774-804).

    With shift 0 the recurrence ``y[i] = x[i] + sum_j c[j]*y[i-(order-j)]``
    is affine over the ring Z/2^64, where wraparound is exact, and the true
    values fit int32, so the log-depth prefix product equals the sequential
    restoration bit for bit. (The shifted recurrence floors inside the loop,
    which breaks the composition of affine maps: no time-parallel form of
    it can be exact.) The state rides as ``v_i = [y[i-K+1..i], 1]``.

    This is the latency form, (K+1)^3 ring multiply-adds a sample and pass;
    the throughput form stays ``ops.lpc.lpc_restore`` and the frame kernel.

    Args:
      data: int32 ``[..., T]`` warm-ups + residuals (shift-0 layout), a
        tensor or :class:`~.mesh.Sharded` along its last axis over a time
        mesh (each segment scans on its own device, then the segments'
        carries compose in order).
      coeffs: int32 ``[..., 32]`` oldest-first, zero-padded (ops/lpc.py).
      order: int32 ``[...]`` predictor order, <= max_order.
      max_order: the window K (4 covers every fixed predictor).
    Returns: int32 ``[..., T]`` restored samples (Sharded like ``data``),
      bit-identical to ``ops.lpc.lpc_restore(..., shift=0)``.
    """
    K = int(max_order)
    if not isinstance(data, Sharded):
        return _restored(_prefix(_companion_maps(data, coeffs, order, K, 0)), K)
    if data.axis not in (-1, len(data.shape) - 1):
        raise ValueError(f"data must be split along its last (time) axis, not {data.axis}")
    carry, t0, parts = None, 0, []
    for part in data.parts:
        dev = part.device
        P = _prefix(_companion_maps(part, coeffs.to(dev), order.to(dev), K, t0))
        if carry is not None:
            P = _compose(carry.to(dev)[None], P)     # after everything before this segment
        carry = P[-1]
        parts.append(_restored(P, K))
        t0 += part.shape[-1]
    return Sharded(parts, data.axis, data.mesh)
