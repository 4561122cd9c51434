"""The MXU-form MP3 granule synthesis (the ``fast=True`` / ``"mxu"`` tier):
the hybrid IMDCT and the PQMF subband stage as probed linear operators,
applied with matrix products.

The counterpart of esp_audio_libs_tpu/ops/mp3mxu.py (the probe sources carry
the reference citations: ops/mp3fast.py, ops/mp3imdct.py, ops/mp3subband.py;
Helix mp3_decoder.cpp:1783-2617 hybrid IMDCT, :798-1120,7707-8019 subband
synthesis). Everything after the dequantizer is linear in the spectra for
fixed side information: the hybrid IMDCT is a per-band map selected by the
window type, and one granule of PQMF synthesis (FDCT32, FIFO, dewindow) a
[576 + 1088 -> 576 + written] map selected by the FIFO phase. The maps are
measured by feeding basis vectors through this package's own f32 mirror
(ops/mp3fast.py) on the CPU, not restated:

- ``AX`` [18, 108]: per-band x-side maps, columns A36 (windows 0..3) | A12
  | C36 | C12 (4 * 18 + 18 + 9 + 9; the 36-point IMDCT's next-granule
  overlap C36 does not depend on the window, which the probe asserts);
- ``PX`` [9, 72]: per-band overlap-side maps, P (previous window 0..3),
  shared by the long and the short current block (asserted);
- ``S`` [8, 1664, 576]: one whole-granule subband map per FIFO phase, input
  [outbuf (576) | the channel's FIFO block (1088)], output the 576
  accumulators in PCM units before rounding;
- ``W`` [8, 576, 1088] and ``keep`` [8, 1088]: the granule's FIFO update:
  written slots are a linear image of outbuf, the others survive (the probe
  asserts the vbuf -> vbuf' map is exactly a 0/1 diagonal and that written
  slots take nothing from the old FIFO).

The probe runs once and its result is cached in
``build/mp3_mxu_ops_torch_<hash>.npz``, a file of this package's own (never
the JAX package's, which would hide a fault of this probe), named by a hash
of the sources the probe runs (``PROBE_SOURCES``): an edit to the mirror
probes afresh, never loads an older probe's operators.

A run (:func:`mxu_run`) computes, once for all its G granules, the
dequantizer (ops/mp3fast.py) and the x-side product ``x @ AX``, which carry
no state; then per granule: the step kernel ``mp3_mxu_pre_cuda`` (the
overlap product ``over @ PX``, the window selects and block masks,
FreqInvert, the new overlap and block count), the two phase-indexed GEMMs
``[of | vc] @ S[v]`` and ``of @ W[v]`` (``torch.matmul``, FP32, TF32 off: the
JAX package's HIGHEST precision), and the step kernel ``mp3_mxu_post_cuda``
(the ``keep[v]`` merge into the FIFO and the int16 quantization). The phase
of step g is ``(vindex - 9 g) & 7``, known to the host, so choosing S[v] and
W[v] needs no synchronisation. On CPU tensors the step kernels run their
plain versions, :func:`mxu_pre_plain` and :func:`mxu_post_plain`.
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
import os

import numpy as np
import torch

from ..runtime.native import REPO
from . import mp3fast
from .mp3_kernels import MXU_AX_COLS, mp3_mxu_post_cuda, mp3_mxu_pre_cuda

__all__ = ["imdct_granule_mxu", "mxu_operators", "mxu_run", "subband_granule_mxu"]

NBANDS = 32
N_OUT, N_V = 576, 34 * 32
PROBE_SOURCES = ("ops/mp3mxu.py", "ops/mp3fast.py", "ops/mp3subband.py", "ops/mp3dsp.py",
                 "runtime/tables.py")
_OPS_KEYS = ("AX", "PX", "S", "W", "keep")
F32 = torch.float32


# --------------------------------------------------------------------------
# probing (f32, on the CPU)
# --------------------------------------------------------------------------

def _probe_imdct() -> dict:
    """The per-band IMDCT maps, measured on the mirror functions."""
    blk = torch.zeros(18, dtype=torch.int32)           # an even band: no FreqInvert
    eye18, z9 = torch.eye(18), torch.zeros(18, 9)
    eye9, z18 = torch.eye(9), torch.zeros(9, 18)
    full = lambda n, v: torch.full((n,), v, dtype=torch.int32)   # noqa: E731

    A36, P36, C36 = [], [], None
    for wc in range(4):
        # bt_prev = 1 takes the windowed path; with xprev = 0 its x-side map
        # is the operator the fast path encodes
        y, prev = mp3fast._imdct36_f(eye18, z9, full(18, wc), full(18, 1), blk)
        A36.append(y.double().numpy())                 # rows = basis: A^T
        cf = prev.double().numpy()
        if C36 is None:
            C36 = cf
        else:
            np.testing.assert_allclose(cf, C36, rtol=0, atol=1e-6)
    for wp in range(4):
        y, _ = mp3fast._imdct36_f(z18, eye9, full(9, 1), full(9, wp), blk[:9])
        P36.append(y.double().numpy())
        # the short current-block path adds the identical previous-window term
        y12p, _ = mp3fast._imdct12x3_f(z18, eye9, full(9, wp), blk[:9])
        np.testing.assert_allclose(y12p.double().numpy(), P36[-1], rtol=0, atol=1e-9)
    y12, prev12 = mp3fast._imdct12x3_f(eye18, z9, full(18, 0), blk)
    ax = np.concatenate(A36 + [y12.double().numpy(), C36, prev12.double().numpy()], axis=1)
    assert ax.shape == (18, MXU_AX_COLS)
    return {"AX": ax.astype(np.float32), "PX": np.concatenate(P36, axis=1).astype(np.float32)}


def _probe_subband() -> dict:
    """The whole-granule subband maps, one per FIFO phase. A mono probe: the
    FIFO's reads and writes for channel ch stay in its own 32-column block,
    so the operator applies to each channel."""
    out_basis = torch.eye(N_OUT).reshape(N_OUT, 1, 18, 32)
    out_zero = torch.zeros(N_V, 1, 18, 32)
    vb_basis = torch.zeros(N_V, 34, 64)
    r, c = np.divmod(np.arange(N_V), 32)
    vb_basis[np.arange(N_V), r, c] = 1.0
    vb_basis = vb_basis.reshape(N_V, 2176)
    vb_zero = torch.zeros(N_OUT, 2176)

    S = np.zeros((8, N_OUT + N_V, N_OUT), np.float32)
    W = np.zeros((8, N_OUT, N_V), np.float32)
    keep = np.zeros((8, N_V), np.float32)
    for v in range(8):
        acc_o, vb_o = mp3fast._subband_scan_acc(out_basis, vb_zero, v, nch=1)
        acc_v, vb_v = mp3fast._subband_scan_acc(out_zero, vb_basis, v, nch=1)
        S[v, :N_OUT] = acc_o.reshape(N_OUT, N_OUT).numpy()
        S[v, N_OUT:] = acc_v.reshape(N_V, N_OUT).numpy()
        W[v] = vb_o.reshape(N_OUT, 34, 64)[:, :, :32].reshape(N_OUT, N_V).numpy()
        blk_v = vb_v.reshape(N_V, 34, 64)[:, :, :32].reshape(N_V, N_V).numpy().copy()
        # the vbuf -> vbuf' map must be exactly a 0/1 diagonal (a pure
        # overwrite FIFO): anything else means the layout assumption broke
        d = np.diagonal(blk_v).copy()
        np.testing.assert_array_equal(np.isin(d, (0.0, 1.0)), True)
        np.fill_diagonal(blk_v, 0.0)
        np.testing.assert_array_equal(blk_v, 0.0)
        keep[v] = d
        # written slots take nothing from the old FIFO
        np.testing.assert_array_equal(W[v][:, d == 1.0], 0.0)
    return {"S": S, "W": W, "keep": keep}


def ops_cache_path():
    """The operators' cache file, named by a hash of ``PROBE_SOURCES``."""
    pkg = REPO / "esp_audio_libs_tpu_torch"
    h = hashlib.sha256()
    for name in PROBE_SOURCES:
        h.update((pkg / name).read_bytes())
    return REPO / "build" / f"mp3_mxu_ops_torch_{h.hexdigest()[:16]}.npz"


def probe_operators() -> dict:
    """The operators probed afresh from the mirror, numpy f32."""
    with torch.no_grad():
        return {**_probe_imdct(), **_probe_subband()}


@functools.lru_cache(None)
def mxu_operators() -> dict:
    """The probed operators, numpy f32 (cached in the process and in
    :func:`ops_cache_path`). ``mxu_operators.origin`` says whether this
    process probed them or loaded the cache."""
    path = ops_cache_path()
    try:
        with np.load(path) as z:
            host = {k: z[k] for k in _OPS_KEYS}
        mxu_operators.origin = f"loaded from {path.relative_to(REPO)}"
        return host
    except (OSError, KeyError, ValueError):
        pass
    host = probe_operators()
    try:   # a temporary file renamed into place: concurrent probes never see half a file
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.npz")
        np.savez(tmp, **host)
        os.replace(tmp, path)
    except OSError:
        pass
    mxu_operators.origin = "probed"
    return host


mxu_operators.origin = None


@functools.lru_cache(None)
def device_operators(device) -> dict:
    """:func:`mxu_operators` as f32 tensors on ``device`` (uploaded once)."""
    return {k: torch.as_tensor(v, device=device) for k, v in mxu_operators().items()}


@contextlib.contextmanager
def _fp32_matmul():
    """TF32 off for the operator products (the JAX package's HIGHEST)."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


# --------------------------------------------------------------------------
# application
# --------------------------------------------------------------------------

def imdct_x_side(x, nbfly, ax):
    """The stateless half of the MXU IMDCT: the anti-alias butterflies, then
    the x-side product, f32 ``[L, 576]`` -> ``[L, 32, 108]``."""
    x = mp3fast._antialias_f(x.to(F32), nbfly)
    return torch.matmul(x.reshape(x.shape[0], NBANDS, 18), ax)


def imdct_tail(yx, xprev, block_type, mixed, prev_type, prev_win_switch, n_prev,
               n_blocks_long, n_blocks_total, curr_win_switch, px):
    """The carried half of the MXU IMDCT for L lanes: the overlap product
    ``xprev @ PX``, the window selects (an exact gather where the JAX
    module takes a one-hot product), the block masks, FreqInvert and the
    block count. Returns (out f32 ``[L, 18, 32]``, new_xprev ``[L, 32, 9]``,
    n_blocks_out ``[L]``)."""
    L = yx.shape[0]
    blk, curr_win, prev_win = mp3fast.block_windows(L, block_type, mixed, prev_type,
                                                    prev_win_switch, curr_win_switch, yx.device)
    yp = torch.matmul(xprev.to(F32), px)                                # [L, 32, 72]

    def sel4(sel, parts):   # parts [L, 32, 4 * 18]: the 18 columns of window sel
        idx = (mp3fast._sel4_index(sel)[..., None] * 18
               + torch.arange(18, device=yx.device))
        return torch.gather(parts, -1, idx)

    y36 = sel4(curr_win, yx[..., :72])
    y12 = yx[..., 72:90]
    prev36 = yx[..., 90:99]
    prev12 = yx[..., 99:108]
    ypo = sel4(prev_win, yp)

    m_lim = torch.maximum(n_blocks_long, n_blocks_total)[:, None]
    in_long = blk < n_blocks_long[:, None]
    in_short = ~in_long & (blk < n_blocks_total[:, None])
    in_prev = ~in_long & ~in_short & (blk >= m_lim) & (blk < n_prev[:, None])

    zero_y = torch.zeros_like(ypo)
    y = (torch.where(in_long[..., None], y36, torch.where(in_short[..., None], y12, zero_y))
         + torch.where((in_long | in_short | in_prev)[..., None], ypo, zero_y))
    new_prev = torch.where(in_long[..., None], prev36,
                           torch.where(in_short[..., None], prev12,
                                       torch.where(in_prev[..., None], torch.zeros_like(prev36),
                                                   xprev.to(F32))))
    y = mp3fast._freq_invert(y, blk)                  # probed at an even band
    po_nonzero = (ypo != 0).any(dim=-1)
    ext = torch.where(in_prev & po_nonzero, blk, torch.full_like(blk, -1))
    n_blocks_out = torch.maximum(m_lim[:, 0], ext.max(dim=-1).values)
    return y.transpose(1, 2), new_prev, n_blocks_out


def imdct_granule_mxu(x, xprev, nzb, block_type, mixed, prev_type, prev_win_switch,
                      block_cutoff, n_prev, ops):
    """Matrix-product hybrid synthesis: the contract of
    ``mp3fast.imdct_granule_fast`` with the per-band IMDCT, window and
    overlap arithmetic as two products against the probed operators ``ops``
    (:func:`device_operators`). Returns (out ``[L, 18, 32]``, new_xprev,
    new_nzb, n_blocks_out, curr_win_switch)."""
    nzb, block_type, mixed, prev_type, prev_win_switch, block_cutoff, n_prev = (
        v.to(torch.int32) for v in (nzb, block_type, mixed, prev_type, prev_win_switch,
                                    block_cutoff, n_prev))
    n_blocks_long, nbfly, n_blocks_total, nzb, cws = mp3fast.block_counts(
        nzb, block_type, mixed, block_cutoff)
    yx = imdct_x_side(x, nbfly, ops["AX"])
    out, new_prev, n_out = imdct_tail(yx, xprev, block_type, mixed, prev_type, prev_win_switch,
                                      n_prev, n_blocks_long, n_blocks_total, cws, ops["PX"])
    return out, new_prev, nzb, n_out, cws


def _fifo_blocks(vbuf, nch: int):
    """The FIFO's channel blocks ``[L * nch, 1088]`` (row-major [34, 32])
    from the interleaved ``[L, 2176]`` layout."""
    L = vbuf.shape[0]
    vb = vbuf.to(F32).reshape(L, 34, 2, 32)
    return vb.transpose(1, 2)[:, :nch].reshape(L * nch, N_V)


def mxu_post_plain(acc, newv, vbuf, keep, *, nch: int):
    """Plain version of ``mp3_mxu_post_cuda``: the ``keep`` merge of the
    written slots into the interleaved FIFO and the PCM quantization.
    Returns (pcm int16 ``[L, 576 * nch]``, new vbuf f32 ``[L, 2176]``)."""
    L = vbuf.shape[0]
    vc = _fifo_blocks(vbuf, nch)
    vc2 = torch.where(keep == 1.0, vc, newv).reshape(L, nch, 34, 32)
    new_vb = vbuf.to(F32).reshape(L, 34, 2, 32).clone()
    new_vb[:, :, :nch] = vc2.transpose(1, 2)
    pcm = mp3fast.quantize_pcm(acc.reshape(L, nch, 18, 32).transpose(1, 2))
    return pcm, new_vb.reshape(L, 2176)


def subband_granule_mxu(outbuf, vbuf, vindex: int, ops, *, nch: int):
    """Matrix-product PQMF synthesis: one probed [1664 -> 576] map per FIFO
    phase for the accumulators and a [576 -> 1088] map of the written slots.
    outbuf f32 ``[L, C, 18, 32]``; vbuf f32 ``[L, 2176]``. Returns (pcm
    int16 ``[L, 18 * 32 * nch]``, new vbuf), the contract of
    ``mp3fast.subband_granule_fast``."""
    L = outbuf.shape[0]
    v = int(vindex) & 7
    of = outbuf.to(F32).reshape(L * nch, N_OUT)
    ofvc = torch.cat([of, _fifo_blocks(vbuf, nch)], dim=-1)
    acc = torch.matmul(ofvc, ops["S"][v])
    newv = torch.matmul(of, ops["W"][v])
    return mxu_post_plain(acc, newv, vbuf, ops["keep"][v], nch=nch)


def mxu_pre_plain(yx, ip, over, prev_type, prev_win_switch, num_prev, vbuf, px, *, nch: int):
    """Plain version of ``mp3_mxu_pre_cuda`` (arguments as there): returns
    (``[of | vc]`` f32 ``[B * nch, 1664]``, new over, prev_type,
    prev_win_switch, num_prev)."""
    B = over.shape[0]
    n_blocks_long, n_blocks_total, cws, block_type, mixed = ip.unbind(-1)
    out, new_prev, n_out = imdct_tail(
        yx, over[:, :nch].reshape(B * nch, 32, 9), block_type, mixed,
        prev_type[:, :nch].reshape(-1), prev_win_switch[:, :nch].reshape(-1),
        num_prev[:, :nch].reshape(-1), n_blocks_long, n_blocks_total, cws, px)
    over, prev_type = over.clone(), prev_type.clone()
    prev_win_switch, num_prev = prev_win_switch.clone(), num_prev.clone()
    over[:, :nch] = new_prev.reshape(B, nch, 288)
    prev_type[:, :nch] = block_type.reshape(B, nch)
    prev_win_switch[:, :nch] = cws.reshape(B, nch)
    num_prev[:, :nch] = n_out.reshape(B, nch)
    ofvc = torch.cat([out.reshape(B * nch, N_OUT), _fifo_blocks(vbuf, nch)], dim=-1)
    return ofvc, over, prev_type, prev_win_switch, num_prev


def mxu_prelude(huff_gs, side_gs, *, ver: int, sr_idx: int, nch: int, cutoff: int):
    """The stateless part of a run, once for all its granules: the
    dequantizer, the block counts and the x-side product. Returns (yx f32
    ``[G, B * nch, 32, 108]``, ip int32 ``[G, B * nch, 5]``: the step
    kernel's n_blocks_long, n_blocks_total, curr_win_switch, block_type,
    mixed)."""
    from ..models.mp3 import expand_hp_device, format_maps
    from ..models.mp3_pipeline import _widen16

    G, B = huff_gs.shape[:2]
    flat = side_gs.reshape(G * B, -1)
    hp = expand_hp_device(flat[:, 3 * nch:], format_maps(ver, sr_idx), nch)
    dq = mp3fast.dequantize_granule_fast(_widen16(huff_gs.reshape(G * B, nch, 576)),
                                         flat[:, :nch], hp, nch=nch)
    nzb = dq["nzb"][:, :nch].reshape(-1)
    block_type = flat[:, nch:2 * nch].reshape(-1)
    mixed = flat[:, 2 * nch:3 * nch].reshape(-1)
    n_blocks_long, nbfly, n_blocks_total, _, cws = mp3fast.block_counts(
        nzb, block_type, mixed, torch.full_like(nzb, cutoff))
    ip = torch.stack([n_blocks_long, n_blocks_total, cws, block_type, mixed],
                     dim=-1).reshape(G, B * nch, 5).contiguous()
    yx = imdct_x_side(dq["x"][:, :nch].reshape(G * B * nch, 576), nbfly,
                      device_operators(huff_gs.device)["AX"])
    return yx.reshape(G, B * nch, NBANDS, MXU_AX_COLS), ip


def mxu_steps(yx, ip, state, vindex: int, pcm, *, nch: int):
    """The granule steps of a run, in place on ``state`` (over, prev_type,
    prev_win_switch, num_prev, vbuf; f32 over and vbuf): per granule g the
    step kernels around the two GEMMs at phase ``(vindex - 9 g) & 7``, the
    PCM into ``pcm[:, g]`` (int16 ``[B, G, 576 * nch]``)."""
    ops = device_operators(yx.device)
    over, prev_type, prev_win_switch, num_prev, vbuf = state
    rows = yx.shape[1]
    acc = torch.empty((rows, N_OUT), dtype=F32, device=yx.device)
    newv = torch.empty((rows, N_V), dtype=F32, device=yx.device)
    v = int(vindex) & 7
    with _fp32_matmul():
        for g in range(yx.shape[0]):
            ofvc = mp3_mxu_pre_cuda(yx[g], ip[g], over, prev_type, prev_win_switch, num_prev,
                                    vbuf, ops["PX"], nch=nch)
            torch.matmul(ofvc, ops["S"][v], out=acc)
            torch.matmul(ofvc[:, :N_OUT], ops["W"][v], out=newv)
            mp3_mxu_post_cuda(acc, newv, vbuf, ops["keep"][v], pcm[:, g], nch=nch)
            v = (v - 9) & 7


def mxu_run(huff_gs, side_gs, over, prev_type, prev_win_switch, num_prev, vbuf, vindex: int,
            *, ver: int, sr_idx: int, nch: int, cutoff: int):
    """Every granule of a run of the MXU tier for B streams of one format
    (:func:`mxu_prelude`, then :func:`mxu_steps`): the operands and results
    of ``mp3_kernels.mp3_granules_f32_cuda`` (pcm int16 ``[G, B, 576 *
    nch]``, the new state with f32 ``over`` and ``vbuf``, ref_undef all
    False). The inputs are not changed."""
    G, B = huff_gs.shape[:2]
    dev = huff_gs.device
    state = tuple(t.clone() for t in (over.to(F32), prev_type, prev_win_switch, num_prev,
                                      vbuf.to(F32)))
    pcm = torch.empty((B, G, 576 * nch), dtype=torch.int16, device=dev)
    if G and B:
        with torch.no_grad(), _fp32_matmul():
            yx, ip = mxu_prelude(huff_gs, side_gs, ver=ver, sr_idx=sr_idx, nch=nch,
                                 cutoff=cutoff)
            mxu_steps(yx, ip, state, vindex, pcm, nch=nch)
    return pcm.transpose(0, 1), state, torch.zeros(B, dtype=torch.bool, device=dev)
