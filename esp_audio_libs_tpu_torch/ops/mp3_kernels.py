"""Wrappers of the hand-written CUDA MP3 kernels, their plain PyTorch
versions and their launch counts.

``mp3_granules_cuda`` (csrc/mp3_granules.cu) replaces the JAX package's
whole-run granule scan, ``_granules_scan_for`` with its body
``_granule_body`` (esp_audio_libs_tpu/models/mp3_pipeline.py:90-265): an
XLA ``lax.scan``, not a Pallas kernel. Eager PyTorch would run it as a few
hundred launches per granule, so on the card it is one kernel: every granule
of a run, for B streams of one format, in one launch, the carried state
(overlap, block types, IMDCT block counts, the subband FIFO) never leaving
the card between granules. Its plain version is :func:`mp3_granules_plain`,
a loop of ``models.mp3_pipeline._granule_body`` over the granules.

The relaxed tiers (``fast=``) have their own kernels:

- ``mp3_granules_f32_cuda`` (csrc/mp3_granules_f32.cu) replaces
  ``_granules_scan_fast_for`` (mp3_pipeline.py:271, body :137), the f32
  value mirror of the exact tier, with the same operands, launch shape and
  state layout (``over`` and ``vbuf`` in f32); plain version
  :func:`mp3_granules_f32_plain`, a loop of ``_granule_body_fast``.
- ``mp3_mxu_pre_cuda`` and ``mp3_mxu_post_cuda`` (csrc/mp3_mxu_step.cu) are
  the two kernels of one granule step of ``_granules_scan_mxu_for``
  (mp3_pipeline.py:315, body :174) around its two FP32 GEMMs
  (ops/mp3mxu.py ``mxu_run``); plain versions ``mp3mxu.mxu_pre_plain`` and
  ``mp3mxu.mxu_post_plain``. They work in place on the carried state.

A wrapper given CPU tensors runs the plain version. Given CUDA tensors it
launches the kernel on the current stream or raises; there is no fallback.
Any other device raises. Each wrapper's ``launches`` counts kernel launches
only.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..runtime import kernels
from ..runtime.tables import mp3_tables
from .polyphase_kernels import _raise_on, _route

__all__ = ["CONST_LAYOUT", "format_consts", "mp3_granules_cuda", "mp3_granules_f32_cuda",
           "mp3_granules_f32_plain", "mp3_granules_plain", "mp3_mxu_post_cuda",
           "mp3_mxu_pre_cuda", "reset_launch_counts"]

GPC_SIZE = 235   # models.mp3._GPC_SIZE: the compact parameter blob's words

# The kernel's per-format constants: one int32 buffer, these blocks in this
# order (csrc/mp3_granules.cu reads them at the same offsets). The first six
# are format_maps(ver, sr_idx); the rest are mp3_tables(), flattened.
CONST_LAYOUT = (("long_band", 576), ("band_out_l", 576), ("band_out_s", 576),
                ("win_out", 576), ("sfb_l", 23), ("sfb_s", 14), ("pow14", 4),
                ("pow43_14", 64), ("pow43", 48), ("poly43lo", 5), ("poly43hi", 5),
                ("pow2exp", 8), ("pow2frac", 8), ("csa", 16), ("imdctWin", 144),
                ("fastWin36", 18), ("c18", 9), ("c9", 5), ("dcttab", 48), ("polyCoef", 264),
                ("ISFMpeg1", 14), ("ISFMpeg2", 64), ("ISFIIP", 4))


# the sample maps csrc/mp3_granules.cu packs into one word per sample, a byte each
_BYTE_MAPS = ("long_band", "band_out_l", "band_out_s", "win_out")


@functools.lru_cache(None)
def _consts_np(ver: int, sr_idx: int) -> np.ndarray:
    from ..models.mp3 import format_maps
    maps, T = format_maps(ver, sr_idx), mp3_tables()
    T = dict(T, c9=np.array([T[f"c9_{i}"] for i in range(5)]))
    parts = []
    for name, n in CONST_LAYOUT:
        a = np.asarray(maps[name] if name in maps else T[name], np.int32).reshape(-1)
        if a.size != n:
            raise AssertionError(f"{name}: {a.size} words, the layout says {n}")
        if name in _BYTE_MAPS and (a.min() < -128 or a.max() > 127):
            raise AssertionError(f"{name}: the kernel keeps it as signed bytes")
        parts.append(a)
    return np.concatenate(parts)


@functools.lru_cache(None)
def format_consts(ver: int, sr_idx: int, device: torch.device) -> torch.Tensor:
    """The kernel's constants of one format on ``device`` (built and
    uploaded once), after checking that csrc/mp3_granules.cu reads the
    layout ``CONST_LAYOUT`` describes."""
    sizes = np.zeros(64, np.int32)
    n = kernels.library().eal_mp3_consts_layout(sizes.ctypes.data)
    if tuple(sizes[:n]) != tuple(size for _, size in CONST_LAYOUT):
        raise RuntimeError("csrc/mp3_granules.cu reads another constants layout than "
                           "CONST_LAYOUT")
    return torch.as_tensor(_consts_np(ver, sr_idx), device=device)


def mp3_granules_plain(huff_gs, side_gs, over, prev_type, prev_win_switch, num_prev, vbuf,
                       vindex: int, *, ver: int, sr_idx: int, nch: int, cutoff: int):
    """Plain version of the kernel: ``models.mp3_pipeline._granule_body``
    over the G granules in turn. Arguments and results as
    :func:`mp3_granules_cuda`."""
    from ..models.mp3 import format_maps
    from ..models.mp3_pipeline import _granule_body

    maps = format_maps(ver, sr_idx)
    G, B = huff_gs.shape[:2]
    ref_undef = torch.zeros(B, dtype=torch.bool, device=huff_gs.device)
    state = (over, prev_type, prev_win_switch, num_prev, vbuf)
    pcm = []
    for g in range(G):
        side = side_gs[g]
        p, *state, vindex, ref_undef = _granule_body(
            huff_gs[g], side[:, :nch], side[:, 3 * nch:], maps, *state[:5],
            side[:, nch:2 * nch].reshape(-1), side[:, 2 * nch:3 * nch].reshape(-1), vindex,
            ref_undef, nch=nch, cutoff=cutoff)
        pcm.append(p)
    return torch.stack(pcm), tuple(state), ref_undef


def _check(name: str, t: torch.Tensor, dtype, shape: tuple) -> None:
    if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous {dtype} {list(shape)}, got "
                         f"{t.dtype} {list(t.shape)}")


def _check_state(over, prev_type, prev_win_switch, num_prev, vbuf, B: int, num_dtype) -> None:
    _check("over", over, num_dtype, (B, 2, 288))
    for name, t in (("prev_type", prev_type), ("prev_win_switch", prev_win_switch),
                    ("num_prev", num_prev)):
        _check(name, t, torch.int32, (B, 2))
    _check("vbuf", vbuf, num_dtype, (B, 2176))


def mp3_granules_cuda(huff_gs, side_gs, over, prev_type, prev_win_switch, num_prev, vbuf,
                      vindex: int, *, ver: int, sr_idx: int, nch: int, cutoff: int):
    """Every granule of a run for B streams of one format, in one launch.

    Args:
      huff_gs: int16 ``[G, B, nch, 576]`` spectra, sign in bit 15
        (``models.mp3_pipeline._pack_huff16``).
      side_gs: int32 ``[G, B, 3 * nch + 235]``: nzb | block_type | mixed |
        the compact parameter blob, per granule.
      over ``[B, 2, 288]``, prev_type / prev_win_switch / num_prev
        ``[B, 2]``, vbuf ``[B, 2176]``: the carried state, int32.
      vindex: the FIFO phase (0..7) shared by the B streams.
      ver, sr_idx, nch: the format; cutoff: ``sfBandLong[8 or 6] // 18``.

    Returns (pcm int16 ``[G, B, 576 * nch]``, the new state as a tuple in
    the order of the arguments, ref_undef bool ``[B]``). The inputs are not
    changed.
    """
    if _route(huff_gs, side_gs, over, prev_type, prev_win_switch, num_prev, vbuf) == "cpu":
        return mp3_granules_plain(huff_gs, side_gs, over, prev_type, prev_win_switch, num_prev,
                                  vbuf, vindex, ver=ver, sr_idx=sr_idx, nch=nch, cutoff=cutoff)
    if huff_gs.dim() != 4:
        raise ValueError(f"huff_gs must be [G, B, nch, 576], got {list(huff_gs.shape)}")
    G, B = huff_gs.shape[:2]
    if nch not in (1, 2):
        raise ValueError(f"nch={nch}: MP3 has 1 or 2 channels")
    _check("huff_gs", huff_gs, torch.int16, (G, B, nch, 576))
    _check("side_gs", side_gs, torch.int32, (G, B, 3 * nch + GPC_SIZE))
    _check_state(over, prev_type, prev_win_switch, num_prev, vbuf, B, torch.int32)
    state = tuple(t.clone() for t in (over, prev_type, prev_win_switch, num_prev, vbuf))
    pcm = torch.empty((B, G, 576 * nch), dtype=torch.int16, device=huff_gs.device)
    undef = torch.zeros(B, dtype=torch.int32, device=huff_gs.device)
    if G and B:
        consts = format_consts(ver, sr_idx, huff_gs.device)
        with kernels.launch_on(huff_gs.device) as lib:
            rc = lib.eal_mp3_granules(
                huff_gs.data_ptr(), side_gs.data_ptr(), consts.data_ptr(),
                *(t.data_ptr() for t in state), pcm.data_ptr(), undef.data_ptr(), G, B, nch,
                int(vindex) & 7, int(cutoff),
                torch.cuda.current_stream(huff_gs.device).cuda_stream)
        _raise_on(rc, "mp3_granules")
        mp3_granules_cuda.launches += 1
    return pcm.transpose(0, 1), state, undef != 0


mp3_granules_cuda.launches = 0


# ------------------------------------------------------------ the mirror tier

def mp3_granules_f32_plain(huff_gs, side_gs, over, prev_type, prev_win_switch, num_prev, vbuf,
                           vindex: int, *, ver: int, sr_idx: int, nch: int, cutoff: int):
    """Plain version of the f32 kernel: ``models.mp3_pipeline.
    _granule_body_fast`` over the G granules in turn. Arguments and results
    as :func:`mp3_granules_f32_cuda`."""
    from ..models.mp3 import format_maps
    from ..models.mp3_pipeline import _granule_body_fast

    maps = format_maps(ver, sr_idx)
    state = (over, prev_type, prev_win_switch, num_prev, vbuf)
    pcm = []
    for g in range(huff_gs.shape[0]):
        side = side_gs[g]
        p, *state, vindex = _granule_body_fast(
            huff_gs[g], side[:, :nch], side[:, 3 * nch:], maps, *state[:5],
            side[:, nch:2 * nch].reshape(-1), side[:, 2 * nch:3 * nch].reshape(-1), vindex,
            nch=nch, cutoff=cutoff)
        pcm.append(p)
    return (torch.stack(pcm), tuple(state),
            torch.zeros(huff_gs.shape[1], dtype=torch.bool, device=huff_gs.device))


def mp3_granules_f32_cuda(huff_gs, side_gs, over, prev_type, prev_win_switch, num_prev, vbuf,
                          vindex: int, *, ver: int, sr_idx: int, nch: int, cutoff: int):
    """Every granule of a run of the mirror tier, for B streams of one
    format, in one launch: the operands of :func:`mp3_granules_cuda`, with
    ``over`` and ``vbuf`` f32. Returns (pcm int16 ``[G, B, 576 * nch]``, the
    new state, ref_undef all False ``[B]``). The inputs are not changed."""
    if _route(huff_gs, side_gs, over, prev_type, prev_win_switch, num_prev, vbuf) == "cpu":
        return mp3_granules_f32_plain(huff_gs, side_gs, over, prev_type, prev_win_switch,
                                      num_prev, vbuf, vindex, ver=ver, sr_idx=sr_idx, nch=nch,
                                      cutoff=cutoff)
    if huff_gs.dim() != 4:
        raise ValueError(f"huff_gs must be [G, B, nch, 576], got {list(huff_gs.shape)}")
    G, B = huff_gs.shape[:2]
    if nch not in (1, 2):
        raise ValueError(f"nch={nch}: MP3 has 1 or 2 channels")
    _check("huff_gs", huff_gs, torch.int16, (G, B, nch, 576))
    _check("side_gs", side_gs, torch.int32, (G, B, 3 * nch + GPC_SIZE))
    _check_state(over, prev_type, prev_win_switch, num_prev, vbuf, B, torch.float32)
    state = tuple(t.clone() for t in (over, prev_type, prev_win_switch, num_prev, vbuf))
    pcm = torch.empty((B, G, 576 * nch), dtype=torch.int16, device=huff_gs.device)
    if G and B:
        consts = format_consts(ver, sr_idx, huff_gs.device)
        with kernels.launch_on(huff_gs.device) as lib:
            rc = lib.eal_mp3_granules_f32(
                huff_gs.data_ptr(), side_gs.data_ptr(), consts.data_ptr(),
                *(t.data_ptr() for t in state), pcm.data_ptr(), G, B, nch, int(vindex) & 7,
                int(cutoff), torch.cuda.current_stream(huff_gs.device).cuda_stream)
        _raise_on(rc, "mp3_granules_f32")
        mp3_granules_f32_cuda.launches += 1
    return (pcm.transpose(0, 1), state,
            torch.zeros(B, dtype=torch.bool, device=huff_gs.device))


mp3_granules_f32_cuda.launches = 0


# ------------------------------------------------------------ the MXU tier

MXU_AX_COLS = 4 * 18 + 18 + 9 + 9   # ops/mp3mxu.py AX: A36 x 4 windows | A12 | C36 | C12
MXU_IN = 576 + 34 * 32              # one GEMM row: of (576) | the channel's FIFO block (1088)


def mp3_mxu_pre_cuda(yx, ip, over, prev_type, prev_win_switch, num_prev, vbuf, px, *,
                     nch: int):
    """The first kernel of an MXU granule step, for B streams.

    Args:
      yx: f32 ``[B * nch, 32, 108]``, the granule's x-side IMDCT products
        (``mp3mxu.imdct_x_side``).
      ip: int32 ``[B * nch, 5]``, the granule's IMDCT parameters per stream
        and channel: n_blocks_long, n_blocks_total, curr_win_switch,
        block_type, mixed (``mp3fast.block_counts``).
      over ``[B, 2, 288]`` f32, prev_type / prev_win_switch / num_prev
        ``[B, 2]`` int32: the carried IMDCT state, updated in place.
      vbuf: f32 ``[B, 2176]``, the FIFO (read only).
      px: f32 ``[9, 72]``, the probed overlap operator.

    Returns ``[of | vc]`` f32 ``[B * nch, 1664]``: the IMDCT output of the
    granule (column ``t * 32 + band``), then the channel's FIFO block
    (column ``576 + row * 32 + slot``), the left operand of both GEMMs.
    """
    if _route(yx, ip, over, prev_type, prev_win_switch, num_prev, vbuf, px) == "cpu":
        from .mp3mxu import mxu_pre_plain
        ofvc, *new = mxu_pre_plain(yx, ip, over, prev_type, prev_win_switch, num_prev, vbuf,
                                   px, nch=nch)
        for t, n in zip((over, prev_type, prev_win_switch, num_prev), new):
            t.copy_(n)
        return ofvc
    B = over.shape[0]
    if nch not in (1, 2):
        raise ValueError(f"nch={nch}: MP3 has 1 or 2 channels")
    _check("yx", yx, torch.float32, (B * nch, 32, MXU_AX_COLS))
    _check("ip", ip, torch.int32, (B * nch, 5))
    _check_state(over, prev_type, prev_win_switch, num_prev, vbuf, B, torch.float32)
    _check("px", px, torch.float32, (9, 72))
    ofvc = torch.empty((B * nch, MXU_IN), dtype=torch.float32, device=yx.device)
    if B:
        with kernels.launch_on(yx.device) as lib:
            rc = lib.eal_mp3_mxu_pre(
                yx.data_ptr(), ip.data_ptr(), over.data_ptr(), prev_type.data_ptr(),
                prev_win_switch.data_ptr(), num_prev.data_ptr(), vbuf.data_ptr(), px.data_ptr(),
                ofvc.data_ptr(), B, nch, torch.cuda.current_stream(yx.device).cuda_stream)
        _raise_on(rc, "mp3_mxu_pre")
        mp3_mxu_pre_cuda.launches += 1
    return ofvc


mp3_mxu_pre_cuda.launches = 0


def mp3_mxu_post_cuda(acc, newv, vbuf, keep, out, *, nch: int):
    """The second kernel of an MXU granule step, for B streams.

    Args:
      acc: f32 ``[B * nch, 576]``, the PQMF accumulators in PCM units
        (``[of | vc] @ S[v]``).
      newv: f32 ``[B * nch, 1088]``, the FIFO slots the granule writes
        (``of @ W[v]``).
      vbuf: f32 ``[B, 2176]``, the FIFO, updated in place: slot ``e`` of
        channel ``ch`` keeps its value where ``keep[e] == 1``, else takes
        ``newv``.
      keep: f32 ``[1088]``, the phase's 0/1 survivor mask.
      out: int16 ``[B, 576 * nch]`` (rows may be strided), gets the PCM:
        ``floor(acc + 0.5)`` clipped to int16, channels interleaved.

    The kernel moves ``acc``, ``newv``, ``vbuf`` and ``keep`` in 16-byte
    words and stores the PCM in ``8 * nch``-byte words: it refuses (a
    RuntimeError here) operands off 16 bytes, or an ``out`` whose base or
    row pitch in bytes is not a multiple of ``8 * nch``. ``mxu_steps``'
    ``pcm[:, g]`` always qualifies.
    """
    if _route(acc, newv, vbuf, keep, out) == "cpu":
        from .mp3mxu import mxu_post_plain
        pcm, new_vbuf = mxu_post_plain(acc, newv, vbuf, keep, nch=nch)
        out.copy_(pcm)
        vbuf.copy_(new_vbuf)
        return
    B = vbuf.shape[0]
    if nch not in (1, 2):
        raise ValueError(f"nch={nch}: MP3 has 1 or 2 channels")
    _check("acc", acc, torch.float32, (B * nch, 576))
    _check("newv", newv, torch.float32, (B * nch, 34 * 32))
    _check("vbuf", vbuf, torch.float32, (B, 2176))
    _check("keep", keep, torch.float32, (34 * 32,))
    if out.dtype != torch.int16 or tuple(out.shape) != (B, 576 * nch) or out.stride(1) != 1:
        raise ValueError(f"out must be int16 [{B}, {576 * nch}] with unit column stride, got "
                         f"{out.dtype} {list(out.shape)} strides {out.stride()}")
    if B:
        with kernels.launch_on(acc.device) as lib:
            rc = lib.eal_mp3_mxu_post(acc.data_ptr(), newv.data_ptr(), vbuf.data_ptr(),
                                      keep.data_ptr(), out.data_ptr(), out.stride(0), B, nch,
                                      torch.cuda.current_stream(acc.device).cuda_stream)
        _raise_on(rc, "mp3_mxu_post")
        mp3_mxu_post_cuda.launches += 1


mp3_mxu_post_cuda.launches = 0

_COUNTED = (mp3_granules_cuda, mp3_granules_f32_cuda, mp3_mxu_pre_cuda, mp3_mxu_post_cuda)


def reset_launch_counts() -> None:
    for fn in _COUNTED:
        fn.launches = 0
