"""MP3 device pipeline of the port: dequant -> IMDCT -> subband per granule,
the counterpart of the exact tier of esp_audio_libs_tpu/models/mp3_pipeline.py.

``MP3Decoder.decode`` (the Helix ``MP3Decode`` equivalent, reference
src/decode/mp3_decoder.cpp:8807-8854) and ``BatchedMP3Decoder`` land here:
streams ride as lanes, every stage is int32/int64 fixed point, byte-exact
against the JAX package. A run of G granules for B streams of one format is
one upload of the stacked spectra and side parameters and one launch of the
hand-written kernel ``ops.mp3_kernels.mp3_granules_cuda``
(csrc/mp3_granules.cu), which carries the overlap, block-type and FIFO state
from granule to granule on the card. On CPU tensors the same call runs its
plain version, a loop of :func:`_granule_body` over the granules.

With a stream ``mesh`` of more than one device (parallel/mesh.py) a run's
streams split into contiguous blocks, one per device: the spectra and side
rows are cut along their stream axis (axis 1 of ``[G, B, ...]``), each
block gets its own escape sideband with block-local positions
(:func:`_pack_huff8_sharded`), the carried state stays split, and the
granule kernel launches once per shard.

The relaxed-precision tiers (``fast=``) run the same runs on other
arithmetic, within 1 LSB of this tier on decodable streams: ``"mirror"``
(:func:`_granule_body_fast`, ops/mp3fast.py: every value of the exact tier
mirrored in f32) in one launch of ``ops.mp3_kernels.mp3_granules_f32_cuda``
(csrc/mp3_granules_f32.cu) a run, and ``"mxu"`` (``True``;
ops/mp3mxu.py: the IMDCT and the subband synthesis as probed linear
operators) as ``ops.mp3mxu.mxu_run``: the
dequantizer and the x-side IMDCT product once for the whole run, then per
granule two step kernels (csrc/mp3_mxu_step.cu) around two FP32 GEMMs.
Their carried overlap and FIFO are f32; the rest of the state is the exact
tier's, and no tier tracks the reference's undefined case but the exact one.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import mp3dsp, mp3fast, mp3imdct, mp3subband
from ..ops.mp3_kernels import mp3_granules_cuda, mp3_granules_f32_cuda
from ..parallel.mesh import Sharded, is_split, shard_streams, shard_streams_axis
from ..runtime import transport
from ..runtime.tables import mp3_tables
from ..runtime.trace import span
from .flac import _put, _to_host
from .mp3 import expand_hp_device, granule_params_compact_blob

__all__ = ["decode_granules", "decode_granules_batch", "decode_granules_batch_dev",
           "decode_granules_run", "run_operands"]

INT_MIN = -(2 ** 31)

# escape-density ceiling for the int8 + sideband spectral transport tier
# (runtime/transport.py); tests force it to 0.0 / 1.0
ESC_MAX_DENSITY = transport.ESC_MAX_DENSITY


def _pack_huff16(huff_np: np.ndarray) -> np.ndarray:
    """Pack sign-in-MSB int32 spectral magnitudes to int16 for transport.

    Lossless: a Layer III magnitude is at most 15 + (2^13 - 1) = 8206 (the
    largest linbits field is 13, ISO/IEC 11172-3 Table B.7), so it fits 15
    bits and the sign moves from bit 31 to bit 15. The granule body widens
    it back.
    """
    h = huff_np.astype(np.int32, copy=False)
    return (((h & 0x7FFF) | ((h >> 16) & 0x8000)).astype(np.uint16)).view(np.int16)


def _pack_huff8_sharded(huff16: np.ndarray, n_shards: int):
    """Narrow a stacked int16-packed spectral plane ``[G, B, ...]`` (see
    ``_pack_huff16``) to int8 plus sparse escape sidebands, if the escapes
    are rare enough.

    The sign moves from bit 15 to bit 7; magnitudes above 127 ship as
    (position, packed int16 value) pairs that :func:`_esc_fixup_flat` puts
    back on the device. The stream axis (axis 1) splits into ``n_shards``
    contiguous blocks, one per launch, and each block gets its own sideband
    row with positions local to the block, in the block's granule-major
    flat order, so that each launch's fixup touches its own block only (one
    block: the plane's flat positions). Returns ``(plane8, pos [S, cap],
    val [S, cap])``, or ``None`` when the escape density exceeds
    ``ESC_MAX_DENSITY``."""
    G, B = huff16.shape[:2]
    u = huff16.view(np.uint16)
    mag = u & 0x7FFF
    esc = mag > 127
    if int(np.count_nonzero(esc)) > ESC_MAX_DENSITY * huff16.size:
        return None
    plane8 = ((mag & 0x7F) | ((u >> 8) & 0x80)).astype(np.uint8).view(np.int8)
    blk = (B // n_shards) * int(np.prod(huff16.shape[2:]))
    mask2 = esc.reshape(G, n_shards, blk).swapaxes(0, 1).reshape(n_shards, -1)
    vals2 = huff16.reshape(G, n_shards, blk).swapaxes(0, 1).reshape(n_shards, -1)
    pos, val = transport.escape_sideband_blocked(mask2, vals2, np.int16)
    return plane8, pos, val


def _pack_huff8(huff16: np.ndarray):
    """:func:`_pack_huff8_sharded` of one block: ``(plane8, esc_pos [cap],
    esc_val [cap])`` with flat positions, or ``None``."""
    narrowed = _pack_huff8_sharded(huff16, 1)
    return None if narrowed is None else (narrowed[0], narrowed[1][0], narrowed[2][0])


def _widen16(huff_g):
    """The int16-packed spectra (sign in bit 15) -> sign-in-MSB int32."""
    v = huff_g.to(torch.int32)            # sign-extends the bit-15 flag
    mag = v & 0x7FFF
    return torch.where(v < 0, mag | INT_MIN, mag)


def _granule_body(huff_g, nzb_in, compact, maps, over, prev_type, prev_win_switch, num_prev,
                  vbuf, block_type, mixed, vindex, ref_undef, *, nch, cutoff):
    """One granule for B streams, plain PyTorch: the body of the whole-run
    scan that csrc/mp3_granules.cu runs on the card.

    Args (B streams): huff_g int16 ``[B, nch, 576]`` packed as
    ``_pack_huff16``; nzb_in ``[B, nch]``; compact ``[B, _GPC_SIZE]``; maps
    the format's ``format_maps``; the carried state over ``[B, 2, 288]``,
    prev_type/prev_win_switch/num_prev ``[B, 2]``, vbuf ``[B, 2176]``;
    block_type/mixed ``[B * nch]``; vindex the FIFO phase (an int);
    ref_undef bool ``[B]``.

    ``ref_undef`` accumulates the reference's undefined case: gb == 31
    means the guard-bit mask was zero and the reference computes CLZ(0),
    whose garbage rescales new samples and the carried overlap unless all of
    them are zero. Returns (pcm int16 ``[B, 576 * nch]``, over, prev_type,
    prev_win_switch, num_prev, vbuf, vindex, ref_undef).
    """
    B = huff_g.shape[0]
    hp = expand_hp_device(compact, maps, nch)
    dq = mp3dsp.dequantize_granule(_widen16(huff_g), nzb_in, hp, nch=nch)
    x = dq["x"].reshape(B * nch, 576)
    gb_in = dq["gb"][:, :nch]
    undef = (gb_in == 31) & ((dq["x"][:, :nch] != 0).any(-1) | (over[:, :nch] != 0).any(-1))
    ref_undef = ref_undef | undef.any(-1)

    out, new_over, _, gb_out, n_out, cws = mp3imdct.imdct_granule(
        x, over[:, :nch].reshape(B * nch, 32, 9), dq["nzb"][:, :nch].reshape(-1),
        gb_in.reshape(-1), block_type, mixed, prev_type[:, :nch].reshape(-1),
        prev_win_switch[:, :nch].reshape(-1), torch.full_like(block_type, cutoff),
        num_prev[:, :nch].reshape(-1))

    over, prev_type = over.clone(), prev_type.clone()
    prev_win_switch, num_prev = prev_win_switch.clone(), num_prev.clone()
    over[:, :nch] = new_over.reshape(B, nch, 288)
    prev_type[:, :nch] = block_type.reshape(B, nch)
    prev_win_switch[:, :nch] = cws.reshape(B, nch)
    num_prev[:, :nch] = n_out.reshape(B, nch)

    pcm, vbuf = mp3subband.subband_granule(out.reshape(B, nch, 18, 32), gb_out.reshape(B, nch),
                                           vbuf, vindex, nch=nch)
    vindex = (vindex - 9) & 7   # 9 odd steps per granule advance the phase
    return pcm, over, prev_type, prev_win_switch, num_prev, vbuf, vindex, ref_undef


def _granule_body_fast(huff_g, nzb_in, compact, maps, over, prev_type, prev_win_switch,
                       num_prev, vbuf, block_type, mixed, vindex, *, nch, cutoff):
    """One granule of the mirror tier for B streams, plain PyTorch: the body
    of the whole-run loop that csrc/mp3_granules_f32.cu runs on the card.

    Arguments as :func:`_granule_body` without ``ref_undef`` (the tier has
    no guard bits to track), with ``over`` and ``vbuf`` f32. Returns (pcm
    int16 ``[B, 576 * nch]``, over, prev_type, prev_win_switch, num_prev,
    vbuf, vindex).
    """
    B = huff_g.shape[0]
    hp = expand_hp_device(compact, maps, nch)
    dq = mp3fast.dequantize_granule_fast(_widen16(huff_g), nzb_in, hp, nch=nch)
    out, new_over, _, n_out, cws = mp3fast.imdct_granule_fast(
        dq["x"].reshape(B * nch, 576), over[:, :nch].reshape(B * nch, 32, 9),
        dq["nzb"][:, :nch].reshape(-1), block_type, mixed, prev_type[:, :nch].reshape(-1),
        prev_win_switch[:, :nch].reshape(-1), torch.full_like(block_type, cutoff),
        num_prev[:, :nch].reshape(-1))

    over, prev_type = over.clone(), prev_type.clone()
    prev_win_switch, num_prev = prev_win_switch.clone(), num_prev.clone()
    over[:, :nch] = new_over.reshape(B, nch, 288)
    prev_type[:, :nch] = block_type.reshape(B, nch)
    prev_win_switch[:, :nch] = cws.reshape(B, nch)
    num_prev[:, :nch] = n_out.reshape(B, nch)

    pcm, vbuf = mp3fast.subband_granule_fast(out.reshape(B, nch, 18, 32), vbuf, vindex, nch=nch)
    return pcm, over, prev_type, prev_win_switch, num_prev, vbuf, (vindex - 9) & 7


def _granules_scan_for(ver: int, sr_idx: int, nch: int, cutoff: int):
    """The whole-run scan of one format: ``scan_fn(huff_gs, side_gs, over,
    prev_type, prev_win_switch, num_prev, vbuf, vindex0)``.

    ``huff_gs`` int16 ``[G, B, nch, 576]`` (``_pack_huff16``); ``side_gs``
    int32 ``[G, B, 3 * nch + _GPC_SIZE]`` packs nzb | block_type | mixed |
    compact blob per granule. Returns (pcm int16 ``[G, B, 576 * nch]``,
    new state, ref_undef bool ``[B]``). On the card: one launch of
    ``mp3_granules_cuda``; on the CPU: its plain version.
    """
    def scan_fn(huff_gs, side_gs, over, prev_type, prev_win_switch, num_prev, vbuf, vindex0):
        return mp3_granules_cuda(huff_gs, side_gs, over, prev_type, prev_win_switch, num_prev,
                                 vbuf, int(vindex0), ver=ver, sr_idx=sr_idx, nch=nch,
                                 cutoff=cutoff)
    return scan_fn


def _granules_scan_fast_for(ver: int, sr_idx: int, nch: int, cutoff: int):
    """The mirror tier's counterpart of :func:`_granules_scan_for`: the
    same operands and results, ``over`` and ``vbuf`` carried in f32 (an
    int32 state is cast by value), ref_undef all False. On the card: one
    launch of ``mp3_granules_f32_cuda``; on the CPU: its plain version, a
    loop of :func:`_granule_body_fast`."""
    def scan_fn(huff_gs, side_gs, over, prev_type, prev_win_switch, num_prev, vbuf, vindex0):
        return mp3_granules_f32_cuda(huff_gs, side_gs, over.to(torch.float32), prev_type,
                                     prev_win_switch, num_prev, vbuf.to(torch.float32),
                                     int(vindex0), ver=ver, sr_idx=sr_idx, nch=nch,
                                     cutoff=cutoff)
    return scan_fn


def _granules_scan_mxu_for(ver: int, sr_idx: int, nch: int, cutoff: int):
    """The MXU tier's counterpart of :func:`_granules_scan_for`
    (``ops.mp3mxu.mxu_run``): the same operands and results as
    :func:`_granules_scan_fast_for`. The probed operators are built (or
    loaded from their cache) here, at the first run."""
    from ..ops import mp3mxu

    def scan_fn(huff_gs, side_gs, over, prev_type, prev_win_switch, num_prev, vbuf, vindex0):
        return mp3mxu.mxu_run(huff_gs, side_gs, over.to(torch.float32), prev_type,
                              prev_win_switch, num_prev, vbuf.to(torch.float32), int(vindex0),
                              ver=ver, sr_idx=sr_idx, nch=nch, cutoff=cutoff)
    return scan_fn


def _tier(fast) -> str:
    """The ``fast`` tier selector: False or None -> ``"exact"`` (the integer
    pipeline), ``"mirror"`` -> the f32 value mirror (ops/mp3fast.py), True
    or ``"mxu"`` -> the probed-operator form (ops/mp3mxu.py). A tier's own
    name selects it too."""
    if fast is False or fast is None or fast == "exact":
        return "exact"
    if fast == "mirror":
        return "mirror"
    if fast is True or fast == "mxu":
        return "mxu"
    raise ValueError(f"fast={fast!r}: expected False, True, 'mirror' or 'mxu'")


def _scan_builder(tier: str):
    return {"exact": _granules_scan_for, "mirror": _granules_scan_fast_for,
            "mxu": _granules_scan_mxu_for}[tier]


def _widen_esc16(huff8_gs):
    """int8 spectral plane (sign in bit 7) -> the int16-packed form the scan
    consumes (sign in bit 15, 7-bit magnitude)."""
    v8 = huff8_gs.to(torch.int16)          # sign-extends bit 7
    mag = v8 & 0x7F
    return torch.where(v8 < 0, mag | -(2 ** 15), mag)


def _esc_fixup_flat(h16, esc_pos, esc_val):
    """Flat-index escape scatter; positions past the plane (the sideband's
    padding) land in one spare slot that is dropped, so nothing syncs."""
    n = h16.numel()
    flat = torch.cat([h16.reshape(-1), h16.new_zeros(1)])
    flat[esc_pos.to(torch.int64).clamp(0, n)] = esc_val.to(flat.dtype)
    return flat[:n].reshape(h16.shape)


def _granules_scan_esc_for(ver: int, sr_idx: int, nch: int, cutoff: int, fast=False):
    """Escape-sideband form of the ``fast`` tier's scan:
    ``esc_fn(huff8_gs, esc_pos, esc_val, side_gs, *state, vindex0)``. The
    int8 plane widens and the escapes scatter back on the device (torch
    ops), then the same scan runs, so only the transport narrows."""
    scan_fn = _scan_builder(_tier(fast))(ver, sr_idx, nch, cutoff)

    def esc_fn(huff8_gs, esc_pos, esc_val, *rest):
        return scan_fn(_esc_fixup_flat(_widen_esc16(huff8_gs), esc_pos, esc_val), *rest)
    return esc_fn


def _advance_vindex(vindex: int, ngr: int) -> int:
    """FIFO phase after ngr granules: 9 odd steps per granule each decrement
    the phase mod 8."""
    return (vindex - 9 * ngr) & 7


def decode_granules(huff, params, sf, frame, sfjs, state, n_granules=None, device="cuda"):
    """Decode all granules of one parsed frame (one stream) on ``device``.

    Args:
      huff: int32 [2, 2, 576]; params: [2, 2, 24]; sf: [2, 2, 62];
      frame: [16]; sfjs: [8] (the native front-end's layout).
      state: (over [2, 288], prev_type [2], prev_win_switch [2],
              num_prev [2], vbuf [2176], vindex int), numpy.

    Returns (pcm int16 [nGrans * 576 * nChans], new state tuple,
    reference_defined).
    """
    over, prev_type, prev_win_switch, num_prev, vbuf, vindex = state
    ngr = int(frame[6])
    if n_granules is not None:
        ngr = min(ngr, n_granules)
    pcm, states, rdef = decode_granules_batch(
        huff[None], params[None], sf[None], frame[None], sfjs[None],
        [(over, prev_type, prev_win_switch, num_prev, vbuf)], vindex, ngr, device=device)
    nch = int(frame[5])
    return (pcm[0].reshape(-1)[: ngr * 576 * nch], (*states[0], _advance_vindex(vindex, ngr)),
            bool(rdef[0]))


def decode_granules_batch(huff, params, sf, frame, sfjs, states, vindex, ngr, device="cuda"):
    """Decode ``ngr`` granules for ``B`` format-uniform streams in lockstep.

    All streams share (version, samplerate index, nChans, vindex), the
    grouping ``BatchedMP3Decoder`` establishes.

    Args:
      huff: int32 [B, 2, 2, 576]; params [B, 2, 2, 24]; sf [B, 2, 2, 62];
      frame [B, 16]; sfjs [B, 8].
      states: B per-stream tuples (over [2, 288], prev_type [2],
        prev_win_switch [2], num_prev [2], vbuf [2176]), numpy.
      vindex: the shared FIFO phase; ngr: granules to synthesize.

    Returns (pcm int16 [B, ngr * 576 * nch], new per-stream state tuples,
    reference_defined bool [B]).
    """
    dev = torch.device(device)
    dev_state = tuple(_put(np.stack([s[i] for s in states]), dev) for i in range(5))
    pcm, dev_state, ref_undef = decode_granules_batch_dev(huff, params, sf, frame, sfjs,
                                                          dev_state, vindex, ngr)
    st_np = tuple(_to_host(v) for v in dev_state)
    new_states = [tuple(a[b] for a in st_np) for b in range(huff.shape[0])]
    return _to_host(pcm), new_states, ~_to_host(ref_undef)


def decode_granules_batch_dev(huff, params, sf, frame, sfjs, dev_state, vindex, ngr,
                              fast=False):
    """Device-resident variant: ``dev_state`` is a tuple of stacked tensors
    (over [B, 2, 288], prev_type [B, 2], prev_win_switch [B, 2], num_prev
    [B, 2], vbuf [B, 2176]) on the device that runs the granules. Returns
    (pcm [B, ngr * 576 * nch], new dev_state, ref_undef bool [B]) there.
    ``fast`` selects the tier (:func:`_tier`)."""
    G = ngr
    frame_g = np.repeat(np.asarray(frame)[:, None], max(G, 1), axis=1)
    sfjs_g = np.repeat(np.asarray(sfjs)[:, None], max(G, 1), axis=1)
    return decode_granules_run(huff[:, :G], params[:, :G], sf[:, :G], frame_g[:, :G],
                               sfjs_g[:, :G], dev_state, vindex, fast=fast)


def run_operands(huff_g, params_g, sf_g, frame_g, sfjs_g):
    """Host operands of a run's scan (arguments as
    :func:`decode_granules_run`): ``((ver, sr_idx, nch, cutoff), huff_gs
    int16 [G, B, nch, 576], side_gs int32 [G, B, 3 * nch + _GPC_SIZE])``,
    numpy. side_gs packs nzb | block_type | mixed | the compact blob."""
    B, G = huff_g.shape[:2]
    nch = int(frame_g[0, 0, 5])
    ver, sr_idx = int(frame_g[0, 0, 0]), int(frame_g[0, 0, 4])
    cutoff = int(mp3_tables()["sfBandLong"][ver][sr_idx][8 if ver == 0 else 6] // 18)
    huff_gs = _pack_huff16(np.ascontiguousarray(huff_g[:, :, :nch].swapaxes(0, 1)))
    side_gs = None
    for g in range(G):
        blob = granule_params_compact_blob(params_g[:, g], sf_g[:, g], frame_g[:, g],
                                           sfjs_g[:, g], params_g[:, g, :nch, 18], nch)
        if side_gs is None:
            side_gs = np.empty((G, B, 3 * nch + blob.shape[-1]), np.int32)
        side_gs[g, :, 0:nch] = params_g[:, g, :nch, 18]
        side_gs[g, :, nch:2 * nch] = params_g[:, g, :nch, 5]
        side_gs[g, :, 2 * nch:3 * nch] = params_g[:, g, :nch, 6]
        side_gs[g, :, 3 * nch:] = blob
    return (ver, sr_idx, nch, cutoff), huff_gs, side_gs


def decode_granules_run(huff_g, params_g, sf_g, frame_g, sfjs_g, dev_state, vindex, mesh=None,
                        fast=False):
    """Synthesize a run of G granules (any mix of frames) for B
    format-uniform streams: one upload and one scan.

    Inputs carry a granule axis: huff_g int32 [B, G, 2, 576], params_g
    [B, G, 2, 24], sf_g [B, G, 2, 62], frame_g [B, G, 16], sfjs_g [B, G, 8].
    Streams share (version, samplerate index, nChans) and the starting
    ``vindex``. The scan runs on ``dev_state``'s device.

    Under a mesh that splits (``is_split``; B divisible by its size), block
    ``i`` of the streams goes to ``mesh.devices[i]`` with its own escape
    sideband and its block of the carried state, and the scan runs once per
    shard: every result is :class:`Sharded` along the stream axis;
    ``dev_state`` should already be split so (``BatchedMP3Decoder`` keeps
    it so). Without one the run is one block on ``dev_state``'s device.
    ``fast`` selects the tier (:func:`_tier`); under a relaxed tier the
    new ``over`` and ``vbuf`` are f32.

    Returns (pcm [B, G * 576 * nch], new dev_state, ref_undef bool [B]).
    """
    B, G = huff_g.shape[:2]
    split = is_split(mesh)
    if G == 0:
        dev = mesh.devices[0] if split else dev_state[0].device
        return (torch.zeros((B, 0), dtype=torch.int16, device=dev), tuple(dev_state),
                torch.zeros(B, dtype=torch.bool, device=dev))
    if split:   # block i of the streams (axis 1 of the run tensors) on devices[i]
        devices = mesh.devices
        blocks = lambda x: shard_streams_axis(x, 1, mesh).parts
        split_state = tuple(shard_streams(t, mesh) for t in dev_state)
        states = [tuple(t.parts[i] for t in split_state) for i in range(mesh.size)]
    else:
        devices = (dev_state[0].device,)
        blocks = lambda x: [_put(x, devices[0])]
        states = [tuple(dev_state)]
    with span("eal.mp3.operands"):
        fmt, huff_gs, side_gs = run_operands(huff_g, params_g, sf_g, frame_g, sfjs_g)
        narrowed = _pack_huff8_sharded(huff_gs, len(devices))
    with span("eal.mp3.upload"):
        if narrowed is not None:
            plane8, esc_pos, esc_val = narrowed
            scan = _granules_scan_esc_for(*fmt, fast=fast)
            operands = [(p, _put(esc_pos[i], d), _put(esc_val[i], d), side) for i, (d, p, side)
                        in enumerate(zip(devices, blocks(plane8), blocks(side_gs)))]
        else:
            scan = _scan_builder(_tier(fast))(*fmt)
            operands = list(zip(blocks(huff_gs), blocks(side_gs)))
    outs = [scan(*ops, *state, vindex) for ops, state in zip(operands, states)]
    # [G, b, 576 * nch] -> [b, G * 576 * nch] per block
    pcm = [o[0].transpose(0, 1).reshape(o[0].shape[1], -1) for o in outs]
    if not split:
        return pcm[0], outs[0][1], outs[0][2]
    return (Sharded(pcm, 0, mesh), tuple(Sharded([o[1][k] for o in outs], 0, mesh)
                                         for k in range(5)),
            Sharded([o[2] for o in outs], 0, mesh))
