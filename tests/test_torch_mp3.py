"""Port parity of the MP3 exact tier: the PyTorch MP3 decode (the plain
version of the granule kernel on the CPU) against the JAX package on the
same inputs, byte for byte.

Stage by stage (the parameter expansion, dequantization and joint stereo,
IMDCT, subband synthesis), the whole-run scan on real parsed runs (int16 and
int8 + escape transports), and ``MP3Decoder`` frame by frame on streams of
tools/mp3frames.py: fuzz frames with the bit reservoir, crafted tonal
frames that decode to nonzero PCM, window-type frames, an invalid header
and ``use_size``. JAX compiles one scan per format and run shape, so the
tests reuse two formats. The CUDA kernel is held to the plain version in
tests/test_torch_kernels.py.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esp_audio_libs_tpu.models import mp3 as jmp3
from esp_audio_libs_tpu.models import mp3_pipeline as jpipe
from esp_audio_libs_tpu.ops import mp3dsp as jdsp
from esp_audio_libs_tpu.ops import mp3imdct as jimdct
from esp_audio_libs_tpu.ops import mp3subband as jsub
from esp_audio_libs_tpu.runtime import transport as jtransport
from esp_audio_libs_tpu.runtime.tables import mp3_tables as jax_tables
from esp_audio_libs_tpu_torch.models import mp3 as tmp3
from esp_audio_libs_tpu_torch.models import mp3_pipeline as tpipe
from esp_audio_libs_tpu_torch.models.batch import BatchedMP3Decoder, parsed_runs
from esp_audio_libs_tpu_torch.ops import mp3dsp as tdsp
from esp_audio_libs_tpu_torch.ops import mp3imdct as timdct
from esp_audio_libs_tpu_torch.ops import mp3subband as tsub
from esp_audio_libs_tpu_torch.runtime import transport
from esp_audio_libs_tpu_torch.runtime.tables import mp3_tables
from esp_audio_libs_tpu_torch.utils.errors import MP3Error
from tests.test_mp3_stages import CASES, random_granule

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
import mp3frames as mf  # noqa: E402

torch.set_num_threads(2)

I32_MIN = -(2 ** 31)
# two formats for the scans JAX compiles: MPEG-1 44.1 kHz stereo (intensity
# and mid-side), and MPEG-2 22.05 kHz with intensity
STEREO_IS = dict(ver_bits=3, bitrate_idx=11, sr_idx=0, mode=1, mode_ext=3)
MPEG2_IS = dict(ver_bits=2, bitrate_idx=7, sr_idx=1, mode=1, mode_ext=1)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _eq(got, want, msg=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_array_equal(got, np.asarray(want), err_msg=msg)


# ------------------------------------------------------------- host side


def test_tables_and_enums_match_jax():
    from esp_audio_libs_tpu.utils.errors import MP3Error as JaxMP3Error
    ours, theirs = mp3_tables(), jax_tables()
    assert ours.keys() == theirs.keys()
    for k in ours:
        assert ours[k].dtype == theirs[k].dtype, k
        _eq(ours[k], theirs[k], k)
    assert {m.name: int(m) for m in MP3Error} == {m.name: int(m) for m in JaxMP3Error}


@pytest.mark.parametrize("ver,sr_idx", [(v, s) for v in range(3) for s in range(3)])
def test_format_maps_match_jax(ver, sr_idx):
    ours, theirs = tmp3.format_maps(ver, sr_idx), jmp3.format_maps(ver, sr_idx)
    assert ours.keys() == theirs.keys()
    for k in ours:
        _eq(ours[k], theirs[k], k)


def _parsed_granules(cfg, seed, n_frames=6):
    """(huff, params, sf, frame, sfjs, gr) of every synthesized granule of a
    mixed stream, parsed by the port's front-end."""
    dec = tmp3.MP3Decoder(device="cpu")
    stream, pos, out = mf.mixed_stream(cfg, seed, n_frames), 0, []
    while pos < len(stream):
        err, huff, params, sf, frame, sfjs, consumed, _, err_gr = dec.parse_frame(stream[pos:])
        ngr = int(frame[6]) if err == MP3Error.NONE else err_gr
        out += [(huff, params, sf, frame, sfjs, g) for g in range(ngr)]
        pos += max(consumed, 1)
    return out


@pytest.mark.parametrize("cfg_i", range(len(mf.BATCH_CFGS) + 2))
def test_expand_hp_device_matches_jax(cfg_i):
    """Per-sample parameters from the compact blob: the port's gathers give
    the JAX select trees' integers, on real parsed granules of the
    batched-decoder formats and of intensity stereo (MPEG-1 and MPEG-2); the
    host ``granule_params`` and the compact blob equal JAX's too."""
    cfg = (mf.BATCH_CFGS + [STEREO_IS, MPEG2_IS])[cfg_i]
    granules = _parsed_granules(cfg, 50 + cfg_i)
    assert len(granules) >= 4
    for huff, params, sf, frame, sfjs, g in granules:
        nch = int(frame[5])
        nzb = params[g, :nch, 18].astype(np.int32)
        args = (params[g][None], sf[g][None], frame[None], sfjs[None], nzb[None], nch)
        compact = tmp3.granule_params_compact_blob(*args)
        _eq(compact, jmp3.granule_params_compact_blob(*args))
        host = (params[g, :nch], sf[g, :nch], frame, sfjs, nzb)
        ours_gp, theirs_gp = tmp3.granule_params(*host), jmp3.granule_params(*host)
        for k in theirs_gp:
            _eq(ours_gp[k], theirs_gp[k], k)
        maps = jmp3.format_maps(int(frame[0]), int(frame[4]))
        want = jmp3.expand_hp_device(jnp.asarray(compact), maps, nch)
        got = tmp3.expand_hp_device(torch.from_numpy(compact), maps, nch)
        assert got.keys() == want.keys()
        for k in want:
            _eq(got[k], want[k], k)


# ------------------------------------------------------------------ stages


def test_clz_and_dequant_block_math_extremes():
    """clz over every bit length (clz(0) = 32) and DequantBlock at the
    magnitude and scale extremes: INT_MIN (a sign with no magnitude), the
    largest magnitudes, every table boundary, scales that shift by 31 and
    more."""
    x = np.array([0, 1, 2, 3, 0x7FFFFFFF, -1, I32_MIN] + [1 << k for k in range(31)], np.int32)
    _eq(tdsp._clz32(_t(x)), np.asarray(jdsp._clz32(jnp.asarray(x))))
    mags = np.array([0, 1, 3, 4, 15, 16, 63, 64, 65, 127, 128, 1000, 8206, 0x7FFF, 1 << 20,
                     0x7FFFFFFF], np.int64)
    sx = np.concatenate([mags, mags | (1 << 31)]).astype(np.uint32).view(np.int32)
    sx = np.append(sx, np.int32(I32_MIN))
    scales = np.array([-400, -130, -129, -30, -5, -1, 0, 1, 2, 3, 7, 100, 127, 128, 131, 600],
                      np.int32)
    S, X = np.meshgrid(scales, sx)
    T = {k: jnp.asarray(v) for k, v in jax_tables().items()}
    want = jdsp.dequant_block_math(jnp.asarray(X), jnp.asarray(S), T)
    got = tdsp.dequant_block_math(_t(X), _t(S), tdsp.tables(torch.device("cpu")))
    for a, b in zip(got, want):
        _eq(a, b)


def _hp_lanes(case, seed, lanes=4, zero_lane=False):
    """L random granules of one stage-test case, their host parameters
    stacked on a lane axis (numpy), and huff/nzb."""
    rng = np.random.default_rng(seed)
    hps, huffs, nzbs = [], [], []
    for k in range(lanes):
        huff, params, sf, frame, sfjs, nzb = random_granule(rng, **case)
        if zero_lane and k == 0:
            huff[:] = 0                        # no magnitude: gb == 31
            huff[:, ::7] = I32_MIN             # a sign and no magnitude
        hps.append(tmp3.granule_params(params, sf, frame, sfjs, nzb))
        huffs.append(huff)
        nzbs.append(nzb)
    hp = {k: np.stack([np.asarray(h[k]) for h in hps]) for k in hps[0]}
    return np.stack(huffs), np.stack(nzbs), hp


@pytest.mark.parametrize("case_i", range(len(CASES)))
def test_dequantize_granule_matches_jax(case_i):
    """Dequantization, short-block reorder and joint stereo (every block
    type, mixed blocks, MS, intensity, MPEG-1/2/2.5), one lane all-zero
    (gb == 31) with INT_MIN entries."""
    case = CASES[case_i]
    huff, nzb, hp = _hp_lanes(case, 10 + case_i, zero_lane=True)
    nch = case["nch"]
    sfb_s = tuple(int(v) for v in hp["sfb_s"][0])
    want = jdsp.dequantize_granule(jnp.asarray(huff), jnp.asarray(nzb),
                                   {k: jnp.asarray(v) for k, v in hp.items()}, nch=nch,
                                   sfb_s=sfb_s)
    got = tdsp.dequantize_granule(_t(huff), _t(nzb), {k: _t(v) for k, v in hp.items()}, nch=nch)
    assert got.keys() == want.keys()
    for k in want:
        _eq(got[k], want[k], k)
    if not case.get("mode_ext"):
        assert int(got["gb"][0, 0]) == 31   # stereo modes see the INT_MIN entries


def test_imdct_granule_matches_jax():
    """Every (block type, mixed, previous type, window switch) over 64
    lanes, guard bits -1 .. 31 (rescale and none), every block-count
    branch including window-previous-only, random carried overlap."""
    rng = np.random.default_rng(7)
    L = 64
    amp = rng.choice([1 << 10, 1 << 20, 1 << 28, 1 << 31], (L, 1))
    x = (rng.integers(-1 << 31, 1 << 31, (L, 576)) % (2 * amp) - amp).astype(np.int32)
    xprev = rng.integers(-(1 << 26), 1 << 26, (L, 32, 9)).astype(np.int32)
    xprev[::5] = 0
    nzb = rng.integers(0, 577, L).astype(np.int32)
    x[np.arange(576)[None, :] >= nzb[:, None]] = 0
    gb = rng.integers(-1, 32, L).astype(np.int32)
    gb[:4] = (31, -1, 0, 7)
    bt = np.tile(np.arange(4, dtype=np.int32), L // 4)
    mixed = ((np.arange(L) // 4) % 2 == 1).astype(np.int32) * (bt == 2)
    pt = rng.integers(0, 4, L).astype(np.int32)
    cutoff = np.full(L, 2, np.int32)
    pws = np.where(rng.random(L) < 0.5, 0, 2).astype(np.int32)
    npv = rng.integers(0, 33, L).astype(np.int32)
    args = (x, xprev, nzb, gb, bt, mixed, pt, pws, cutoff, npv)
    want = jimdct.imdct_granule(*map(jnp.asarray, args))
    got = timdct.imdct_granule(*map(_t, args))
    for k, (a, b) in enumerate(zip(got, want)):
        _eq(a, b, f"output {k}")


@pytest.mark.parametrize("nch", [1, 2])
def test_subband_granule_matches_jax(nch):
    """FDCT32, the FIFO in the JAX layout and the int64 PQMF, every FIFO
    phase (both parities), guard bits that rescale and that clip."""
    rng = np.random.default_rng(nch)
    L = 8
    outbuf = rng.integers(-(1 << 27), 1 << 27, (L, nch, 18, 32)).astype(np.int32)
    outbuf[1] >>= 12
    gb = rng.integers(-1, 32, (L, nch)).astype(np.int32)
    gb[0] = 0
    vbuf = rng.integers(-(1 << 28), 1 << 28, (L, 2176)).astype(np.int32)
    for vindex in range(8):
        want = jsub.subband_granule(jnp.asarray(outbuf), jnp.asarray(gb), jnp.asarray(vbuf),
                                    jnp.int32(vindex), nch=nch)
        got = tsub.subband_granule(_t(outbuf), _t(gb), _t(vbuf), vindex, nch=nch)
        _eq(got[0], want[0], f"pcm vindex={vindex}")
        _eq(got[1], want[1], f"vbuf vindex={vindex}")


@pytest.mark.parametrize("nch", [1, 2])
def test_subband_onepass_matches_jax(nch):
    """The one-pass FIFO index map of csrc/mp3_granules.cu
    (``subband_granule_onepass``: all stored values first, every PQMF output
    over a linear history, the ring rebuilt) against JAX's step-by-step
    ``subband_granule`` at every FIFO phase, over two granules in a row (the
    second from the first's ring at the phase it left), from a random ring
    whose two copies disagree."""
    rng = np.random.default_rng(10 + nch)
    L = 4
    outbufs = rng.integers(-(1 << 27), 1 << 27, (2, L, nch, 18, 32)).astype(np.int32)
    outbufs[:, 1] >>= 12
    gbs = rng.integers(-1, 32, (2, L, nch)).astype(np.int32)
    gbs[:, 0] = 0
    vbuf0 = rng.integers(-(1 << 28), 1 << 28, (L, 2176)).astype(np.int32)
    for vindex in range(8):
        vbuf, v = vbuf0, vindex
        for g in range(2):
            want = jsub.subband_granule(jnp.asarray(outbufs[g]), jnp.asarray(gbs[g]),
                                        jnp.asarray(vbuf), jnp.int32(v), nch=nch)
            got = tsub.subband_granule_onepass(_t(outbufs[g]), _t(gbs[g]), _t(vbuf), v, nch=nch)
            _eq(got[0], want[0], f"pcm vindex={vindex} granule {g}")
            _eq(got[1], want[1], f"vbuf vindex={vindex} granule {g}")
            vbuf, v = np.asarray(want[1]), (v - 9) & 7


# ---------------------------------------------------------- whole-run scan


def _scan_operands(cfg, B, n_frames, seed):
    bat = BatchedMP3Decoder(B, device="cpu")
    streams = [mf.mixed_stream(cfg, seed + i, n_frames, fuzz=False) for i in range(B)]
    (run,) = parsed_runs(bat, streams, n_frames)
    return run


@pytest.mark.parametrize("esc", [False, True])
def test_granule_scan_matches_jax(esc):
    """The whole-run scan on real parsed runs (tonal and window-type frames)
    against JAX's ``_granules_scan_for`` / ``_granules_scan_esc_for``, state
    included, the second starting from random carried state at FIFO phase
    3. B = 3, G = 8 (MPEG-1) and B = 4, G = 6 (MPEG-2)."""
    cfg, B, nf = (MPEG2_IS, 4, 6) if esc else (STEREO_IS, 3, 4)
    fmt, _, _, huff_gs, side_gs = _scan_operands(cfg, B, nf, 60 + esc)
    rng = np.random.default_rng(esc)
    state = (rng.integers(-(1 << 20), 1 << 20, (B, 2, 288)).astype(np.int32),
             rng.integers(0, 4, (B, 2)).astype(np.int32), np.zeros((B, 2), np.int32),
             rng.integers(0, 33, (B, 2)).astype(np.int32),
             rng.integers(-(1 << 24), 1 << 24, (B, 2176)).astype(np.int32))
    if not esc:
        state = tuple(np.zeros_like(s) for s in state)
    vindex = 3 if esc else 0
    if esc:
        plane8, pos, val = tpipe._pack_huff8(huff_gs)
        assert pos.size >= 16
        want = jpipe._granules_scan_esc_for(*fmt)(
            *map(jnp.asarray, (plane8, pos, val, side_gs, *state)), jnp.int32(vindex))
        got = tpipe._granules_scan_esc_for(*fmt)(*map(_t, (plane8, pos, val, side_gs, *state)),
                                                vindex)
    else:
        want = jpipe._granules_scan_for(*fmt)(*map(jnp.asarray, (huff_gs, side_gs, *state)),
                                              jnp.int32(vindex))
        got = tpipe._granules_scan_for(*fmt)(*map(_t, (huff_gs, side_gs, *state)), vindex)
    _eq(got[0], want[0], "pcm")
    assert np.abs(got[0].numpy()).max() > 0
    for k, (a, b) in enumerate(zip(got[1], want[1])):
        _eq(a, b, f"state {k}")
    _eq(got[2], want[2], "ref_undef")


def test_pack_huff_matches_jax():
    rng = np.random.default_rng(3)
    mags = rng.choice([0, 1, 5, 127, 128, 8206], (2, 3, 2, 576)).astype(np.int64)
    huff = np.where(rng.random(mags.shape) < 0.5, mags | (1 << 31), mags)
    huff = huff.astype(np.uint32).view(np.int32)
    h16 = tpipe._pack_huff16(huff)
    _eq(h16, jpipe._pack_huff16(huff))
    for density in (1.0, 0.0):
        tpipe.ESC_MAX_DENSITY = jpipe.ESC_MAX_DENSITY = density
        try:
            ours, theirs = tpipe._pack_huff8(h16), jpipe._pack_huff8(h16)
        finally:
            tpipe.ESC_MAX_DENSITY = jpipe.ESC_MAX_DENSITY = transport.ESC_MAX_DENSITY
        assert (ours is None) == (theirs is None) == (density == 0.0)
        if ours is not None:
            for a, b in zip(ours, theirs):
                _eq(a, b)
            _eq(tpipe._esc_fixup_flat(tpipe._widen_esc16(_t(ours[0])), _t(ours[1]), _t(ours[2])),
                h16)
    mask = (np.abs(h16.reshape(3, -1)) > 127)
    for a, b in zip(transport.escape_sideband_blocked(mask, h16.reshape(3, -1), np.int16),
                    jtransport.escape_sideband_blocked(mask, h16.reshape(3, -1), np.int16)):
        _eq(a, b)


# ----------------------------------------------------------------- decoder


def _decode_both(stream, n_frames, use_size=False):
    """Frame by frame through both packages' MP3Decoder, advancing by the
    consumed bytes; every result, the state and the UB flag compared."""
    j, p = jmp3.MP3Decoder(), tmp3.MP3Decoder(device="cpu")
    pos, nonzero, codes = 0, 0, []
    for f in range(n_frames):
        ej, pj, cj = j.decode(stream[pos:], use_size)
        ep, pp, cp = p.decode(stream[pos:], use_size)
        assert (int(ep), cp) == (int(ej), cj), f"frame {f}"
        assert (pp is None) == (pj is None), f"frame {f}"
        if pj is not None:
            _eq(pp, pj, f"frame {f} pcm")
            nonzero += int(np.any(pj))
        assert p.last_frame_reference_defined == j.last_frame_reference_defined
        for a, b in zip(p._state()[:5], (j._over, j._prev_type, j._prev_win_switch,
                                         j._num_prev, j._vbuf)):
            _eq(a, b, f"frame {f} state")
        assert p._vindex == j._vindex
        assert p.get_last_frame_info() == j.get_last_frame_info()
        codes.append(int(ep))
        pos += cj
        if pos >= len(stream):
            break
    return codes, nonzero


def test_decoder_mixed_stream_matches_jax():
    """Tonal, window-type and fuzz frames in turn (MS + intensity): nonzero
    overlap meets every block type, fuzz frames fail, some mid-frame with
    a partial-granule state update."""
    codes, nonzero = _decode_both(mf.mixed_stream(STEREO_IS, 5, 12), 12)
    assert nonzero >= 3 and any(c != 0 for c in codes) and codes.count(0) >= 6


def test_decoder_reservoir_and_mpeg2_match_jax():
    """Random mainDataBegin (the bit reservoir, MAINDATA_UNDERFLOW on early
    frames) at 44.1 kHz stereo, then an MPEG-2 intensity stream (one
    granule per frame: both FIFO parities)."""
    rng = np.random.default_rng(100)
    cfg = dict(ver_bits=3, bitrate_idx=11, sr_idx=0, mode=0)
    total, _ = mf.frame_sizes(3, 11, 0, 0)
    stream = b"".join(mf.make_header(**cfg) + rng.integers(0, 256, total - 4, np.uint8).tobytes()
                      for _ in range(5))
    codes, _ = _decode_both(stream, 5)
    assert MP3Error.MAINDATA_UNDERFLOW in codes or any(c != 0 for c in codes)
    codes, nonzero = _decode_both(mf.mixed_stream(MPEG2_IS, 8, 7, fuzz=False), 7)
    assert codes == [0] * 7


def test_decoder_invalid_header_use_size_and_info_match_jax():
    """An invalid header, ``use_size`` on a truncated buffer, sync search and
    frame info before and after a parse."""
    assert tmp3.MP3Decoder.find_sync_word(b"\x12\x34" * 10 + mf.make_header()) == \
        jmp3.MP3Decoder.find_sync_word(b"\x12\x34" * 10 + mf.make_header()) == 20
    bad = b"\x00\x11\x22\x33" * 100
    j, p = jmp3.MP3Decoder(), tmp3.MP3Decoder(device="cpu")
    assert p.get_last_frame_info() == j.get_last_frame_info()
    rj, rp = j.decode(bad), p.decode(bad)
    assert (int(rp[0]), rp[2]) == (int(rj[0]), rj[2]) and rp[0] == MP3Error.INVALID_FRAMEHEADER
    frame = mf.craft_tonal_frame(STEREO_IS, np.random.default_rng(1))
    assert p.get_next_frame_info(frame) == j.get_next_frame_info(frame)
    for buf in (frame, frame[:len(frame) // 2]):
        for use_size in (True, False):
            codes, _ = _decode_both(buf + frame, 2, use_size=use_size)
            assert codes
