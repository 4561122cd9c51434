"""Port parity of the FLAC slice: the PyTorch FLAC decode (plain versions of
the frame kernel on the CPU) against the JAX package on the same inputs.

Every comparison is byte-exact, except the composed FLAC -> 16 kHz chain
against JAX's, which is held to the resampler's contract: packed s16 within
1 LSB (its f32 contraction sums in another order) with equal generated
counts. Inputs come from numpy seeds, the numpy-only encoder tools/flacgen.py
and the committed corpus/independent/ files, whose STREAMINFO MD5 pins the
reference decoder's PCM.
"""

import os
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esp_audio_libs_tpu.models import flac as jax_flac
from esp_audio_libs_tpu.models.batch import BatchedFLACDecoder as JaxBatched
from esp_audio_libs_tpu.models.resampler import Resampler as JaxResampler
from esp_audio_libs_tpu.models.resampler import ResamplerConfiguration as JaxConfig
from esp_audio_libs_tpu.ops import lpc as jax_lpc
from esp_audio_libs_tpu_torch.models import (BatchedFLACDecoder, FLACDecoder, Resampler,
                                             ResamplerConfiguration)
from esp_audio_libs_tpu_torch.models import flac as port_flac
from esp_audio_libs_tpu_torch.ops import flac_kernels as fk
from esp_audio_libs_tpu_torch.ops import lpc as port_lpc
from esp_audio_libs_tpu_torch.runtime import transport
from esp_audio_libs_tpu_torch.utils.errors import FLACDecoderResult

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))
from flacgen import SubframePlan, make_flac  # noqa: E402

torch.set_num_threads(2)

CORPUS = REPO / "corpus" / "independent"
FILES = sorted(CORPUS.glob("*.flac"))
I32 = np.iinfo(np.int32)


def _lpc_inputs(seed, W, lanes=8, T=80, overflow=False):
    """Residual planes with orders 0..W (W = the order class), random
    coefficients and shifts (some outside [0, 32): XLA fills with the
    sign), and, with ``overflow``, magnitudes whose dot overflows int32."""
    rng = np.random.default_rng(seed)
    amp = 1 << 24 if overflow else 1 << 12
    data = rng.integers(-amp, amp, (lanes, T)).astype(np.int32)
    order = rng.integers(0, W + 1, lanes).astype(np.int32)
    order[:2] = (W, 0)
    cmax = 1 << 14 if overflow else 1 << 8
    coeffs = np.zeros((lanes, 32), np.int32)
    for i, o in enumerate(order):
        coeffs[i, :o] = rng.integers(-cmax, cmax, o)
    shift = rng.integers(0, 16, lanes).astype(np.int32)
    shift[-3:] = (-1, 33, 70)
    return data, coeffs, order, shift


@pytest.mark.parametrize("use64", [True, False])
@pytest.mark.parametrize("W", fk.ORDER_CLASSES)
def test_lpc_restore_matches_jax(W, use64):
    for overflow in (False, True):
        data, coeffs, order, shift = _lpc_inputs(W * 7 + use64 + 31 * overflow, W,
                                                 overflow=overflow)
        want = np.asarray(jax_lpc.lpc_restore(jnp.asarray(data), jnp.asarray(coeffs),
                                              jnp.asarray(order), jnp.asarray(shift),
                                              use64=use64, max_order=W))
        got = port_lpc.lpc_restore(*map(torch.from_numpy, (data, coeffs, order, shift)),
                                   use64=use64, max_order=W)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"overflow={overflow}")


def test_lpc_restore_32bit_path_wraps():
    """With use64=False the dot wraps in int32 where the exact sum does
    not: the two accumulators disagree on these inputs, and each matches
    JAX's (the case the i32-overflow corpus file pins)."""
    data, coeffs, order, shift = _lpc_inputs(5, 8, overflow=True)
    args = tuple(map(torch.from_numpy, (data, coeffs, order, shift)))
    a = port_lpc.lpc_restore(*args, use64=False, max_order=8)
    b = port_lpc.lpc_restore(*args, use64=True, max_order=8)
    assert not torch.equal(a, b)


@pytest.mark.parametrize("ca", range(11))
def test_decorrelate_matches_jax(ca):
    rng = np.random.default_rng(ca)
    x = rng.integers(I32.min, I32.max, (3, 2, 50), dtype=np.int64).astype(np.int32)
    x[0, :, :4] = [[I32.min, I32.max, -1, 0], [I32.max, I32.min, I32.min, -1]]
    cas = np.full(3, ca, np.int32)
    want = np.asarray(jax_lpc.decorrelate(jnp.asarray(x), jnp.asarray(cas)))
    got = port_lpc.decorrelate(torch.from_numpy(x), torch.from_numpy(cas))
    np.testing.assert_array_equal(got.numpy(), want)


def _frame_inputs(seed, nch, depth, F=3, T=40, W=8):
    rng = np.random.default_rng(seed)
    amp = 1 << max(depth - 2, 2)
    data = rng.integers(-amp, amp, (F, nch, T)).astype(np.int32)
    order = rng.integers(0, W + 1, (F, nch)).astype(np.int32)
    coeffs = np.zeros((F, nch, 32), np.int32)
    for f in range(F):
        for c in range(nch):
            coeffs[f, c, :order[f, c]] = rng.integers(-300, 300, order[f, c])
    shift = rng.integers(0, 12, (F, nch)).astype(np.int32)
    wasted = rng.integers(0, 3, (F, nch)).astype(np.int32)
    wasted[0, 0] = 33                       # shifts everything out: zeros
    ca = (np.array([8, 9, 10], np.int32)[:F] if nch == 2 else np.full(F, nch - 1, np.int32))
    return data, coeffs, order, shift, wasted, ca


@pytest.mark.parametrize("mode32", [False, True])
@pytest.mark.parametrize("nch", [1, 2, 8])
@pytest.mark.parametrize("depth", [8, 12, 16, 20, 24, 32])
def test_flac_frame_plain_matches_jax_body(depth, nch, mode32):
    arrays = _frame_inputs(depth * 10 + nch, nch, depth)
    kw = dict(depth=depth, nch=nch, mode32=mode32, use64=True, max_order=8)
    want = np.asarray(jax_flac._frame_kernel_body(*map(jnp.asarray, arrays), **kw))
    got = fk.flac_frame_plain(*map(torch.from_numpy, arrays), **kw)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


def test_flac_frame_escape_tier_matches_jax():
    """The int8 plane + sorted escape sideband (padded with out-of-range
    positions) against _frame_kernel_esc, and against the widened int16
    plane it stands for."""
    data, coeffs, order, shift, wasted, ca = _frame_inputs(3, 2, 16, W=12)
    data = np.clip(data, -200, 200).astype(np.int16)
    mask = np.abs(data.astype(np.int32)) > 127
    flat = np.flatnonzero(mask)
    (pos,), (val,) = transport.escape_sideband_blocked(mask.reshape(1, -1),
                                                       data.reshape(1, -1), np.int32)
    assert flat.size and pos.size > flat.size
    kw = dict(depth=16, nch=2, mode32=False, use64=False, max_order=12)
    params = (coeffs, order, shift, wasted, ca)
    want = np.asarray(jax_flac._frame_kernel_esc(
        *map(jnp.asarray, (data.astype(np.int8), pos, val) + params), **kw))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    got = fk.flac_frame_cuda(t(data.astype(np.int8)), *map(t, params), **kw,
                             esc_pos=t(pos), esc_val=t(val))
    np.testing.assert_array_equal(got.numpy(), want)
    wide = fk.flac_frame_plain(t(data), *map(t, params), **kw)
    np.testing.assert_array_equal(got.numpy(), wide.numpy())


# the (order class, T) edges of the frame kernel's tiles and recurrence: one
# step, one short of a window, a window, and around the 64-step tiles (48
# for the 12 class, 96 there too)
EDGES = [(W, T) for W in fk.ORDER_CLASSES
         for T in sorted({1, W - 1, W, 63, 64, 65, 95, 96, 97, 129})]


def _edge_frames(seed, W, T, overflow):
    """Stereo frames whose lanes take every order 0..W (so order == T where
    T <= W), random coefficients, shifts including -1, 33 and 70 (filled
    with the sign), wasted bits including 33, every stereo channel
    assignment; ``overflow``: residuals of up to 2^24 and coefficients of up
    to 2^14, whose dots overflow int32."""
    rng = np.random.default_rng(seed)
    F = W // 2 + 2
    amp, cmax = (1 << 24, 1 << 14) if overflow else (1 << 12, 1 << 8)
    data = rng.integers(-amp, amp, (F, 2, T)).astype(np.int32)
    order = np.resize(np.arange(W + 1, dtype=np.int32), 2 * F).reshape(F, 2)
    coeffs = np.zeros((F, 2, 32), np.int32)
    for f in range(F):
        for c in range(2):
            coeffs[f, c, :order[f, c]] = rng.integers(-cmax, cmax, order[f, c])
    shift = rng.integers(0, 16, (F, 2)).astype(np.int32)
    shift.reshape(-1)[-3:] = (-1, 33, 70)
    wasted = rng.integers(0, 3, (F, 2)).astype(np.int32)
    wasted[-1, 0] = 33
    ca = np.resize(np.array([1, 8, 9, 10], np.int32), F)
    return data, coeffs, order, shift, wasted, ca


@pytest.mark.parametrize("W,T", EDGES, ids=[f"W{W}-T{T}" for W, T in EDGES])
def test_flac_frame_plain_edges_match_jax(W, T):
    """flac_frame_plain against _frame_kernel_body at the edges the kernel's
    tiles and ring touch, with both accumulators on ordinary and on
    int32-overflow magnitudes (one batch), and against _frame_kernel_esc with escapes at position 0, at
    the tile boundaries and at the plane's last sample."""
    arrays = [np.concatenate(parts) for parts in zip(
        _edge_frames(W * 1000 + T, W, T, False), _edge_frames(W * 1000 + T + 1, W, T, True))]
    for use64 in (True, False):
        kw = dict(depth=24, nch=2, mode32=False, use64=use64, max_order=W)
        want = np.asarray(jax_flac._frame_kernel_body(*map(jnp.asarray, arrays), **kw))
        got = fk.flac_frame_plain(*map(torch.from_numpy, arrays), **kw)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{use64=}")

    data, *params = _edge_frames(W + T, W, T, False)
    data = np.clip(data, -100, 100)
    edges = [t for t in (0, 47, 48, 63, 64, 65, 95, 96, 97, 128, T - 1) if t < T]
    data[..., edges] = (np.arange(len(edges)) * 257 - 1000)[None, None, :]
    mask = data.astype(np.int8) != data
    flat = np.flatnonzero(mask)
    (pos,), (val,) = transport.escape_sideband_blocked(mask.reshape(1, -1),
                                                       data.reshape(1, -1), np.int32)
    assert flat.size
    kw = dict(depth=16, nch=2, mode32=False, use64=False, max_order=W)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    want = np.asarray(jax_flac._frame_kernel_esc(
        *map(jnp.asarray, (data.astype(np.int8), pos, val, *params)), **kw))
    got = fk.flac_frame_plain(t(data.astype(np.int8)), *map(t, params), **kw,
                              esc_pos=t(pos), esc_val=t(val))
    np.testing.assert_array_equal(got.numpy(), want)


def _transposed_restore(data, coeffs, order, shift, use64, W):
    """lpc_restore in the frame kernel's transposed form, in numpy: each
    lane keeps W running sums, one per coming step; once y[t] is known,
    c[W-1] y[t] goes into step t + 1's sum, c[k] y[t] into step t + W - k's,
    and the sum step t used starts again as step t + W's. Sums wrap modulo
    2^32 (use64 False) or 2^64."""
    lanes, T = data.shape
    bits = 64 if use64 else 32
    mod = np.uint64 if use64 else np.uint32
    c = np.zeros((lanes, W), np.int64)
    for n in range(lanes):
        o = int(order[n])
        c[n, W - o:] = coeffs[n, :o]                 # c[k] multiplies lag W - k
    cw = c.astype(mod)                               # two's complement, mod 2^bits
    sh = np.where((shift < 0) | (shift >= bits), bits - 1, shift).astype(np.int64)
    acc = np.zeros((lanes, W), mod)                  # acc[:, t % W]: step t's sum
    out = np.zeros((lanes, T), np.int32)
    with np.errstate(over="ignore"):
        for t in range(T):
            u = t % W
            s = acc[:, u].view(np.int64 if use64 else np.int32).astype(np.int64)
            pred = (s >> sh).astype(np.int64)
            y = ((data[:, t].astype(np.int64) + pred + (1 << 31)) % (1 << 32) - (1 << 31))
            y = np.where(t < order, data[:, t], y).astype(np.int32)
            yw = y.astype(np.int64).astype(mod)
            for j in range(1, W):
                acc[:, (u + j) % W] += cw[:, W - j] * yw
            acc[:, u] = cw[:, 0] * yw
            out[:, t] = y
    return out


@pytest.mark.parametrize("use64", [True, False])
@pytest.mark.parametrize("W", fk.ORDER_CLASSES)
def test_transposed_recurrence_is_lpc_restore(W, use64):
    """The reordered sums the frame kernel runs (csrc/flac_frame.cu) equal
    lpc_restore bit for bit on int32-overflow inputs: addition modulo 2^32
    or 2^64 does not depend on the order of the products."""
    data, coeffs, order, shift = _lpc_inputs(W * 7 + use64 + 31, W, overflow=True)
    got = _transposed_restore(data, coeffs, order, shift, use64, W)
    want = port_lpc.lpc_restore(*map(torch.from_numpy, (data, coeffs, order, shift)),
                                use64=use64, max_order=W)
    np.testing.assert_array_equal(got, want.numpy())
    jax_want = np.asarray(jax_lpc.lpc_restore(*map(jnp.asarray, (data, coeffs, order, shift)),
                                              use64=use64, max_order=W))
    np.testing.assert_array_equal(got, jax_want)


def _decode_file(cls, blob, **kw):
    dec = cls(**kw)
    assert dec.read_header(blob) == FLACDecoderResult.SUCCESS
    return dec.decode_stream(blob[dec.get_bytes_index():])


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.name)
def test_corpus_file_matches_jax(path):
    blob = path.read_bytes()
    pcm, r = _decode_file(FLACDecoder, blob, device="cpu")
    assert len(pcm) > 0 and r["md5_ok"] is True
    assert all(c == FLACDecoderResult.SUCCESS for c in r["frame_results"])
    jpcm, jr = _decode_file(jax_flac.FLACDecoder, blob)
    assert pcm == jpcm
    assert r["frame_results"] == jr["frame_results"]
    assert (r["num_samples"], r["num_frames"]) == (jr["num_samples"], jr["num_frames"])


def test_corpus_i32_overflow_file_needs_the_wrap(monkeypatch):
    """The i32-overflow file decodes md5_ok only because the 32-bit path
    wraps: accumulating its cleared subframes exactly breaks the MD5."""
    blob = (CORPUS / "mut_flip_payload_bits_i32_overflow.flac").read_bytes()
    assert _decode_file(FLACDecoder, blob, device="cpu")[1]["md5_ok"] is True
    real = port_flac._frame_shape_key
    monkeypatch.setattr(port_flac, "_frame_shape_key",
                        lambda g, fi, m32: real(g, fi, m32)[:4] + (True, m32))
    assert _decode_file(FLACDecoder, blob, device="cpu")[1]["md5_ok"] is False


def test_decode_frame_and_32bit_mode_match_jax():
    blob, _ = make_flac(rng_seed=5, depth=24, channels=2, block_size=512, n_frames=2,
                        stereo_modes=["ms", "rs"],
                        plans=[[SubframePlan("lpc", order=10), SubframePlan("fixed", order=3)]] * 2)
    for mode32 in (False, True):
        decs = [FLACDecoder(device="cpu"), jax_flac.FLACDecoder()]
        outs = []
        for d in decs:
            assert d.read_header(blob) == FLACDecoderResult.SUCCESS
            d.set_output_32bit_samples(mode32)
            body = blob[d.get_bytes_index():]
            outs.append((d.decode_frame(body), d.decode_stream(body, verify_md5=True)))
        (fp, sp), (fj, sj) = outs
        assert fp == fj and sp == sj
        assert fp[0] == FLACDecoderResult.SUCCESS and fp[2] == 512 * 2
        assert sp[1]["md5_ok"] is (None if mode32 else True)


def _fleet_blobs():
    cfgs = [
        dict(rng_seed=21, depth=16, channels=2, block_size=1024, n_frames=3,
             stereo_modes=["ms", "ls", None],
             plans=[[SubframePlan("lpc", order=8), SubframePlan("fixed", order=2)]] * 3),
        dict(rng_seed=22, depth=16, channels=2, block_size=1024, n_frames=3,
             plans=[[SubframePlan("lpc", order=4, fit=True),
                     SubframePlan("lpc", order=12, fit=True)]] * 3),
        dict(rng_seed=23, depth=24, channels=1, block_size=512, n_frames=2,
             plans=[[SubframePlan("lpc", order=20)], [SubframePlan("verbatim")]]),
        dict(rng_seed=24, depth=8, channels=2, block_size=1024, n_frames=2,
             plans=[[SubframePlan("constant"), SubframePlan("fixed", order=1, wasted=2)]] * 2),
        dict(rng_seed=25, depth=12, channels=3, block_size=256, n_frames=2,
             plans=[[SubframePlan("lpc", order=32, precision=15, shift=14)] * 3] * 2),
    ]
    return [make_flac(**c)[0] for c in cfgs]


def _bodies(bat, blobs):
    assert all(h == FLACDecoderResult.SUCCESS for h in bat.read_headers(blobs))
    return [b[d.get_bytes_index():] for b, d in zip(blobs, bat.decoders)]


@pytest.mark.parametrize("tier", ["default", "escape_off", "escape_forced", "sliced"])
def test_fleet_decode_streams_matches_jax(monkeypatch, tier):
    """BatchedFLACDecoder.decode_streams against the JAX fleet, with the
    escape tier at its default, disabled and forced, and with tiny dispatch
    slices (ragged tails)."""
    blobs = _fleet_blobs()
    jax_bat = JaxBatched(len(blobs))
    want = jax_bat.decode_streams(_bodies(jax_bat, blobs))
    if tier == "escape_off":
        monkeypatch.setattr(port_flac, "ESC_MAX_DENSITY", 0.0)
    elif tier == "escape_forced":
        monkeypatch.setattr(port_flac, "ESC_MAX_DENSITY", 1.0)
    elif tier == "sliced":
        monkeypatch.setattr(transport, "SLICE_OUT_BYTES", 3 * 1024 * 2 * 2)
    bat = BatchedFLACDecoder(len(blobs), device="cpu")
    got = bat.decode_streams(_bodies(bat, blobs))
    for s, ((pg, rg), (pw, rw)) in enumerate(zip(got, want)):
        assert pg == pw, f"stream {s}"
        assert rg == rw and rg["md5_ok"] is True


def test_fleet_threaded_parse_and_skipped_stream(monkeypatch):
    monkeypatch.setenv("EAL_PARSE_THREADS", "3")
    blobs = _fleet_blobs() * 2
    bat = BatchedFLACDecoder(len(blobs), device="cpu")
    bodies = _bodies(bat, blobs)
    bodies[3] = None
    got = bat.decode_streams(bodies)
    assert got[3] == (b"", None)
    for s in (0, 1, 2, 4):
        assert got[s + 5] == got[s]
    assert all(r["md5_ok"] for s, (_, r) in enumerate(got) if s != 3)


def test_fleet_to_device_matches_host():
    """decode_streams_to_device of a uniform fleet equals the host decode,
    and so does JAX's device PCM."""
    blob = _fleet_blobs()[1]
    B = 3
    bat = BatchedFLACDecoder(B, device="cpu")
    host = bat.decode_streams(_bodies(bat, [blob] * B))
    bat2 = BatchedFLACDecoder(B, device="cpu")
    pcm_dev, res = bat2.decode_streams_to_device(_bodies(bat2, [blob] * B))
    assert pcm_dev.dtype == torch.uint8 and pcm_dev.shape[0] == B
    want = np.stack([np.frombuffer(p, np.uint8) for p, _ in host])
    np.testing.assert_array_equal(pcm_dev.numpy(), want)
    assert [r["num_samples"] for r in res] == [r["num_samples"] for _, r in host]
    jbat = JaxBatched(B)
    jpcm, jres = jbat.decode_streams_to_device(_bodies(jbat, [blob] * B))
    np.testing.assert_array_equal(np.asarray(jpcm), want)
    assert jres == res


def test_mixed_fleet_to_device_grouped():
    """A fleet of two block sizes interleaved (tests/test_compose.py's
    mixed fleet): the uniform call raises, the grouped call gives one
    device block per signature, each row the host decode of its stream and
    the JAX grouped block."""
    n_frames = 3
    by_block = {block: make_flac(rng_seed=31 + block, depth=16, channels=2, block_size=block,
                                 n_frames=n_frames,
                                 plans=[[SubframePlan("lpc", order=6, fit=True)] * 2] * n_frames)[0]
                for block in (1024, 2048)}
    blobs = [by_block[1024] if i % 2 == 0 else by_block[2048] for i in range(6)]
    host = BatchedFLACDecoder(6, device="cpu")
    host_res = host.decode_streams(_bodies(host, blobs))
    assert all(r[1]["md5_ok"] for r in host_res)

    bat = BatchedFLACDecoder(6, device="cpu")
    with pytest.raises(ValueError, match="grouped"):
        bat.decode_streams_to_device(_bodies(bat, blobs))
    bat2 = BatchedFLACDecoder(6, device="cpu")
    group_list, results = bat2.decode_streams_to_device_grouped(_bodies(bat2, blobs))
    jbat = JaxBatched(6)
    jgroups, jresults = jbat.decode_streams_to_device_grouped(_bodies(jbat, blobs))
    assert [ids for ids, _ in group_list] == [ids for ids, _ in jgroups]
    assert len(group_list) == 2 and results == jresults
    for (ids, pcm_dev), (_, jpcm) in zip(group_list, jgroups):
        np.testing.assert_array_equal(pcm_dev.numpy(), np.asarray(jpcm))
        for k, s in enumerate(ids):
            np.testing.assert_array_equal(pcm_dev[k].numpy(),
                                          np.frombuffer(host_res[s][0], np.uint8))


def test_composed_chain_matches_jax_and_host_roundtrip():
    """FLAC fleet -> device PCM -> Resampler 44.1 -> 16 kHz: the port's
    device chain is byte-identical to its host-roundtrip chain and within
    1 LSB of JAX's chain, with equal generated counts."""
    B, n_frames, block = 4, 4, 1024
    blob, _ = make_flac(rng_seed=1, depth=16, channels=2, block_size=block, n_frames=n_frames,
                        plans=[[SubframePlan("lpc", order=8, fit=True)] * 2] * n_frames)
    frames = n_frames * block
    args = (44100.0, 16000.0, 16, 16, 2, True, True, 64, 32)

    bat = BatchedFLACDecoder(B, device="cpu")
    host = bat.decode_streams(_bodies(bat, [blob] * B), verify_md5=True)
    assert all(r["md5_ok"] for _, r in host)
    pcm_host = np.stack([np.frombuffer(p, np.uint8) for p, _ in host])
    bat2 = BatchedFLACDecoder(B, device="cpu")
    pcm_dev, _ = bat2.decode_streams_to_device(_bodies(bat2, [blob] * B))
    np.testing.assert_array_equal(pcm_dev.numpy(), pcm_host)

    outs = []
    for pcm in (pcm_dev, torch.from_numpy(pcm_host)):
        r = Resampler(batch=B, exact=False, device="cpu")
        r.initialize(ResamplerConfiguration(*args))
        outs.append(r.resample_stream(pcm, frames, 1))
    (od, gd, cd), (oh, gh, ch) = outs
    assert gd == gh
    assert torch.equal(od, oh) and np.array_equal(cd, ch)

    jbat = JaxBatched(B)
    jpcm, _ = jbat.decode_streams_to_device(_bodies(jbat, [blob] * B))
    jr = JaxResampler(batch=B, exact=False)
    jr.initialize(JaxConfig(*args))
    oj, gj, _ = jr.resample_stream(jpcm, frames, 1)
    assert list(gj) == list(gd)
    a = np.asarray(oj).view(np.int16).astype(np.int32)
    b = od.numpy().view(np.int16).astype(np.int32)
    assert a.shape == b.shape and np.abs(a - b).max() <= 1


def test_state_exchanges_between_packages():
    """A stream whose header was read by one package continues in the
    other: FLACDecoder and BatchedFLACDecoder states load both ways (the
    native blob is the shared library's)."""
    blobs = _fleet_blobs()[:3]
    jbat = JaxBatched(len(blobs))
    bodies = _bodies(jbat, blobs)
    pbat = BatchedFLACDecoder(len(blobs), device="cpu")
    pbat.set_state(jbat.get_state())
    state = pbat.get_state()
    assert state == jbat.get_state()
    got = pbat.decode_streams(bodies)
    want = JaxBatched(len(blobs))
    want.set_state(state)
    assert got == want.decode_streams(bodies)
    assert all(r["md5_ok"] for _, r in got)
    with pytest.raises(ValueError, match="streams"):
        BatchedFLACDecoder(2, device="cpu").set_state(jbat.get_state())

    d = FLACDecoder(device="cpu")
    assert d.read_header(blobs[0]) == FLACDecoderResult.SUCCESS
    d.set_output_32bit_samples(True)
    j = jax_flac.FLACDecoder()
    j.set_state(d.get_state())
    assert j._output_32bit and j.sample_rate == d.sample_rate
    assert j.get_bytes_index() == d.get_bytes_index()


def test_no_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device='cuda' is valid here")
    for make in (FLACDecoder, lambda: BatchedFLACDecoder(2)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    with pytest.raises(RuntimeError, match="CUDA"):
        port_flac.decode_streams_to_device([], [])
    with pytest.raises(ValueError, match="device"):
        FLACDecoder(device="meta")


def test_pack_params_and_wrapper_routing():
    assert fk.pack_params(8, False) == (1, 0, 128)
    assert fk.pack_params(12, False) == (2, 4, 0)
    assert fk.pack_params(20, True) == (4, 12, 0)
    assert fk.pack_params(32, False) == (4, 0, 0)
    with pytest.raises(ValueError, match="depth"):
        fk.pack_params(33, False)
    arrays = [torch.zeros((1, 2, 8), dtype=torch.int16)] + [
        torch.zeros(s, dtype=torch.int32) for s in ((1, 2, 32), (1, 2), (1, 2), (1, 2), (1,))]
    fk.reset_launch_counts()
    out = fk.flac_frame_cuda(*arrays, depth=16, nch=2, mode32=False, max_order=4)
    assert out.shape == (1, 8 * 2 * 2) and fk.flac_frame_cuda.launches == 0
    with pytest.raises(ValueError, match="device"):
        fk.flac_frame_cuda(*(a.to("meta") for a in arrays), depth=16, nch=2, mode32=False)


def test_transport_sideband_and_parse_threads(monkeypatch):
    vals = np.zeros((1, 64), np.int32)
    vals[0, [3, 9, 40]] = [-300, 200, 999]
    (pos,), (val,) = transport.escape_sideband_blocked(vals != 0, vals, np.int32)
    assert pos.tolist() == [3, 9, 40] + [64] * 13 and val[:3].tolist() == [-300, 200, 999]
    mask = np.zeros((1, 99), bool)
    mask[0, :17] = True
    assert transport.escape_sideband_blocked(mask, mask.astype(np.int32), np.int32)[0].size == 32
    monkeypatch.delenv("EAL_PARSE_THREADS", raising=False)
    monkeypatch.setattr(os, "cpu_count", lambda: 8)
    assert port_flac._parse_thread_count(10) == 1
    assert port_flac._parse_thread_count(256) == 8
    assert port_flac._parse_thread_count(100) == 3
    monkeypatch.setenv("EAL_PARSE_THREADS", "16")
    assert port_flac._parse_thread_count(2) == 2
    for n in (0, 4, 5, 12, 13, 16, 17, 32, 33):
        assert port_flac._order_class(np.array([n])) == jax_flac._order_class(np.array([n]))
