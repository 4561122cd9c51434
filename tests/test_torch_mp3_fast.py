"""Port parity of the MP3 relaxed tiers (``fast="mirror"`` and ``fast="mxu"``)
with the JAX package, on the CPU.

Stage by stage on the same inputs: the f32 dequantizer and joint stereo on
every stage-test case (``dequantize_granule_fast``), the f32 hybrid IMDCT
(``imdct_granule_fast``) and the FIFO scan before quantization
(``_subband_scan_acc``), values within rtol 1e-5 of each tensor's largest
magnitude (f32 in another order of operations: XLA on the CPU contracts
FMAs and flushes subnormals, torch does neither); ``subband_granule_fast``'s
PCM within 1 LSB. The probed operators of the MXU tier (``AX``, ``PX``,
``S``, ``W``, ``keep``) against JAX's ``mxu_operators()``: shapes equal,
``keep`` exactly, the rest within 1e-6 of each operator's largest magnitude.
Then each port tier against JAX's same tier on the window matrix of
tests/test_mp3_fast.py (five stereo modes, every window shape over charged
state): PCM within 1 LSB, errors, consumed bytes and ``next_pos`` identical;
the same decodes within 1 LSB of the port's exact tier; the ``fast=``
mapping; and a port fleet snapshot of each relaxed tier loaded into a JAX
fleet of the same tier, continuing within 1 LSB of the port's uninterrupted
run (the other way: tests/test_torch_mp3_state.py).

JAX's ``BatchedMP3Decoder`` keeps ``bool(fast)``, so its ``fast="mirror"``
runs the MXU tier; its mirror tier is reached by setting the fleet's
``fast`` attribute to ``"mirror"`` after constructing it with ``fast=True``
(f32 state), which the tests do. The port's tier contract against its own
exact tier is tests/test_torch_mp3_fast_contract.py.
"""

import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esp_audio_libs_tpu.models import mp3_pipeline as jpipe
from esp_audio_libs_tpu.models.batch import BatchedMP3Decoder as JaxBatched
from esp_audio_libs_tpu.ops import mp3fast as jfast
from esp_audio_libs_tpu.ops import mp3mxu as jmxu
from esp_audio_libs_tpu_torch.models import mp3_pipeline as tpipe
from esp_audio_libs_tpu_torch.models.batch import BatchedMP3Decoder
from esp_audio_libs_tpu_torch.ops import mp3fast as tfast
from esp_audio_libs_tpu_torch.ops import mp3mxu as tmxu
from tests.test_mp3_stages import CASES
from tests.test_torch_mp3 import _hp_lanes

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
import mp3frames as mf  # noqa: E402

torch.set_num_threads(2)

RTOL = 1e-5     # of each tensor's largest magnitude: f32 stages in another order
OP_TOL = 1e-6   # of each probed operator's largest magnitude
TOL = 1         # int16 LSB
TIERS = ["mirror", "mxu"]

# tests/test_mp3_fast.py STEREO_CASES
STEREO_CASES = [
    ("stereo", dict(mode=0, mode_ext=0)),
    ("joint_is", dict(mode=1, mode_ext=1)),
    ("joint_ms", dict(mode=1, mode_ext=2)),
    ("joint_ms_is", dict(mode=1, mode_ext=3)),
    ("mono", dict(mode=3, mode_ext=0)),
]


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _close(got, want, what, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-30)
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= rtol * scale, f"{what}: max |d| {err:.3g} > {rtol} x {scale:.3g}"


def _assert_tol(a, b, what, tol=TOL):
    a, b = np.asarray(a, np.int32), np.asarray(b, np.int32)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    d = np.abs(a - b)
    assert d.max(initial=0) <= tol, (what, int(d.max()), float(d.mean()))


def windows_stream(cfg, seed):
    """Tonal frames interleaved with every window shape (tests/test_mp3_fast.py
    ``_windows_stream``): the window transitions fire over charged state."""
    rng = np.random.default_rng(seed)
    frames = []
    for bt, mixed in mf.WINDOWS:
        frames.append(mf.craft_tonal_frame(cfg, rng))
        frames.append(mf.crafted_frame(cfg, bt, mixed, rng))
    return b"".join(frames)


def run_pcm(dec, stream, n_frames=16):
    """(pcm, errors, consumed, next_pos) of one decode_run of one stream."""
    res = dec.decode_run([stream], n_frames)
    frames = res[0]
    pcm = [np.asarray(p) for (e, p, c) in frames if p is not None]
    return (np.concatenate(pcm) if pcm else np.zeros(0, np.int16),
            [int(e) for (e, p, c) in frames], [int(c) for (e, p, c) in frames], res.next_pos[0])


def jax_fleet(n, tier):
    """A JAX fleet of ``tier``: ``fast=True`` (f32 state), then its tier."""
    if tier == "exact":
        return JaxBatched(n)
    dec = JaxBatched(n, fast=True)
    dec.fast = tier
    return dec


def matrix_stream(name):
    mm = dict(STEREO_CASES)[name]
    cfg = dict(ver_bits=3, bitrate_idx=9, sr_idx=0, **mm)
    return windows_stream(cfg, seed=10 * mm["mode"] + mm["mode_ext"])


@functools.lru_cache(None)
def matrix_decode(name, package, tier):
    stream = matrix_stream(name)
    dec = (BatchedMP3Decoder(1, device="cpu", fast=tier) if package == "port"
           else jax_fleet(1, tier))
    return run_pcm(dec, stream)


# ------------------------------------------------------------------ stages


@pytest.mark.parametrize("case_i", range(len(CASES)))
def test_dequantize_granule_fast_matches_jax(case_i):
    """The f32 dequantizer, short-block reorder and joint stereo on random
    granules of every stage-test case (every block type, mixed blocks, MS,
    intensity, MPEG-1/2/2.5), one lane all-zero with INT_MIN entries."""
    case = CASES[case_i]
    huff, nzb, hp = _hp_lanes(case, 30 + case_i, zero_lane=True)
    nch = case["nch"]
    sfb_s = tuple(int(v) for v in hp["sfb_s"][0])
    want = jfast.dequantize_granule_fast(jnp.asarray(huff), jnp.asarray(nzb),
                                         {k: jnp.asarray(v) for k, v in hp.items()}, nch=nch,
                                         sfb_s=sfb_s)
    got = tfast.dequantize_granule_fast(_t(huff), _t(nzb), {k: _t(v) for k, v in hp.items()},
                                        nch=nch)
    assert got.keys() == want.keys()
    _close(got["x"], want["x"], "x")
    np.testing.assert_array_equal(got["nzb"].numpy(), np.asarray(want["nzb"]))


def test_imdct_granule_fast_matches_jax():
    """Every (block type, mixed, previous type, window switch) over 64
    lanes, every block-count branch including window-previous-only, random
    f32 samples and carried overlap."""
    rng = np.random.default_rng(8)
    L = 64
    amp = rng.choice([1e2, 1e5, 1e8], (L, 1))
    x = (rng.standard_normal((L, 576)) * amp).astype(np.float32)
    xprev = (rng.standard_normal((L, 32, 9)) * 1e6).astype(np.float32)
    xprev[::5] = 0
    nzb = rng.integers(0, 577, L).astype(np.int32)
    x[np.arange(576)[None, :] >= nzb[:, None]] = 0
    bt = np.tile(np.arange(4, dtype=np.int32), L // 4)
    mixed = ((np.arange(L) // 4) % 2 == 1).astype(np.int32) * (bt == 2)
    pt = rng.integers(0, 4, L).astype(np.int32)
    cutoff = np.full(L, 2, np.int32)
    pws = np.where(rng.random(L) < 0.5, 0, 2).astype(np.int32)
    npv = rng.integers(0, 33, L).astype(np.int32)
    args = (x, xprev, nzb, bt, mixed, pt, pws, cutoff, npv)
    want = jfast.imdct_granule_fast(*map(jnp.asarray, args))
    got = tfast.imdct_granule_fast(*map(_t, args))
    _close(got[0], want[0], "out")
    _close(got[1], want[1], "new_xprev")
    for k in (2, 3, 4):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=f"output {k}")


@pytest.mark.parametrize("nch", [1, 2])
def test_subband_fast_matches_jax(nch):
    """FDCT32 and the f32 FIFO at every phase: the accumulators before
    quantization and the new ring within RTOL, the PCM within 1 LSB."""
    rng = np.random.default_rng(20 + nch)
    L = 6
    outbuf = (rng.standard_normal((L, nch, 18, 32)) * 2e5).astype(np.float32)
    vbuf = (rng.standard_normal((L, 2176)) * 2e5).astype(np.float32)
    scan_acc = jax.jit(functools.partial(jfast._subband_scan_acc, nch=nch))
    for vindex in range(8):
        want = scan_acc(jnp.asarray(outbuf), jnp.asarray(vbuf), jnp.int32(vindex))
        got = tfast._subband_scan_acc(_t(outbuf), _t(vbuf), vindex, nch=nch)
        _close(got[0], want[0], f"acc vindex={vindex}")
        _close(got[1], want[1], f"vbuf vindex={vindex}")
        want_pcm, _ = jfast.subband_granule_fast(jnp.asarray(outbuf), jnp.asarray(vbuf),
                                                 jnp.int32(vindex), nch=nch)
        got_pcm, _ = tfast.subband_granule_fast(_t(outbuf), _t(vbuf), vindex, nch=nch)
        _assert_tol(got_pcm.numpy(), np.asarray(want_pcm), f"pcm vindex={vindex}")
        assert 0 < np.mean(np.abs(np.asarray(want_pcm, np.int32)) < 32767)


def test_mxu_operators_match_jax():
    """The port's operators, probed from its own mirror on the CPU, against
    JAX's: AX [18, 108] (A36 x 4 | A12 | C36 | C12), PX [9, 72], S [8, 1664,
    576], W [8, 576, 1088], keep [8, 1088]. Probed afresh here, never read
    from a cache, so that the port's probe itself is held to JAX's."""
    ours, theirs = tmxu.probe_operators(), jmxu.mxu_operators()
    assert ours.keys() == theirs.keys() == {"AX", "PX", "S", "W", "keep"}
    assert ours["AX"].shape == (18, 108)
    for k in ours:
        want = np.asarray(theirs[k])
        assert ours[k].shape == want.shape, k
        if k == "keep":
            np.testing.assert_array_equal(ours[k], want)
        else:
            _close(ours[k], want, k, rtol=OP_TOL)


def test_mxu_granule_functions_match_jax():
    """``imdct_granule_mxu`` and ``subband_granule_mxu`` with the port's
    operators against JAX's functions with JAX's, on the IMDCT stage test's
    inputs and a stereo FIFO at two phases."""
    rng = np.random.default_rng(9)
    L = 16
    x = (rng.standard_normal((L, 576)) * 1e6).astype(np.float32)
    xprev = (rng.standard_normal((L, 32, 9)) * 1e6).astype(np.float32)
    nzb = rng.integers(0, 577, L).astype(np.int32)
    bt = np.tile(np.arange(4, dtype=np.int32), L // 4)
    mixed = ((np.arange(L) // 4) % 2 == 1).astype(np.int32) * (bt == 2)
    pt = rng.integers(0, 4, L).astype(np.int32)
    pws = np.where(rng.random(L) < 0.5, 0, 2).astype(np.int32)
    npv = rng.integers(0, 33, L).astype(np.int32)
    args = (x, xprev, nzb, bt, mixed, pt, pws, np.full(L, 2, np.int32), npv)
    jops, tops = jmxu.mxu_operators(), tmxu.device_operators(torch.device("cpu"))
    want = jmxu.imdct_granule_mxu(*map(jnp.asarray, args), jops)
    got = tmxu.imdct_granule_mxu(*map(_t, args), tops)
    _close(got[0], want[0], "out")
    _close(got[1], want[1], "new_xprev")
    for k in (2, 3, 4):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=f"output {k}")
    outbuf = (rng.standard_normal((4, 2, 18, 32)) * 2e5).astype(np.float32)
    vbuf = (rng.standard_normal((4, 2176)) * 2e5).astype(np.float32)
    for vindex in (3, 4):
        want = jmxu.subband_granule_mxu(jnp.asarray(outbuf), jnp.asarray(vbuf),
                                        jnp.int32(vindex), jops, nch=2)
        got = tmxu.subband_granule_mxu(_t(outbuf), _t(vbuf), vindex, tops, nch=2)
        _assert_tol(got[0].numpy(), np.asarray(want[0]), f"pcm vindex={vindex}")
        _close(got[1], want[1], f"vbuf vindex={vindex}")


# -------------------------------------------------------------- the tiers


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("name", [n for n, _ in STEREO_CASES])
def test_tier_matches_jax_window_matrix(name, tier):
    """Each port tier against JAX's same tier: every window shape over
    charged state, five stereo modes: PCM within 1 LSB, identical errors,
    consumed bytes and next_pos."""
    pcm, errs, cons, nxt = matrix_decode(name, "port", tier)
    pcm_j, errs_j, cons_j, nxt_j = matrix_decode(name, "jax", tier)
    assert errs == errs_j and cons == cons_j and nxt == nxt_j
    assert np.any(pcm)
    _assert_tol(pcm, pcm_j, f"{name} {tier}")


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("name", [n for n, _ in STEREO_CASES])
def test_tier_window_matrix_against_exact(name, tier):
    """The tier contract of tests/test_mp3_fast.py on the port: within 1 LSB
    of the port's exact tier, identical errors, consumed bytes, next_pos."""
    pcm, errs, cons, nxt = matrix_decode(name, "port", tier)
    pcm_e, errs_e, cons_e, nxt_e = matrix_decode(name, "port", "exact")
    assert errs == errs_e and cons == cons_e and nxt == nxt_e
    _assert_tol(pcm, pcm_e, f"{name} {tier} vs exact")


def test_fast_mapping():
    """``fast=``: False / None exact, True and "mxu" the MXU tier, "mirror"
    the mirror tier; anything else raises. The fleet routes each to its
    scan and keeps f32 overlap and FIFO under both relaxed tiers."""
    assert tpipe._tier(False) == tpipe._tier(None) == "exact"
    assert tpipe._tier(True) == tpipe._tier("mxu") == "mxu"
    assert tpipe._tier("mirror") == "mirror"
    for fast in (False, None, True, "mirror", "mxu"):
        assert tpipe._tier(fast) == jpipe._tier(fast)
    with pytest.raises(ValueError, match="fast"):
        tpipe._tier("fp16")
    assert tpipe._scan_builder("mirror") is tpipe._granules_scan_fast_for
    assert tpipe._scan_builder("mxu") is tpipe._granules_scan_mxu_for
    for fast, tier, dtype in ((False, "exact", torch.int32), (True, "mxu", torch.float32),
                              ("mxu", "mxu", torch.float32),
                              ("mirror", "mirror", torch.float32)):
        dec = BatchedMP3Decoder(2, device="cpu", fast=fast)
        assert dec.tier == tier
        assert dec._over.dtype == dec._vbuf.dtype == dtype
        assert dec._pt.dtype == dec._pws.dtype == dec._npv.dtype == torch.int32


def _head_tail():
    rng = np.random.default_rng(5)
    cfg = dict(ver_bits=3, bitrate_idx=9, sr_idx=0, mode=0, mode_ext=0)
    frames = [mf.craft_tonal_frame(cfg, rng) for _ in range(6)]
    return b"".join(frames[:3]), b"".join(frames[3:])


@pytest.mark.parametrize("tier", TIERS)
def test_port_fast_snapshot_into_jax_fast_fleet(tier):
    """The other way: a port fleet of the tier snapshots (f32 overlap and
    FIFO), a JAX fleet of the same tier loads it and continues within 1 LSB
    of the port's uninterrupted run."""
    head, tail = _head_tail()
    port = BatchedMP3Decoder(1, device="cpu", fast=tier)
    port.decode_run([head], 3)
    snap = port.get_state()
    assert snap["vbuf"].dtype == np.float32 and snap["over"].dtype == np.float32
    pcm, errs, cons, nxt = run_pcm(port, tail, 3)
    jd = jax_fleet(1, tier)
    jd.set_state(snap)
    pcm_j, errs_j, cons_j, nxt_j = run_pcm(jd, tail, 3)
    assert errs == errs_j and cons == cons_j and nxt == nxt_j
    _assert_tol(pcm, pcm_j, f"port {tier} snapshot -> JAX")
