"""Port parity of the stream mesh: parallel/mesh.py, the two sharded
contraction wrappers and ``Resampler(mesh=...)``, against the JAX package.

The JAX functions run on ``stream_mesh(jax.devices()[:8])``, the 8 virtual
CPU devices of tests/conftest.py; the port runs on ``stream_mesh(["cpu"] *
8)``, one CPU device named eight times (its counterpart of XLA's virtual
devices), with the same numpy inputs. Tolerances:

- ``polyphase_banded_sharded`` against ``polyphase_banded_pallas_sharded``
  (``interpret=True``): rtol 2e-6, atol 4e-5 (f32 sums of ~300 products in
  another order, tests/test_polyphase_banded.py:131);
- ``polyphase_fused16_sharded`` against ``polyphase_fused16_pallas_sharded``:
  bit-equal samples and clip masks;
- the port's sharded forms against its single-device wrappers, and the mesh
  ``Resampler`` against the single-device one: byte-equal (torch's CPU
  contraction of a row does not depend on the other rows);
- the mesh ``Resampler`` against JAX's mesh ``Resampler``: fast mode within
  1 LSB (tests/test_batch_sharded.py:284-290); exact mode within 1 LSB in
  under 2 % of samples, the contract of tests/test_torch_exact_resampler.py
  (XLA on the CPU contracts the subsample lerp into an FMA), byte-equal
  where no lerp reaches the output;
- state: the history bit-equal in every direction, the biquad states
  bit-equal where no lerp output reaches them (downsampling) and within
  rtol 1e-5 otherwise.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import esp_audio_libs_tpu_torch.models.resampler as rmod
from esp_audio_libs_tpu.models.resampler import Resampler as JaxResampler
from esp_audio_libs_tpu.models.resampler import ResamplerConfiguration as JaxConfig
from esp_audio_libs_tpu.ops.polyphase_pallas import (polyphase_banded_pallas_sharded,
                                                     polyphase_fused16_pallas_sharded)
from esp_audio_libs_tpu.parallel.mesh import stream_mesh as jax_stream_mesh
from esp_audio_libs_tpu_torch.models import Resampler, ResamplerConfiguration
from esp_audio_libs_tpu_torch.ops import polyphase_kernels as pk
from esp_audio_libs_tpu_torch.parallel.mesh import (Sharded, shard_streams, shard_streams_axis,
                                                    stream_mesh)
from tests.test_torch_kernels import hot_pcm

N = 8
CFG = (44100.0, 16000.0, 16, 16, 2, True, True, 64, 32)


@pytest.fixture(scope="module")
def jmesh():
    assert len(jax.devices()) >= N, "conftest should provide 8 virtual devices"
    return jax_stream_mesh(jax.devices()[:N])


@pytest.fixture(scope="module")
def mesh():
    return stream_mesh(["cpu"] * N)


def _s16(packed) -> np.ndarray:
    if isinstance(packed, Sharded):
        packed = packed.gather("cpu")
    return np.asarray(packed).view(np.int16).astype(np.int32)


def _pcm(seed, B, n):
    rng = np.random.default_rng(seed)
    return rng.integers(-8192, 8192, (B, n)).astype(np.int16).view(np.uint8).reshape(B, -1)


# ------------------------------------------------------------------ the mesh


def test_stream_mesh_devices(monkeypatch):
    m = stream_mesh(["cpu"] * 3)
    assert m.size == 3 and m.type == "cpu" and m.distinct() == [torch.device("cpu")]
    with pytest.raises(ValueError, match="all cpu or all cuda"):
        stream_mesh(["cpu", "cuda:0"])
    with pytest.raises(ValueError, match="no devices"):
        stream_mesh([])
    with pytest.raises(ValueError, match="unsupported device"):
        stream_mesh(["meta"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        stream_mesh(["cuda:0"] * 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        stream_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        Resampler(8, exact=False, device="cuda", mesh=m)


def test_shard_streams_split_and_gather(mesh):
    x = torch.arange(16 * 3 * 5).reshape(16, 3, 5)
    s = shard_streams(x, mesh)
    assert s.shape == (16, 3, 5) and s.axis == 0 and len(s.parts) == N
    assert all(p.shape == (2, 3, 5) for p in s.parts)
    assert s.block_rows()[3] == (6, 8)
    assert torch.equal(s.gather(), x)
    assert shard_streams(s, mesh) is s
    g = shard_streams_axis(np.arange(3 * 16).reshape(3, 16), 1, mesh)
    assert g.axis == 1 and g.parts[1].tolist() == [[2, 3], [18, 19], [34, 35]]
    assert torch.equal(s.map(lambda p: p * 2).gather(), x * 2)
    with pytest.raises(ValueError, match="divide"):
        shard_streams(x[:12], mesh)
    with pytest.raises(ValueError, match="divide"):
        shard_streams_axis(x, 2, mesh)


# ------------------------------------------------------- the sharded wrappers


def test_banded_sharded_matches_jax(jmesh, mesh):
    rng = np.random.default_rng(17)
    B, ch, L, nt, K, tile = 16, 2, 2176, 4, 512, 128
    xext = rng.standard_normal((B, ch, L)).astype(np.float32)
    Wt = np.zeros((nt, K, tile), np.float32)
    for i in range(nt):
        for j in range(tile):
            o = rng.integers(0, K - 300)
            Wt[i, o:o + 300, j] = rng.standard_normal(300).astype(np.float32)
    starts = np.minimum(np.arange(nt) * 256, L - K).astype(np.int32)
    T = nt * tile - 50
    want = np.asarray(polyphase_banded_pallas_sharded(
        jnp.asarray(xext), jnp.asarray(Wt), jnp.asarray(starts), T=T, mesh=jmesh,
        interpret=True))
    x_t, W_t, s_t = map(torch.from_numpy, (xext, Wt, starts))
    got = pk.polyphase_banded_sharded(x_t, W_t, s_t, T=T, mesh=mesh)
    assert isinstance(got, Sharded) and got.shape == (B, ch, T)
    np.testing.assert_allclose(got.gather().numpy(), want, rtol=2e-6, atol=4e-5)
    # each shard is the single-device wrapper on its own block
    one = pk.polyphase_banded_cuda(x_t, W_t, s_t, T=T)
    assert torch.equal(got.gather(), one)
    # an input already split over the mesh, and a shared (stride-0) weight tile
    Wb = W_t[:1].expand(nt, K, tile)
    assert torch.equal(pk.polyphase_banded_sharded(shard_streams(x_t, mesh), Wb, s_t, T=T,
                                                   mesh=mesh).gather(),
                       pk.polyphase_banded_cuda(x_t, Wb, s_t, T=T))
    assert pk.polyphase_banded_cuda.launches == 0    # CPU tensors: plain versions only
    with pytest.raises(ValueError, match="divide"):
        pk.polyphase_banded_sharded(x_t[:6], W_t, s_t, T=T, mesh=mesh)


def test_fused16_sharded_matches_jax(jmesh, mesh):
    rng = np.random.default_rng(31)
    M, L, nt, K, tile = 128, 1024, 3, 512, 128        # local block: 16 rows
    x = rng.integers(-32768, 32768, (M, L), dtype=np.int16)
    Wt = (rng.standard_normal((nt, K, tile)) * 0.02).astype(np.float32)
    Wt[:, 300:, :] = 0.0
    Wt[0, :300, 5] = 1e6      # an int32-overflow column: x86 INT_MIN clip semantics
    starts = np.array([0, 128, 256], np.int32)
    Wf = Wt * np.float32(1.0 / 32768.0)
    s_want, c_want = polyphase_fused16_pallas_sharded(
        jnp.asarray(x), jnp.asarray(Wf), jnp.asarray(starts), mesh=jmesh, interpret=True)
    x_t, W_t, st_t = torch.from_numpy(x), torch.from_numpy(Wf), torch.from_numpy(starts)
    s_got, c_got = pk.polyphase_fused16_sharded(x_t, W_t, st_t, mesh=mesh)
    np.testing.assert_array_equal(s_got.gather().numpy(), np.asarray(s_want))
    np.testing.assert_array_equal(c_got.gather().numpy(), np.asarray(c_want))
    assert (c_got.gather()[:, 5] > 0).all()
    s_one, c_one = pk.polyphase_fused16_cuda(x_t, W_t, st_t)
    assert torch.equal(s_got.gather(), s_one) and torch.equal(c_got.gather(), c_one)
    with pytest.raises(ValueError, match="divide"):
        pk.polyphase_fused16_sharded(x_t[:116], W_t, st_t, mesh=mesh)
    with pytest.raises(ValueError, match="sublane minimum"):
        pk.polyphase_fused16_sharded(x_t[:64], W_t, st_t, mesh=mesh)


# ------------------------------------------------------------ Resampler(mesh)


def _spy(monkeypatch, name):
    calls = []
    real = getattr(rmod, name)

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(rmod, name, spy)
    return calls


def _port(B, mesh, exact=False, cfg=CFG):
    r = Resampler(B, exact=exact, device="cpu", mesh=mesh)
    r.initialize(ResamplerConfiguration(*cfg))
    return r


def test_resampler_mesh_routes_to_sharded(monkeypatch, mesh):
    """Port of tests/test_polyphase_banded.py::
    test_resampler_mesh_routes_to_sharded_pallas: under a mesh the fast path
    goes through the sharded wrapper, once per chunk, byte-equal to the
    single-device path, its state split over the mesh."""
    B, frames, n_chunks = 16, 512, 2
    data = _pcm(29, B, n_chunks * frames * 2)
    single = _port(B, None)
    p1, g1, c1 = single.resample_stream(data, frames, n_chunks)
    calls = _spy(monkeypatch, "polyphase_banded_sharded")
    sharded = _port(B, mesh)
    p2, g2, c2 = sharded.resample_stream(data, frames, n_chunks)
    assert len(calls) == n_chunks
    assert isinstance(p2, Sharded) and p2.axis == 1 and p2.shape == tuple(p1.shape)
    assert isinstance(sharded.history, Sharded)
    assert list(g1) == list(g2)
    np.testing.assert_array_equal(_s16(p1), _s16(p2))
    np.testing.assert_array_equal(c1, c2)
    np.testing.assert_array_equal(single.history.numpy(), sharded.history.gather().numpy())


def test_resampler_mesh_fused16_routes_sharded(monkeypatch, mesh):
    """Port of test_resampler_mesh_fused16_routes_sharded: B * ch / 8 = 16
    rows a shard, the fused tier goes through the sharded fused wrapper;
    packed samples equal the single-device fused tier's, counts zero, the
    carried history bit-exact."""
    monkeypatch.setenv("EAL_RESAMPLE_FUSED16", "1")
    B, frames, n_chunks = 64, 512, 2
    data = _pcm(37, B, n_chunks * frames * 2)
    single = _port(B, None)
    p1, g1, c1 = single.resample_stream(data, frames, n_chunks)
    calls = _spy(monkeypatch, "polyphase_fused16_sharded")
    sharded = _port(B, mesh)
    p2, g2, c2 = sharded.resample_stream(data, frames, n_chunks)
    assert len(calls) == n_chunks
    assert list(g1) == list(g2)
    np.testing.assert_array_equal(_s16(p1), _s16(p2))
    assert c1.sum() == 0 and c2.sum() == 0
    np.testing.assert_array_equal(single.history.numpy(), sharded.history.gather().numpy())


def test_resampler_mesh_fused16_indivisible_local_block_falls_back(monkeypatch, mesh):
    """Port of test_resampler_mesh_fused16_indivisible_local_block_falls_back:
    B * ch / 8 = 4 rows a shard is below the 16-row minimum, so the tier gate
    picks the f32 sharded path, as JAX's gate does."""
    monkeypatch.setenv("EAL_RESAMPLE_FUSED16", "1")
    B, frames = 16, 512
    fused = _spy(monkeypatch, "polyphase_fused16_sharded")
    banded = _spy(monkeypatch, "polyphase_banded_sharded")
    r = _port(B, mesh)
    assert not r._fused_tier_selected(True)
    p, g, c = r.resample_stream(_pcm(41, B, frames * 2), frames, 1)
    assert not fused and len(banded) == 1
    assert p.shape[0] == 1


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("src,dst", [(44100.0, 16000.0), (16000.0, 44100.0)])
def test_resampler_mesh_matches_jax_mesh(jmesh, mesh, exact, src, dst):
    """The mesh Resampler of each package on the same bytes, two calls in a
    row: exact byte-equal, fast within 1 LSB; the port's also byte-equal to
    its own single-device Resampler; states equal."""
    B, frames, n_chunks = 8, 512, 2
    cfg = (src, dst, *CFG[2:])
    j = JaxResampler(batch=B, exact=exact, mesh=jmesh)
    j.initialize(JaxConfig(*cfg))
    t, one = _port(B, mesh, exact, cfg), _port(B, None, exact, cfg)
    for call in range(2):
        data = _pcm(100 + call, B, n_chunks * frames * 2)
        pj, gj, cj = j.resample_stream(jnp.asarray(data), frames, n_chunks)
        pt, gt, ct = t.resample_stream(data, frames, n_chunks)
        po, _, co = one.resample_stream(data, frames, n_chunks)
        assert list(gj) == list(gt)
        np.testing.assert_array_equal(_s16(pt), _s16(po))
        np.testing.assert_array_equal(ct, co)
        d = np.abs(_s16(pt) - np.asarray(pj).view(np.int16).astype(np.int32))
        assert d.max() <= 1, f"call {call}"
        if exact:
            assert (d > 0).mean() < 0.02, f"call {call}"
    sj, st = j.get_state(), t.get_state()
    np.testing.assert_array_equal(st["history"], sj["history"])
    if exact:
        for stage_j, stage_t in zip(sj["biquad"], st["biquad"]):
            for a, b in zip(stage_j, stage_t):
                if src > dst:      # the biquads run before the polyphase
                    np.testing.assert_array_equal(a, b)
                else:
                    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-30)


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("src,dst", [(44100.0, 16000.0), (16000.0, 44100.0)])
def test_resample_stream_outputs_and_clips_match_jax(jmesh, mesh, src, dst, exact, split):
    """resample_stream's packed output (one uint8 [chunks, B, out_max * 4]
    buffer the chunks quantize into, split along the stream axis 1 under the
    mesh), generated counts and per-stream clip counts, with and without the
    CPU mesh, on hot input whose clip counts are nonzero, two calls in a row:
    against JAX's Resampler with the same mesh or none (exact mode without
    subsample interpolation byte for byte and every clip count equal; fast
    mode within 1 LSB), and against the port's other layout byte for byte."""
    B, frames, n_chunks = 8, 512, 3
    cfg = (src, dst, 16, 16, 2, True, not exact, 64, 32)
    j = JaxResampler(batch=B, exact=exact, mesh=jmesh if split else None)
    j.initialize(JaxConfig(*cfg))
    t, other = _port(B, mesh if split else None, exact, cfg), _port(B, None if split else mesh,
                                                                  exact, cfg)
    for call in range(2):
        data = hot_pcm(call, B, n_chunks * frames)
        pj, gj, cj = j.resample_stream(jnp.asarray(data), frames, n_chunks)
        pt, gt, ct = t.resample_stream(data, frames, n_chunks)
        po, go, co = other.resample_stream(data, frames, n_chunks)
        assert isinstance(pt, Sharded) == split and (not split or pt.axis == 1)
        whole = pt.gather("cpu") if split else pt
        assert whole.dtype == torch.uint8 and tuple(whole.shape) == np.asarray(pj).shape
        assert ct.dtype == np.uint32 and ct.shape == (n_chunks, B) and ct.sum() > 0
        assert list(gt) == list(gj) == list(go)
        np.testing.assert_array_equal(_s16(pt), _s16(po))
        np.testing.assert_array_equal(ct, co)
        d = np.abs(_s16(pt) - np.asarray(pj).view(np.int16).astype(np.int32))
        if exact:
            assert d.max() == 0, f"call {call}"
            np.testing.assert_array_equal(ct, np.asarray(cj))
        else:
            assert d.max() <= 1, f"call {call}"


def test_resampler_mesh_resample_matches_single(mesh):
    """The per-call ``resample`` under a mesh, both modes: byte-equal to the
    single-device Resampler, clip counts included."""
    B = 8
    for exact in (False, True):
        t, one = _port(B, mesh, exact), _port(B, None, exact)
        for seed in range(2):
            data = _pcm(7 + seed, B, 700 * 2)
            pt, rt = t.resample(data, 700, 300)
            po, ro = one.resample(data, 700, 300)
            np.testing.assert_array_equal(_s16(pt), _s16(po))
            assert (rt.frames_used, rt.frames_generated) == (ro.frames_used, ro.frames_generated)
            np.testing.assert_array_equal(rt.clipped_samples, ro.clipped_samples)


@pytest.mark.parametrize("exact", [False, True])
def test_resampler_state_moves_between_mesh_no_mesh_and_jax(jmesh, mesh, exact):
    """A checkpoint taken on the port's mesh loads with no mesh, into JAX's
    mesh Resampler, and back onto the port's mesh; each continues as an
    uninterrupted run does."""
    B, frames = 8, 512
    d0, d1, d2 = (_pcm(200 + k, B, frames * 2) for k in range(3))
    ref = _port(B, None, exact)
    ref.resample_stream(d0, frames, 1)
    want1 = _s16(ref.resample_stream(d1, frames, 1)[0])
    want2 = _s16(ref.resample_stream(d2, frames, 1)[0])

    src = _port(B, mesh, exact)
    src.resample_stream(d0, frames, 1)
    snap = src.get_state()
    plain = _port(B, None, exact)
    plain.set_state(snap)
    np.testing.assert_array_equal(_s16(plain.resample_stream(d1, frames, 1)[0]), want1)
    j = JaxResampler(batch=B, exact=exact, mesh=jmesh)
    j.initialize(JaxConfig(*CFG))
    j.set_state(plain.get_state())
    got_j = np.asarray(j.resample_stream(jnp.asarray(d2), frames, 1)[0])
    d = np.abs(got_j.view(np.int16).astype(np.int32) - want2)
    assert d.max() <= 1 and (d > 0).mean() < 0.02
    back = _port(B, mesh, exact)
    back.set_state(plain.get_state())
    assert isinstance(back.history, Sharded)
    np.testing.assert_array_equal(_s16(back.resample_stream(d2, frames, 1)[0]), want2)


def test_resampler_mesh_checks(mesh, monkeypatch):
    """Port of test_resampler_mesh_requires_even_division, with the port's
    device rules: the batch must divide the mesh, the mesh's device type must
    be the Resampler's, and a one-device mesh takes the single-device route."""
    with pytest.raises(ValueError, match="divide"):
        Resampler(3, device="cpu", mesh=stream_mesh(["cpu"] * 2))
    r = _port(8, stream_mesh(["cpu"]))
    assert r._poly() is pk.polyphase_banded_cuda
    assert isinstance(r.history, torch.Tensor)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="cpu mesh"):
        Resampler(8, device="cuda", mesh=mesh)
