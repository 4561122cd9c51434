"""The resampler's schedule prefetch (``models/resampler.py``): once a
``resample_stream`` call repeats the shape of the call before, it builds the
next call's schedule after issuing its own work, and the next call takes it
over when its key matches.

- Equal schedules: the device tuples a call consumes are bit for bit those
  of the synchronous build (the phase grid into fresh arrays, then the
  kernels' layout), and the outputs, clip counts and carried state equal
  those of a twin that never takes a prefetched schedule over.
- Misses: a new chunk size, a ``set_state``, a ``resample`` call in
  between, a phase moved in place and an ``initialize`` each miss and
  rebuild; the counters read the hits and misses.
- A speculative build that fails leaves its call's results intact; the next
  call builds at its head and raises there.
"""

import dataclasses

import numpy as np
import pytest
import torch

from esp_audio_libs_tpu_torch.models import Resampler, ResamplerConfiguration
from esp_audio_libs_tpu_torch.models import resampler as resampler_module
from esp_audio_libs_tpu_torch.ops.polyphase import TILE
from esp_audio_libs_tpu_torch.runtime.phase_grid import phase_grid

torch.set_num_threads(2)

B, FRAMES, CHUNKS, CALLS = 4, 256, 3, 5
RATES = {"down": (44100.0, 16000.0), "up": (16000.0, 44100.0)}
# each tier's chunk body: the chunk loop hands it one chunk's schedule tuple,
# its third argument
CONSUMER = {"exact": "_exact_chunk", "fast": "_fast_chunk", "fused": "_fused_chunk"}
CASES = [("down", "exact"), ("down", "fast"), ("down", "fused"), ("up", "exact"),
         ("up", "fast")]


def _resampler(direction: str, tier: str, monkeypatch) -> Resampler:
    if tier == "fused":
        monkeypatch.setenv("EAL_RESAMPLE_FUSED16", "1")
    r = Resampler(B, exact=tier == "exact", device="cpu")
    r.initialize(ResamplerConfiguration(*RATES[direction], 16, 16, 2, True, True, 64, 32))
    return r


def _pcm(call: int, frames: int = FRAMES, chunks: int = CHUNKS) -> np.ndarray:
    pcm = np.random.default_rng(100 + call).integers(-20000, 20000, (B, frames * chunks * 2))
    return pcm.astype(np.int16).view(np.uint8).reshape(B, -1)


def _out_max(r: Resampler, frames: int = FRAMES) -> int:
    return int(np.ceil(frames * float(r.sample_ratio))) + 8


def _synchronous_grids(r: Resampler, frames: int = FRAMES, chunks: int = CHUNKS) -> list:
    """The schedule of a call from ``r``'s phase as the synchronous build
    makes it: each chunk's grid into fresh arrays, then laid out for the
    tier (exact: win0 + hist_len; fast: rows padded to a tile multiple,
    win0 shifted by hist_len - fold offset, the pad repeating the last)."""
    phase, n = dataclasses.replace(r.phase), _out_max(r, frames)
    out = []
    for _ in range(chunks):
        g = phase_grid(phase, r.config.number_of_filters, r.bank_flags, r.sample_ratio,
                       frames, n)
        assert g.input_used == frames
        if r.exact:
            rows = [g.win0 + r.hist_len, g.idx1, g.idx2, g.mode.astype(np.int32)]
            weight = g.weight
        else:
            T = -(-n // TILE) * TILE
            rows = [np.zeros(T, np.int32) for _ in range(4)]
            weight = np.zeros(T, np.float32)
            rows[0][:n] = g.win0 + (r.hist_len - r._fold_offset)
            rows[0][n:] = rows[0][n - 1]
            rows[1][:n], rows[2][:n], rows[3][:n], weight[:n] = g.idx1, g.idx2, g.mode, g.weight
        out.append((rows[0], rows[1], rows[2], weight, rows[3]))
    return out


def _consumed(r: Resampler, tier: str) -> list:
    """Patches ``r`` so that its chunk loop appends each chunk's schedule
    tuple, as consumed, to the returned list (copied at once, in the
    stream's order: the device slots are reused)."""
    orig, seen = getattr(r, CONSUMER[tier]), []

    def grab(*args, **kw):
        seen.append(tuple(t.clone() for t in args[2]))
        return orig(*args, **kw)

    setattr(r, CONSUMER[tier], grab)
    return seen


def _same_bits(a, b) -> bool:
    a, b = (x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x) for x in (a, b))
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def _same_state(a: dict, b: dict) -> bool:
    if a.keys() != b.keys():
        return False
    for k in a:
        if k == "biquad":
            if not all(_same_bits(x, y) for sa, sb in zip(a[k], b[k]) for x, y in zip(sa, sb)):
                return False
        elif not _same_bits(a[k], b[k]):
            return False
    return True


@pytest.mark.parametrize("direction, tier", CASES)
def test_prefetched_schedule_equals_synchronous_build(direction, tier, monkeypatch):
    """Over 5 calls of one shape the calls consume, hit or miss, the
    synchronous build's schedule bit for bit, and give the outputs, clip
    counts and state of a twin that misses every call (``set_state`` drops
    the prefetch)."""
    r = _resampler(direction, tier, monkeypatch)
    twin = _resampler(direction, tier, monkeypatch)
    seen = _consumed(r, tier)
    for call in range(CALLS):
        want = _synchronous_grids(r)
        got = r.resample_stream(_pcm(call), FRAMES, CHUNKS)
        twin.set_state(twin.get_state())
        ref = twin.resample_stream(_pcm(call), FRAMES, CHUNKS)
        assert len(seen) == (call + 1) * CHUNKS
        for g_got, g_want in zip(seen[-CHUNKS:], want):
            assert all(_same_bits(a, b) for a, b in zip(g_got, g_want))
        assert _same_bits(got[0], ref[0])
        assert got[1] == ref[1]
        assert _same_bits(got[2], ref[2])
        assert _same_state(r.get_state(), twin.get_state())
    assert (r.schedule_hits, r.schedule_misses) == (CALLS - 2, 2)
    assert (twin.schedule_hits, twin.schedule_misses) == (0, CALLS)


def _twin_call(r: Resampler, st: dict, pcm, frames: int):
    """The call from state ``st`` on a fresh resampler of ``r``'s kind."""
    t = Resampler(B, exact=r.exact, device="cpu")
    t.initialize(r.config)
    t.set_state(st)
    return t.resample_stream(pcm, frames, CHUNKS)


def _hits(r: Resampler, call, *args) -> int:
    before = r.schedule_hits
    call(*args)
    return r.schedule_hits - before


@pytest.mark.parametrize("tier", ["exact", "fast"])
@pytest.mark.parametrize("direction", ["down", "up"])
def test_misses_rebuild_and_counters_read_them(direction, tier, monkeypatch):
    """Hits over calls 1-4 of one shape read 0 / 0 / 1 / 1 (the second call
    of a shape builds the third's schedule). A new chunk size, a
    ``set_state`` to another phase, a ``resample`` call, a phase moved in
    place and an ``initialize`` each miss, and the missed call's results
    equal a fresh resampler's from the same state."""
    r = _resampler(direction, tier, monkeypatch)

    def stream(call, frames=FRAMES):
        return r.resample_stream(_pcm(call, frames), frames, CHUNKS)

    assert [_hits(r, stream, c) for c in range(4)] == [0, 0, 1, 1]
    assert (r.schedule_hits, r.schedule_misses) == (2, 2)

    # a new chunk size misses, and its second call too; the third hits
    st = r.get_state()
    got = stream(4, FRAMES * 2)
    ref = _twin_call(r, st, _pcm(4, FRAMES * 2), FRAMES * 2)
    assert _same_bits(got[0], ref[0]) and got[1] == ref[1]
    assert [_hits(r, stream, c, FRAMES * 2) for c in (5, 6)] == [0, 1]

    # a set_state to another phase misses
    early = Resampler(B, exact=r.exact, device="cpu")
    early.initialize(r.config)
    early.resample_stream(_pcm(0), FRAMES, CHUNKS)
    other = early.get_state()
    assert other["phase_offset"] != r.get_state()["phase_offset"]
    r.set_state(other)
    assert r._prefetch is None
    got = stream(7, FRAMES * 2)
    ref = _twin_call(r, other, _pcm(7, FRAMES * 2), FRAMES * 2)
    assert _same_bits(got[0], ref[0]) and got[1] == ref[1]
    assert _same_bits(got[2], ref[2])
    assert _hits(r, stream, 8, FRAMES * 2) == 1

    # a resample() call in between misses
    r.resample(_pcm(9), FRAMES, FRAMES)
    assert _hits(r, stream, 10, FRAMES * 2) == 0
    assert _hits(r, stream, 11, FRAMES * 2) == 1

    # a phase moved in place keeps the prefetch but fails its key
    r.phase.advance(0.25)
    assert r._prefetch is not None
    st = r.get_state()
    got = stream(12, FRAMES * 2)
    ref = _twin_call(r, st, _pcm(12, FRAMES * 2), FRAMES * 2)
    assert _same_bits(got[0], ref[0]) and got[1] == ref[1]
    assert r.schedule_hits == 5 and _hits(r, stream, 13, FRAMES * 2) == 1

    # an initialize misses, and starts the count of its shapes anew
    r.initialize(r.config)
    assert r._prefetch is None
    assert [_hits(r, stream, c) for c in range(3)] == [0, 0, 1]
    fresh = _resampler(direction, tier, monkeypatch)
    for c in range(3):
        fresh.resample_stream(_pcm(c), FRAMES, CHUNKS)
    assert _same_state(r.get_state(), fresh.get_state())


@pytest.mark.parametrize("tier", ["exact", "fast"])
def test_failed_speculative_build_leaves_results_intact(tier, monkeypatch):
    """A speculative build that raises leaves its call's outputs and state
    as a twin's and no prefetch; the next call builds at its head and raises
    there, its state unchanged, and once the fault is gone runs as the
    twin's."""
    r = _resampler("down", tier, monkeypatch)
    twin = _resampler("down", tier, monkeypatch)
    for res in (r, twin):
        res.resample_stream(_pcm(0), FRAMES, CHUNKS)
    ref = twin.resample_stream(_pcm(1), FRAMES, CHUNKS)
    real, grids_built = resampler_module.phase_grid, []

    def failing(*a, **kw):
        grids_built.append(1)
        if len(grids_built) > CHUNKS:   # the call's own build passes, the tail's fails
            raise RuntimeError("planted schedule fault")
        return real(*a, **kw)

    monkeypatch.setattr(resampler_module, "phase_grid", failing)
    got = r.resample_stream(_pcm(1), FRAMES, CHUNKS)
    assert len(grids_built) == CHUNKS + 1 and r._prefetch is None
    assert _same_bits(got[0], ref[0]) and got[1] == ref[1]
    assert _same_bits(got[2], ref[2])
    st = r.get_state()
    assert _same_state(st, twin.get_state())

    with pytest.raises(RuntimeError, match="planted schedule fault"):
        r.resample_stream(_pcm(2), FRAMES, CHUNKS)
    assert _same_state(r.get_state(), st)

    monkeypatch.setattr(resampler_module, "phase_grid", real)
    got = r.resample_stream(_pcm(2), FRAMES, CHUNKS)
    ref = twin.resample_stream(_pcm(2), FRAMES, CHUNKS)
    assert _same_bits(got[0], ref[0])
    assert _same_state(r.get_state(), twin.get_state())


def test_phase_grid_into_given_arrays_equals_fresh_ones():
    """``phase_grid(out=...)`` into arrays holding stale values gives the
    fresh arrays' grid, zeros past the generated count included, and
    refuses arrays of another dtype or length."""
    r = Resampler(B, device="cpu")
    r.initialize(ResamplerConfiguration(16000.0, 44100.0, 16, 16, 2, True, True, 64, 32))
    n = _out_max(r)
    args = (r.config.number_of_filters, r.bank_flags, r.sample_ratio, FRAMES, n)
    want = phase_grid(dataclasses.replace(r.phase), *args)
    assert want.output_generated < n
    out = tuple(np.full(n, 7, t) for t in (np.int32, np.int32, np.int32, np.float32, np.int8))
    got = phase_grid(dataclasses.replace(r.phase), *args, out=out)
    assert (got.input_used, got.output_generated) == (want.input_used, want.output_generated)
    for name in ("win0", "idx1", "idx2", "weight", "mode"):
        assert _same_bits(getattr(got, name), getattr(want, name))
    with pytest.raises(ValueError):
        phase_grid(dataclasses.replace(r.phase), *args, out=out[:3] + (out[0], out[4]))
    with pytest.raises(ValueError):
        phase_grid(dataclasses.replace(r.phase), *args, out=tuple(a[:-1] for a in out))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the upload stream and the CUDA kernels run only on "
                    "the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("direction, tier", [("down", "exact"), ("up", "exact"),
                                             ("down", "fast")])
def test_prefetch_on_the_card_behind_a_busy_stream(direction, tier, cuda):
    """On the card, with every call queued behind a sleeping kernel so that
    the tail's upload overlaps the call's own work: the consumed schedules
    equal the synchronous build's, and the outputs, clip counts and state
    a twin's that misses every call."""
    rs = []
    for _ in range(2):
        r = Resampler(B, exact=tier == "exact", device="cuda")
        r.initialize(ResamplerConfiguration(*RATES[direction], 16, 16, 2, True, True, 64, 32))
        rs.append(r)
    r, twin = rs
    seen = _consumed(r, tier)
    for call in range(CALLS):
        want = _synchronous_grids(r)
        torch.cuda._sleep(50_000_000)
        got = r.resample_stream(_pcm(call), FRAMES, CHUNKS)
        twin.set_state(twin.get_state())
        ref = twin.resample_stream(_pcm(call), FRAMES, CHUNKS)
        for g_got, g_want in zip(seen[-CHUNKS:], want):
            assert all(_same_bits(a, b) for a, b in zip(g_got, g_want))
        assert _same_bits(got[0], ref[0])
        assert got[1] == ref[1] and _same_bits(got[2], ref[2])
        assert _same_state(r.get_state(), twin.get_state())
    assert r.schedule_hits == CALLS - 2
