"""The traffic generators: the same seed gives the same bytes."""

from __future__ import annotations

import json

import torch

from perfbench import harness

from .conftest import REPO, TINY


def _pool(name: str, seed: int):
    tr = json.loads((REPO / "perfbench" / "traffic" / f"{name}.json").read_text())
    tr.update(TINY)
    gen = harness.load_module(REPO / "perfbench" / "generators" / f"{tr['generator']}.py",
                              f"test_gen_{tr['generator']}")
    return tr, gen.make_pool(tr, seed, torch.device("cpu"))


def test_pcm_pool_same_seed_same_bytes():
    for name in ("pcm_44k1_to_16k_b2048", "pcm_16k_to_44k1_b2048"):
        tr, a = _pool(name, 2 ** 31 + 12345)
        _, b = _pool(name, 2 ** 31 + 12345)
        _, c = _pool(name, 2 ** 31 + 12346)
        assert len(a) == tr["pool_buffers"]
        frames = tr["chunk_frames"] * tr["chunks_per_call"]
        for x, y_, z in zip(a, b, c):
            assert x.dtype == torch.uint8
            assert x.shape == (tr["streams"], frames * tr["channels"] * 2)
            assert torch.equal(x, y_)
            assert not torch.equal(x, z)
        s16 = a[0].view(torch.int16).float()
        assert s16.abs().max() > 0 and s16.std() > 10


def test_mp3_pool_same_seed_same_bytes():
    tr = json.loads((REPO / "perfbench" / "traffic" / "mp3_128k_js_b2048.json").read_text())
    tr.update(pool_streams=2, stream_frames=4)
    gen = harness.load_module(REPO / "perfbench" / "generators" / "mp3.py", "test_gen_mp3")
    a, b = gen.make_pool(tr, 2 ** 31 + 5), gen.make_pool(tr, 2 ** 31 + 5)
    c = gen.make_pool(tr, 2 ** 31 + 6)
    assert a == b and a != c
    for s in a:                                   # 417 or 418 bytes a frame at 128 kbit/s
        assert 4 * 417 <= len(s) <= 4 * 418 and s[:2] == b"\xff\xfb"
