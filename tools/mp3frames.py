"""MPEG-1/2 Layer III frame builders for tests and smoke runs (numpy only).

No MP3 encoder exists here, so inputs are built frame by frame:

- :func:`fuzz_frame`: a valid header over random side info and main data
  (mainDataBegin 0, so frames are self-contained); most decode to errors or
  silence, which exercises the error paths;
- :func:`crafted_frame`: real side info for a chosen window type (block
  type, mixed flag) with no main data;
- :func:`craft_tonal_frame`: side info and Huffman-coded spectra (table 1)
  with different global gains per granule: frames that decode to nonzero
  PCM, the only inputs that catch a wrong parameter or state in synthesis;
- :func:`craft_reservoir_stream`: tonal frames whose main data lives in the
  bit reservoir (real back-references, also across slots of different
  sizes);
- :func:`make_free_frame`: one free-bitrate (bitrate index 0) frame;
- :func:`fuzz_stream`, :func:`tonal_stream` and :func:`mixed_stream`:
  whole streams of them.

A copy, importing nothing of JAX, of the builders in tests/test_mp3_decode.py,
tests/test_mp3_coverage.py and tests/test_mp3_modes.py, which the JAX
package's tests keep; each draws from its rng in the same order, so a seed
gives the same bytes. Put
``tools/`` on ``sys.path`` to import it (it uses ``flacgen.BitWriter``).
"""

from __future__ import annotations

import numpy as np
from flacgen import BitWriter

from esp_audio_libs_tpu_torch.runtime.tables import mp3_tables

__all__ = ["BATCH_CFGS", "WINDOWS", "craft_reservoir_stream", "craft_tonal_frame",
           "crafted_frame", "frame_sizes", "fuzz_frame", "fuzz_stream", "make_free_frame",
           "make_header", "mixed_stream", "tonal_stream"]

# the formats of the JAX package's batched-decoder tests: MPEG-1 mono, stereo,
# joint mid-side, MPEG-2 stereo
BATCH_CFGS = [
    dict(ver_bits=3, bitrate_idx=9, sr_idx=0, mode=3),
    dict(ver_bits=3, bitrate_idx=11, sr_idx=0, mode=0),
    dict(ver_bits=3, bitrate_idx=11, sr_idx=1, mode=1, mode_ext=2),
    dict(ver_bits=2, bitrate_idx=8, sr_idx=0, mode=0),
]
WINDOWS = [(0, 0), (1, 0), (2, 0), (2, 1), (3, 0)]      # (block type, mixed)


def make_header(ver_bits=3, layer_bits=1, bitrate_idx=9, sr_idx=0, padding=0, mode=0,
                mode_ext=0, crc=1):
    """4-byte MPEG audio frame header. ver_bits: 3 = MPEG-1, 2 = MPEG-2,
    0 = MPEG-2.5; layer_bits 1 = Layer III; crc=1 means no CRC."""
    b1 = 0xE0 | (ver_bits << 3) | (layer_bits << 1) | crc
    b2 = (bitrate_idx << 4) | (sr_idx << 2) | (padding << 1)
    return bytes([0xFF, b1, b2, (mode << 6) | (mode_ext << 4)])


def frame_sizes(ver_bits, bitrate_idx, sr_idx, mode):
    """(total frame bytes, side info bytes) from the standard tables."""
    T = mp3_tables()
    ver = {3: 0, 2: 1, 0: 2}[ver_bits]
    return (int(T["slotTab"][ver][sr_idx][bitrate_idx]),
            int(T["sideBytesTab"][ver][0 if mode == 3 else 1]))


def fuzz_frame(cfg, rng):
    """A header over random bytes with mainDataBegin = 0. slotTab is the
    total frame size, so frames butt together exactly."""
    slots, _ = frame_sizes(cfg["ver_bits"], cfg["bitrate_idx"], cfg["sr_idx"], cfg["mode"])
    body = bytearray(rng.integers(0, 256, slots - 4, dtype=np.uint8).tobytes())
    body[0] = 0
    if cfg["ver_bits"] == 3:
        body[1] &= 0x7F
    return make_header(**cfg) + bytes(body)


def _craft_side_info(ver_bits, mode, block_type, mixed, rng):
    """Side info with part23Length = 0 (no main data) and real window fields."""
    mpeg1 = ver_bits == 3
    mono = mode == 3
    nch, ngr = (1 if mono else 2), (2 if mpeg1 else 1)
    w = BitWriter()
    w.write(0, 9 if mpeg1 else 8)                       # mainDataBegin
    w.write(0, (5 if mono else 3) if mpeg1 else (1 if mono else 2))
    if mpeg1:
        for _ in range(nch * 4):
            w.write(0, 1)                               # scfsi
    for _ in range(ngr):
        for _ in range(nch):
            w.write(0, 12)                              # part23Length
            w.write(0, 9)                               # nBigvals
            w.write(int(rng.integers(0, 256)), 8)       # globalGain
            w.write(0, 4 if mpeg1 else 9)               # sfCompress
            if block_type == 0 and not mixed:
                w.write(0, 1)                           # winSwitch off
                for _ in range(3):
                    w.write(0, 5)                       # tableSelect
                w.write(0, 4)                           # region0
                w.write(0, 3)                           # region1
            else:
                w.write(1, 1)                           # winSwitch on
                w.write(block_type, 2)
                w.write(int(mixed), 1)
                for _ in range(2):
                    w.write(0, 5)
                for _ in range(3):
                    w.write(0, 3)                       # subBlockGain
            if mpeg1:
                w.write(0, 1)                           # preFlag
            w.write(0, 1)                               # sfactScale
            w.write(0, 1)                               # count1TableSelect
    w.align()
    return w.getvalue()


def crafted_frame(cfg, block_type, mixed, rng):
    """A frame whose side info selects ``block_type`` / ``mixed``, no main data."""
    slots, side = frame_sizes(cfg["ver_bits"], cfg["bitrate_idx"], cfg["sr_idx"], cfg["mode"])
    si = _craft_side_info(cfg["ver_bits"], cfg["mode"], block_type, mixed, rng)
    assert len(si) == side, (len(si), side)
    pad = bytes(int(x) for x in rng.integers(0, 256, slots - 4 - side))
    return make_header(**cfg) + si + pad


def _craft_tonal_parts(cfg, rng, gains, nb_pairs, main_data_begin=0):
    """(side info, main data) of a frame whose granules carry nonzero
    Huffman spectra (ISO/IEC 11172-3 Table B.7 table 1: (0,0)='1',
    (1,0)='01', (0,1)='001', (1,1)='000', each nonzero value with a sign
    bit) and per-granule global gains. ``main_data_begin`` goes into the
    side info as it is (:func:`craft_reservoir_stream` computes it)."""
    mpeg1 = cfg["ver_bits"] == 3
    mono = cfg["mode"] == 3
    nch, ngr = (1 if mono else 2), (2 if mpeg1 else 1)

    main = BitWriter()
    part23 = []
    for _ in range(ngr * nch):
        bits = 0
        for p in range(nb_pairs):
            if p % 2 == 0:
                main.write(0b000, 3)                    # (1,1)
                main.write(int(rng.integers(0, 2)), 1)
                main.write(int(rng.integers(0, 2)), 1)
                bits += 5
            else:
                main.write(0b01, 2)                     # (1,0)
                main.write(int(rng.integers(0, 2)), 1)
                bits += 3
        part23.append(bits)
    main.align()

    si = BitWriter()
    si.write(main_data_begin, 9 if mpeg1 else 8)        # mainDataBegin
    si.write(0, (5 if mono else 3) if mpeg1 else (1 if mono else 2))
    if mpeg1:
        for _ in range(nch * 4):
            si.write(0, 1)
    k = 0
    for g in range(ngr):
        for _ in range(nch):
            si.write(part23[k], 12)
            si.write(nb_pairs, 9)
            si.write(gains[g % len(gains)], 8)
            si.write(0, 4 if mpeg1 else 9)              # sfCompress 0: no sf bits
            si.write(0, 1)                              # winSwitch off
            si.write(1, 5)                              # tableSelect[0] = table 1
            si.write(0, 5)
            si.write(0, 5)
            si.write(0, 4)
            si.write(0, 3)
            if mpeg1:
                si.write(0, 1)
            si.write(0, 1)
            si.write(0, 1)
            k += 1
    si.align()
    return si.getvalue(), main.getvalue()


def craft_tonal_frame(cfg, rng, gains=(120, 200), nb_pairs=16):
    """A self-contained (mainDataBegin = 0) frame that decodes to audible
    PCM, each granule with its own global gain."""
    side, main_bytes = _craft_tonal_parts(cfg, rng, gains, nb_pairs)
    slots, side_bytes = frame_sizes(cfg["ver_bits"], cfg["bitrate_idx"], cfg["sr_idx"],
                                    cfg["mode"])
    assert len(side) == side_bytes, (len(side), side_bytes)
    body = side + main_bytes
    assert len(body) <= slots - 4
    return make_header(**cfg) + body + bytes(slots - 4 - len(body))


def craft_reservoir_stream(cfgs, rng, gains=(200, 235), nb_pairs=16):
    """Tonal frames, one per entry of ``cfgs`` (the bitrate index may vary:
    VBR), whose main data lives in the bit reservoir and decodes: the main
    data of all frames packs tightly into the frames' main-data regions, so
    frame i's ``mainDataBegin`` points back into bytes that earlier frames
    carry (the reference assembles them in mainBuf, mp3_decoder.cpp:
    8774-8802). Every frame's main data is drawn first; the side info is
    then written again with the packed ``mainDataBegin`` from a throwaway
    ``default_rng(0)`` (it only draws sign bits of discarded main data)."""
    mains, regions = [], []
    for cfg in cfgs:
        side, main_bytes = _craft_tonal_parts(cfg, rng, gains, nb_pairs)
        slots, side_bytes = frame_sizes(cfg["ver_bits"], cfg["bitrate_idx"], cfg["sr_idx"],
                                        cfg["mode"])
        assert len(side) == side_bytes
        mains.append(main_bytes)
        regions.append(slots - 4 - side_bytes)

    # main data of frame i at p_i = q_i - mdb_i: mdb_i bytes back into the
    # earlier regions; the gaps are stuffing, as an encoder's padding keeps
    # mainDataBegin inside its field
    G = bytearray(sum(regions))
    mdbs = []
    q = prev_end = 0
    for i, (cfg, region, main_bytes) in enumerate(zip(cfgs, regions, mains)):
        mdb_max = 511 if cfg["ver_bits"] == 3 else 255
        # as deep into the reservoir as the field and the free bytes allow
        # (frame 0 is self-contained: q = 0)
        mdb = min(q - prev_end + len(main_bytes) + 23 * i, mdb_max, q - prev_end)
        p = q - mdb
        assert p >= prev_end, (i, p, prev_end)
        G[p:p + len(main_bytes)] = main_bytes
        prev_end = p + len(main_bytes)
        mdbs.append(mdb)
        q += region
    assert any(m > 0 for m in mdbs[1:]), "reservoir stream degenerated to self-contained frames"

    frames = []
    q = 0
    for cfg, region, mdb in zip(cfgs, regions, mdbs):
        side, _ = _craft_tonal_parts(cfg, np.random.default_rng(0), gains, nb_pairs,
                                     main_data_begin=mdb)
        frames.append(make_header(**cfg) + side + bytes(G[q:q + region]))
        q += region
    return b"".join(frames)


def make_free_frame(payload_slots, padding=0, mode=3, sr_idx=0, tonal_rng=None):
    """One free-bitrate (bitrate index 0) MPEG-1 frame of ``payload_slots``
    main-data bytes: silent side info, or with ``tonal_rng`` a tonal frame's
    body (:func:`craft_tonal_frame`) cut or zero-padded to that size."""
    cfg = dict(ver_bits=3, bitrate_idx=9, sr_idx=sr_idx, mode=mode, mode_ext=0)
    _, side = frame_sizes(3, 9, sr_idx, mode)
    body = craft_tonal_frame(cfg, tonal_rng)[4:] if tonal_rng is not None else bytes(side)
    hdr = make_header(ver_bits=3, bitrate_idx=0, sr_idx=sr_idx, padding=padding, mode=mode)
    return hdr + body[:side + payload_slots].ljust(side + payload_slots, b"\x00")


def fuzz_stream(cfg, seed, n_frames=3):
    """``n_frames`` fuzz frames of one format from ``seed``."""
    rng = np.random.default_rng(seed)
    return b"".join(fuzz_frame(cfg, rng) for _ in range(n_frames))


def tonal_stream(cfg, seed, n_frames):
    """``n_frames`` tonal frames of one format, gains drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    return b"".join(craft_tonal_frame(cfg, rng, gains=(int(rng.integers(100, 236)),
                                                       int(rng.integers(100, 236))))
                    for _ in range(n_frames))


def mixed_stream(cfg, seed, n_frames, fuzz=True):
    """Tonal frames, window-type frames (cycling through ``WINDOWS``) and,
    with ``fuzz``, fuzz frames of one format in turn, from ``seed``: nonzero
    carried state meets every block type. A fuzz frame usually fails and
    ends a ``decode_run`` run; without them every frame decodes."""
    rng = np.random.default_rng(seed)
    frames = []
    for f in range(n_frames):
        kind = f % (3 if fuzz else 2)
        if kind == 0:
            frames.append(craft_tonal_frame(cfg, rng, gains=(int(rng.integers(100, 236)),
                                                             int(rng.integers(100, 236)))))
        elif kind == 1:
            bt, mixed = WINDOWS[(f // 2) % len(WINDOWS)]
            frames.append(crafted_frame(cfg, bt, mixed, rng))
        else:
            frames.append(fuzz_frame(cfg, rng))
    return b"".join(frames)
