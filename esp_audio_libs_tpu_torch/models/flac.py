"""FLAC decoding pipeline of the port: native host front-end + batched
device back-end, the counterpart of esp_audio_libs_tpu/models/flac.py.

Public semantics mirror the reference ``flac::FLACDecoder``
(reference: include/flac_decoder.h, src/decode/flac/flac_decoder.cpp): same
result codes, streaming header protocol, metadata size limits, CRC toggles,
byte accounting, and output packing (native depths and the 32-bit
left-justified mode).

The native front-end (native/src/flac_frontend.cpp, the same
``libeal_host.so`` the JAX package loads) does everything bitstream-serial:
sync, headers, CRC, Rice decoding into dense residual tables. The device
restores LPC/fixed prediction, applies wasted-bits shifts and stereo
decorrelation and packs PCM bytes for a whole bucket of frames in one launch
of the hand-written kernel ``ops.flac_kernels.flac_frame_cuda``
(csrc/flac_frame.cu), which stands for the JAX module's
``_frame_kernel_body`` and, given an escape sideband, ``_frame_kernel_esc``;
on the CPU its plain version runs.

Entry points take ``device``, ``"cuda"`` by default; without a card that
raises, and nothing falls back. A slice uploads from pinned host memory
with ``non_blocking=True`` on the current stream and, on the host-returning
path, downloads into pinned memory; slices dispatch serially.

With a stream ``mesh`` of more than one device (parallel/mesh.py) a bucket
whose frame count divides the mesh size splits its frame axis into
contiguous blocks, one per device, with one escape sideband per block
(positions local to the block), and runs one frame-kernel launch per shard:
the JAX package's ``_frame_kernel_esc_sharded``. Other buckets run on the
mesh's first device, and the device-resident PCM of a stream group that
divides the mesh comes back split along the stream axis.
"""

from __future__ import annotations

import ctypes as C
import hashlib
import os

import numpy as np
import torch

from ..ops.flac_kernels import ORDER_CLASSES, flac_frame_cuda
from ..parallel.mesh import Sharded, _put, is_split, shard_streams, to_numpy as _to_host
from ..runtime import transport
from ..runtime.kernels import entry_device
from ..runtime.native import host_lib
from ..utils.errors import FLACDecoderResult, FLACMetadataType

__all__ = ["FLACDecoder", "decode_streams_to_device", "decode_streams_to_device_grouped",
           "parsed_buckets"]

_i32p = C.POINTER(C.c_int32)

# escape-density ceiling for choosing the int8 + sideband transport tier
# (runtime/transport.py); tests force it to 0.0 / 1.0
ESC_MAX_DENSITY = transport.ESC_MAX_DENSITY


def _order_class(orders) -> int:
    """Window class for a dispatch: the smallest of {4, 8, 12, 16, 32}
    covering every subframe order in the batch (five kernel specialisations;
    the dominant real-encoder orders <= 8/12 run a narrow window)."""
    mo = int(np.max(orders, initial=0))
    for c in ORDER_CLASSES:
        if mo <= c:
            return c
    return 32


class _ParseGroup:
    """Host-side frame table for one (channels, max_block_size) shape class.

    The native front-end appends every parsed frame of every stream directly
    into these batch-major arrays (``eal_flac_parse_stream``): residuals land
    narrowed to the narrowest width the frame's words fit (int8, int16 or
    int32), predictor metadata is row-indexed by frame. Arrays double when
    full.
    """

    def __init__(self, nch: int, mbs: int, cap: int = 256):
        self.nch, self.mbs, self.cap = nch, mbs, cap
        self.nf = 0
        self.data8 = np.empty((cap, nch, mbs), np.int8)
        self.data16 = np.empty((cap, nch, mbs), np.int16)
        self.data32 = np.empty((cap, nch, mbs), np.int32)
        self.cursors = np.zeros(3, np.int32)  # [slot8, slot16, slot32]
        self.wide = np.empty(cap, np.int32)
        self.slot = np.empty(cap, np.int32)
        self.order = np.empty((cap, nch), np.int32)
        self.shift = np.empty((cap, nch), np.int32)
        self.wasted = np.empty((cap, nch), np.int32)
        self.use64 = np.empty((cap, nch), np.int32)
        self.coeffs = np.empty((cap, nch, 32), np.int32)
        self.bs = np.empty(cap, np.int32)
        self.ca = np.empty(cap, np.int32)
        self.depth = np.empty(cap, np.int32)
        self.crc_ok = np.empty(cap, np.int32)
        self.consumed = np.empty(cap, np.int32)

    def room(self) -> int:
        return min([self.cap - self.nf] + [self.cap - int(c) for c in self.cursors])

    def grow(self) -> None:
        """Double the capacity, copying only the rows in use."""
        new_cap = self.cap * 2
        for name, used in (("data8", self.cursors[0]), ("data16", self.cursors[1]),
                           ("data32", self.cursors[2])) + tuple(
                (name, self.nf) for name in ("wide", "slot", "order", "shift", "wasted",
                                             "use64", "coeffs", "bs", "ca", "depth",
                                             "crc_ok", "consumed")):
            old = getattr(self, name)
            new = np.empty((new_cap,) + old.shape[1:], old.dtype)
            new[:used] = old[:used]
            setattr(self, name, new)
        self.cap = new_cap


def _parse_one_stream(lib, dec, buffer, g):
    """Parse every frame of one stream into group ``g`` (appending at
    ``g.nf``), one native call per capacity window. Returns
    ``(rows, codes_s)``: the group rows appended and the stream's result
    codes (SUCCESS per parsed frame plus the code that ended the stream, if
    any)."""
    u8p = C.POINTER(C.c_uint8)
    i16p = C.POINTER(C.c_int16)
    buf = np.frombuffer(buffer, np.uint8) if isinstance(buffer, (bytes, bytearray)) \
        else np.ascontiguousarray(buffer)
    mbs = g.mbs
    rows, codes_s = [], []
    pos = 0
    while pos < buf.size:
        room = g.room()
        if room == 0:
            g.grow()
            continue
        last_rc = C.c_int32(0)
        sub = buf[pos:]
        f0 = g.nf
        nf = lib.eal_flac_parse_stream(
            dec._ctx, sub.ctypes.data_as(u8p), sub.size, room, mbs,
            g.data8.ctypes.data_as(C.POINTER(C.c_int8)),
            g.data16.ctypes.data_as(i16p), g.data32.ctypes.data_as(_i32p),
            g.cursors[0:].ctypes.data_as(_i32p), g.cursors[1:].ctypes.data_as(_i32p),
            g.cursors[2:].ctypes.data_as(_i32p),
            g.wide[f0:].ctypes.data_as(_i32p), g.slot[f0:].ctypes.data_as(_i32p),
            g.order[f0:].ctypes.data_as(_i32p), g.shift[f0:].ctypes.data_as(_i32p),
            g.wasted[f0:].ctypes.data_as(_i32p), g.use64[f0:].ctypes.data_as(_i32p),
            g.coeffs[f0:].ctypes.data_as(_i32p), g.bs[f0:].ctypes.data_as(_i32p),
            g.ca[f0:].ctypes.data_as(_i32p), g.depth[f0:].ctypes.data_as(_i32p),
            g.crc_ok[f0:].ctypes.data_as(_i32p), g.consumed[f0:].ctypes.data_as(_i32p),
            C.byref(last_rc))
        g.nf += nf
        pos += int(g.consumed[f0 : f0 + nf].sum())
        codes_s.extend([FLACDecoderResult.SUCCESS] * nf)
        rows.extend(range(f0, f0 + nf))
        rc = last_rc.value
        if rc != 0:
            codes_s.append(FLACDecoderResult(rc))
            break
        if nf < room:   # clean exhaustion (pos >= size)
            break
    return rows, codes_s


def _parse_thread_count(n_live: int) -> int:
    """Host-parse pool size for a fleet of ``n_live`` streams: engaged only
    above a minimum fleet with >= 32 streams per thread; ``EAL_PARSE_THREADS``
    overrides (clamped to the live-stream count)."""
    forced = 0
    env = os.environ.get("EAL_PARSE_THREADS")
    if env:
        try:
            forced = int(env)
        except ValueError:
            forced = 0
    hw = os.cpu_count() or 1
    n = forced if forced > 0 else hw
    if forced > 0:
        n = max(min(n, n_live), 1)
        return n if n > 1 else 1
    if n <= 1 or n_live < max(64, 2 * n):
        return 1
    if n > n_live // 32:   # >= 32 streams per thread when auto-sized
        n = n_live // 32
    return max(min(n, n_live), 1)


def _parse_streams(decoders, buffers, groups=None, codes=None, frames_of=None,
                   on_stream=None):
    """Host front-end for a fleet: parse every frame of every stream into
    the shared :class:`_ParseGroup` tables. Returns ``(groups, codes,
    frames_of)``: per-stream result-code lists and per-stream lists of
    (group key, frame row) pairs.

    ``groups``/``codes``/``frames_of`` may be passed in pre-allocated, and
    ``on_stream(s)`` is then called after stream ``s`` is fully parsed (the
    hook the dispatchers use to start on completed streams while later ones
    parse). With a parse pool, workers parse into private staging groups and
    the main thread commits them in stream order, so the committed layout
    is the serial path's, whatever the thread scheduling.
    """
    lib = host_lib()
    groups = {} if groups is None else groups
    codes = [[] for _ in buffers] if codes is None else codes
    frames_of = [[] for _ in buffers] if frames_of is None else frames_of

    def key_of(dec):
        return (dec.num_channels, dec.max_block_size)

    def shared_group(key):
        g = groups.get(key)
        if g is None:
            g = groups[key] = _ParseGroup(*key)
        return g

    n_live = sum(1 for b in buffers if b is not None)
    n_threads = _parse_thread_count(n_live)
    if n_threads <= 1:
        for s, (dec, buffer) in enumerate(zip(decoders, buffers)):
            if buffer is not None:
                key = key_of(dec)
                rows, codes_s = _parse_one_stream(lib, dec, buffer, shared_group(key))
                codes[s].extend(codes_s)
                frames_of[s].extend((key, r) for r in rows)
            if on_stream is not None:
                on_stream(s)
        return groups, codes, frames_of

    from concurrent.futures import ThreadPoolExecutor

    def worker(s):
        gp = _ParseGroup(*key_of(decoders[s]), cap=8)
        rows, codes_s = _parse_one_stream(lib, decoders[s], buffers[s], gp)
        return gp, rows, codes_s

    def commit(s, gp, rows, codes_s):
        """Append a private group's rows to the shared group, in the layout
        the serial path would have produced."""
        key = key_of(decoders[s])
        g = shared_group(key)
        while g.cap - g.nf < gp.nf or any(
                g.cap - int(g.cursors[w]) < int(gp.cursors[w]) for w in range(3)):
            g.grow()
        f0, base = g.nf, g.cursors.copy()
        pnf = gp.nf
        for name in ("wide", "order", "shift", "wasted", "use64", "coeffs",
                     "bs", "ca", "depth", "crc_ok", "consumed"):
            getattr(g, name)[f0 : f0 + pnf] = getattr(gp, name)[:pnf]
        # private width-slot counters start at 0: global slot = the width's
        # shared cursor at commit + private slot
        g.slot[f0 : f0 + pnf] = gp.slot[:pnf] + base[gp.wide[:pnf]]
        for w, name in enumerate(("data8", "data16", "data32")):
            cw = int(gp.cursors[w])
            if cw:
                getattr(g, name)[base[w] : base[w] + cw] = getattr(gp, name)[:cw]
        g.cursors += gp.cursors
        g.nf = f0 + pnf
        codes[s].extend(codes_s)
        frames_of[s].extend((key, f0 + r) for r in rows)

    window = n_threads + 2
    futs = {}
    submit_i = 0
    with ThreadPoolExecutor(max_workers=n_threads) as pool:
        def maybe_submit():
            nonlocal submit_i
            while submit_i < len(buffers) and len(futs) < window:
                s = submit_i
                submit_i += 1
                if buffers[s] is not None:
                    futs[s] = pool.submit(worker, s)

        maybe_submit()
        for s in range(len(buffers)):
            if buffers[s] is not None:
                gp, rows, codes_s = futs.pop(s).result()
                maybe_submit()
                commit(s, gp, rows, codes_s)
            if on_stream is not None:
                on_stream(s)
    return groups, codes, frames_of


def _frame_shape_key(g, fi, m32):
    """Kernel shape key of one frame row (shared by the host-returning and
    device-resident paths)."""
    return ((g.nch, g.mbs), int(g.bs[fi]), int(g.depth[fi]), int(g.wide[fi]),
            bool(g.use64[fi].any()), m32)


def _bucket_operands(g, rows, frs, bkey, n_blocks: int = 1):
    """Host operands of one shape bucket: ``(arrays, kw)`` with arrays the
    residual plane ``[F, C, bs]`` and coeffs, order, shift, wasted, chan
    assignment, and kw the frame kernel's keyword arguments.

    int16 buckets whose words are int8-sized except for rare escapes take
    the int8 + escape-sideband transport tier: the plane ships at half
    width, and kw carries the sorted escape positions and values that the
    kernel puts back, one row ``[n_blocks, cap]`` per contiguous block of
    frames (``F`` divisible by ``n_blocks``), positions local to the block
    (``transport.escape_sideband_blocked``): block ``i`` is the sideband of
    the launch on frames ``[i F/n, (i+1) F/n)``."""
    ((nch, mbs), bs, depth, wide, acc64, m32) = bkey
    src = (g.data8, g.data16, g.data32)[wide]
    data = src[rows] if bs == mbs else src[rows][:, :, :bs]
    arrays = [data, g.coeffs[frs], g.order[frs], g.shift[frs], g.wasted[frs], g.ca[frs]]
    kw = dict(depth=depth, nch=nch, mode32=m32, use64=acc64,
              max_order=_order_class(g.order[frs]))
    if wide == 1:
        narrow = data.astype(np.int8)          # wraps exactly where a word escapes
        esc_mask = narrow != data
        if np.count_nonzero(esc_mask) <= ESC_MAX_DENSITY * data.size:
            kw["esc_pos"], kw["esc_val"] = transport.escape_sideband_blocked(
                esc_mask.reshape(n_blocks, -1), data.reshape(n_blocks, -1), np.int32)
            arrays[0] = narrow
    return arrays, kw


def _run_frame_bucket(g, rows, frs, bkey, device, mesh=None):
    """Dispatch one shape bucket through the frame kernel on ``device``;
    returns the packed PCM ``[len(rows), bytes]`` there.

    Under a mesh that splits (``is_split``) and a frame count that divides
    its size, the frames split into contiguous blocks, each with its own
    escape sideband, and the kernel launches once per shard on the shard's
    device: the result is :class:`Sharded` along the frame axis. Otherwise
    the bucket is one block on ``device``."""
    split = is_split(mesh) and len(rows) % mesh.size == 0
    devices = mesh.devices if split else (device,)
    arrays, kw = _bucket_operands(g, rows, frs, bkey, n_blocks=len(devices))
    esc = {name: kw.pop(name) for name in ("esc_pos", "esc_val") if name in kw}
    blk = len(rows) // len(devices)
    parts = [flac_frame_cuda(*(_put(a[i * blk:(i + 1) * blk], dev) for a in arrays), **kw,
                             **{name: _put(v[i], dev) for name, v in esc.items()})
             for i, dev in enumerate(devices)]
    return Sharded(parts, 0, mesh) if split else parts[0]


def parsed_buckets(decoders, buffers):
    """Yield ``(bkey, arrays, kw)`` (see :func:`_bucket_operands`) for every
    shape bucket of a fleet, each bucket whole, as the host parse leaves
    them: real operands for checking the frame kernel against its plain
    version. The decoders must have read their headers."""
    groups, _, frames_of = _parse_streams(decoders, buffers)
    buckets: dict = {}
    for dec, frames in zip(decoders, frames_of):
        for key, fi in frames:
            buckets.setdefault(_frame_shape_key(groups[key], fi, dec._output_32bit),
                               []).append(fi)
    for bkey, frs in buckets.items():
        g = groups[bkey[0]]
        frs = np.asarray(frs, np.int64)
        arrays, kw = _bucket_operands(g, g.slot[frs], frs, bkey)
        for name in ("esc_pos", "esc_val"):
            if name in kw:
                kw[name] = kw[name][0]      # the one block's sideband
        yield bkey, arrays, kw


def _decode_streams(decoders, buffers, verify_md5: bool = True, device="cuda", mesh=None):
    """Shared end-to-end path for 1..N streams: native batched host parse,
    cross-stream shape-bucketed device kernels, per-stream reassembly.

    ``mesh``: an optional stream mesh (see :func:`_run_frame_bucket`). Under
    a mesh of more than one device the buckets stay whole (no slicing), as
    in the JAX package, so that each can split over the mesh.

    The host parse signals per completed stream (overlapped with dispatch
    for fleets); the main thread buckets each completed stream's frames by
    the kernel's shape key and dispatches a slice as soon as one holds
    ``transport.SLICE_OUT_BYTES`` of PCM: upload, kernel, download into
    pinned memory. Slice outputs are assembled by (stream, frame), so the
    result does not depend on slicing.

    Returns the per-stream (pcm_bytes, results-dict) list of
    ``FLACDecoder.decode_stream`` / ``BatchedFLACDecoder.decode_streams``.
    """
    dev = entry_device(device, "FLAC decode")
    split = is_split(mesh)
    n = len(decoders)
    assert len(buffers) == n
    groups: dict = {}
    codes = [[] for _ in buffers]
    frames_of = [[] for _ in buffers]
    out_chunks = [[] for _ in range(n)]
    buckets: dict = {}   # bkey -> not-yet-dispatched (s, j, fi) rows

    def _parse_call(on_stream):
        _parse_streams(decoders, buffers, groups, codes, frames_of, on_stream=on_stream)

    def _run_slice(bkey, sl):
        g = groups[bkey[0]]
        rows = np.fromiter((g.slot[fi] for _, _, fi in sl), np.int64, len(sl))
        frs = np.fromiter((fi for _, _, fi in sl), np.int64, len(sl))
        packed_np = _to_host(_run_frame_bucket(g, rows, frs, bkey, dev, mesh))
        for k, (s, j, _) in enumerate(sl):
            out_chunks[s][j] = packed_np[k]

    with transport.overlapped_parse(_parse_call, n) as done_q:
        while True:
            s = done_q.get()
            if s is None:
                break
            out_chunks[s] = [None] * len(frames_of[s])
            m32 = decoders[s]._output_32bit
            for j, (key, fi) in enumerate(frames_of[s]):
                bkey = _frame_shape_key(groups[key], fi, m32)
                sl = buckets.setdefault(bkey, [])
                sl.append((s, j, fi))
                if split:
                    continue   # buckets stay whole, to split over the mesh
                ((nch, _mbs), bs, depth, _wide, _acc64, bm32) = bkey
                bps = 4 if bm32 else (depth + 7) // 8
                if len(sl) * bs * nch * bps >= transport.SLICE_OUT_BYTES:
                    buckets[bkey] = []
                    _run_slice(bkey, sl)
        for bkey, sl in buckets.items():   # tails (and whole buckets under a mesh)
            if sl:
                _run_slice(bkey, sl)

    results = []
    for s, dec in enumerate(decoders):
        if buffers[s] is None:
            results.append((b"", None))
            continue
        pcm = b"".join(c.tobytes() for c in out_chunks[s] if c is not None)
        md5_ok = None
        if verify_md5 and not dec._output_32bit:
            sig = dec.md5_signature
            if any(sig):
                md5_ok = dec._md5_of_output(out_chunks[s]) == sig
        total = int(sum(groups[key].bs[fi] for key, fi in frames_of[s])) * dec.num_channels
        results.append((pcm, {"frame_results": codes[s], "num_samples": total,
                              "md5_ok": md5_ok, "num_frames": len(frames_of[s])}))
    return results


class _FleetSig:
    """Per-signature dispatch state for :func:`decode_streams_to_device_grouped`.

    A signature is a stream's full per-frame shape-key sequence; streams
    with the same signature batch into the same dispatches and share one
    rectangular device PCM block."""

    __slots__ = ("keys", "bucket_js", "chunk_outs", "ready", "chunk_n", "stream_ids")

    def __init__(self, keys, n, split):
        self.keys = keys
        self.bucket_js = {}
        for bkey in dict.fromkeys(keys):
            self.bucket_js[bkey] = [j for j, k in enumerate(keys) if k == bkey]
        # chunk streams so each dispatch round moves about one transport
        # slice of PCM bytes; under a mesh the group dispatches whole
        stream_bytes = sum(k[1] * k[0][0] * (4 if k[5] else (k[2] + 7) // 8) for k in keys)
        self.chunk_n = n if split else max(
            1, transport.SLICE_OUT_BYTES // max(1, stream_bytes))
        self.chunk_outs = {}   # bkey -> [chunk, len(js), bytes] device tensors
        self.ready = []        # parsed, not-yet-dispatched stream ids
        self.stream_ids = []   # all stream ids, dispatch order


def decode_streams_to_device_grouped(decoders, buffers, device="cuda", mesh=None):
    """Fleet decode with the PCM left on ``device``, for an arbitrary
    (possibly mixed) fleet: the composition path (decode -> resample without
    a host round trip).

    Streams are grouped by their frame-shape signature; each group batches
    into shared dispatches and yields one rectangular device PCM block.

    Returns ``(group_list, results)``:

    - ``group_list``: ``(stream_ids, pcm_dev)`` pairs in first-seen order,
      ``pcm_dev`` a uint8 tensor ``[len(stream_ids), stream_bytes]`` of
      packed PCM on ``device`` (the byte layout ``Resampler.resample_stream``
      consumes).
    - ``results``: per-stream metadata (``decode_streams`` without
      ``md5_ok``: the bytes never reach the host).

    With a ``mesh`` of more than one device each group dispatches whole,
    its buckets split over the mesh (:func:`_run_frame_bucket`), and the
    PCM of a group whose stream count divides the mesh size comes back
    :class:`Sharded` along the stream axis, ready for a ``Resampler`` on the
    same mesh; other groups' PCM lands on ``device``.
    """
    dev = entry_device(device, "FLAC decode")
    split = is_split(mesh)
    n = len(decoders)
    groups: dict = {}
    codes = [[] for _ in buffers]
    frames_of = [[] for _ in buffers]
    sigs: dict = {}          # signature -> _FleetSig, first-seen order

    def _parse_call(on_stream):
        _parse_streams(decoders, buffers, groups, codes, frames_of, on_stream=on_stream)

    def _dispatch_chunk(st, streams_chunk):
        for bkey, js in st.bucket_js.items():
            g = groups[bkey[0]]
            rows = np.fromiter((g.slot[frames_of[s][j][1]] for s in streams_chunk for j in js),
                               np.int64, len(streams_chunk) * len(js))
            frs = np.fromiter((frames_of[s][j][1] for s in streams_chunk for j in js),
                              np.int64, len(streams_chunk) * len(js))
            packed = _run_frame_bucket(g, rows, frs, bkey, dev, mesh)
            if isinstance(packed, Sharded) and len(streams_chunk) % mesh.size == 0:
                # each shard's block holds whole streams
                packed = packed.map(lambda p: p.reshape(-1, len(js), p.shape[-1]))
            else:
                if isinstance(packed, Sharded):
                    packed = packed.gather(dev)
                packed = packed.reshape(len(streams_chunk), len(js), -1)
            st.chunk_outs.setdefault(bkey, []).append(packed)

    with transport.overlapped_parse(_parse_call, n) as done_q:
        while True:
            s = done_q.get()
            if s is None:
                break
            m32 = decoders[s]._output_32bit
            keys = [_frame_shape_key(groups[key], fi, m32) for key, fi in frames_of[s]]
            sig = (m32, tuple(keys))
            st = sigs.get(sig)
            if st is None:
                st = sigs[sig] = _FleetSig(keys, n, split)
            st.stream_ids.append(s)
            st.ready.append(s)
            if len(st.ready) >= st.chunk_n:
                _dispatch_chunk(st, st.ready)
                st.ready = []
        if not any(st.keys for st in sigs.values()):
            raise ValueError("no frames parsed")
        for st in sigs.values():
            if st.ready:
                _dispatch_chunk(st, st.ready)
                st.ready = []

    group_list = []
    for st in sigs.values():
        F = len(st.keys)
        if F == 0:
            group_list.append((st.stream_ids,
                               torch.zeros((len(st.stream_ids), 0), dtype=torch.uint8,
                                           device=dev)))
            continue
        # stitch chunk rows (stream-major, dispatch order) and per-frame
        # segments back into stream x frame order on the device
        def stitch(blocks):
            segs = [None] * F
            for bkey, js in st.bucket_js.items():
                for k, j in enumerate(js):
                    segs[j] = blocks[bkey][:, k]
            return torch.cat(segs, dim=1) if F > 1 else segs[0].contiguous()

        outs = {bkey: o[0] if len(o) == 1 else torch.cat(o, dim=0)
                for bkey, o in st.chunk_outs.items()}
        first = next(iter(outs.values()))
        if isinstance(first, Sharded):   # every bucket split by whole streams
            pcm_dev = Sharded([stitch({b: o.parts[i] for b, o in outs.items()})
                               for i in range(mesh.size)], 0, mesh)
        else:
            pcm_dev = stitch(outs)
        group_list.append((st.stream_ids, pcm_dev))

    results = []
    for s in range(n):
        total = int(sum(groups[key].bs[fi] for key, fi in frames_of[s])) \
            * decoders[s].num_channels
        results.append({"frame_results": codes[s], "num_samples": total,
                        "num_frames": len(frames_of[s])})
    return group_list, results


def decode_streams_to_device(decoders, buffers, device="cuda", mesh=None):
    """Uniform-fleet wrapper over :func:`decode_streams_to_device_grouped`:
    returns ``(pcm_dev, results)`` with ``pcm_dev`` one uint8 tensor
    ``[n_streams, stream_bytes]`` on ``device`` (rows in stream order;
    :class:`Sharded` along the stream axis when the fleet divides a mesh of
    more than one device). A fleet with more than one frame-shape signature
    raises: call the grouped variant for a mixed fleet.
    """
    group_list, results = decode_streams_to_device_grouped(decoders, buffers, device=device,
                                                           mesh=mesh)
    if len(group_list) != 1:
        raise ValueError(
            "decode_streams_to_device requires a uniform fleet (same "
            "frame-shape sequence per stream); this fleet has "
            f"{len(group_list)} shape signatures - use "
            "decode_streams_to_device_grouped for per-group device PCM")
    ids, pcm_dev = group_list[0]
    if ids != list(range(len(decoders))):
        whole = pcm_dev.gather() if isinstance(pcm_dev, Sharded) else pcm_dev
        whole = whole[torch.as_tensor(np.argsort(ids), device=whole.device)]
        pcm_dev = shard_streams(whole, mesh) if isinstance(pcm_dev, Sharded) else whole
    return pcm_dev, results


class FLACDecoder:
    """Drop-in equivalent of the reference decoder class, device-accelerated.

    Args:
      device: where the frame kernel runs: ``"cuda"`` (the default: the
        hand-written kernel) or ``"cpu"`` (its plain version). ``"cuda"``
        without a usable card raises; nothing falls back.
    """

    def __init__(self, device="cuda"):
        self.device = entry_device(device, "FLACDecoder")
        self._lib = host_lib()
        self._ctx = self._lib.eal_flac_create()
        self._output_32bit = False
        self._header_ok = False

    def __del__(self):
        try:
            self._lib.eal_flac_destroy(self._ctx)
        except Exception:
            pass

    # -------------------------------------------------------- checkpointing
    def get_state(self) -> dict:
        """Serializable snapshot of all carried decode state: the native
        front-end's blob (STREAMINFO, metadata, partial-header resume, CRC
        toggle) and the Python-side flags, with the JAX package's keys. The
        blob is the shared native library's, so a state saved by either
        package restores into the other with :meth:`set_state`."""
        n = self._lib.eal_flac_state_size(self._ctx)
        buf = np.zeros(n, np.uint8)
        rc = self._lib.eal_flac_state_save(
            self._ctx, buf.ctypes.data_as(C.POINTER(C.c_uint8)), n)
        if rc != 0:
            raise RuntimeError("FLAC state save failed")
        return {"native": buf.tobytes(), "output_32bit": self._output_32bit,
                "header_ok": self._header_ok}

    def set_state(self, state: dict) -> None:
        data = np.frombuffer(state["native"], np.uint8)
        rc = self._lib.eal_flac_state_load(
            self._ctx, data.ctypes.data_as(C.POINTER(C.c_uint8)), data.size)
        if rc != 0:
            raise RuntimeError("FLAC state load failed (bad/incompatible blob)")
        self._output_32bit = bool(state["output_32bit"])
        self._header_ok = bool(state["header_ok"])

    # ------------------------------------------------------------- header
    def read_header(self, buffer: bytes) -> FLACDecoderResult:
        buf = np.frombuffer(buffer, np.uint8)
        rc = self._lib.eal_flac_read_header(
            self._ctx, buf.ctypes.data_as(C.POINTER(C.c_uint8)), buf.size)
        res = FLACDecoderResult(rc)
        if res == FLACDecoderResult.SUCCESS:
            self._header_ok = True
        return res

    # ------------------------------------------------------------ getters
    @property
    def sample_rate(self) -> int:
        return self._lib.eal_flac_sample_rate(self._ctx)

    @property
    def num_channels(self) -> int:
        return self._lib.eal_flac_num_channels(self._ctx)

    @property
    def sample_depth(self) -> int:
        return self._lib.eal_flac_sample_depth(self._ctx)

    @property
    def min_block_size(self) -> int:
        return self._lib.eal_flac_min_block_size(self._ctx)

    @property
    def max_block_size(self) -> int:
        return self._lib.eal_flac_max_block_size(self._ctx)

    @property
    def num_samples(self) -> int:
        return self._lib.eal_flac_num_samples(self._ctx)

    @property
    def md5_signature(self) -> bytes:
        out = np.zeros(16, np.uint8)
        self._lib.eal_flac_md5(self._ctx, out.ctypes.data_as(C.POINTER(C.c_uint8)))
        return out.tobytes()

    def get_bytes_index(self) -> int:
        return self._lib.eal_flac_bytes_index(self._ctx)

    def get_output_bytes_per_sample(self) -> int:
        if self._output_32bit:
            return 4
        return (self.sample_depth + 7) // 8

    def get_output_buffer_size(self) -> int:
        return self.max_block_size * self.num_channels

    def get_output_buffer_size_bytes(self) -> int:
        return self.get_output_buffer_size() * self.get_output_bytes_per_sample()

    def get_metadata_blocks(self):
        n = self._lib.eal_flac_num_metadata(self._ctx)
        blocks = []
        for i in range(n):
            t = C.c_int32(0)
            ln = C.c_int32(0)
            self._lib.eal_flac_metadata_info(self._ctx, i, C.byref(t), C.byref(ln))
            data = np.zeros(max(ln.value, 1), np.uint8)
            self._lib.eal_flac_metadata_data(self._ctx, i,
                                             data.ctypes.data_as(C.POINTER(C.c_uint8)))
            blocks.append((FLACMetadataType(t.value), data[: ln.value].tobytes()))
        return blocks

    # ------------------------------------------------------------- config
    def set_max_metadata_size(self, mtype: FLACMetadataType, max_size: int) -> None:
        self._lib.eal_flac_set_max_metadata_size(self._ctx, int(mtype), max_size)

    def set_max_album_art_size(self, max_size: int) -> None:
        self.set_max_metadata_size(FLACMetadataType.PICTURE, max_size)

    def set_crc_check_enabled(self, enabled: bool) -> None:
        self._lib.eal_flac_set_crc_check(self._ctx, int(enabled))

    def set_output_32bit_samples(self, enabled: bool) -> None:
        self._output_32bit = enabled

    # ------------------------------------------------------------- frames
    def _parse_frame(self, buffer: np.ndarray):
        nch = self.num_channels
        mb = self.max_block_size
        data = np.zeros((nch, mb), np.int32)
        order = np.zeros(nch, np.int32)
        shift = np.zeros(nch, np.int32)
        wasted = np.zeros(nch, np.int32)
        use64 = np.zeros(nch, np.int32)
        coeffs = np.zeros((nch, 32), np.int32)
        bs = C.c_int32(0)
        ca = C.c_int32(0)
        depth = C.c_int32(0)
        crc_ok = C.c_int32(1)
        rc = self._lib.eal_flac_parse_frame(
            self._ctx, buffer.ctypes.data_as(C.POINTER(C.c_uint8)), buffer.size,
            data.ctypes.data_as(_i32p), mb,
            order.ctypes.data_as(_i32p), shift.ctypes.data_as(_i32p),
            wasted.ctypes.data_as(_i32p), use64.ctypes.data_as(_i32p),
            coeffs.ctypes.data_as(_i32p),
            C.byref(bs), C.byref(ca), C.byref(depth), C.byref(crc_ok))
        return (FLACDecoderResult(rc), data, order, shift, wasted, use64, coeffs,
                bs.value, ca.value, depth.value)

    def decode_frame(self, buffer: bytes):
        """Decode one frame: returns (result, packed_pcm_bytes | None,
        num_samples). num_samples counts interleaved samples (block_size *
        channels), like the reference's out-param (flac_decoder.cpp:221)."""
        buf = np.frombuffer(buffer, np.uint8) if isinstance(buffer, (bytes, bytearray)) \
            else buffer
        res, data, order, shift, wasted, use64, coeffs, bs, ca, depth = self._parse_frame(buf)
        if res != FLACDecoderResult.SUCCESS:
            return res, None, 0
        dev = self.device
        packed = flac_frame_cuda(
            _put(data[None, :, :bs], dev), _put(coeffs[None], dev), _put(order[None], dev),
            _put(shift[None], dev), _put(wasted[None], dev),
            _put(np.array([ca], np.int32), dev),
            depth=depth, nch=self.num_channels, mode32=self._output_32bit,
            use64=bool(use64.any()), max_order=_order_class(order))
        return res, _to_host(packed)[0].tobytes(), bs * self.num_channels

    # ----------------------------------------------------------- streaming
    def decode_stream(self, buffer: bytes, verify_md5: bool = True):
        """Decode an entire stream after read_header: one native call parses
        every frame, then all equal-shaped frames decode in single kernel
        launches (shared with the fleet path, see ``_decode_streams``).

        Returns (pcm_bytes, results) where results is a dict with per-frame
        result codes, total samples, and md5_ok (None when the STREAMINFO
        carries no signature or verify_md5=False).
        """
        return _decode_streams([self], [buffer], verify_md5, device=self.device)[0]

    def _md5_of_output(self, out_chunks) -> bytes:
        """MD5 over decoded PCM in FLAC's canonical form: interleaved,
        little-endian, ceil(depth/8) bytes, signed (the 8-bit bias removed
        and the byte-boundary shift undone before hashing)."""
        depth = self.sample_depth
        md5 = hashlib.md5()
        shift_amount = (8 - depth % 8) % 8
        bps = (depth + 7) // 8
        for chunk in out_chunks:
            if chunk is None:
                continue
            if shift_amount == 0 and depth != 8:
                md5.update(chunk.tobytes())
            else:
                arr = np.frombuffer(chunk.tobytes(), np.uint8).reshape(-1, bps).astype(np.int64)
                v = np.zeros(arr.shape[0], np.int64)
                for k in range(bps):
                    v |= arr[:, k] << (8 * k)
                sign = 1 << (8 * bps - 1)
                v = (v ^ sign) - sign
                if depth == 8:
                    v -= 128
                v >>= shift_amount
                repacked = np.zeros((arr.shape[0], bps), np.uint8)
                for k in range(bps):
                    repacked[:, k] = (v >> (8 * k)) & 0xFF
                md5.update(repacked.tobytes())
        return md5.digest()
