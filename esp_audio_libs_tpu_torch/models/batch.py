"""Batched multi-stream FLAC and MP3 decoding: the port's data-parallel
serving layer, the counterpart of esp_audio_libs_tpu/models/batch.py.

The reference is one decoder instance per stream and leaves parallelism to
the caller. Here each stream keeps its own native bitstream front-end on the
host, and every stream's numeric work folds into the lane axis of the shared
kernels, so one launch decodes a whole group of streams: FLAC frames are
bucketed by block size x depth x channels, MP3 streams grouped by version x
samplerate x channels x FIFO phase.

Both fleets take an optional stream ``mesh`` (parallel/mesh.py): a dispatch
whose size divides the mesh splits into contiguous blocks, one kernel launch
per device, and the MP3 fleet keeps its carried device state split along the
stream axis; other dispatches run on the mesh's first device.
"""

from __future__ import annotations

import ctypes as C

import numpy as np
import torch

from ..parallel.mesh import Sharded, is_split, place, shard_streams
from ..runtime import transport
from ..runtime.kernels import entry_device
from ..runtime.native import host_lib
from ..runtime.trace import span
from ..utils.errors import MP3Error
from . import mp3_pipeline
from .flac import (FLACDecoder, _decode_streams, _to_host, decode_streams_to_device,
                   decode_streams_to_device_grouped)
from .mp3 import MP3Decoder

__all__ = ["BatchedFLACDecoder", "BatchedMP3Decoder", "MP3DeviceRunResult", "MP3RunResult",
           "parsed_runs"]

_i32p = C.POINTER(C.c_int32)
_u8p = C.POINTER(C.c_uint8)
_SKIP = np.iinfo(np.int32).min     # the batch parse's code for a skipped stream


class MP3RunResult(list):
    """``decode_run`` host result: a list over streams of per-frame
    ``(err, pcm | None, consumed)`` tuples, plus ``next_pos``.

    ``next_pos[s]`` is the offset into the buffer passed for stream s where
    the next run starts. It is not ``sum(consumed)``: after each successful
    frame the run plays the reference caller protocol and skips reservoir
    slack to the next sync word (MP3FindSyncWord, reference
    mp3_decoder.cpp:8533), bytes that appear in no frame's ``consumed``.
    After an error frame (which ends that stream's run) ``next_pos`` points
    just past the consumed bytes, where the reference caller would resync.
    """

    def __init__(self, items, next_pos):
        super().__init__(items)
        self.next_pos = list(next_pos)


class MP3DeviceRunResult(tuple):
    """``decode_run(to_device=True)`` result: unpacks as ``(pcm_dev,
    consumed_list)``, with the ``next_pos`` attribute of
    :class:`MP3RunResult`."""

    def __new__(cls, pcm, consumed, next_pos):
        self = super().__new__(cls, (pcm, consumed))
        self.next_pos = list(next_pos)
        return self


def _fleet_device(device, mesh, what: str) -> torch.device:
    """The fleet's device: ``device``, or the first device of ``mesh``,
    whose type must be ``device``'s."""
    dev = entry_device(device, what)
    if mesh is None:
        return dev
    if mesh.type != dev.type:
        raise ValueError(f"{what}(device={str(dev)!r}) on a {mesh.type} mesh")
    return mesh.devices[0]


class BatchedFLACDecoder:
    """Decode many independent FLAC streams with shared batched kernels.

    Each stream has its own host front-end (sync, header and Rice parsing
    are bitstream-serial); frames from all streams are bucketed by kernel
    shape and each bucket runs as one launch of the same kernel the
    single-stream ``FLACDecoder.decode_stream`` uses, so outputs are
    bit-identical to decoding each stream alone.

    Args:
      n_streams: number of stream slots.
      device: ``"cuda"`` (the default) or ``"cpu"``; ``"cuda"`` without a
        usable card raises.
      mesh: optional stream mesh of ``device``'s type: a bucket whose frame
        count divides its size splits over it, one frame-kernel launch per
        shard, each with its own escape sideband; other buckets run on its
        first device (``models.flac._run_frame_bucket``).
    """

    def __init__(self, n_streams: int, *, device="cuda", mesh=None):
        self.device = _fleet_device(device, mesh, "BatchedFLACDecoder")
        self.mesh = mesh
        self.decoders = [FLACDecoder(device=self.device) for _ in range(n_streams)]

    def read_headers(self, blobs):
        """Parse headers for all streams; returns a list of FLACDecoderResult."""
        return [d.read_header(b) for d, b in zip(self.decoders, blobs)]

    def reset_stream(self, s: int) -> None:
        """Recycle slot ``s`` for a new stream: FLAC carries all per-stream
        state in the host front-end (the frame kernel is stateless), so a
        fresh decoder is the whole reset; read the new stream's header with
        ``self.decoders[s].read_header(blob)`` next."""
        self.decoders[s] = FLACDecoder(device=self.device)

    def decode_streams(self, buffers, verify_md5: bool = True):
        """Decode all streams' frame sections (the bytes after the header).

        Args:
          buffers: per-stream bytes (None skips a stream).
        Returns: per-stream (pcm_bytes, results-dict) like
          ``FLACDecoder.decode_stream``.
        """
        return _decode_streams(self.decoders, buffers, verify_md5, device=self.device,
                               mesh=self.mesh)

    def decode_streams_to_device(self, buffers):
        """Uniform-fleet decode leaving the packed PCM on the device: the
        composition path for decode -> resample chains (see
        ``models.flac.decode_streams_to_device``). With a mesh the PCM comes
        back split along the stream axis, ready for a ``Resampler`` on the
        same mesh."""
        return decode_streams_to_device(self.decoders, buffers, device=self.device,
                                        mesh=self.mesh)

    def decode_streams_to_device_grouped(self, buffers):
        """Mixed-fleet decode leaving PCM on the device, grouped by
        frame-shape signature (``models.flac.decode_streams_to_device_grouped``)."""
        return decode_streams_to_device_grouped(self.decoders, buffers, device=self.device,
                                                mesh=self.mesh)

    # ---------------------------------------------------------- checkpoint
    def get_state(self) -> dict:
        """Serializable snapshot of the whole fleet, the JAX package's dict:
        FLAC carries all per-stream state in the host front-end, so the
        snapshot is the per-stream state list. Restore with
        :meth:`set_state` into a ``BatchedFLACDecoder`` (of either package)
        of the same width."""
        return {"streams": [d.get_state() for d in self.decoders]}

    def set_state(self, state: dict) -> None:
        if len(state["streams"]) != len(self.decoders):
            raise ValueError(
                f"state holds {len(state['streams'])} streams, decoder has "
                f"{len(self.decoders)}")
        for d, s in zip(self.decoders, state["streams"]):
            d.set_state(s)


class BatchedMP3Decoder:
    """Decode many independent MP3 streams in lockstep.

    Each stream keeps its own Helix-equivalent front-end (sync, side info,
    Huffman and the bit reservoir are serial per stream); granule synthesis
    runs with streams folded into the lanes of the granule kernel. Streams
    are grouped by (version, samplerate index, channels, FIFO phase,
    granules to run), each group one launch per dispatch slice; outputs are
    bit-identical to decoding each stream alone.

    The carried synthesis state lives on the device, batch-stacked, in the
    JAX package's layout: over ``[N, 2, 288]``, block type, window switch
    and IMDCT block count ``[N, 2]``, vbuf ``[N, 2176]``, and a host-side
    FIFO phase per stream.

    Args:
      n_streams: number of stream slots.
      device: ``"cuda"`` (the default) or ``"cpu"``; ``"cuda"`` without a
        usable card raises.
      mesh: optional stream mesh of ``device``'s type; ``n_streams`` must be
        a multiple of its size. The carried device state stays split along
        the stream axis over it, and a dispatch group whose size divides it
        runs one granule-kernel launch per shard (``_group_mesh``); other
        groups run on its first device.
      fast: the granule tier (``mp3_pipeline._tier``). ``False`` (the
        default): the exact integer pipeline above. ``"mirror"``: every
        value of the exact tier mirrored in f32 (ops/mp3fast.py), one
        launch of csrc/mp3_granules_f32.cu per group and slice. ``True`` or
        ``"mxu"``: the IMDCT and the subband synthesis as probed linear
        operators (ops/mp3mxu.py; built on the CPU at the first run, or
        loaded from their cache), two step kernels and two FP32 GEMMs per
        granule. Both relaxed tiers are within 1 LSB of the exact tier on
        decodable streams (at most 4 LSB on under 0.5 % of samples where
        the audio clips hard), not bit-exact; errors, consumed bytes and
        ``next_pos`` are the exact tier's. Their ``over`` and ``vbuf`` are
        f32 (snapshots cross between tiers by value, see :meth:`set_state`),
        and ``last_frame_reference_defined`` stays True: they do not track
        the reference's undefined case. The JAX package's fleet keeps
        ``bool(fast)``, so there ``fast="mirror"`` runs its MXU tier; here
        it runs the mirror tier, and ``fast=True`` runs the MXU tier in
        both.
    """

    def __init__(self, n_streams: int, *, device="cuda", mesh=None, fast=False):
        self.device = _fleet_device(device, mesh, "BatchedMP3Decoder")
        if mesh is not None and n_streams % mesh.size:
            raise ValueError(f"n_streams={n_streams} must be a multiple of the mesh size "
                             f"({mesh.size}) for an even stream split")
        self.mesh = mesh
        self.tier = mp3_pipeline._tier(fast)
        # the dtype of the carried overlap and FIFO: f32 under a relaxed tier
        self._num_dtype = torch.int32 if self.tier == "exact" else torch.float32
        self.decoders = [MP3Decoder(device=self.device) for _ in range(n_streams)]
        self.last_frame_reference_defined = [True] * n_streams

        def zeros(*shape, dtype=torch.int32):
            return place(torch.zeros(shape, dtype=dtype, device=self.device), mesh)

        N = n_streams
        self._over = zeros(N, 2, 288, dtype=self._num_dtype)
        self._pt = zeros(N, 2)
        self._pws = zeros(N, 2)
        self._npv = zeros(N, 2)
        self._vbuf = zeros(N, 2176, dtype=self._num_dtype)
        self._vindex = [0] * N

    def _state(self):
        return (self._over, self._pt, self._pws, self._npv, self._vbuf)

    def _group_mesh(self, n_group: int):
        """The mesh for a dispatch group of ``n_group`` streams, or None when
        the group cannot split evenly (it then runs on the first device)."""
        if is_split(self.mesh) and n_group % self.mesh.size == 0:
            return self.mesh
        return None

    def _gather_state(self, streams):
        if streams == list(range(len(self.decoders))):
            return self._state()              # the whole fleet: no gather
        idx = torch.as_tensor(streams, device=self.device)
        picked = tuple((a.gather(self.device) if isinstance(a, Sharded) else a).index_select(0, idx)
                       for a in self._state())
        gmesh = self._group_mesh(len(streams))
        if gmesh is not None:   # a sub-fleet that divides the mesh stays split
            picked = tuple(shard_streams(a, gmesh) for a in picked)
        return picked

    def _scatter_state(self, streams, new_state):
        if streams == list(range(len(self.decoders))):
            self._over, self._pt, self._pws, self._npv, self._vbuf = new_state
            return
        if not is_split(self.mesh):
            idx = torch.as_tensor(streams, device=self.device)
            for a, new in zip(self._state(), new_state):
                a.index_copy_(0, idx, new)
            return
        # each new row goes into the block of the shard that holds its stream
        rows = np.asarray(streams)
        for a, new in zip(self._state(), new_state):
            new = new.gather(self.device) if isinstance(new, Sharded) else new
            for part, (lo, hi) in zip(a.parts, a.block_rows()):
                mine = np.flatnonzero((rows >= lo) & (rows < hi))
                if mine.size:
                    src = new.index_select(0, torch.as_tensor(mine, device=new.device))
                    part.index_copy_(0, torch.as_tensor(rows[mine] - lo, device=part.device),
                                     src.to(part.device))

    def reset_stream(self, s: int) -> None:
        """Recycle slot ``s`` for a new stream: a fresh native front-end (bit
        reservoir, sync state), a zeroed device state row (in the fleet's
        dtypes) and FIFO phase 0; the other slots are untouched, and a split
        state stays split."""
        self.decoders[s] = MP3Decoder(device=self.device)
        self.last_frame_reference_defined[s] = True
        self._vindex[s] = 0
        for a in self._state():
            if isinstance(a, Sharded):
                for part, (lo, hi) in zip(a.parts, a.block_rows()):
                    if lo <= s < hi:
                        part[s - lo] = 0
            else:
                a[s] = 0

    # ---------------------------------------------------------- checkpoint
    def get_state(self) -> dict:
        """Serializable snapshot of the whole fleet, the JAX package's dict:
        per-stream native front-end images (bit reservoirs included), the
        batch-stacked device state as numpy (one synchronisation), the FIFO
        phases and the reference-UB flags. Restore with :meth:`set_state`
        into a ``BatchedMP3Decoder`` (of either package) of the same width;
        decoding then continues byte-identically to an uninterrupted run of
        the same tier. ``over`` and ``vbuf`` are in the fleet's own dtype
        (f32 under a relaxed tier)."""
        state = tuple(a.gather(self.device) if isinstance(a, Sharded) else a
                      for a in self._state())
        pinned = self.device.type == "cuda"
        host = [torch.empty(a.shape, dtype=a.dtype, pin_memory=pinned) for a in state]
        for h, a in zip(host, state):
            h.copy_(a, non_blocking=pinned)
        if pinned:
            with span("eal.wait"):
                torch.cuda.current_stream(self.device).synchronize()
        over, pt, pws, npv, vbuf = (h.numpy().copy() for h in host)
        return {"native": [d._native_snapshot() for d in self.decoders],
                "over": over, "pt": pt, "pws": pws, "npv": npv, "vbuf": vbuf,
                "vindex": list(self._vindex),
                "ref_defined": list(self.last_frame_reference_defined)}

    def set_state(self, state: dict) -> None:
        """Load a :meth:`get_state` snapshot (of either package) and upload
        its device state to ``self.device`` (split over the mesh, if the
        fleet has one: a snapshot moves between fleets with and without a
        mesh). A snapshot of another width
        raises ``ValueError``, a bad native image ``RuntimeError``. ``over``
        and ``vbuf`` cross between tiers by value, as in JAX's ``set_state``
        (a relaxed tier mirrors the exact tier's integer values in f32): an
        f32 snapshot is rounded to int32 in an exact fleet, and any snapshot
        is cast to f32 in a relaxed one."""
        n = len(self.decoders)
        if len(state["native"]) != n:
            raise ValueError(f"state holds {len(state['native'])} streams, decoder has {n}")
        for d, blob in zip(self.decoders, state["native"]):
            d._native_restore(blob)

        def upload(a, shape, by_value=False):
            a = np.asarray(a)
            dtype = np.int32
            if by_value and self._num_dtype == torch.float32:
                dtype = np.float32
            elif by_value and a.dtype.kind == "f":
                a = np.rint(np.clip(a, -2 ** 31, 2 ** 31 - 1))
            if a.shape != shape:
                raise ValueError(f"state array of shape {a.shape}, expected {shape}")
            return place(torch.as_tensor(a.astype(dtype), device=self.device), self.mesh)

        self._over = upload(state["over"], (n, 2, 288), by_value=True)
        self._pt = upload(state["pt"], (n, 2))
        self._pws = upload(state["pws"], (n, 2))
        self._npv = upload(state["npv"], (n, 2))
        self._vbuf = upload(state["vbuf"], (n, 2176), by_value=True)
        self._vindex = [int(v) for v in state["vindex"]]
        self.last_frame_reference_defined = [bool(v) for v in state["ref_defined"]]

    def _parse_batch(self, views, use_size=False):
        """The fleet's serial front-ends in one native call
        (``eal_mp3_parse_frame_batch``); outputs land batch-stacked.

        views: per-stream uint8 numpy views, or None to skip a stream.
        Returns a dict of batch arrays; ``rc`` is ``_SKIP`` for skipped rows.
        """
        n = len(self.decoders)
        out = {
            "huff": np.zeros((n, 2, 2, 576), np.int32),
            "params": np.zeros((n, 2, 2, 24), np.int32),
            "sf": np.zeros((n, 2, 2, 62), np.int32),
            "frame": np.zeros((n, 16), np.int32),
            "sfjs": np.zeros((n, 8), np.int32),
            "consumed": np.zeros(n, np.int32),
            "clear": np.zeros(n, np.int32),
            "err_gr": np.zeros(n, np.int32),
            "rc": np.full(n, _SKIP, np.int32),
        }
        ctxs = (C.c_void_p * n)()
        bufp = (_u8p * n)()
        lens = np.zeros(n, np.int32)
        for s, (dec, b) in enumerate(zip(self.decoders, views)):
            if b is None:
                continue
            ctxs[s] = dec._ctx
            bufp[s] = b.ctypes.data_as(_u8p)
            lens[s] = b.size
        host_lib().eal_mp3_parse_frame_batch(
            n, ctxs, bufp, lens.ctypes.data_as(_i32p), int(use_size),
            *(out[k].ctypes.data_as(_i32p) for k in ("huff", "params", "sf", "frame", "sfjs",
                                                      "consumed", "clear", "err_gr", "rc")))
        return out

    @staticmethod
    def _as_view(buf):
        if buf is None:
            return None
        return (np.frombuffer(buf, np.uint8) if isinstance(buf, (bytes, bytearray))
                else np.ascontiguousarray(buf))

    @staticmethod
    def _sync_ahead(view, pos: int) -> int:
        """Advance ``pos`` to the next frame sync word (the reference caller
        protocol, mp3_decoder.cpp:8533-8568); ``view.size`` when there is
        none."""
        if pos >= view.size:
            return view.size
        sub = view[pos:]
        off = host_lib().eal_mp3_find_sync_word(sub.ctypes.data_as(_u8p), sub.size)
        return pos + off if off >= 0 else view.size

    def _run_group(self, streams, arrays, vindex):
        """Synthesize one group's granules (``arrays`` as
        ``mp3_pipeline.decode_granules_run`` takes them) on the fleet's
        device state; commits the state and the FIFO phase. Returns (pcm,
        ref_undef) on the device."""
        pcm, new_state, ref_undef = mp3_pipeline.decode_granules_run(
            *arrays, self._gather_state(streams), vindex, mesh=self._group_mesh(len(streams)),
            fast=self.tier)
        self._scatter_state(streams, new_state)
        new_vindex = mp3_pipeline._advance_vindex(vindex, arrays[0].shape[1])
        for s in streams:
            self._vindex[s] = new_vindex
        return pcm, ref_undef

    def decode(self, buffers, use_size=False):
        """One frame per stream: returns a list of (err, pcm | None, consumed).

        Pass None for a stream to skip it this step (its state is kept).
        Semantics per stream match ``MP3Decoder.decode``, including the
        MP3ClearBadFrame zero-fill and the partial-granule state update of a
        mid-frame error (reference mp3_decoder.cpp:8677-8685, 8807-8854).
        """
        n = len(self.decoders)
        assert len(buffers) == n
        pa = self._parse_batch([self._as_view(b) for b in buffers], use_size)
        results = [None] * n
        work = {}   # group key -> streams
        for s, dec in enumerate(self.decoders):
            if pa["rc"][s] == _SKIP:
                continue
            err = MP3Error(int(pa["rc"][s]))
            frame = pa["frame"][s]
            dec._last_frame = frame
            ngr, nch, ngs = int(frame[6]), int(frame[5]), int(frame[7])
            self.last_frame_reference_defined[s] = True
            if err != MP3Error.NONE:
                results[s] = (err, np.zeros(ngr * ngs * nch, np.int16) if pa["clear"][s]
                              else None, int(pa["consumed"][s]))
                ngr = max(int(pa["err_gr"][s]), 0)
            if ngr > 0:
                key = (int(frame[0]), int(frame[4]), nch, self._vindex[s], ngr)
                work.setdefault(key, []).append(s)

        for (_, _, _, vindex, ngr), streams in work.items():
            frame = pa["frame"][streams]
            arrays = (pa["huff"][streams, :ngr], pa["params"][streams, :ngr],
                      pa["sf"][streams, :ngr], np.repeat(frame[:, None], ngr, 1),
                      np.repeat(pa["sfjs"][streams][:, None], ngr, 1))
            pcm, ref_undef = self._run_group(streams, arrays, vindex)
            pcm_np, undef = _to_host(pcm), _to_host(ref_undef)
            for k, s in enumerate(streams):
                self.last_frame_reference_defined[s] = not bool(undef[k])
                if results[s] is None:   # success: emit the PCM
                    results[s] = (MP3Error.NONE, pcm_np[k], int(pa["consumed"][s]))
        return results

    @staticmethod
    def _peek_format(view, pos):
        """(ver, sr_idx, nch) from the 4 header bytes at pos, or None when
        they cannot be a Layer III header (the parse then reports the
        error). Field layout per ISO/IEC 11172-3 §2.4.1.3."""
        if pos + 4 > view.size:
            return None
        b1, b2, b3 = int(view[pos + 1]), int(view[pos + 2]), int(view[pos + 3])
        if int(view[pos]) != 0xFF or (b1 & 0xF0) != 0xF0:
            return None
        ver_idx = (b1 >> 3) & 0x03
        ver = 2 if ver_idx == 0 else (0 if (ver_idx & 1) else 1)
        return (ver, (b2 >> 2) & 0x03, 1 if ((b3 >> 6) & 0x03) == 3 else 2)

    def decode_run(self, buffers, n_frames, use_size=False, to_device=False):
        """Serving-rate API: decode up to ``n_frames`` sequential frames per
        stream, synthesizing each format group's whole run of granules in one
        kernel launch per dispatch slice.

        Per-frame semantics are those of repeated :meth:`decode` calls with
        the reference caller protocol between frames (skip reservoir slack to
        the next sync word after each successful frame). A stream's run ends
        at its first error frame (included, with the partial-granule state
        update), at the end of its buffer, or before a format change.
        ``last_frame_reference_defined`` aggregates over the run.

        Returns :class:`MP3RunResult`. With ``to_device=True`` (a uniform,
        error-free fleet: one format group holding every stream) returns
        :class:`MP3DeviceRunResult`, ``(pcm_dev, consumed_list)`` with
        ``pcm_dev`` int16 ``[n_streams, run_samples]`` left on the device
        for composition (``pcm_dev.view(torch.uint8)`` is the packed PCM;
        with a mesh, :class:`~..parallel.mesh.Sharded` along the stream
        axis, one block per device).
        A fleet that breaks those conditions raises ``ValueError`` and is
        left as it was before the call.
        """
        with span("eal.mp3.decode_run"):
            views = [self._as_view(b) for b in buffers]
            start = [0] * len(self.decoders)
            if not to_device:
                return self._dispatch_run(self._parse_run(views, start, n_frames, use_size))
            # the parse advances every native bit reservoir before the
            # conditions can be checked: snapshot, and roll back on failure
            snaps = [(d._native_snapshot(), d._last_frame) for d in self.decoders]
            try:
                return self._dispatch_run(self._parse_run(views, start, n_frames, use_size), True)
            except ValueError:
                for d, (blob, lf) in zip(self.decoders, snaps):
                    d._native_restore(blob)
                    d._last_frame = lf
                raise

    def _parse_run(self, views, pos, n_frames, use_size=False):
        """Host phase of a run: parse up to n_frames per stream, stream s
        from offset ``pos[s]`` of its view. Changes only the native
        front-ends (reservoirs) and ``_last_frame`` of each decoder, never
        the device state, the FIFO phases or ``last_frame_reference_defined``
        (what ``_dispatch_run`` reads), so a worker thread can parse run
        k + 1 while run k dispatches (:meth:`decode_run_pipelined`). It
        touches no CUDA. Returns the parses, per-stream frame plans and the
        end positions, absolute within the views."""
        with span("eal.mp3.parse"):
            n = len(self.decoders)
            pos = list(pos)
            active = [v is not None and v.size > pos[s] for s, v in enumerate(views)]
            fmt0 = [None] * n
            perstream = [[] for _ in range(n)]   # (parse index, err, clear, consumed, granules)
            parses = []
            for _ in range(n_frames):
                ins = [None] * n
                for s in range(n):
                    if not active[s]:
                        continue
                    fmt = self._peek_format(views[s], pos[s])
                    if fmt is not None and fmt0[s] is not None and fmt != fmt0[s]:
                        active[s] = False   # a format change: the next call takes it
                        continue
                    ins[s] = views[s][pos[s]:]
                if all(v is None for v in ins):
                    break
                pa = self._parse_batch(ins, use_size)
                parses.append(pa)
                for s in range(n):
                    if ins[s] is None or pa["rc"][s] == _SKIP:
                        continue
                    err = MP3Error(int(pa["rc"][s]))
                    consumed = int(pa["consumed"][s])
                    frame = pa["frame"][s]
                    pos[s] += consumed
                    self.decoders[s]._last_frame = frame
                    if err == MP3Error.NONE:
                        pos[s] = self._sync_ahead(views[s], pos[s])
                        ngr = int(frame[6])
                        fmt0[s] = (int(frame[0]), int(frame[4]), int(frame[5]))
                    else:
                        ngr = max(int(pa["err_gr"][s]), 0)
                        active[s] = False
                    perstream[s].append((len(parses) - 1, err, bool(pa["clear"][s]), consumed, ngr))
                    if active[s] and pos[s] >= views[s].size:
                        active[s] = False
            return {"parses": parses, "perstream": perstream, "pos": pos}

    def decode_run_pipelined(self, buffers, n_frames, n_runs, use_size=False, to_device=False):
        """Generator over up to ``n_runs`` successive :meth:`decode_run`
        results with the host and device phases overlapped: one worker
        thread parses run k + 1 (the native batch parse releases the GIL)
        while run k dispatches.

        Each run equals a sequential ``decode_run`` call (``to_device``
        included) from where the last one stopped; ``next_pos`` is absolute
        within the ``buffers`` given here. It stops early when no stream
        has frames left. As in the JAX package, a consumer that stops early
        leaves the run after its last one parsed (its native reservoirs
        advanced), and a ``to_device`` run that breaks its conditions
        raises ``ValueError`` without the rollback of ``decode_run``.
        """
        from concurrent.futures import ThreadPoolExecutor

        # the worker's _parse_run writes only the native front-ends and
        # _last_frame; _dispatch_run (with _run_groups, _run_group and the
        # state gathers) reads and writes the device state, _vindex and
        # last_frame_reference_defined and reads the parsed dict it is
        # handed, never a front-end or _last_frame: no state is shared
        views = [self._as_view(b) for b in buffers]
        with ThreadPoolExecutor(max_workers=1) as ex:
            fut = ex.submit(self._parse_run, views, [0] * len(self.decoders), n_frames,
                            use_size)
            for r in range(n_runs):
                parsed = fut.result()
                if not any(parsed["perstream"]):
                    break
                if r + 1 < n_runs:
                    fut = ex.submit(self._parse_run, views, parsed["pos"], n_frames, use_size)
                yield self._dispatch_run(parsed, to_device)

    def _run_groups(self, parsed):
        """Group a parsed run's streams by (format, FIFO phase, granules):
        {key: streams}, key = (ver, sr_idx, nch, vindex, G)."""
        work = {}
        for s, plan in enumerate(parsed["perstream"]):
            if not plan:
                continue
            G = sum(k for *_, k in plan)
            first = parsed["parses"][plan[0][0]]["frame"][s]
            key = (int(first[0]), int(first[4]), int(first[5]), self._vindex[s], G)
            work.setdefault(key, []).append(s)
        return work

    @staticmethod
    def _group_arrays(parsed, streams, G):
        """The run arrays of a group: huff [B, G, 2, 576], params, sf,
        frame [B, G, 16], sfjs [B, G, 8], each stream's granules in order."""
        with span("eal.mp3.arrays"):
            B = len(streams)
            huff_g = np.empty((B, G, 2, 576), np.int32)
            params_g = np.empty((B, G, 2, 24), np.int32)
            sf_g = np.empty((B, G, 2, 62), np.int32)
            frame_g = np.empty((B, G, 16), np.int32)
            sfjs_g = np.empty((B, G, 8), np.int32)
            for bi, s in enumerate(streams):
                g = 0
                for (fi, _err, _clear, _con, k) in parsed["perstream"][s]:
                    pa = parsed["parses"][fi]
                    huff_g[bi, g:g + k] = pa["huff"][s][:k]
                    params_g[bi, g:g + k] = pa["params"][s][:k]
                    sf_g[bi, g:g + k] = pa["sf"][s][:k]
                    frame_g[bi, g:g + k] = pa["frame"][s]
                    sfjs_g[bi, g:g + k] = pa["sfjs"][s]
                    g += k
            return huff_g, params_g, sf_g, frame_g, sfjs_g

    def _dispatch_run(self, parsed, to_device=False):
        """Device phase of a run: group, synthesize, assemble the results.
        Changes the device state and the FIFO phases; call in run order."""
        n = len(self.decoders)
        parses, perstream = parsed["parses"], parsed["perstream"]
        work = self._run_groups(parsed)
        if to_device:
            if len(work) != 1:
                raise ValueError("to_device requires a uniform fleet (one format group)")
            (key, streams), = work.items()
            if len(streams) != n:
                raise ValueError("to_device requires every stream in the group")
            if any(e != MP3Error.NONE for plan in perstream for _, e, *_ in plan):
                raise ValueError("to_device requires an error-free run")
            pcm, ref_undef = self._run_group(streams, self._group_arrays(parsed, streams, key[4]),
                                             key[3])
            for s, u in zip(streams, _to_host(ref_undef)):
                self.last_frame_reference_defined[s] = not bool(u)
            return MP3DeviceRunResult(pcm, [sum(c for *_, c, _k in perstream[s])
                                            for s in streams], parsed["pos"])

        results = [[] for _ in range(n)]
        pending = []   # (pcm, ref_undef, streams, nch) per dispatch slice, in order
        for (ver, sr_idx, nch, vindex, G), streams in work.items():
            if G == 0:
                pending.append((None, None, streams, nch))
                continue
            arrays = self._group_arrays(parsed, streams, G)
            # stream-axis slices of about MP3_SLICE_PCM_BYTES of PCM each:
            # the host packs and uploads a slice while the card runs the last
            B = len(streams)
            per = B   # under a mesh a group dispatches whole, as in the JAX package
            if not is_split(self.mesh):
                n_sl = max(1, -(-B * G * 576 * nch * 2 // transport.MP3_SLICE_PCM_BYTES))
                per = -(-B // n_sl)
            for c0 in range(0, B, per):
                chunk = streams[c0:c0 + per]
                pcm, ref_undef = self._run_group(chunk, tuple(a[c0:c0 + per] for a in arrays),
                                                 vindex)
                pending.append((pcm, ref_undef, chunk, nch))
        for pcm, ref_undef, chunk, nch in pending:
            pcm_np = None if pcm is None else _to_host(pcm)
            undef = None if ref_undef is None else _to_host(ref_undef)
            for bi, s in enumerate(chunk):
                if undef is not None:
                    self.last_frame_reference_defined[s] = not bool(undef[bi])
                off = 0
                for (fi, err, clear, consumed, k) in perstream[s]:
                    if err == MP3Error.NONE:
                        results[s].append((err, pcm_np[bi, off:off + k * 576 * nch].copy(),
                                           consumed))
                    else:
                        frame = parses[fi]["frame"][s]
                        ntot = int(frame[6]) * int(frame[7]) * int(frame[5])
                        results[s].append((err, np.zeros(ntot, np.int16) if clear else None,
                                           consumed))
                    off += k * 576 * nch
        return MP3RunResult(results, parsed["pos"])


def parsed_runs(bat: BatchedMP3Decoder, buffers, n_frames: int):
    """Parse one run of ``bat``'s fleet (advancing its native front-ends,
    not its device state) and yield, per format group, ``(fmt, vindex,
    streams, huff_gs, side_gs)`` with ``fmt = (ver, sr_idx, nch, cutoff)``
    and the host operands of the group's kernel launch
    (``mp3_pipeline.run_operands``): real parsed runs for holding
    ``mp3_granules_cuda`` to its plain version."""
    parsed = bat._parse_run([bat._as_view(b) for b in buffers], [0] * len(buffers), n_frames)
    for (_, _, _, vindex, G), streams in bat._run_groups(parsed).items():
        if G:
            fmt, huff_gs, side_gs = mp3_pipeline.run_operands(
                *bat._group_arrays(parsed, streams, G))
            yield fmt, vindex, streams, huff_gs, side_gs
