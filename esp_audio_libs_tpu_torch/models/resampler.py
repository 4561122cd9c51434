"""User-facing batched resampling pipeline in PyTorch: exact and fast mode.

The counterpart of esp_audio_libs_tpu/models/resampler.py (reference:
src/resample/resampler.cpp:21-160, include/resampler.h:15-82): packed PCM in,
packed PCM out, with the same configuration semantics: the ``lowpass_ratio``
heuristic, pre- vs post-filter selection, the ``taps/2`` latency advance, the
required-samples throttle, pass-through when rates match and per-stream clip
counts.

Exact mode (the default, bit-exact against the JAX package's exact mode):
each chunk runs unpack (stereo s16: one kernel,
ops/quantization_kernels.py::unpack16_extend_cuda, which reads the chunk's
bytes in place and writes the f32 slab behind the carried history; behind
the pre-filter it unpacks alone) -> two exact pre-filter biquad stages (downsampling;
the kernel ops/biquad_kernels.py::biquad_df1_cuda) -> the ordered-dot
polyphase kernel (ops/polyphase_kernels.py::polyphase_exact_cuda) -> two
exact post-filter stages (upsampling) -> quantize + pack (stereo s16: one
kernel, ops/quantization_kernels.py::quantize_pack16_cuda, which writes each
chunk's bytes and clip counts into the call's output buffers).

Fast mode: the pre-filter biquads are folded into the filterbank on the
host; each chunk then runs on the device as unpack into the slab (the same
kernel, padded to the slab's length) -> banded weight build ->
banded contraction (the CUDA kernel ops/polyphase_kernels.py::
polyphase_banded_cuda) -> post-filter conv through the same kernel
(upsampling) -> quantize + pack. The s16-in/s16-out fused tier
(``EAL_RESAMPLE_FUSED16=1``) swaps the f32 contraction and quantize for the
fused int16 kernel.

With a ``mesh`` of more than one device (parallel/mesh.py) every per-stream
tensor (the packed input, the history, the biquad states, the post-filter
tail, the outputs) is split along the stream axis, one block per device:
the weight tiles are built once per chunk and each contraction launches once
per shard through ``polyphase_banded_sharded`` /
``polyphase_fused16_sharded``; exact mode runs its biquad and polyphase
kernels per shard. The JAX package's ``mesh`` argument does the same with
``jax.sharding``.

The host runs only the f32 phase-grid control plane; all per-stream state
lives in tensors on the Resampler's device. The schedule depends only on the
configuration, the chunk counts and the carried phase, so once a call of
``resample_stream`` repeats the shape of the call before, it also builds the
next call's schedule and starts its upload after issuing its own device
work, while the card still runs it; the next call takes it over when its
key still matches (:meth:`Resampler.resample_stream`).
"""

from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import biquad as bq
from ..ops import quantization as q
from ..ops import sinc
from ..ops.polyphase import TILE, banded_K, banded_weights_device, polyphase_apply
from ..ops.polyphase_kernels import (polyphase_banded_cuda, polyphase_banded_sharded,
                                     polyphase_fused16_cuda, polyphase_fused16_sharded)
from ..ops.quantization_kernels import quantize_pack16_cuda, unpack16_extend_cuda
from ..parallel.mesh import Sharded, is_split, place, shard_streams, to_numpy
from ..runtime.kernels import entry_device
from ..runtime.native import design_filterbank_native
from ..runtime.phase_grid import HISTORY_MARGIN, PhaseState, phase_grid, required_samples
from ..runtime.trace import span

__all__ = ["ResamplerConfiguration", "ResamplerResults", "Resampler"]


def _ceil_to(n: int, m: int) -> int:
    return -(-n // m) * m


@dataclasses.dataclass
class ResamplerConfiguration:
    """Field-for-field mirror of the reference struct (include/resampler.h:22-32)."""

    source_sample_rate: float
    target_sample_rate: float
    source_bits_per_sample: int
    target_bits_per_sample: int
    channels: int
    use_pre_or_post_filter: bool
    subsample_interpolate: bool
    number_of_taps: int
    number_of_filters: int


@dataclasses.dataclass
class ResamplerResults:
    """Mirror of include/resampler.h:15-20, plus per-stream clip counts."""

    frames_used: int
    frames_generated: int
    predicted_frames_used: int
    clipped_samples: np.ndarray  # uint32 [batch]


def _clip_counts(per_stream) -> np.ndarray:
    """int64 device counts (a tensor, or split over a mesh) -> uint32 numpy
    at the API edge."""
    return to_numpy(per_stream).astype(np.uint32)


def _mesh_of(tree):
    """The mesh of the first :class:`Sharded` leaf of nested lists and
    tuples, or None."""
    if isinstance(tree, Sharded):
        return tree.mesh
    if isinstance(tree, (list, tuple)):
        for t in tree:
            m = _mesh_of(t)
            if m is not None:
                return m
    return None


def _shard_view(tree, i: int):
    """Shard ``i`` of nested lists and tuples: each Sharded leaf becomes its
    block ``i``; other leaves pass as they are."""
    if isinstance(tree, Sharded):
        return tree.parts[i]
    if isinstance(tree, (list, tuple)):
        return type(tree)(_shard_view(t, i) for t in tree)
    return tree


def _join(per_shard: list, mesh):
    """The inverse of :func:`_shard_view`: per-shard nested results, one
    structure whose tensor leaves are Sharded along axis 0."""
    first = per_shard[0]
    if isinstance(first, torch.Tensor):
        return Sharded(per_shard, 0, mesh)
    if isinstance(first, (list, tuple)):
        return type(first)(_join([p[k] for p in per_shard], mesh) for k in range(len(first)))
    return first


def _each(fn, *args):
    """``fn`` on the stream blocks: once per shard when an argument holds a
    :class:`Sharded` leaf (block ``i`` of every such leaf, other arguments
    whole), the results joined along axis 0; a plain call otherwise."""
    mesh = _mesh_of(args)
    if mesh is None:
        return fn(*args)
    return _join([fn(*_shard_view(args, i)) for i in range(mesh.size)], mesh)


class _ScheduleStage:
    """Where a call's schedule is built and uploaded: one reused host buffer
    (pinned on a card) that the rows are written into, and two device slots
    that it is uploaded into in turn, so that an upload never lands in the
    slot that the latest schedule's call reads. Each buffer grows to the
    largest schedule it has held.

    On a card the upload runs on a stream of its own, so that it overlaps
    the work already queued; the current stream then waits for it, so that
    work issued later, and the call's own synchronise, come after it. An
    upload into a slot waits for the work that was issued before the
    previous upload: it holds every reader of that slot."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.slot = 1               # the slot of the latest upload
        self._host = None           # (int32, f32) flat host buffers
        self._slots = [None, None]  # (int32, f32) flat device buffers
        self._stream = None
        self._copied = None         # the latest upload's completion
        self._issued = None         # the work issued before the latest upload

    def host(self, chunks: int, width: int):
        """Views ``[chunks, 4, width]`` int32 and ``[chunks, width]`` f32 of
        the host buffer, once the latest upload from it has completed."""
        if self._copied is not None:
            self._copied.synchronize()
        n = chunks * width
        if self._host is None or self._host[1].numel() < n:
            self._host = (torch.empty(4 * n, dtype=torch.int32, pin_memory=self.cuda),
                          torch.empty(n, dtype=torch.float32, pin_memory=self.cuda))
        gi, gw = self._host
        return (gi[:4 * n].numpy().reshape(chunks, 4, width),
                gw[:n].numpy().reshape(chunks, width))

    def upload(self, chunks: int, width: int):
        """Copy the host buffer's first ``chunks`` rows into the next slot.
        Returns its device views, shaped as :meth:`host`'s."""
        s = self.slot = self.slot ^ 1
        n = chunks * width
        fresh = self._slots[s] is None or self._slots[s][1].numel() < n
        if fresh:
            self._slots[s] = (torch.empty(4 * n, dtype=torch.int32, device=self.device),
                              torch.empty(n, dtype=torch.float32, device=self.device))
        (hi, hw), (di, dw) = self._host, self._slots[s]
        pairs = ((di[:4 * n], hi[:4 * n]), (dw[:n], hw[:n]))
        if not self.cuda:
            for dst, src in pairs:
                dst.copy_(src)
        else:
            cur = torch.cuda.current_stream(self.device)
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
            if fresh:   # a new block is free in the current stream's order only
                self._stream.wait_stream(cur)
            elif self._issued is not None:
                self._stream.wait_event(self._issued)
            self._issued = cur.record_event()
            with torch.cuda.stream(self._stream):
                for dst, src in pairs:
                    dst.copy_(src, non_blocking=True)
            self._copied = self._stream.record_event()
            cur.wait_event(self._copied)
        return di[:4 * n].view(chunks, 4, width), dw[:n].view(chunks, width)


@dataclasses.dataclass
class _Prefetch:
    """A schedule built ahead for the next call: its key, the per-chunk
    device tuples, the generated counts and the phase after it."""

    key: tuple
    grids: list
    gens: list
    phase: PhaseState


def _chunk_of(buf, c: int):
    """Chunk ``c`` of a ``[chunks, B, ...]`` output buffer; of one split along
    the stream axis 1, the shards' chunk ``c``, split along axis 0."""
    if isinstance(buf, Sharded):
        return Sharded([p[c] for p in buf.parts], 0, buf.mesh)
    return buf[c]


class Resampler:
    """Batched quantized -> float -> (biquads) -> sinc resample -> quantized.

    Args:
      batch: number of independent streams processed per call.
      exact: the bit-exact sequential mode (the default, as in the JAX
        package) or the fast banded mode.
      device: where every stream's state lives and the work runs: ``"cuda"``
        (the default: the hand-written kernels) or ``"cpu"`` (their plain
        versions). ``"cuda"`` without a usable card raises; nothing falls back.
      mesh: optional stream mesh (``parallel.mesh.stream_mesh``) of
        ``device``'s type. With more than one device, every per-stream
        tensor is split along the stream axis over it and each kernel
        launches once per shard; ``batch`` must divide evenly over it. A
        one-device mesh takes the single-device route on that device.
    """

    def __init__(self, batch: int, *, exact: bool = True, device="cuda", mesh=None):
        self.device = entry_device(device, "Resampler")
        if mesh is not None:
            if mesh.type != self.device.type:
                raise ValueError(f"Resampler(device={str(self.device)!r}) on a {mesh.type} mesh")
            if batch % mesh.size:
                raise ValueError(
                    f"batch {batch} must divide evenly over the {mesh.size}-device mesh")
            self.device = mesh.devices[0]
        self.mesh = mesh
        self._copies = {}
        self.batch = batch
        self.exact = exact
        self._initialized = False
        self._stage = _ScheduleStage(self.device)
        self._prefetch = None
        self._last_shape = None
        self.schedule_hits = 0
        self.schedule_misses = 0

    def _on(self, t: torch.Tensor, dev: torch.device) -> torch.Tensor:
        """A constant tensor of this instance on ``dev``: itself on its own
        device, else one copy per device, made once."""
        if t.device == dev:
            return t
        hit = self._copies.get((id(t), dev))
        if hit is None or hit[0] is not t:
            hit = self._copies[id(t), dev] = (t, t.to(dev))
        return hit[1]

    def _poly(self):
        """The banded contraction of this instance: the single-device kernel,
        or its sharded form under a mesh of more than one device."""
        if is_split(self.mesh):
            return functools.partial(polyphase_banded_sharded, mesh=self.mesh)
        return polyphase_banded_cuda

    def _poly16(self):
        """The fused int16 contraction, chosen as :meth:`_poly` chooses."""
        if is_split(self.mesh):
            return functools.partial(polyphase_fused16_sharded, mesh=self.mesh)
        return polyphase_fused16_cuda

    def _zeros(self, *shape) -> torch.Tensor:
        return torch.zeros(shape, dtype=torch.float32, device=self.device)

    def _outputs(self, lead: tuple, width: int):
        """A call's output buffers, unfilled: packed bytes uint8 ``[*lead,
        batch, width]`` and int64 clip counts ``[*lead, batch]``; under a mesh
        one block of streams per shard, split along the stream axis."""
        def make(dev, b):
            return (torch.empty((*lead, b, width), dtype=torch.uint8, device=dev),
                    torch.empty((*lead, b), dtype=torch.int64, device=dev))

        if not is_split(self.mesh):
            return make(self.device, self.batch)
        parts = [make(dev, self.batch // self.mesh.size) for dev in self.mesh.devices]
        return tuple(Sharded([p[k] for p in parts], len(lead), self.mesh) for k in range(2))

    def initialize(self, config: ResamplerConfiguration) -> bool:
        """Reference Resampler::initialize (resampler.cpp:21-98)."""
        f32 = np.float32
        self._prefetch = None
        self._last_shape = None
        self.config = config
        self.input_bits = config.source_bits_per_sample
        self.output_bits = config.target_bits_per_sample
        self.channels = config.channels
        taps = config.number_of_taps
        self.sample_ratio = f32(f32(config.target_sample_rate) / f32(config.source_sample_rate))
        self.lowpass_ratio = f32(1.0)
        self.requires_resampling = config.source_sample_rate != config.target_sample_rate
        self.pre_filter = False
        self.post_filter = False
        self._post_hist = None

        if self.requires_resampling:
            flags = sinc.SUBSAMPLE_INTERPOLATE if config.subsample_interpolate else 0

            if self.sample_ratio < 1.0:
                self.lowpass_ratio = f32(self.lowpass_ratio - f32(f32(10.24) / f32(taps)))
                if self.lowpass_ratio < f32(0.84):
                    self.lowpass_ratio = f32(0.84)
                if self.lowpass_ratio < self.sample_ratio:
                    # avoid discontinuities near unity sample ratios
                    self.lowpass_ratio = self.sample_ratio

            if f32(self.lowpass_ratio * self.sample_ratio) < f32(0.98) and config.use_pre_or_post_filter:
                cutoff = f32(f32(self.lowpass_ratio * self.sample_ratio) / f32(2.0))
                self.lowpass_coeffs = bq.biquad_init(bq.biquad_lowpass(float(cutoff)), 1.0)
                self.pre_filter = True
            if (f32(self.lowpass_ratio / self.sample_ratio) < f32(0.98) and config.use_pre_or_post_filter
                    and not self.pre_filter):
                cutoff = f32(f32(self.lowpass_ratio / self.sample_ratio) / f32(2.0))
                self.lowpass_coeffs = bq.biquad_init(bq.biquad_lowpass(float(cutoff)), 1.0)
                self.post_filter = True

            if self.pre_filter or self.post_filter:
                # DF-I states of the two biquad stages. Fast mode folds the
                # filters away and never reads them; it carries them so that
                # get_state/set_state keep the JAX package's checkpoint keys.
                self._coeffs_dev = torch.as_tensor(self.lowpass_coeffs, device=self.device)
                self._biquad_state = [
                    tuple(place(t, self.mesh) for t in
                          bq.BiquadState.zeros((self.batch, self.channels), device=self.device))
                    for _ in range(2)]

            if self.sample_ratio < 1.0:
                bank_lowpass = f32(self.sample_ratio * self.lowpass_ratio)
                bank_flags = flags | sinc.INCLUDE_LOWPASS
            elif self.lowpass_ratio < 1.0:
                bank_lowpass = self.lowpass_ratio
                bank_flags = flags | sinc.INCLUDE_LOWPASS
            else:
                bank_lowpass = f32(1.0)
                bank_flags = flags

            sinc.validate_params(taps, config.number_of_filters)
            self.bank_flags = bank_flags
            filters_np = np.asarray(design_filterbank_native(
                taps, config.number_of_filters, float(bank_lowpass), bank_flags), np.float32)
            self._fold_offset = 0
            if self.exact:
                self._filters = torch.as_tensor(filters_np, device=self.device)
            else:
                self._init_fast(filters_np, taps)
            self.hist_len = taps + HISTORY_MARGIN + self._fold_offset
            self.phase = PhaseState.initial(taps)
            self.phase.advance(taps / 2.0)
            self.history = place(self._zeros(self.batch, self.channels, self.hist_len), self.mesh)

        # True while the carried history was produced under gain_db == 0
        # (zeros qualify): the fused int16 tier reconstructs raw samples as
        # history / factor, which is only exact when the history's own gain
        # factor equals the current call's.
        self._hist_gain_zero = True
        self._initialized = True
        return True

    def _init_fast(self, filters_np, taps: int) -> None:
        """Fast mode's device constants: the folded filterbank, its direct
        row and slab width, and the post-filter's shared weight tile."""
        # Compose the pre-filter cascade into the filterbank (LTI): the
        # contraction does the lowpassing and the raw-input history reaches
        # back by the extra IR length.
        direct = np.zeros(taps, np.float32)
        direct[taps // 2 - 1] = 1.0
        fir_len = bq.fir_len_for(self.lowpass_coeffs) if self.pre_filter else None
        if fir_len is not None:
            filters_np, direct, self._fold_offset = bq.fold_biquad_into_filterbank(
                filters_np, self.lowpass_coeffs, fir_len, half=taps // 2)
        self._taps_p = filters_np.shape[1]
        self._K = banded_K(float(self.sample_ratio), self._taps_p)
        self._filters = torch.as_tensor(filters_np, device=self.device)
        self._direct = torch.as_tensor(direct, device=self.device)
        if self.post_filter:
            # post-lowpass (upsampling) as a banded conv at OUTPUT rate: both
            # biquad stages collapse into one truncated IR through the same
            # contraction. Stride-1 windows make the weight tile identical
            # for every 128-output block: one [K2, 128] block, starts 128*i.
            post_ir = bq.fir_len_for(self.lowpass_coeffs, cap=8192)
            if post_ir is None:
                raise NotImplementedError(
                    "post-filter poles too close to the unit circle for the "
                    "truncated-IR fast path; use exact=True")
            h1 = bq.biquad_impulse(self.lowpass_coeffs, post_ir)
            row = np.convolve(h1, h1)[::-1].astype(np.float32)
            Lh = row.shape[0]
            self._post_Hlen = Lh - 1
            self._post_K = banded_K(1.0, Lh)
            W2 = np.zeros((self._post_K, TILE), np.float32)
            for j in range(TILE):
                W2[j:j + Lh, j] = row
            self._post_W2 = torch.as_tensor(W2, device=self.device)
            self._post_hist = place(self._zeros(self.batch, self.channels, self._post_Hlen),
                                    self.mesh)

    # -------------------------------------------------------- checkpointing
    def get_state(self) -> dict:
        """Serializable snapshot of the carried stream state, with the keys
        and dtypes of the JAX package's ``Resampler.get_state``. Restore into
        an identically initialized Resampler (of either package, with or
        without a mesh) with :meth:`set_state`. Split state is gathered."""
        if not self._initialized:
            raise RuntimeError("Resampler.initialize() first")
        host = to_numpy
        st = {}
        if self.requires_resampling:
            st["phase_offset"] = np.float32(self.phase.offset)
            st["phase_input_index"] = int(self.phase.input_index)
            st["history"] = host(self.history)
        if self.pre_filter or self.post_filter:
            st["biquad"] = [tuple(host(s) for s in stage) for stage in self._biquad_state]
        if self._post_hist is not None:
            st["post_hist"] = host(self._post_hist)
        st["hist_gain_zero"] = bool(self._hist_gain_zero)
        return st

    def set_state(self, st: dict) -> None:
        if not self._initialized:
            raise RuntimeError("Resampler.initialize() first")
        as_dev = lambda a: place(torch.as_tensor(np.array(a, np.float32), device=self.device),
                                 self.mesh)
        self._prefetch = None
        if self.requires_resampling:
            self.phase.offset = np.float32(st["phase_offset"])
            self.phase.input_index = int(st["phase_input_index"])
            self.history = as_dev(st["history"])
        if self.pre_filter or self.post_filter:
            self._biquad_state = [tuple(as_dev(s) for s in stage) for stage in st["biquad"]]
        if "post_hist" in st:
            self._post_hist = as_dev(st["post_hist"])
        # absent in snapshots from before the fused tier -> conservatively
        # route the first post-restore calls through the f32 body
        self._hist_gain_zero = bool(st.get("hist_gain_zero", False))

    # ------------------------------------------------------------------ core
    def _to_device(self, input_bytes):
        """The packed input on the device, split over the mesh if there is
        one (a :class:`Sharded` input split the same way stays as it is)."""
        if is_split(self.mesh):
            if not isinstance(input_bytes, Sharded):
                input_bytes = torch.as_tensor(input_bytes, dtype=torch.uint8)
            return shard_streams(input_bytes, self.mesh)
        if isinstance(input_bytes, Sharded):
            input_bytes = input_bytes.gather(self.device)
        return torch.as_tensor(input_bytes, dtype=torch.uint8, device=self.device)

    def resample(self, input_bytes, input_frames_available: int,
                 output_frames_free: int, gain_db: float = 0.0):
        """Reference Resampler::resample (resampler.cpp:100-160), batched.

        Args:
          input_bytes: uint8 ``[batch, >= frames*channels*bps]`` packed
            little-endian interleaved PCM (numpy or tensor).
          input_frames_available / output_frames_free: per-stream counts
            (identical across the batch: streams advance in lockstep).
        Returns: (packed uint8 tensor ``[batch, generated*channels*bps_out]``,
          results). Frames beyond ``results.frames_used`` were not consumed.
        """
        with span("eal.resample"):
            if not self._initialized:
                raise RuntimeError("Resampler.initialize() first")
            ch = self.channels
            if self.requires_resampling:
                necessary = required_samples(self.phase, output_frames_free, self.sample_ratio)
                frames = min(input_frames_available, necessary)
            else:
                frames = min(input_frames_available, output_frames_free)

            bps_in = q.bytes_per_sample(self.input_bits)
            data = _each(lambda d: d[:, : frames * ch * bps_in], self._to_device(input_bytes))

            if not self.requires_resampling:
                factor = q.gain_factor(self.input_bits, gain_db)

                def passthrough(d):
                    x = q.int_to_float(q.unpack_pcm(d, self.input_bits), factor)
                    samples, clipped = q.float_to_int(x, self.output_bits)
                    return q.pack_pcm(samples, self.output_bits), clipped.sum(-1, dtype=torch.int64)
                packed, per_stream = _each(passthrough, data)
                return packed, ResamplerResults(frames, frames, frames, _clip_counts(per_stream))

            # compute the schedule on a SCRATCH phase and commit it only after
            # the device work was issued without error: phase_grid advances its
            # state in place, and a failed call must leave self.phase aligned
            # with the carried history. The frame count is the caller's: the
            # schedule is built here, never ahead.
            with span("eal.schedule"):
                self._prefetch = None
                phase = dataclasses.replace(self.phase)
                (grid_t,), (gen,), used = self._schedule(phase, frames, output_frames_free, 1)
            # gen is host-known: quantize (and post-filter) only the generated
            # samples, as the reference does
            packed, clips = self._run_chunks([data], [grid_t], [gen], phase, gain_db,
                                             frames=frames, T=gen, out_max=output_frames_free,
                                             hist_from=used, fused_ok=False)
            return _chunk_of(packed, 0), ResamplerResults(
                frames_used=used,
                frames_generated=gen,
                predicted_frames_used=frames,
                clipped_samples=_clip_counts(_chunk_of(clips, 0)),
            )

    # ------------------------------------------------------------ schedule
    def _schedule(self, phase: PhaseState, frames: int, n: int, chunks: int, *,
                  whole: bool = False):
        """Build the schedules of ``chunks`` chunks of ``frames`` input and
        ``n`` output frames from ``phase`` (advanced in place), straight into
        the stage's host buffer, and upload them into its next slot.
        ``whole``: every chunk must consume all its frames.

        The layout is the kernels': exact mode takes each grid as generated
        (win0 + hist_len; entries past the generated count as the phase grid
        leaves them, mode 0); the fast tiers take rows padded to a tile
        multiple, window starts shifted into xext coordinates, the pad
        repeating the last window start. Returns (per chunk the device tuple
        (win0, idx1, idx2, weight, mode), the generated counts, the frames
        the last chunk used); the tuples view a slot that the upload after
        the next one overwrites."""
        width, shift = n, self.hist_len
        if not self.exact:
            width, shift = _ceil_to(n, TILE), self.hist_len - self._fold_offset
        gi, gw = self._stage.host(chunks, width)
        mode = np.empty(n, np.int8)
        gens, used = [], frames
        for c in range(chunks):
            g = phase_grid(phase, self.config.number_of_filters, self.bank_flags,
                           self.sample_ratio, frames, n,
                           out=(gi[c, 0, :n], gi[c, 1, :n], gi[c, 2, :n], gw[c, :n], mode))
            # generous out_max guarantees every input sample is consumed
            if whole and g.input_used != frames:
                raise AssertionError((g.input_used, frames))
            gi[c, 3, :n] = mode
            gi[c, 0, :n] += shift
            gi[c, 0, n:] = gi[c, 0, n - 1] if n else 0
            gi[c, 1:, n:] = 0
            gw[c, n:] = 0
            gens.append(g.output_generated)
            used = g.input_used
        di, dw = self._stage.upload(chunks, width)
        return [(di[c, 0], di[c, 1], di[c, 2], dw[c], di[c, 3]) for c in range(chunks)], gens, used

    def _schedule_key(self, chunk_frames: int, num_chunks: int, out_max: int) -> tuple:
        """What a stream call's schedule depends on, the carried phase by
        its f32 bits."""
        p = self.phase
        return (np.float32(p.offset).tobytes(), p.input_index, p.num_taps,
                self.config.number_of_filters, self.bank_flags,
                np.float32(self.sample_ratio).tobytes(), chunk_frames, num_chunks, out_max,
                self.exact, self.hist_len, self._fold_offset, self.device, self.mesh)

    def _prefetch_next(self, chunk_frames: int, num_chunks: int, out_max: int) -> None:
        """Build the schedule of a next call of this shape from the committed
        phase and start its upload, while the card runs this call. A failed
        build leaves no prefetch, and the next call then builds at its head
        and raises there."""
        try:
            with span("eal.schedule"):
                phase = dataclasses.replace(self.phase)
                grids, gens, _ = self._schedule(phase, chunk_frames, out_max, num_chunks,
                                                whole=True)
        except Exception:
            return
        self._prefetch = _Prefetch(self._schedule_key(chunk_frames, num_chunks, out_max),
                                   grids, gens, phase)

    # ------------------------------------------------------ chunk bodies
    def _biquad_states(self) -> list:
        """The carried states of the two biquad stages ([] without a filter)."""
        return list(self._biquad_state) if (self.pre_filter or self.post_filter) else []

    @staticmethod
    def _carry(xext, start: int, n: int):
        """The next history of a slab ``xext`` that holds the carried one
        first: the clone of its ``n`` frames that start at ``start``. Every
        history carry of the chunk path goes through here: the input history
        of each tier and the fast post-filter's output tail."""
        return xext[..., start:start + n].clone()

    @staticmethod
    def _extend(hist, x, start: int, length: int | None = None):
        """The carried history ``hist`` put before ``x`` along time, padded
        with zeros at the end to ``length`` frames (None: unpadded), and the
        next history (:meth:`_carry`)."""
        xext = torch.cat([hist, x], dim=-1)
        padded = xext if length is None else F.pad(xext, (0, length - xext.shape[-1]))
        return padded, Resampler._carry(xext, start, hist.shape[-1])

    def _slab_len(self, frames: int) -> int:
        """xext's padded time length: at least one slab, a multiple of 128."""
        return _ceil_to(max(self.hist_len + frames, self._K), TILE)

    def _unpack(self, data, factor, frames, hist=None, start: int = 0,
                length: int | None = None):
        """Packed bytes -> f32 [B, ch, frames] times the gain ``factor``
        (both modes). Given the carried ``hist``, what :meth:`_extend` gives
        of those frames: the slab padded to ``length`` and the next history.
        Stereo s16 is one kernel launch on the card that writes the whole
        slab (ops/quantization_kernels.py); other formats run the torch ops."""
        B = data.shape[0]
        ch, in_bits = self.channels, self.input_bits
        with span("eal.unpack"):
            if ch == 2 and in_bits == 16:
                H = 0 if hist is None else hist.shape[-1]
                xext = unpack16_extend_cuda(data, frames, factor, hist,
                                            H + frames if length is None else length)
                return xext if hist is None else (xext, self._carry(xext, start, H))
            x = q.int_to_float(q.unpack_pcm(data, in_bits), factor)
            x = x.reshape(B, frames, ch).transpose(1, 2)
            return x if hist is None else self._extend(hist, x, start, length)

    def _quantize(self, out, gen: int, packed, clips) -> None:
        """f32 [B, ch, T] -> quantized and packed into ``packed`` (uint8 [B,
        T*ch*bps]), and the int64 per-stream clip counts over the ``gen``
        valid outputs into ``clips``; both modes. Stereo s16 is one kernel
        launch on the card (ops/quantization_kernels.py); other formats run
        the torch ops."""
        B, ch, T = out.shape
        out_bits = self.output_bits
        with span("eal.quantize"):
            if ch == 2 and out_bits == 16:
                quantize_pack16_cuda(out, gen, packed, clips)
                return
            y = out.transpose(1, 2).reshape(B, T * ch)
            samples, clipped = q.float_to_int(y, out_bits)
            packed.copy_(q.pack_pcm(samples, out_bits))
            clips.copy_(clipped[:, : gen * ch].sum(-1, dtype=torch.int64))

    # The tier bodies, as :meth:`_run_chunks` calls them: one chunk, the
    # carried (history, tier state) in and out, the first T frames of the
    # out_max-wide contraction quantized into the chunk's slab.
    def _exact_chunk(self, chunk, carry, grid_t, gen: int, packed, clips, *, hist_from: int,
                     factor, frames: int, T: int, out_max: int):
        """Exact mode, on each block of streams as a whole: unpack, the two
        exact pre-filter stages (downsampling), the ordered-dot kernel over
        history + chunk, the two exact post-filter stages over the T frames
        with ``valid_len`` = ``gen`` (upsampling), the quantize. The tier
        state is the biquad stages' ([] without a filter); the schedule is
        already ``out_max`` wide."""
        def step(d, hist, states, p, c):
            dev, states = d.device, list(states)

            def biquads(x, valid_len=None):
                coeffs = self._on(self._coeffs_dev, dev)
                with span("eal.biquad"):
                    for stage in range(2):
                        x, states[stage] = bq.biquad_apply(x, coeffs, states[stage], exact=True,
                                                           valid_len=valid_len)
                return x

            if self.pre_filter:   # the biquads run between the unpack and the extend
                x = biquads(self._unpack(d, factor, frames))
            else:
                x = None
                xext, hist = self._unpack(d, factor, frames, hist, hist_from)
            with span("eal.polyphase"):
                if x is not None:
                    xext, hist = self._extend(hist, x, hist_from)
                out = polyphase_apply(
                    xext, self._on(self._filters, dev), *(g.to(dev) for g in grid_t),
                    half=self.config.number_of_taps // 2, exact=True,
                    compute_second=bool(self.bank_flags & sinc.SUBSAMPLE_INTERPOLATE))
            # free the chunk's slab before the post-filter stages, which
            # hold three output-sized buffers at once (upsampling's peak)
            del x, xext
            out = out[..., :T]
            if self.post_filter:
                out = biquads(out, gen)
            self._quantize(out, gen, p, c)
            return hist, states

        return _each(step, chunk, *carry, packed, clips)

    def _fast_chunk(self, chunk, carry, grid_t, gen: int, packed, clips, *, hist_from: int,
                    factor, frames: int, T: int, out_max: int):
        """The f32 fast path: the extend and the quantize per block of
        streams, the banded weight tiles built once, the contraction (once
        per shard under a mesh), then the post-filter (upsampling) as a
        banded conv over the output stream through the same kernel. The
        tier state is the post-filter's output tail (None without it)."""
        hist, oh = carry
        L = self._slab_len(frames)
        xext, hist = _each(lambda c, h: self._unpack(c, factor, frames, h, hist_from, L),
                           chunk, hist)
        with span("eal.weights"):
            Wt, starts = banded_weights_device(
                self._filters, self._direct, *grid_t, gen, K=self._K, taps_p=self._taps_p, L=L)
        with span("eal.polyphase"):
            out = self._poly()(xext, Wt, starts, T=out_max)
        if self.post_filter:
            # y[t] = sum_j h2[j] out[t-j], the tail carrying the previous
            # chunk's valid outputs; one weight tile shared by every block
            with span("eal.post"):
                K2 = self._post_K
                L2 = _ceil_to(self._post_Hlen + out_max + K2, TILE)
                xe, oh = _each(lambda o, h: self._extend(h, o, gen, L2), out, oh)
                nt2 = -(-out_max // TILE)
                starts2 = torch.arange(nt2, dtype=torch.int32, device=self.device) * TILE
                Wt2 = self._post_W2[None].expand(nt2, K2, TILE)
                out = self._poly()(xe, Wt2, starts2, T=out_max)
        _each(lambda o, p, c: self._quantize(o[..., :T], gen, p, c), out, packed, clips)
        return hist, oh

    def _fused_chunk(self, chunk, carry, grid_t, gen: int, packed, clips, *, hist_from: int,
                     factor, frames: int, T: int, out_max: int):
        """The fused int16 tier: samples stay RAW int16 (the history too),
        the gain ``factor`` (a device scalar here) is folded into the weight
        tiles, and the fused kernel does contraction + quantize in one pass;
        its packed bytes and clip counts are copied into the slab."""
        ch = self.channels
        L = self._slab_len(frames)

        def extend(c, h):
            x = q.unpack_pcm16_planar2_raw(c) if ch == 2 else q.unpack_pcm16_raw(c)[:, None, :]
            xext, h = self._extend(h, x, hist_from, L)
            return xext.reshape(-1, L), h

        def finish(s16, cmask, p, c):
            s16 = s16.reshape(-1, ch, s16.shape[-1])[..., :T]
            cmask = cmask.reshape(-1, ch, cmask.shape[-1])[..., :gen]
            clip = (cmask > 0).sum((1, 2), dtype=torch.int64)
            if ch == 2:
                p.copy_(q.pack_pcm16_interleave2(s16.to(torch.int32)))
            else:
                p.copy_(q.pack_pcm(s16[:, 0, :].to(torch.int32), 16))
            c.copy_(clip)

        hist, oh = carry
        x2, hist = _each(extend, chunk, hist)
        Wt, starts = banded_weights_device(
            self._filters, self._direct, *grid_t, gen, K=self._K, taps_p=self._taps_p, L=L)
        _each(finish, *self._poly16()(x2, Wt * factor, starts), packed, clips)
        return hist, oh

    def _run_chunks(self, chunks, grids, gens, phase: PhaseState, gain_db: float, *,
                    frames: int, T: int, out_max: int, hist_from: int, fused_ok: bool):
        """The chunk loop of both entry points: the tier's body over each
        chunk's packed bytes, schedule tuple and generated count, the
        history and the tier state carried from chunk to chunk. Each chunk
        consumes ``hist_from`` of its ``frames`` input frames, contracts
        ``out_max`` output frames and quantizes the first T into its slab of
        the call's outputs. ``fused_ok``: the fused int16 tier may serve
        (:meth:`_fused_tier_selected`). The carried state, ``phase`` and the
        gain flag commit once, after the last chunk was issued: a call that
        raises commits nothing. Returns the outputs: packed uint8 ``[chunks,
        batch, T*ch*bps]`` and int64 clip counts ``[chunks, batch]``."""
        factor = q.gain_factor(self.input_bits, gain_db)
        packed, clips = self._outputs((len(chunks),),
                                      T * self.channels * q.bytes_per_sample(self.output_bits))
        # the fused int16 tier carries the history as raw int16: exact only
        # when the history holds int16 * factor products of this call's gain
        # factor, so that f32 -> raw -> f32 gives identical floats
        raw = not self.exact and self._fused_tier_selected(fused_ok)
        if raw:
            body = self._fused_chunk
            factor = torch.tensor(factor, dtype=torch.float32, device=self.device)
            carry = (_each(lambda h: torch.clamp(torch.round(h / factor.to(h.device)),
                                                 -32768.0, 32767.0).to(torch.int16),
                           self.history), self._post_hist)
        elif self.exact:
            body, carry = self._exact_chunk, (self.history, self._biquad_states())
        else:
            body, carry = self._fast_chunk, (self.history, self._post_hist)
        for c, (chunk, grid_t, gen) in enumerate(zip(chunks, grids, gens)):
            carry = body(chunk, carry, grid_t, gen, _chunk_of(packed, c), _chunk_of(clips, c),
                         hist_from=hist_from, factor=factor, frames=frames, T=T, out_max=out_max)
        history, state = carry
        if raw:
            history = _each(lambda h: h.to(torch.float32) * factor.to(h.device), history)
        self.history = history
        if not self.exact:
            self._post_hist = state
        elif self.pre_filter or self.post_filter:
            self._biquad_state = state
        self.phase = phase
        self._hist_gain_zero = gain_db == 0.0
        return packed, clips

    # ------------------------------------------------------------ streaming
    def resample_stream(self, input_bytes, chunk_frames: int, num_chunks: int,
                        gain_db: float = 0.0):
        """Process ``num_chunks`` fixed-size chunks in one call.

        The host precomputes the phase grids of all chunks up front (they
        are data-independent) and ships them in one transfer; the chunk loop
        then issues device work only, carrying the history (and post-filter
        tail) on the device. When this call's shape repeats the call
        before's, it then builds the schedule of a next call of the same
        shape from the committed phase, before the clip counts' synchronise,
        so the card runs this call meanwhile; the next call takes it over
        (``eal.schedule.hit``, ``schedule_hits``) when its key matches, and
        builds at its head otherwise (``schedule_misses``).

        Args:
          input_bytes: uint8 ``[batch, >= num_chunks*chunk_frames*ch*bps]``,
            numpy or a tensor (already on the device: no copy), or under a
            mesh a :class:`~..parallel.mesh.Sharded` split along axis 0 (the
            fleets' device PCM: no copy either).
        Returns: (packed uint8 tensor ``[num_chunks, batch, out_max*ch*bps_out]``
          (under a mesh, Sharded along the stream axis 1),
          list of per-chunk generated counts, uint32 numpy clip counts
          ``[num_chunks, batch]``). Output chunk i holds ``gen[i]*ch*bps_out``
          valid bytes.
        """
        with span("eal.resample_stream"):
            if not (self._initialized and self.requires_resampling):
                raise RuntimeError("resample_stream needs an initialized, resampling Resampler")
            ch = self.channels
            out_max = int(np.ceil(chunk_frames * float(self.sample_ratio))) + 8

            # schedules compute on a SCRATCH phase, committed only after the
            # device work was issued (retry-safety, like _hist_gain_zero)
            pre, self._prefetch = self._prefetch, None
            if pre is not None and pre.key == self._schedule_key(chunk_frames, num_chunks,
                                                                 out_max):
                with span("eal.schedule.hit"):
                    grids, gens, phase = pre.grids, pre.gens, pre.phase
                self.schedule_hits += 1
            else:
                self.schedule_misses += 1
                with span("eal.schedule"):
                    phase = dataclasses.replace(self.phase)
                    grids, gens, _ = self._schedule(phase, chunk_frames, out_max, num_chunks,
                                                    whole=True)

            chunk_bytes = chunk_frames * ch * q.bytes_per_sample(self.input_bits)
            data = self._to_device(input_bytes)
            chunks = [_each(lambda d, c=c: d[:, c * chunk_bytes:(c + 1) * chunk_bytes], data)
                      for c in range(num_chunks)]
            packed, clips = self._run_chunks(
                chunks, grids, gens, phase, gain_db, frames=chunk_frames, T=out_max,
                out_max=out_max, hist_from=chunk_frames,
                fused_ok=gain_db == 0.0 and self._hist_gain_zero)
            shape, self._last_shape = self._last_shape, (chunk_frames, num_chunks)
            if shape == self._last_shape:
                self._prefetch_next(chunk_frames, num_chunks, out_max)
            return packed, gens, _clip_counts(clips)

    def _fused_tier_selected(self, fused_ok: bool) -> bool:
        """The fused int16 tier serves s16 in/out without a post stage, on
        opt-in (``EAL_RESAMPLE_FUSED16=1``) and only under the gain
        precondition ``fused_ok``."""
        return (fused_ok
                and os.environ.get("EAL_RESAMPLE_FUSED16", "") in ("1", "true")
                and not self.post_filter and self.channels in (1, 2)
                and self.input_bits == 16 and self.output_bits == 16
                # under a mesh the kernel runs per shard
                # (polyphase_fused16_sharded): each shard's local
                # [B*ch/mesh, L] block must meet the JAX kernel's 16-row
                # minimum, so that both packages pick the same tier
                and (not is_split(self.mesh)
                     or (self.batch * self.channels // self.mesh.size) % 16 == 0))
