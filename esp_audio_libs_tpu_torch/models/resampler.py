"""User-facing batched resampling pipeline, fast mode, in PyTorch.

The counterpart of esp_audio_libs_tpu/models/resampler.py (reference:
src/resample/resampler.cpp:21-160, include/resampler.h:15-82): packed PCM in,
packed PCM out, with the same configuration semantics: the ``lowpass_ratio``
heuristic, pre- vs post-filter selection, the ``taps/2`` latency advance, the
required-samples throttle, pass-through when rates match and per-stream clip
counts.

Fast mode only. The pre-filter biquads are folded into the filterbank on the
host; each chunk then runs on the device as unpack -> banded weight build ->
banded contraction (the CUDA kernel ops/polyphase_kernels.py::
polyphase_banded_cuda) -> post-filter conv through the same kernel
(upsampling) -> quantize + pack. The s16-in/s16-out fused tier
(``EAL_RESAMPLE_FUSED16=1``) swaps the f32 contraction and quantize for the
fused int16 kernel. The host runs only the f32 phase-grid control plane;
all per-stream state lives in tensors on the Resampler's device.

Exact mode needs the sequential f32 scans (ROADMAP.md, Queue 1 item 3) and
raises ``NotImplementedError`` until they are ported.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import biquad as bq
from ..ops import quantization as q
from ..ops import sinc
from ..ops.polyphase import TILE, banded_K, banded_weights_device
from ..ops.polyphase_kernels import polyphase_banded_cuda, polyphase_fused16_cuda
from ..runtime.native import design_filterbank_native
from ..runtime.phase_grid import HISTORY_MARGIN, PhaseState, phase_grid, required_samples

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


def _clip_counts(per_stream: torch.Tensor) -> np.ndarray:
    """int64 device counts -> uint32 numpy at the API edge."""
    return per_stream.cpu().numpy().astype(np.uint32)


class Resampler:
    """Batched quantized -> float -> sinc resample -> quantized, fast mode.

    Args:
      batch: number of independent streams processed per call.
      exact: the bit-exact sequential mode of the JAX package; not ported
        yet, so ``True`` raises ``NotImplementedError``.
      device: where every stream's state lives and the work runs: ``"cuda"``
        (the hand-written kernels) or ``"cpu"`` (their plain versions).
        ``"cuda"`` without a usable card raises; nothing falls back.
    """

    def __init__(self, batch: int, *, exact: bool = True, device):
        if exact:
            raise NotImplementedError(
                "exact=True needs the sequential f32 scans of ops/scan.py and the "
                "device biquad (ROADMAP.md, Queue 1 item 3), not ported yet; "
                "use exact=False")
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("Resampler(device='cuda'): CUDA is not available")
        elif self.device.type != "cpu":
            raise ValueError(f"unsupported device {self.device}: expected cpu or cuda")
        self.batch = batch
        self._initialized = False

    def _zeros(self, *shape) -> torch.Tensor:
        return torch.zeros(shape, dtype=torch.float32, device=self.device)

    def initialize(self, config: ResamplerConfiguration) -> bool:
        """Reference Resampler::initialize (resampler.cpp:21-98)."""
        f32 = np.float32
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

            fir_len = None
            if self.pre_filter or self.post_filter:
                # DF-I states of the two biquad stages. Fast mode folds the
                # filters away and never reads them; they are carried so that
                # get_state/set_state keep the JAX package's checkpoint keys.
                self._biquad_state = [
                    tuple(self._zeros(self.batch, self.channels) for _ in range(4))
                    for _ in range(2)]
                fir_len = bq.fir_len_for(self.lowpass_coeffs)

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
            # Compose the pre-filter cascade into the filterbank (LTI): the
            # contraction does the lowpassing and the raw-input history
            # reaches back by the extra IR length.
            self._fold_offset = 0
            direct = np.zeros(taps, np.float32)
            direct[taps // 2 - 1] = 1.0
            if self.pre_filter and fir_len is not None:
                filters_np, direct, self._fold_offset = bq.fold_biquad_into_filterbank(
                    filters_np, self.lowpass_coeffs, fir_len, half=taps // 2)
            self.hist_len = taps + HISTORY_MARGIN + self._fold_offset
            self._taps_p = filters_np.shape[1]
            self._K = banded_K(float(self.sample_ratio), self._taps_p)
            self._filters = torch.as_tensor(filters_np, device=self.device)
            self._direct = torch.as_tensor(direct, device=self.device)
            if self.post_filter:
                # post-lowpass (upsampling) as a banded conv at OUTPUT rate:
                # both biquad stages collapse into one truncated IR through
                # the same contraction. Stride-1 windows make the weight tile
                # identical for every 128-output block: one [K2, 128] block,
                # starts 128*i.
                post_ir = bq.fir_len_for(self.lowpass_coeffs, cap=8192)
                if post_ir is None:
                    raise NotImplementedError(
                        "post-filter poles too close to the unit circle for the "
                        "truncated-IR fast path")
                h1 = bq.biquad_impulse(self.lowpass_coeffs, post_ir)
                row = np.convolve(h1, h1)[::-1].astype(np.float32)
                Lh = row.shape[0]
                self._post_Hlen = Lh - 1
                self._post_K = banded_K(1.0, Lh)
                W2 = np.zeros((self._post_K, TILE), np.float32)
                for j in range(TILE):
                    W2[j:j + Lh, j] = row
                self._post_W2 = torch.as_tensor(W2, device=self.device)
                self._post_hist = self._zeros(self.batch, self.channels, self._post_Hlen)
            self.phase = PhaseState.initial(taps)
            self.phase.advance(taps / 2.0)
            self.history = self._zeros(self.batch, self.channels, self.hist_len)

        # True while the carried history was produced under gain_db == 0
        # (zeros qualify): the fused int16 tier reconstructs raw samples as
        # history / factor, which is only exact when the history's own gain
        # factor equals the current call's.
        self._hist_gain_zero = True
        self._initialized = True
        return True

    # -------------------------------------------------------- checkpointing
    def get_state(self) -> dict:
        """Serializable snapshot of the carried stream state, with the keys
        and dtypes of the JAX package's ``Resampler.get_state``. Restore into
        an identically initialized Resampler (of either package) with
        :meth:`set_state`."""
        if not self._initialized:
            raise RuntimeError("Resampler.initialize() first")
        st = {}
        if self.requires_resampling:
            st["phase_offset"] = np.float32(self.phase.offset)
            st["phase_input_index"] = int(self.phase.input_index)
            st["history"] = self.history.cpu().numpy()
        if self.pre_filter or self.post_filter:
            st["biquad"] = [tuple(s.cpu().numpy() for s in stage)
                            for stage in self._biquad_state]
        if self._post_hist is not None:
            st["post_hist"] = self._post_hist.cpu().numpy()
        st["hist_gain_zero"] = bool(self._hist_gain_zero)
        return st

    def set_state(self, st: dict) -> None:
        if not self._initialized:
            raise RuntimeError("Resampler.initialize() first")
        as_dev = lambda a: torch.as_tensor(np.array(a, np.float32), device=self.device)
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
    def _to_device(self, input_bytes) -> torch.Tensor:
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
        if not self._initialized:
            raise RuntimeError("Resampler.initialize() first")
        ch = self.channels
        if self.requires_resampling:
            necessary = required_samples(self.phase, output_frames_free, self.sample_ratio)
            frames = min(input_frames_available, necessary)
        else:
            frames = min(input_frames_available, output_frames_free)

        bps_in = q.bytes_per_sample(self.input_bits)
        factor = q.gain_factor(self.input_bits, gain_db)
        data = self._to_device(input_bytes)[:, : frames * ch * bps_in]

        if not self.requires_resampling:
            x = q.int_to_float(q.unpack_pcm(data, self.input_bits), factor)
            samples, clipped = q.float_to_int(x, self.output_bits)
            per_stream = clipped.sum(-1, dtype=torch.int64)
            return q.pack_pcm(samples, self.output_bits), ResamplerResults(
                frames, frames, frames, _clip_counts(per_stream))

        # compute the schedule on a SCRATCH phase and commit it only after
        # the device work was issued without error: phase_grid advances its
        # state in place, and a failed call must leave self.phase aligned
        # with the carried history
        phase = dataclasses.replace(self.phase)
        grid = phase_grid(phase, self.config.number_of_filters, self.bank_flags,
                          self.sample_ratio, frames, output_frames_free)
        gen = grid.output_generated
        packed, per_stream, history, post_hist = self._fast_chunk(
            data, factor, self.history, self._post_hist,
            self._device_grids([grid], output_frames_free)[0], gen,
            frames=frames, out_max=output_frames_free, hist_from=grid.input_used)
        self.history, self._post_hist = history, post_hist
        self.phase = phase
        self._hist_gain_zero = gain_db == 0.0
        bps_out = q.bytes_per_sample(self.output_bits)
        return packed[:, : gen * ch * bps_out], ResamplerResults(
            frames_used=grid.input_used,
            frames_generated=gen,
            predicted_frames_used=frames,
            clipped_samples=_clip_counts(per_stream),
        )

    # -------------------------------------------------- fast-path pieces
    def _device_grids(self, grids, out_len: int):
        """Per chunk, the grid tensors (win0x, idx1, idx2, weight, mode) on
        the device: padded to a tile multiple, window starts shifted into
        xext coordinates. All chunks ship in two transfers (one int32 and
        one f32 array), whatever their number."""
        T = _ceil_to(out_len, TILE)
        gi = np.zeros((len(grids), 4, T), np.int32)
        gw = np.zeros((len(grids), T), np.float32)
        for c, g in enumerate(grids):
            gi[c, 0, :out_len] = g.win0[:out_len] + (self.hist_len - self._fold_offset)
            gi[c, 0, out_len:] = gi[c, 0, out_len - 1] if out_len else 0
            gi[c, 1, :out_len] = g.idx1[:out_len]
            gi[c, 2, :out_len] = g.idx2[:out_len]
            gi[c, 3, :out_len] = g.mode[:out_len]
            gw[c, :out_len] = g.weight[:out_len]
        gi_d = torch.as_tensor(gi, device=self.device)
        gw_d = torch.as_tensor(gw, device=self.device)
        return [(gi_d[c, 0], gi_d[c, 1], gi_d[c, 2], gw_d[c], gi_d[c, 3])
                for c in range(len(grids))]

    def _slab_len(self, frames: int) -> int:
        """xext's padded time length: at least one slab, a multiple of 128."""
        return _ceil_to(max(self.hist_len + frames, self._K), TILE)

    def _unpack_fast(self, data, factor, frames):
        """Packed bytes -> f32 [B, ch, frames]."""
        B = data.shape[0]
        ch, in_bits = self.channels, self.input_bits
        if ch == 2 and in_bits == 16:
            return q.int_to_float(q.unpack_pcm16_planar2(data), factor)
        x = q.int_to_float(q.unpack_pcm(data, in_bits), factor)
        return x.reshape(B, frames, ch).transpose(1, 2)

    def _quantize_fast(self, out, gen: int, out_max: int):
        """f32 [B, ch, out_max] -> (packed bytes, int64 per-stream clip counts
        over the ``gen`` valid outputs)."""
        B = out.shape[0]
        ch, out_bits = self.channels, self.output_bits
        if ch == 2 and out_bits == 16:
            samples, clipped = q.float_to_int(out, out_bits)             # [B, 2, T]
            per_stream = clipped[..., :gen].sum((1, 2), dtype=torch.int64)
            return q.pack_pcm16_interleave2(samples), per_stream
        y = out.transpose(1, 2).reshape(B, out_max * ch)
        samples, clipped = q.float_to_int(y, out_bits)
        per_stream = clipped[:, : gen * ch].sum(-1, dtype=torch.int64)
        return q.pack_pcm(samples, out_bits), per_stream

    def _conv_post(self, out, oh, gen: int, out_max: int):
        """Post-lowpass (upsampling) as a banded conv over the output stream:
        ``y[t] = sum_j h2[j] out[t-j]`` with ``oh`` carrying the previous
        chunk's valid tail, through the same kernel as the polyphase with
        one shared weight tile. Returns (y, new_oh)."""
        Hlen, K2 = self._post_Hlen, self._post_K
        nt2 = -(-out_max // TILE)
        L2 = _ceil_to(Hlen + out_max + K2, TILE)
        xe = torch.cat([oh, out], dim=-1)
        new_oh = xe[..., gen:gen + Hlen].clone()
        xe = F.pad(xe, (0, L2 - Hlen - out_max))
        starts2 = torch.arange(nt2, dtype=torch.int32, device=self.device) * TILE
        Wt2 = self._post_W2[None].expand(nt2, K2, TILE)
        return polyphase_banded_cuda(xe, Wt2, starts2, T=out_max), new_oh

    def _fast_chunk(self, chunk, factor, hist, oh, grid_t, gen: int, *,
                    frames: int, out_max: int, hist_from: int):
        """One chunk of the f32 fast path. ``hist_from`` is the number of
        input frames consumed: the new history is xext[hist_from : +hist_len].
        Returns (packed, per-stream clip counts, new history, new post hist)."""
        hist_len = self.hist_len
        L = self._slab_len(frames)
        xc = self._unpack_fast(chunk, factor, frames)
        xext = torch.cat([hist, xc], dim=-1)
        new_hist = xext[..., hist_from:hist_from + hist_len].clone()
        xext = F.pad(xext, (0, L - hist_len - frames))
        Wt, starts = banded_weights_device(
            self._filters, self._direct, *grid_t, gen, K=self._K, taps_p=self._taps_p, L=L)
        out = polyphase_banded_cuda(xext, Wt, starts, T=out_max)
        if self.post_filter:
            out, oh = self._conv_post(out, oh, gen, out_max)
        packed, per_stream = self._quantize_fast(out, gen, out_max)
        return packed, per_stream, new_hist, oh

    # ------------------------------------------------------------ streaming
    def resample_stream(self, input_bytes, chunk_frames: int, num_chunks: int,
                        gain_db: float = 0.0):
        """Process ``num_chunks`` fixed-size chunks in one call.

        The host precomputes the phase grids of all chunks up front (they
        are data-independent) and ships them in one transfer; the chunk loop
        then issues device work only, carrying the history (and post-filter
        tail) on the device.

        Args:
          input_bytes: uint8 ``[batch, >= num_chunks*chunk_frames*ch*bps]``,
            numpy or a tensor (already on the device: no copy).
        Returns: (packed uint8 tensor ``[num_chunks, batch, out_max*ch*bps_out]``,
          list of per-chunk generated counts, uint32 numpy clip counts
          ``[num_chunks, batch]``). Output chunk i holds ``gen[i]*ch*bps_out``
          valid bytes.
        """
        if not (self._initialized and self.requires_resampling):
            raise RuntimeError("resample_stream needs an initialized, resampling Resampler")
        ch = self.channels
        out_max = int(np.ceil(chunk_frames * float(self.sample_ratio))) + 8

        # schedules compute on a SCRATCH phase, committed only after the
        # device work was issued (retry-safety, like _hist_gain_zero)
        phase = dataclasses.replace(self.phase)
        host_grids = []
        for _ in range(num_chunks):
            g = phase_grid(phase, self.config.number_of_filters, self.bank_flags,
                           self.sample_ratio, chunk_frames, out_max)
            # generous out_max guarantees every input sample is consumed
            if g.input_used != chunk_frames:
                raise AssertionError((g.input_used, chunk_frames))
            host_grids.append(g)
        gens = [g.output_generated for g in host_grids]
        grids = self._device_grids(host_grids, out_max)

        bps_in = q.bytes_per_sample(self.input_bits)
        factor = q.gain_factor(self.input_bits, gain_db)
        chunk_bytes = chunk_frames * ch * bps_in
        data = self._to_device(input_bytes)[:, : num_chunks * chunk_bytes]
        chunks = [data[:, c * chunk_bytes:(c + 1) * chunk_bytes] for c in range(num_chunks)]

        # the fused int16 tier is exact only when the carried history shares
        # this call's gain factor; the flag commits only after the call
        fused_ok = gain_db == 0.0 and self._hist_gain_zero
        if self._fused_tier_selected(fused_ok):
            packed, clipped, history = self._fused_stream(
                chunks, grids, gens, factor, chunk_frames, out_max)
        else:
            hist, oh = self.history, self._post_hist
            packed, clipped = [], []
            for chunk, grid_t, gen in zip(chunks, grids, gens):
                p, c, hist, oh = self._fast_chunk(
                    chunk, factor, hist, oh, grid_t, gen,
                    frames=chunk_frames, out_max=out_max, hist_from=chunk_frames)
                packed.append(p)
                clipped.append(c)
            history = hist
            self._post_hist = oh
        self.history = history
        self.phase = phase
        self._hist_gain_zero = gain_db == 0.0
        return torch.stack(packed), gens, _clip_counts(torch.stack(clipped))

    def _fused_tier_selected(self, fused_ok: bool) -> bool:
        """The fused int16 tier serves s16 in/out without a post stage, on
        opt-in (``EAL_RESAMPLE_FUSED16=1``) and only under the gain
        precondition ``fused_ok``."""
        return (fused_ok
                and os.environ.get("EAL_RESAMPLE_FUSED16", "") in ("1", "true")
                and not self.post_filter and self.channels in (1, 2)
                and self.input_bits == 16 and self.output_bits == 16)

    def _fused_stream(self, chunks, grids, gens, factor, frames: int, out_max: int):
        """Fused-tier chunk loop: samples stay RAW int16 end to end (int16
        history carry, gain folded into the weight tiles) and the fused
        kernel does contraction + quantize in one pass. The f32
        ``self.history`` contract holds at the call boundary: history values
        are ``int16 * factor`` products whenever the history was produced
        under the same gain factor as this call (the ``fused_ok``
        precondition), so f32 -> raw -> f32 round-trips to identical floats.
        Returns (packed chunks, clip counts, new f32 history)."""
        ch, hist_len = self.channels, self.hist_len
        B = self.batch
        L = self._slab_len(frames)
        fac = torch.tensor(factor, dtype=torch.float32, device=self.device)
        hist_raw = torch.clamp(torch.round(self.history / fac), -32768.0, 32767.0).to(torch.int16)
        packed, clipped = [], []
        for chunk, grid_t, gen in zip(chunks, grids, gens):
            if ch == 2:
                xc = q.unpack_pcm16_planar2_raw(chunk)
            else:
                xc = q.unpack_pcm16_raw(chunk)[:, None, :]
            xext = torch.cat([hist_raw, xc], dim=-1)
            hist_raw = xext[..., -hist_len:].clone()
            xext = F.pad(xext, (0, L - hist_len - frames))
            Wt, starts = banded_weights_device(
                self._filters, self._direct, *grid_t, gen, K=self._K, taps_p=self._taps_p, L=L)
            s16, cmask = polyphase_fused16_cuda(xext.reshape(B * ch, L), Wt * fac, starts)
            s16 = s16.reshape(B, ch, -1)[..., :out_max]
            cmask = cmask.reshape(B, ch, -1)[..., :gen]
            clipped.append((cmask > 0).sum((1, 2), dtype=torch.int64))
            if ch == 2:
                packed.append(q.pack_pcm16_interleave2(s16.to(torch.int32)))
            else:
                packed.append(q.pack_pcm(s16[:, 0, :].to(torch.int32), 16))
        return packed, clipped, hist_raw.to(torch.float32) * fac
