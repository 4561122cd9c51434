"""Driver of the cells that time the composed MP3 -> 16 kHz chain:
``BatchedMP3Decoder.decode_run(bufs, run_frames, to_device=True)`` into
``Resampler.resample_stream`` of the same slots, a closed loop of runs.

Every slot plays streams of the traffic's pool one after another: stream
``(slot + 7 * epoch) % pool_streams`` in epoch ``epoch``. The pool's
streams all have ``stream_frames`` frames, so every slot ends its stream
on the same run; then every slot is recycled through ``reset_stream`` and
the next epoch begins, which keeps one format group and one FIFO phase, as
``to_device`` needs. The resampler's state carries across epochs, as a
serving fleet's would.

Set-up builds the fleet and the resampler, makes the pool and warms the
cell's shapes with ``warm_runs`` runs. The window then runs until
``seconds`` have passed; each run is synchronised.

What is checked, once the window has closed and the program is freed: on
``check.slots`` slots drawn from the seed, every run from the first warm
one: the decoded PCM against the reference decoder's, and the 16 kHz PCM
against the exact reference resampler run over the program's decoded PCM
of that slot from its first run.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from perfbench import harness, yardstick


KERNELS = {"mp3_granules": "mp3_granules_kernel"}


def launch_count() -> int:
    """The program's own launch counter of the exact granule kernel."""
    from esp_audio_libs_tpu_torch.ops import mp3_kernels
    return mp3_kernels.mp3_granules_cuda.launches


class Cell:
    def __init__(self, spec: harness.Spec):
        from esp_audio_libs_tpu_torch.models.batch import BatchedMP3Decoder
        from esp_audio_libs_tpu_torch.models.resampler import Resampler, ResamplerConfiguration

        self.spec = spec
        tr, rc = spec.traffic, spec.config["resampler"]
        self.B, self.run_frames = tr["slots"], tr["run_frames"]
        if tr["stream_frames"] % self.run_frames:
            raise ValueError("stream_frames must be a multiple of run_frames")
        gen = harness.load_module(harness.ROOT / "generators" / f"{tr['generator']}.py",
                                  f"perfbench_generator_{tr['generator']}")
        t = time.perf_counter()
        self.pool = [np.frombuffer(s, np.uint8) for s in gen.make_pool(tr, spec.seed)]
        print(f"perfbench: MP3 pool {len(self.pool)} streams in "
              f"{time.perf_counter() - t:.2f} s", file=spec.log)
        self.fleet = BatchedMP3Decoder(self.B, device=spec.device)
        self.res = Resampler(self.B, exact=rc["exact"], device=spec.device)
        self.res.initialize(ResamplerConfiguration(
            44100.0, float(tr["target_sample_rate"]), rc["source_bits_per_sample"],
            rc["target_bits_per_sample"], rc["channels"], rc["use_pre_or_post_filter"],
            rc["subsample_interpolate"], rc["number_of_taps"], rc["number_of_filters"]))
        self.epoch, self.runs_in_epoch = 0, 0
        self.pos = np.zeros(self.B, np.int64)
        self.runs_per_stream = tr["stream_frames"] // self.run_frames
        rng = np.random.default_rng([spec.seed % (1 << 63), 3])
        self.check_slots = np.sort(rng.choice(self.B, min(tr["check"]["slots"], self.B),
                                              replace=False))
        self.kept = []          # per run: (epoch, run in epoch, decoded PCM, 16 kHz, gens)
        self.runs = []          # per run: (epoch, run in epoch, seconds in decode_run or None)

    def stream_of(self, slot: int, epoch: int) -> int:
        return (slot + 7 * epoch) % len(self.pool)

    def run(self):
        """One run of every slot: decode to the device, then resample.
        Returns (decoded PCM int16 [B, samples] on the device, the
        resampler's (packed, gens, clips))."""
        if self.runs_in_epoch == self.runs_per_stream:
            for s in range(self.B):
                self.fleet.reset_stream(s)
            self.epoch, self.runs_in_epoch = self.epoch + 1, 0
            self.pos[:] = 0
        t0 = time.perf_counter()
        bufs = [self.pool[self.stream_of(s, self.epoch)][self.pos[s]:] for s in range(self.B)]
        pcm, consumed = self.fleet.decode_run(bufs, self.run_frames, to_device=True)[:2]
        decode_s = None
        if self.spec.trace:         # a span around the decode, synchronised (traced runs only)
            harness.sync(self.spec.device)
            decode_s = time.perf_counter() - t0
        self.runs.append((self.epoch, self.runs_in_epoch, decode_s))
        out = self.res.resample_stream(pcm.contiguous().view(torch.uint8),
                                       pcm.shape[1] // 2, 1)
        self.pos += np.asarray(consumed, np.int64)
        self.runs_in_epoch += 1
        return pcm, out

    def keep(self, pcm, out):
        """Copy the checked slots' decoded and 16 kHz PCM of this run."""
        sel = torch.as_tensor(self.check_slots, device=pcm.device)
        packed, gens, _ = out
        self.kept.append((self.epoch, self.runs_in_epoch - 1, pcm[sel].cpu().numpy(),
                          packed[0, sel].cpu().numpy(), gens[0]))

    def launches(self, runs):
        """(bytes, operations, peak) of the granule kernel's launch in each
        of ``runs`` (one a run): every slot's granules of that run, counted
        from the reference's parse of the pool."""
        n = self.spec.traffic["stream_frames"]
        stats = np.stack([self.spec.reference.frame_stats(p.tobytes(), n)
                          for p in self.pool])                         # [P, frames, 2, 2, 4]
        work = []
        for epoch, k, _ in runs:
            idx = [self.stream_of(s, epoch) for s in range(self.B)]
            f0 = k * self.run_frames
            run = stats[idx, f0:f0 + self.run_frames]
            work.append(yardstick.mp3_granules_work(run, self.B) + (yardstick.PEAK_INT32,))
        return work

    def free_program(self):
        del self.fleet, self.res


def drive(spec: harness.Spec) -> harness.Record:
    cell = Cell(spec)
    for _ in range(spec.traffic["warm_runs"]):
        cell.keep(*cell.run())
    harness.sync(spec.device)
    rec = harness.Record(setup_s=time.perf_counter() - spec.t_process)
    calls, samples = [], 0
    before = launch_count()
    with harness.window(spec, rec) as win:
        while True:
            with win.call():
                t0 = time.perf_counter()
                pcm, out = cell.run()
                harness.sync(spec.device)
                t1 = time.perf_counter()
            calls.append((t0, t1))
            samples += pcm.numel()
            cell.keep(pcm, out)
            del pcm, out
            if t1 - win.start >= win.seconds:
                break
    rec.calls = calls
    rec.work = {"decoded_samples": samples}
    if rec.trace is not None:
        traced = cell.runs[-len(calls):]
        rec.work["decode_s"] = [s for *_, s in traced]
        rec.launches, rec.kernel_names = {"mp3_granules": cell.launches(traced)}, KERNELS
        if launch_count() - before != len(rec.launches["mp3_granules"]):
            print("perfbench: mp3_granules launches differ from the runs", file=spec.log)
            rec.launches["mp3_granules"] = []
    rec.device = harness.device_info(spec)
    cell.free_program()
    harness.empty_cache(spec.device)
    t = time.perf_counter()
    rec.checks = check(spec, cell)
    rec.check_s = time.perf_counter() - t
    return rec


def check(spec: harness.Spec, cell: Cell) -> dict:
    """The compared numbers with their limits:

    * ``pcm_gap_lsb``: the largest gap between a decoded sample and the
      reference decoder's;
    * ``resampled_gap_lsb``: the largest gap between a 16 kHz sample and the
      exact reference resampler's over the same decoded PCM (a generated
      count that differs counts as a gap of 65535).

    With ``spec.control`` the reference in that precision stands in the
    program's place: its own decode, and its own resampler over it."""
    ref = spec.reference
    art = harness.load_module(harness.ROOT / "configs" / "art_resampler_ref.py",
                              "perfbench_ref_art_resampler_ref")
    tr, lim = spec.traffic, spec.config["limits"]
    streams = sorted({cell.stream_of(int(s), e) for e, *_ in cell.kept for s in cell.check_slots})
    pool = [cell.pool[i].tobytes() for i in streams]
    decoded = dict(zip(streams, ref.decode(pool, tr["stream_frames"])))
    control = (dict(zip(streams, ref.decode(pool, tr["stream_frames"], spec.control)))
               if spec.control else None)
    d = art.design(spec.config["resampler"], 44100.0, float(tr["target_sample_rate"]))
    S, F = len(cell.check_slots), cell.run_frames * 1152
    st = art.State.zero(d, S, 2)
    cst = art.State.zero(d, S, 2)
    pcm_gap = resampled_gap = 0
    for epoch, k, pcm, packed, gen in cell.kept:
        want = np.stack([decoded[cell.stream_of(int(s), epoch)][k * F:(k + 1) * F]
                         for s in cell.check_slots])                  # [S, F, 2]
        if control is not None:
            pcm = np.stack([control[cell.stream_of(int(s), epoch)][k * F:(k + 1) * F]
                            for s in cell.check_slots]).reshape(S, -1)
            outs, _, gens, cst, _ = art.resample_call(d, cst, pcm, F, 1, 2,
                                                      precision=spec.control, device=spec.device)
            packed = np.zeros((S, packed.shape[1]), np.uint8)
            packed[:, :gens[0] * 4] = outs[0].reshape(S, -1).view(np.uint8)
            gen = gens[0]
        prog = pcm.reshape(S, F, 2).astype(np.int64)
        pcm_gap = max(pcm_gap, int(np.abs(prog - want).max()))
        r_out, _, r_gen, st, _ = art.resample_call(d, st, pcm.reshape(S, -1).astype(np.int16),
                                                   F, 1, 2, device=spec.device)
        if r_gen[0] != gen:
            resampled_gap = 65535
            continue
        got = packed[:, :gen * 4].view(np.int16).reshape(S, gen, 2).astype(np.int64)
        resampled_gap = max(resampled_gap, int(np.abs(got - r_out[0]).max()))
    return {"pcm_gap_lsb": (pcm_gap, lim["pcm_gap_lsb"]),
            "resampled_gap_lsb": (resampled_gap, lim["resampled_gap_lsb"])}
