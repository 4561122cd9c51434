"""Driver of the cells that time ``Resampler.resample_stream``: a closed loop
of calls back to back over a batch of streams, state carried call to call.

Set-up builds the Resampler of the configuration, makes the traffic's input
pool on the device and warms the cell's one shape with two calls from the
zero state. The window then calls ``resample_stream(pool[i % P], chunk_frames,
chunks_per_call)`` until ``seconds`` have passed, each call synchronised.

What is checked, once the window has closed and the program is freed (the
traffic's ``check`` numbers): the first ``setup_calls`` set-up calls, from
the zero state, by the reference chaining its own state (their outputs,
clip counts and generated counts, and the program's carried state after the
first against the reference's), and ``window_calls`` calls of the window
drawn from the seed among its first ``within_first_calls``, each from the
program's state before it. Each on ``streams`` streams drawn from the seed.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from perfbench import harness, yardstick

KERNELS = {"biquad_exact": "recurrence_kernel", "polyphase_exact": "polyphase_exact_kernel"}


def launch_counts() -> dict:
    """The program's own launch counters of the two exact kernels' wrappers."""
    from esp_audio_libs_tpu_torch.ops import biquad_kernels, polyphase_kernels
    return {"biquad_exact": biquad_kernels.biquad_df1_cuda.launches,
            "polyphase_exact": polyphase_kernels.polyphase_exact_cuda.launches}


class Cell:
    def __init__(self, spec: harness.Spec):
        from esp_audio_libs_tpu_torch.models.resampler import Resampler, ResamplerConfiguration

        self.spec = spec
        tr, rc = spec.traffic, spec.config["resampler"]
        self.B, self.ch = tr["streams"], rc["channels"]
        self.cf, self.nc = tr["chunk_frames"], tr["chunks_per_call"]
        self.src, self.dst = float(tr["source_sample_rate"]), float(tr["target_sample_rate"])
        if tr["channels"] != self.ch:
            raise ValueError("the traffic's channels differ from the configuration's")
        self.cfg = ResamplerConfiguration(self.src, self.dst, rc["source_bits_per_sample"],
                                          rc["target_bits_per_sample"], self.ch,
                                          rc["use_pre_or_post_filter"],
                                          rc["subsample_interpolate"], rc["number_of_taps"],
                                          rc["number_of_filters"])
        self.res = Resampler(self.B, exact=rc["exact"], device=spec.device)
        self.res.initialize(self.cfg)
        gen = harness.load_module(harness.ROOT / "generators" / f"{tr['generator']}.py",
                                  f"perfbench_generator_{tr['generator']}")
        self.pool = gen.make_pool(tr, spec.seed, spec.device)
        self.out_max = int(np.ceil(self.cf * float(self.res.sample_ratio))) + 8
        rng = np.random.default_rng([spec.seed % (1 << 63), 1])
        chk = tr["check"]
        self.check_streams = np.sort(rng.choice(self.B, min(chk["streams"], self.B),
                                                replace=False))
        self.window_checks = sorted(int(i) for i in rng.choice(
            chk["within_first_calls"], chk["window_calls"], replace=False))
        self.kept = {}          # call label -> (start state or None, input index, outputs)

    def call(self, i: int):
        return self.res.resample_stream(self.pool[i % len(self.pool)], self.cf, self.nc)

    def keep(self, label, start_state, i, result):
        out, gens, clips = result
        sel = torch.as_tensor(self.check_streams, device=out.device)
        self.kept[label] = (start_state, i, out[:, sel].cpu().numpy(), list(gens),
                            np.asarray(clips)[:, self.check_streams])

    def state(self):
        st = self.res.get_state()
        return {"history": st["history"][self.check_streams],
                "biquad": [tuple(s[self.check_streams] for s in stage) for stage in st["biquad"]],
                "phase": (np.float32(st["phase_offset"]), int(st["phase_input_index"]))}

    def input_samples_per_call(self) -> int:
        return self.B * self.cf * self.nc * self.ch

    def launches(self, gens_per_call):
        """(bytes, operations, peak) of every hand-kernel launch the calls
        made, by kernel: per chunk two biquad stages (before the dots when
        downsampling, after them over ``out_max`` outputs when upsampling)
        and one exact polyphase launch over history + chunk."""
        lanes = self.B * self.ch
        hist = self.res.hist_len
        taps = self.cfg.number_of_taps
        rows = self.cfg.number_of_filters + 1
        bq_T = self.cf if self.res.pre_filter else self.out_max
        bq = yardstick.biquad_work(lanes, bq_T) + (yardstick.PEAK_FP32,)
        out = {"biquad_exact": [], "polyphase_exact": []}
        for gens in gens_per_call:
            for gen in gens:
                if self.res.pre_filter or self.res.post_filter:
                    out["biquad_exact"] += [bq, bq]
                # every generated output counted as a two-row one: the copies and
                # one-row outputs of an upsampling schedule (a fraction of a
                # percent) are over-counted
                out["polyphase_exact"].append(yardstick.polyphase_exact_work(
                    lanes, hist + self.cf, self.out_max, rows, taps, 0, gen)
                    + (yardstick.PEAK_FP32,))
        return out

    def free_program(self):
        del self.res


def drive(spec: harness.Spec) -> harness.Record:
    cell = Cell(spec)
    # set-up: the cell's one shape, twice, from the zero state (checked below)
    n_setup = spec.traffic["check"]["setup_calls"]
    for i in range(2):
        result = cell.call(i)
        if i < n_setup:
            cell.keep(f"setup_{i + 1}", None, i, result)
        if i == 0:
            state_after_1 = cell.state()
        del result
    harness.sync(spec.device)
    rec = harness.Record(setup_s=time.perf_counter() - spec.t_process)

    calls, gens_per_call = [], []
    snaps = set(cell.window_checks)
    before = launch_counts()
    with harness.window(spec, rec) as win:
        i = 0
        while True:
            snap = cell.state() if i in snaps else None
            with win.call():
                t0 = time.perf_counter()
                result = cell.call(2 + i)
                harness.sync(spec.device)
                t1 = time.perf_counter()
            calls.append((t0, t1))
            gens_per_call.append(result[1])
            if snap is not None:
                cell.keep(f"window_{i}", snap, 2 + i, result)
            del result
            i += 1
            if t1 - win.start >= win.seconds and i > max(snaps, default=-1):
                break
    rec.calls = calls
    rec.work = {"input_samples_per_call": cell.input_samples_per_call()}
    if rec.trace is not None:
        traced = gens_per_call[-rec.trace.calls:]
        rec.launches, rec.kernel_names = cell.launches(traced), KERNELS
        counted = {k: v - before[k] for k, v in launch_counts().items()}
        for k, work in rec.launches.items():
            if counted[k] != len(work):     # the work is not what ran: no roofline
                print(f"perfbench: {k} launched {counted[k]} times, {len(work)} expected",
                      file=spec.log)
                rec.launches[k] = []
    rec.device = harness.device_info(spec)
    cell.free_program()
    harness.empty_cache(spec.device)
    t = time.perf_counter()
    rec.checks = check(spec, cell, state_after_1)
    rec.check_s = time.perf_counter() - t
    return rec


def check(spec: harness.Spec, cell: Cell, state_after_1) -> dict:
    """Hold the kept calls to the reference; returns the compared numbers
    with their limits (both exact, so 0):

    * ``differing_output_values``: values of the calls' outputs that differ
      from the reference's: PCM samples, per-stream clip counts, and every
      sample missing or extra where a chunk's generated count differs;
    * ``differing_state_words``: f32 words of the carried state after the
      first set-up call (history, biquad states, phase) that differ.

    With ``spec.control`` the reference in that precision stands in the
    program's place, its own state included."""
    ref = spec.reference
    d = ref.design(spec.config["resampler"], cell.src, cell.dst)
    S, ch = len(cell.check_streams), cell.ch
    bad = {"differing_output_values": 0, "differing_state_words": 0}
    chained = ref.State.zero(d, S, ch)
    control_chained = ref.State.zero(d, S, ch)
    mode_counts = np.zeros(3, np.int64)
    for label in sorted(cell.kept, key=lambda k: cell.kept[k][1]):
        start, i, out, gens, clips = cell.kept[label]
        if start is None:
            st, cst = chained, control_chained
        else:
            st = cst = ref.State(start["history"], [tuple(s) for s in start["biquad"]],
                                 ref.Phase(*start["phase"]))
        pcm = cell.pool[i % len(cell.pool)][torch.as_tensor(cell.check_streams,
                                                            device=cell.pool[0].device)]
        pcm = pcm.cpu().numpy().view(np.int16)
        r_out, r_clip, r_gen, r_state, modes = ref.resample_call(d, st, pcm, cell.cf, cell.nc,
                                                                 ch, device=spec.device)
        mode_counts += modes
        if start is None:
            chained = r_state
        prog_state = state_after_1
        if spec.control:
            out, clips, gens, cst_new = _as_program(ref, d, cst, pcm, cell, spec)
            prog_state = {"history": cst_new.history, "biquad": cst_new.biquad,
                          "phase": (cst_new.phase.offset, cst_new.phase.input_index)}
            if start is None:
                control_chained = cst_new
        for c in range(cell.nc):
            n = min(gens[c], r_gen[c])
            prog = out[c][:, :n * ch * 2].view(np.int16).reshape(S, n, ch)
            bad["differing_output_values"] += (int((prog != r_out[c][:, :n]).sum())
                                               + abs(gens[c] - r_gen[c]) * S * ch
                                               + int((clips[c] != r_clip[c]).sum()))
        if label == "setup_1":
            bad["differing_state_words"] = _state_words(prog_state, r_state)
    print(f"reference schedule modes (copy, one row, two rows): {mode_counts.tolist()}",
          file=spec.log)
    return {k: (v, 0) for k, v in bad.items()}


def _as_program(ref, d, st, pcm, cell, spec):
    """The reference in the control's precision, shaped as the program's
    outputs: (packed bytes per chunk [S, out_max * ch * 2], clips, gens, state)."""
    o, c, g, new, _ = ref.resample_call(d, st, pcm, cell.cf, cell.nc, cell.ch,
                                     precision=spec.control, device=spec.device)
    packed = []
    for q in o:
        buf = np.zeros((q.shape[0], cell.out_max * cell.ch), np.int16)
        buf[:, :q.shape[1] * cell.ch] = q.reshape(q.shape[0], -1)
        packed.append(buf.view(np.uint8))
    return packed, np.stack(c), g, new


def _state_words(prog: dict, ref_state) -> int:
    """f32 words of the carried state that differ in their bits: the
    history's last inputs, both biquad stages, and the phase."""
    def words(a):
        return np.ascontiguousarray(a, np.float32).view(np.uint32)

    n = int((words(prog["history"]) != words(ref_state.history)).sum())
    for ps, rs in zip(prog["biquad"], ref_state.biquad):
        n += sum(int((words(a) != words(b)).sum()) for a, b in zip(ps, rs))
    n += int(np.float32(prog["phase"][0]) != ref_state.phase.offset)
    n += int(prog["phase"][1] != ref_state.phase.input_index)
    return n
