#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (esp_audio_libs_tpu_torch) on one
NVIDIA GPU: the quickest proof that the port builds and runs on the card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each printing a line:
  1. device  - the card's name and power limit (nvidia-smi); fails without CUDA.
  2. build   - libeal_host.so (native/build_host.sh's compile line, built
               atomically) and the CUDA kernels
               (csrc/*.cu, nvcc for sm_90a), timed; the MXU tier's operators
               probed from this checkout's f32 mirror on the host's CPU (or
               loaded from the cache named by a hash of the probe's sources).
  3. kernels - each kernel against its plain PyTorch version on the card at
               the slice's shapes and at a ragged one (37 rows, unaligned
               starts), TF32 off; the band-range kernel against its plain
               version; the kernel, its plain version and the library call
               (torch.bmm of the pre-gathered slabs) timed with CUDA events,
               beside the bound computed from the launch's shapes and the
               nonzero count of its weights.
  4. e2e     - Resampler(batch=2048, exact=False, device="cuda"), 44.1 kHz ->
               16 kHz stereo s16, 64 taps, 32 filters, resample_stream(data,
               8192, 8), with the fused int16 tier off and then on; the first
               8 streams compared with a CPU Resampler of the port, and the
               steady-state input rate taken at the median of 5 timed calls.
  5. upsample - 16 kHz -> 44.1 kHz with the post-filter at batch 256, compared
               the same way.
  6. flac kernel - the FLAC frame kernel against its plain version on the
               card, byte for byte, on the real parsed buckets of
               tools/flac_kernel_fleet.py (depths 8/12/16/20/24/32, mono,
               stereo in every channel assignment, 3 and 8 channels, wasted
               bits, the 32-bit mode, int8/int16/int32 planes and the int8
               escape tier, rows of 16-byte multiples and not), each bucket
               run at every order class that covers it, with both
               accumulators where the 32-bit one is valid and with its plane
               widened; then at the main path's launches: one dispatch of
               decode_streams_to_device (a transport slice of 32 composed
               streams: 512 frames x 2 channels x 4096, int8 + escapes,
               order 8; the headline), the whole 256-stream bucket (4096
               frames), one lane alone, and dispatches of order-12 and
               order-32 streams. Each is held to the plain version byte for
               byte and timed by direct launches through the C entry point
               (CUDA events, 20 launches, operands prepared once) beside one
               wrapper call, its bytes bound and two estimates printed in the
               text line only (the serial chain, and W multiply-adds a step
               at 2 issue cycles).
  7. flac corpus - every corpus/independent/*.flac decoded by
               FLACDecoder(device="cuda"): all frames SUCCESS and md5_ok (the
               STREAMINFO MD5 pins the reference decoder's PCM).
  8. flac -> 16k composed - 256 streams of 16 x 4096-sample stereo frames:
               BatchedFLACDecoder.decode_streams_to_device, then a Resampler
               44.1 -> 16 kHz on the device PCM; MD5 of the host decode, the
               device PCM and the resampled output against the host-roundtrip
               chain, 8 streams against a CPU run of the port; rates at the
               median of 5 calls.
  9. exact kernels - the two kernels of exact mode against their plain
               versions on the card, bit for bit: the DF-I biquad kernel on
               the main pre-filter chunk ([2048, 2, 8192] from the phase-4
               bytes) second- and first-order, with valid_len, as iir2, and
               with a burst followed by silence whose tail decays through
               the subnormal range, and on the exact upsampling post-filter
               chunk (16 -> 44.1 kHz at batch 2048, the up cell's shape: the
               first chunk's polyphase output [2048, 2, 22588] with valid_len
               = its generated count); the exact polyphase kernel on the main
               chunk's real operands ([4096, 8264] -> 2981 outputs, its last
               tile ragged) and on the exact upsampling chunk's ([4096, 8264]
               -> 22588), each with and without the second dot and on 13
               rows. Times (CUDA events) of direct launches through the C
               entry points, operands prepared once, beside one wrapper call
               and the bound; for the biquad at both shapes, each also with
               one lane alone (the measured step time) and an estimated
               serial chain, for the polyphase the FMA-free issue floor (an
               estimate; text lines only). Then the quantize-and-pack kernel
               (csrc/pcm_quantize16.cu) byte for byte against its plain
               version on quantize16_cases (NaN, infinities, 2^31 and its
               neighbours, half-ties, subnormals, gen < T and 0, odd T,
               strided inputs, padded rows left untouched) and at both
               cells' chunks ([2048, 2, 2981] and [2048, 2, 22587]), timed
               by direct launches beside its bytes bound and one wrapper call.
               Then the unpack-gain-extend kernel (csrc/pcm_unpack16.cu)
               bit for bit against its plain version on unpack16_cases (the
               cells' H and L scaled down, a chunk inside a wider row, row
               starts at 1-, 2-, 4-, 8- and 16-byte alignment, an odd L, a
               strided history, 0 / -6.02 / +12 dB and a subnormal factor,
               -32768 and 32767, B = 1, frames = 0) and at the three cells'
               chunk shapes (2048 streams x 8192 frames read in place from
               chunk 3 of the phase-4 bytes; H / L 72 / 8264, 326 / 8576,
               0 / 8192), timed by direct launches beside its bytes bound,
               one wrapper call and the plain version.
 10. exact e2e - Resampler(2048) (exact, the default) resample_stream(data,
               8192, 8) on the phase-4 bytes, its packed bytes, counts and
               state equal to a CPU run of the plain path on 8 streams, with
               its launches asserted (2 biquad, 1 polyphase_exact, 1
               quantize_pack16 and 1 unpack16_extend per chunk); the same
               for 16 kHz -> 44.1 kHz at
               batch 2048 (the post-filter runs with valid_len);
               BatchedResample((2048, 2), exact=True).process on one
               8192-sample chunk; the
               biquad_cascade_2x_stereo configuration of bench_all.py (2048 x
               stereo x 65536, lowpass 0.18) in the conv form and through
               the exact kernel, held to each other at rtol 1e-4 / atol 1e-5.
 11. mp3 kernel - the MP3 granule kernel (csrc/mp3_granules.cu) against its
               plain version on the card, byte for byte (PCM, carried state,
               UB flag), on real parsed runs of tools/mp3frames.py streams:
               the four formats of the JAX package's batched-decoder tests
               plus MPEG-1 and MPEG-2 intensity stereo, tonal and window-type
               frames and fuzz frames, two runs in a row, and the escape
               tier; then timed by direct launches through eal_mp3_granules
               beside one wrapper call, the plain version and the bound (the
               larger of its bytes at 3.35 TB/s and its integer operations at
               PEAK_INT32, mp3_work) at B = 256 and 2048 x G = 16 (8 frames
               of MPEG-1 44.1 kHz stereo).
 11b. mp3 fast tiers - the relaxed tiers' kernels (fast="mirror":
               csrc/mp3_granules_f32.cu; fast="mxu": the two step kernels of
               csrc/mp3_mxu_step.cu around two FP32 GEMMs a granule): (a)
               mp3_granules_f32 and (b) mp3_mxu_pre / mp3_mxu_post (at every
               granule step, each step continuing from the kernel's results)
               against their plain versions on phase 11's parsed runs (its
               formats and frame kinds, two runs in a row, the escape tier):
               PCM within 1 LSB, f32 state within MP3F_STATE_RTOL of its
               scale, the rest equal; mp3_mxu_post bit for bit, there and on
               mxu_post_cases (accumulators past int16 and on half-ties,
               masks mixed within groups of four, mono, wide PCM rows); the
               operators are probed on the host's CPU in phase 2; (c) timed by
               direct launches (CUDA events) at B = 256 and 2048 x G = 16
               (phase 11's tonal run): mp3_granules_f32 beside its bound (its
               bytes at 3.35 TB/s or FP32 operations at 67 TFLOP/s,
               mp3f32_work) and, at B = 256, its plain version; the MXU run,
               its prelude and its steps (ms a granule), each step kernel
               beside its bytes bound (mxu_step_bytes: what this step's data
               needs) and plain version (pre and post queued behind a
               sleeping kernel, and unqueued), the two GEMMs alone,
               and the step's bound (its GEMM flop at 67 TFLOP/s); (d) phase
               13's 256 streams x 8 frames through BatchedMP3Decoder(fast=
               "mirror") and (fast="mxu"), decode_run(to_device=True):
               consumed and next_pos equal to the exact tier's, PCM within
               the hot-clipping bound of the exact tier's (these frames
               saturate about a quarter of the samples, where the exact tier
               truncates guard bits: at most 4 LSB on under 0.5 % of the
               samples) and within 1 LSB of the CPU plain path on 8 streams,
               launches counted over 5 timed calls (1 mp3_granules_f32 a
               call; 1 mp3_mxu_pre and 1 mp3_mxu_post a granule), decoded
               Msamples/s beside the exact tier's (median of 5 calls).
 12. mp3 corpus - every corpus/independent_mp3 file decoded frame by frame by
               MP3Decoder(device="cuda"): error ladder, consumed bytes and PCM
               SHA256 equal to its signatures.json (pinned by the reference).
 13. mp3 -> 16k composed - 256 streams x 8 frames of 44.1 kHz stereo tonal
               frames: BatchedMP3Decoder.decode_run(to_device=True), then the
               fast Resampler 44.1 -> 16 kHz on the device PCM; the device PCM
               against decode_run(to_device=False) and a CPU run of the plain
               path on 8 streams, the chain against the host-roundtrip chain
               (bytes) and a CPU run (1 LSB); rates at the median of 5 calls.
 14. dsp     - ops/dsp.py on the card: dotprod_f32 (exact) at [4096, 8192]
               (2048 stereo streams x one 8192-frame chunk) and [65536, 64]
               (64-tap FIR dots), biquad_f32 (exact) at [4096, 8192] and
               add_s16 / mulc_s16 / mix_s16 at S = 4 x [2048, 2 x 8192],
               launches counted (one dotprod_exact per dot, one iir2 launch
               per biquad_f32); the dot bit for bit against its plain version
               on the card, there and on ragged n (0, 1, 17, 4099), an
               unaligned row pitch, subnormal products, R = 1000, 5 and
               20000, a tensor-copy box past R and n, and rows through each
               copy path; the biquad and the int16 ops (shifts 0, 15, 31,
               32, 40, -1 and a tensor shift) against a CPU run on a few
               rows; then the dot timed by direct launches through
               eal_dotprod_exact queued behind a sleeping kernel ([65536,
               64] over 4 operand sets in turn, past L2) beside one wrapper
               call, the plain version, its bytes bound, an estimated serial
               chain and torch.linalg.vecdot (another rounding order).
 15. mp3 serving - phase 13's streams lengthened to 4 runs x 8 frames:
               decode_run_pipelined(to_device=True) against sequential
               decode_run(to_device=True) calls (PCM, consumed, absolute
               next_pos, byte for byte), both timed in turns; a fleet
               checkpointed after run 1 (get_state, pickle) and restored
               into a new fleet continues byte-identically.
 16. serving  - the port's serve_fleet (cli/serve_fleet.py) in-process on the
               card: (a) ragged MP3 with continuous batching, 2048 slots
               serving 4096 tonal streams of 4-16 frames (stereo and mono
               groups), runs of 8 frames, seed 7: 2048 slots recycled, every
               stream's sample count and nonzero PCM, 64 sampled streams (32
               admitted into recycled slots) byte for byte against
               single-stream MP3Decoder decodes, and the whole --verify at 64
               slots over 160 streams; (b) composed --rate 16000, 2048 streams
               x 8 frames in runs of 4: 1 mp3_granules launch per run, the
               banded launches per run printed, the PCM a card tensor between
               the stages, run 1's output equal to a fresh Resampler's on the
               same PCM; (c) the FLAC fleet, 256 flacgen streams (16-bit
               stereo, order-8 LPC, 8-16 frames of 1024), all md5_ok. Each
               mode prints its aggregate (samples, runs, msps,
               realtime_streams) and its slowest and median run.
 17. soak    - tests/test_soak.py on the card: 40 serving cycles (64 MP3
               slots reset and run, 8 FLAC streams) after 5 warm-up ones,
               memory_allocated back to its post-warm-up value within 1 MiB,
               live CUDA tensors within 4, RSS +64 MB at most; 300
               FLACDecoder/MP3Decoder create/destroy cycles, RSS +16 MB at
               most.
 18. conformance - the port's FLAC conformance runner (cli/
               flac_conformance.py) over its generated 114-file corpus with a
               WarmCliPool of 2 card workers: all pass, status, parity and md5
               per file equal to build/test_results/test_report.json.
 19. mesh    - the multi-device surface (parallel/mesh.py, parallel/
               sequence.py) on one card named 4 times,
               stream_mesh(["cuda:0"] * 4): (a) polyphase_banded_sharded and
               polyphase_fused16_sharded at phase 3's main shape (4 shards x
               1024 rows), each shard bit for bit equal to the single-device
               launch on its rows, held to the plain versions, each shard's
               launch timed (CUDA events) beside its bound and the library
               call; (b) Resampler(2048, mesh) at the bench configuration,
               fast (fused tier off and on) and exact, against the
               single-device Resampler (exact byte-equal, fast: differing
               samples counted, more than 1 LSB fails), 4 launches per
               contraction per chunk, and stream_mesh() (the visible cards;
               one card: the single-device route); (c) phase 8's composed
               FLAC chain over the mesh (md5_ok, split PCM, output equal to
               the unsharded chain); (d) phase 13's MP3 chain over the mesh,
               4 mp3_granules launches a run, equal to the unsharded chain;
               (e) sequence parallelism: sequence_parallel_resample of 4
               stereo streams x 120 s at 44.1 kHz within TOL_BANDED of the
               single-device contraction, sequence_parallel_iir2 on [64, 4 x
               2^20] and lpc_companion_scan on [16, 2^18] (whole and split,
               against lpc_restore(shift=0) run on the CPU by a child process)
               bit for bit; (f) serve_mp3 composed over the mesh at 2048
               slots x 8 frames, runs of 4, --verify. Its launches are
               counted drive by drive (each count set to 0 just before a
               mesh drive and read just after) and go into the kernels
               line: two entries for the sharded wrappers and
               launches_other_paths["mesh"] for the others (for the two
               single-device contraction entries net of the launches made
               through their sharded wrappers, so each launch counts once). A second card,
               which would show that each launch runs on its tensors' card,
               is not needed: one card runs every split.
 20. mp3 conformance - the port's MP3 conformance runner (cli/
               mp3_conformance.py) over its generated 53-file corpus
               (standard 26, modes 3, long 4, faulty 10, independent 10)
               with a WarmCliPool of 2 card workers: every generated file's
               bytes equal the hash that the signature file
               (cli/mp3_conformance_signatures.json, written from JAX's
               decode by tools/mp3_conformance_signatures.py) holds; every
               file passes with its frame ladder, decoded frames and payload
               SHA256 equal to the signature, and its status, parity and
               frames equal to build/test_results/mp3_test_report.json. The
               short files decode frame by frame through MP3Decoder, the
               four 30 s streams through BatchedMP3Decoder(1).decode_run in
               runs of 128 frames: one mp3_granules launch per run (B = 1,
               G = 256 for MPEG-1, 128 for MPEG-2), asserted per file (9
               each); the launches go into the kernels line as
               launches_other_paths["mp3_conformance"]. Prints the decode
               time per category and the long streams' Msamples/s at B = 1.
The conformance corpora of phases 18 and 20 are built by child processes
started before phase 2 (phase 18's takes minutes of Python), on one CPU core
each while the card runs the phases before them; a phase that ends while
phase 18's is still building says so in its seconds line.
Phase 16's three corpora are built by three child processes started
together after phase 15, and phase 16 starts when all are ready.
The launch counts of phases 4-5, of phase 8's, 11b(d)'s and 13's timed
calls, of each path of phase 10, of phase 14's DSP path, of phase 15's pipelined
pass, of each serving mode of phase 16 and of phase 20's runner, each set
to 0 just before and read just after, show that the main paths ran through
the kernels; phases 8, 10, 11b(d), 13, 14, 15, 16(b), 19 and 20 (its long
streams) assert their exact counts. Every phase prints its seconds.
The last three lines are the card line, one JSON object describing the
kernels, and
``{"ok": true, "device": {...}}``. Any failure exits non-zero before those
lines. Imports nothing of JAX.
"""

import json
import math
import os
import subprocess
import sys
import time

TOL_BANDED = dict(rtol=2e-6, atol=4e-5)   # f32 sums of ~300 products, another order
FRAMES, CHUNKS, BATCH, CMP_STREAMS = 8192, 8, 2048, 8
PEAK_TF32, PEAK_BYTES = 495e12, 3.35e12   # H100 SXM: dense TF32 tensor cores; HBM3
TF32_PASSES = 3                            # 3xTF32: three tensor-core products per product
FLAC_STREAMS, FLAC_FRAMES, FLAC_BLOCK = 256, 16, 4096   # bench_all.py's composed row
CHAIN_OPS, OP_CYCLES = 3, 4   # FLAC step chain: multiply-add, shift, add; assumed cycles each
PEAK_FP32 = 67e12             # H100 SXM FP32 outside the tensor cores (an FMA counts 2)
BIQUAD_CHAIN_OPS = 3          # exact biquad step chain: b1*o1, two subtractions
CASCADE_B, CASCADE_T = 2048, 65536   # bench_all.py's biquad_cascade_2x_stereo
CASCADE_TOL = dict(rtol=1e-4, atol=1e-5)   # tests/test_biquad.py:65, fast vs exact
MP3F_STATE_RTOL = 1e-5   # the relaxed MP3 tiers' f32 state against the plain versions, of its scale


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    stop_children()
    sys.exit(1)


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if res.returncode != 0 or not res.stdout.strip():
        fail(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def max_clock_mhz() -> float:
    """The card's maximum SM clock in MHz (nan if nvidia-smi gives none)."""
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                            "--format=csv,noheader,nounits"],
                           capture_output=True, text=True, timeout=60).stdout.split()
    return float(clock[0]) if clock else float("nan")


def cuda_time(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean milliseconds of fn() on the card, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cuda_time_queued(fn, iters: int = 20, warmup: int = 2) -> float:
    """Mean milliseconds of fn() on the card, by CUDA events, with the
    launches queued behind a sleeping kernel: the card runs them back to
    back, whatever the host's time to enqueue one (which can exceed a short
    kernel's own). The start event fires when the sleep ends."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(200e3 * iters))   # about 0.1 ms a launch at 2 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(tf32_flop: float, nbytes: float) -> tuple[float, str]:
    """Least milliseconds for the work: the larger of the TF32 flop at the
    tensor cores' peak and unique bytes at the memory rate, and which of the
    two it is."""
    t_ops, t_bytes = tf32_flop / PEAK_TF32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def contraction_bound(M, x, Wt, out_bytes):
    """Bound of one banded contraction on the tensor cores it runs on:
    2 * nnz(Wt) * M flop (the products these weights need; a stride-0 tile
    counts once per tile), each done as TF32_PASSES TF32 products, against
    x, the distinct weight tiles, the starts and the outputs, each moved once."""
    nt = Wt.shape[0]
    ntw = 1 if Wt.stride(0) == 0 else nt
    nnz = int((Wt[:ntw] != 0).sum()) * (nt // ntw)
    nbytes = x.numel() * x.element_size() + ntw * Wt[0].numel() * 4 + nt * 4 + out_bytes
    return bound(TF32_PASSES * 2.0 * nnz * M, nbytes)


def library_time(x, Wt, starts):
    """Milliseconds of one torch.bmm of the pre-gathered slabs [nt, M, K]
    against Wt (TF32 off), the gather outside the timer: the library call
    that computes the same contraction. The port never calls it."""
    import torch
    K = Wt.shape[1]
    cols = starts.long()[:, None] + torch.arange(K, device=x.device)
    slabs = x.float()[:, cols].permute(1, 0, 2).contiguous()
    ms = cuda_time(lambda: torch.bmm(slabs, Wt))
    del slabs
    return ms


def band_ranges_launcher(Wt):
    """A function that launches band_ranges on ``Wt`` through the C entry
    point eal_band_ranges, its scratch allocated once: the kernel alone, as
    each banded contraction launch runs it first. Used only to time it."""
    import torch

    from esp_audio_libs_tpu_torch.ops import polyphase_kernels as pk
    from esp_audio_libs_tpu_torch.runtime import kernels
    parts = pk._band_parts(Wt)
    args = (Wt.data_ptr(), parts.data_ptr(), parts.shape[0], Wt.shape[1], Wt.stride(0),
            torch.cuda.current_stream().cuda_stream)
    lib = kernels.library()

    def launch():
        if lib.eal_band_ranges(*args) != 0:
            fail("eal_band_ranges refused its arguments")
        launch.keep = (Wt, parts)
        return parts
    return launch


def ragged_operands(rng, M, L, nt, K, band, step, device):
    """Random banded weights (one band of ``band`` taps per column at a
    random offset), f32 and int16 inputs and starts ``i * step`` (unaligned),
    for checking the kernels' masks at a shape that is not the main one."""
    import torch
    Wt = torch.zeros((nt, K, 128), device=device)
    offs = torch.as_tensor(rng.integers(0, K - band, (nt, 128)), device=device)
    rows = offs[..., None] + torch.arange(band, device=device)             # [nt, 128, band]
    vals = torch.as_tensor(rng.standard_normal((nt, 128, band)), dtype=torch.float32,
                           device=device)
    Wt[torch.arange(nt, device=device)[:, None, None], rows,
       torch.arange(128, device=device)[None, :, None]] = vals
    xf = torch.as_tensor(rng.standard_normal((M, L)), dtype=torch.float32, device=device)
    x2 = torch.as_tensor(rng.integers(-32768, 32768, (M, L)), dtype=torch.int16, device=device)
    starts = torch.as_tensor([min(i * step, L - K) for i in range(nt)], dtype=torch.int32,
                             device=device)
    return xf, x2, Wt, starts


def check_fused(s_k, c_k, s_p, c_p, label) -> int:
    """Samples within 1 LSB, clip masks equal where the samples agree;
    returns the largest difference in LSB."""
    d16 = (s_k.int() - s_p.int()).abs()
    err = int(d16.max())
    if err > 1:
        fail(f"{label}: fused16 differs from its plain version by {err} LSB")
    if not (c_k[d16 == 0] == c_p[d16 == 0]).all():
        fail(f"{label}: fused16 clip masks disagree where the samples agree")
    return err


def make_resampler(src, dst, batch, device, exact=False):
    from esp_audio_libs_tpu_torch.models import Resampler, ResamplerConfiguration
    r = Resampler(batch=batch, exact=exact, device=device)
    r.initialize(ResamplerConfiguration(src, dst, 16, 16, 2, True, True, 64, 32))
    return r


def chunk_operands(r, data_dev):
    """The first chunk's real contraction operands of Resampler ``r``:
    (f32 xext [M, L], raw int16 xext [M, L], Wt, starts, out_max)."""
    import dataclasses

    import torch
    import torch.nn.functional as F

    from esp_audio_libs_tpu_torch.ops import quantization as q
    from esp_audio_libs_tpu_torch.ops.polyphase import banded_weights_device

    out_max = math.ceil(FRAMES * float(r.sample_ratio)) + 8
    (grid_t,), (gen,), _ = r._schedule(dataclasses.replace(r.phase), FRAMES, out_max, 1)
    L = r._slab_len(FRAMES)
    Wt, starts = banded_weights_device(r._filters, r._direct, *grid_t, gen,
                                       K=r._K, taps_p=r._taps_p, L=L)
    raw = q.unpack_pcm16_planar2_raw(data_dev[:, : FRAMES * 4])
    raw = F.pad(torch.cat([torch.zeros_like(raw[..., : r.hist_len]), raw], -1),
                (0, L - r.hist_len - FRAMES))
    x2 = raw.reshape(-1, L).contiguous()
    factor = float(q.gain_factor(16, 0.0))
    return x2.float() * factor, x2, Wt, starts, out_max, factor


def compare_stream(out_dev, out_cpu, label):
    """Packed s16 within 1 LSB, gens equal, clip counts within the number of
    differing samples. Returns (differing samples, clipped samples on the card)."""
    import numpy as np
    (pg, gg, cg), (pc, gc, cc) = out_dev, out_cpu
    if gg != gc:
        fail(f"{label}: generated counts differ")
    a = pg[:, :CMP_STREAMS].cpu().numpy().view(np.int16).astype(np.int32)
    b = pc.numpy().view(np.int16).astype(np.int32)
    if a.shape != b.shape:
        fail(f"{label}: shapes {a.shape} vs {b.shape}")
    d = np.abs(a - b)
    ndiff = int((d > 0).sum())
    if d.max() > 1:
        fail(f"{label}: packed s16 differs by {d.max()} LSB")
    clip_gap = int(np.abs(cg[:, :CMP_STREAMS].astype(np.int64) - cc.astype(np.int64)).sum())
    if clip_gap > ndiff:
        fail(f"{label}: clip counts differ by {clip_gap} > {ndiff} differing samples")
    return ndiff, int(cg.sum())


def run_stream(src, dst, batch, data, label, reps=5):
    """Stream on the card: a first call (warm-up) whose output is checked,
    ``reps`` timed calls, then the first call's first streams compared
    against a CPU Resampler of the port (after the timing, so the CPU run
    does not share the host with it). Prints the steady-state input rate
    at the median call time."""
    import numpy as np
    import torch

    r = make_resampler(src, dst, batch, "cuda")
    data_dev = torch.as_tensor(data, device="cuda")
    first = r.resample_stream(data_dev, FRAMES, CHUNKS)
    torch.cuda.synchronize()
    packed, gens, _ = first
    n_out = math.ceil(FRAMES * float(r.sample_ratio)) + 8
    if not packed.is_cuda or tuple(packed.shape) != (CHUNKS, batch, n_out * 4):
        fail(f"{label}: output {tuple(packed.shape)} on {packed.device}")
    if not all(0 < g <= n_out for g in gens):
        fail(f"{label}: generated counts {gens}")
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        r.resample_stream(data_dev, FRAMES, CHUNKS)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    med = float(np.median(times))
    rate = CHUNKS * FRAMES * 2 * batch / med / 1e6
    ref = make_resampler(src, dst, CMP_STREAMS, "cpu")
    ndiff, clips = compare_stream(first, ref.resample_stream(data[:CMP_STREAMS], FRAMES, CHUNKS),
                                  label)
    print(f"{label}: {rate:.1f} input Msamples/s at the median of {reps} calls "
          f"({med * 1e3:.2f} ms/call, min {min(times) * 1e3:.2f}, max {max(times) * 1e3:.2f}), "
          f"gens {gens[0]}..{gens[-1]}, {ndiff} samples of {CMP_STREAMS} streams differ by 1 LSB "
          f"from the CPU port, {clips} clipped samples")


def tools_import(name: str):
    """A module of tools/ (numpy and the port only, no JAX)."""
    import importlib
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools"))
    return importlib.import_module(name)


def flac_headers(blobs, device):
    """Decoders of ``device`` that have read each blob's header, and the
    frame sections after the headers."""
    from esp_audio_libs_tpu_torch.models import FLACDecoder
    decs, bodies = [], []
    for i, blob in enumerate(blobs):
        d = FLACDecoder(device=device)
        if d.read_header(blob) != 0:
            fail(f"FLAC stream {i}: read_header failed")
        decs.append(d)
        bodies.append(blob[d.get_bytes_index():])
    return decs, bodies


def flac_stream(order):
    """The composed chain's stream shape (tools/flacgen.py, seed 1, 16-bit
    stereo, FLAC_FRAMES x FLAC_BLOCK samples), every subframe fitted LPC of
    ``order``: 8 is the composed stream itself."""
    fg = tools_import("flacgen")
    P = fg.SubframePlan
    return fg.make_flac(rng_seed=1, depth=16, channels=2, block_size=FLAC_BLOCK,
                        n_frames=FLAC_FRAMES,
                        plans=[[P("lpc", order=order, fit=True)] * 2] * FLAC_FRAMES)[0]


def flac_bucket(blob, n_streams):
    """The one shape bucket of ``n_streams`` copies of ``blob`` as the host
    parse leaves it (escape sideband included), on the card: (tensors, kw)."""
    from esp_audio_libs_tpu_torch.models.flac import parsed_buckets
    decs, bodies = flac_headers([blob] * n_streams, "cuda")
    (_, arrays, kw), = parsed_buckets(decs, bodies)
    return tools_import("flac_kernel_fleet").on_device(arrays, kw, "cuda")


def flac_shapes(composed_blob):
    """The frame kernel's timed launches: {name: (tensors, kw)}.
    - dispatch: one launch of decode_streams_to_device, a transport slice of
      32 composed streams (512 frames, 1024 lanes, int8 + escapes, W = 8);
    - bucket: the whole 256-stream bucket (4096 frames) in one launch;
    - one_lane: the dispatch's first frame, first channel, alone, escapes
      left out (the measured step time);
    - dispatch_w12, dispatch_w32: a dispatch of streams of the same shape
      whose subframes are order-12 and order-32 LPC."""
    from esp_audio_libs_tpu_torch.runtime.transport import SLICE_OUT_BYTES
    per = SLICE_OUT_BYTES // (FLAC_FRAMES * FLAC_BLOCK * 2 * 2)
    shapes = {"dispatch": flac_bucket(composed_blob, per),
              "bucket": flac_bucket(composed_blob, FLAC_STREAMS)}
    t, kw = shapes["dispatch"]
    lean = {k: v for k, v in kw.items() if not k.startswith("esc")}
    shapes["one_lane"] = ([a[:1, :1].contiguous() for a in t[:5]] + [t[5][:1].contiguous()],
                          dict(lean, nch=1))
    for order in (12, 32):
        shapes[f"dispatch_w{order}"] = flac_bucket(flac_stream(order), per)
    return shapes


def flac_launcher(tensors, kw, lib=None):
    """A function that launches flac_frame on a bucket's operands through
    the C entry point eal_flac_frame (of ``lib``, the package's library by
    default), its arguments and output prepared once: the kernel alone,
    without the wrapper's checks and output allocation. Used only to time
    the kernel; its launches are not counted. The function returns the
    output tensor."""
    import torch

    from esp_audio_libs_tpu_torch.ops import flac_kernels as fk
    from esp_audio_libs_tpu_torch.runtime import kernels
    data, coeffs, order, shift, wasted, ca = tensors
    F, C, T = data.shape
    nbytes, lshift, bias = fk.pack_params(kw["depth"], kw["mode32"])
    out = torch.empty((F, T * C * nbytes), dtype=torch.uint8, device=data.device)
    pos, val = kw.get("esc_pos"), kw.get("esc_val")
    n_esc = 0 if pos is None else pos.numel()
    args = (data.data_ptr(), fk._RES_DTYPES.index(data.dtype),
            pos.data_ptr() if n_esc else None, val.data_ptr() if n_esc else None, n_esc,
            coeffs.data_ptr(), order.data_ptr(), shift.data_ptr(), wasted.data_ptr(),
            ca.data_ptr(), out.data_ptr(), F, C, T, nbytes, lshift, bias, int(kw["use64"]),
            int(kw["max_order"]), torch.cuda.current_stream().cuda_stream)
    lib = lib or kernels.library()

    def launch():
        if lib.eal_flac_frame(*args) != 0:
            fail("eal_flac_frame refused its arguments")
        launch.keep = (tensors, pos, val)         # keeps the operands alive
        return out
    return launch


def flac_work(tensors, kw):
    """(bytes, bound ms, serial-chain estimate ms, issue estimate ms) of one
    frame-kernel launch: every operand read once and the packed PCM written
    once at 3.35 TB/s; the estimates (not measured) are T steps of the
    dependent multiply-add, shift and add at an assumed OP_CYCLES each, and
    T steps of W multiply-adds at 2 issue cycles each, at the card's
    maximum SM clock."""
    from esp_audio_libs_tpu_torch.ops import flac_kernels as fk
    F, C, T = tensors[0].shape
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    nbytes += sum(kw[k].numel() * 4 for k in ("esc_pos", "esc_val") if k in kw)
    nbytes += F * T * C * fk.pack_params(kw["depth"], kw["mode32"])[0]
    mhz = max_clock_mhz()
    chain_ms = T * CHAIN_OPS * OP_CYCLES / (mhz * 1e6) * 1e3
    issue_ms = T * 2 * kw["max_order"] / (mhz * 1e6) * 1e3
    return nbytes, nbytes / PEAK_BYTES * 1e3, chain_ms, issue_ms


def flac_kernel_phase(composed_blob):
    """Phase 6: the frame kernel byte for byte against its plain version on
    real parsed buckets (tools/flac_kernel_fleet.py) and at the main path's
    shapes; timed by direct launches at those shapes. Returns the
    kernels-line entry without its launch count."""
    import torch

    from esp_audio_libs_tpu_torch.ops import flac_kernels as fk

    fleet = tools_import("flac_kernel_fleet")
    buckets = fleet.fleet_buckets("cuda")
    cover = fleet.coverage(buckets)
    if fleet.missing(cover):
        fail(f"the FLAC kernel fleet does not cover {fleet.missing(cover)}")
    n_runs = 0
    for bkey, arrays, kw in buckets:
        tensors, kw_dev = fleet.on_device(arrays, kw, "cuda")
        plain = fk.flac_frame_plain(*tensors, **kw_dev)
        for label, plane, esc, kwv in fleet.kernel_variants(arrays, kw):
            extra = {} if esc is None else dict(zip(("esc_pos", "esc_val"),
                                                    fleet.on_device(esc, {}, "cuda")[0]))
            got = fk.flac_frame_cuda(torch.as_tensor(plane, device="cuda"), *tensors[1:], **kwv,
                                     **extra)
            torch.cuda.synchronize()
            if not torch.equal(got, plain):
                bad = int((got != plain).sum())
                fail(f"flac_frame differs from its plain version in {bad} bytes: bucket {bkey}, "
                     f"{label}")
            n_runs += 1
    print(f"flac kernel: {n_runs} launches on {len(buckets)} real buckets byte-identical to the "
          f"plain version; covered " + ", ".join(f"{k} {sorted(v)}" for k, v in cover.items()))

    # the main path's launches: held to the plain version, then timed
    shapes = flac_shapes(composed_blob)
    res = {}
    for name, (tensors, kw) in shapes.items():
        got = fk.flac_frame_cuda(*tensors, **kw)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        plain = fk.flac_frame_plain(*tensors, **kw)
        end.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(end)
        if not torch.equal(got, plain):
            fail(f"flac_frame differs from its plain version at the {name} shape")
        ms = cuda_time(flac_launcher(tensors, kw), iters=20)
        ms_wrapper = cuda_time(lambda: fk.flac_frame_cuda(*tensors, **kw))
        nbytes, bound_ms, chain_ms, issue_ms = flac_work(tensors, kw)
        F, C, T = tensors[0].shape
        res[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms)
        tier = "int8+escapes" if "esc_pos" in kw else str(tensors[0].dtype).split(".")[-1]
        print(f"kernel flac_frame {name} F={F} C={C} T={T} ({F * C} lanes, {tier}, "
              f"W={kw['max_order']}, use64={kw['use64']}): byte-identical; {ms:.4f} ms per direct "
              f"launch (one wrapper call {ms_wrapper:.4f} ms; plain version {plain_ms:.1f} ms), "
              f"{ms / T * 1e6:.2f} ns per step; bound {bound_ms:.4f} ms (bytes: {nbytes} B at "
              f"3.35 TB/s; no integer multiply-add peak is published), {bound_ms / ms:.1%} of "
              f"it; estimates, not measured: serial chain {chain_ms:.4f} ms (T x {CHAIN_OPS} "
              f"dependent ops x an assumed {OP_CYCLES} cycles), issue {issue_ms:.4f} ms (T x "
              f"{kw['max_order']} multiply-adds x 2 issue cycles), at the maximum SM clock")
    b, d = res["bucket"], res["dispatch"]
    return {"name": "flac_frame", "route": "cuda",
            "source": "esp_audio_libs_tpu_torch/csrc/flac_frame.cu",
            "replaces": "esp_audio_libs_tpu/models/flac.py:40 / esp_audio_libs_tpu/ops/lpc.py:43",
            "launches": 0, "max_abs_err": 0, "byte_exact": True,
            "ms": b["ms"], "plain_ms": b["plain_ms"], "bound_ms": b["bound_ms"],
            "bound_by": "bytes", "library_ms": None,
            "ms_dispatch": d["ms"], "bound_ms_dispatch": d["bound_ms"],
            "plain_ms_dispatch": d["plain_ms"], "one_lane_ms": res["one_lane"]["ms"],
            "ms_by_order": {"8": d["ms"], "12": res["dispatch_w12"]["ms"],
                            "32": res["dispatch_w32"]["ms"]}}


def flac_corpus_phase():
    """Phase 7: every corpus/independent file decoded on the card, md5_ok."""
    from pathlib import Path
    files = sorted((Path(__file__).resolve().parent / "corpus" / "independent").glob("*.flac"))
    if len(files) < 20:
        fail(f"corpus/independent holds {len(files)} files")
    for path in files:
        blob = path.read_bytes()
        (dec,), (body,) = flac_headers([blob], "cuda")
        pcm, r = dec.decode_stream(body)
        if not pcm or r["md5_ok"] is not True or any(c != 0 for c in r["frame_results"]):
            fail(f"{path.name}: md5_ok={r['md5_ok']}, frame results {set(r['frame_results'])}")
    print(f"flac corpus: {len(files)} corpus/independent files decoded on the card, all frames "
          f"SUCCESS, all md5_ok (mut_flip_payload_bits_i32_overflow.flac included)")


def flac_composed_phase(composed_blob, reps=5):
    """Phase 8: FLAC fleet -> device PCM -> 44.1 -> 16 kHz Resampler, checked
    and timed; returns the launch counts of the phase."""
    import numpy as np
    import torch

    from esp_audio_libs_tpu_torch.models import BatchedFLACDecoder
    from esp_audio_libs_tpu_torch.models.flac import _parse_streams
    from esp_audio_libs_tpu_torch.ops import flac_kernels as fk
    from esp_audio_libs_tpu_torch.ops import polyphase_kernels as pk
    from esp_audio_libs_tpu_torch.runtime.transport import SLICE_OUT_BYTES

    frames = FLAC_FRAMES * FLAC_BLOCK
    # a call dispatches one frame-kernel launch per transport slice of
    # streams; a chain call resamples its one chunk in one contraction
    per_slice = SLICE_OUT_BYTES // (frames * 2 * 2)
    want = {"flac_frame": 2 * reps * -(-FLAC_STREAMS // per_slice), "polyphase_banded": reps}
    bat = BatchedFLACDecoder(FLAC_STREAMS, device="cuda")
    if any(h != 0 for h in bat.read_headers([composed_blob] * FLAC_STREAMS)):
        fail("composed fleet: read_header failed")
    bodies = [composed_blob[d.get_bytes_index():] for d in bat.decoders]

    host = bat.decode_streams(bodies, verify_md5=True)
    if not all(r["md5_ok"] is True for _, r in host):
        fail("composed fleet: decode_streams on the card is not md5_ok for every stream")
    pcm_host = np.stack([np.frombuffer(p, np.uint8) for p, _ in host])
    pcm_dev, res = bat.decode_streams_to_device(bodies)
    torch.cuda.synchronize()
    if not pcm_dev.is_cuda or not np.array_equal(pcm_dev.cpu().numpy(), pcm_host):
        fail("composed fleet: device PCM differs from the host-roundtrip PCM")
    if any(r["num_samples"] != frames * 2 for r in res):
        fail("composed fleet: sample counts")
    out_dev = make_resampler(44100.0, 16000.0, FLAC_STREAMS, "cuda").resample_stream(
        pcm_dev, frames, 1)
    out_host = make_resampler(44100.0, 16000.0, FLAC_STREAMS, "cuda").resample_stream(
        torch.as_tensor(pcm_host, device="cuda"), frames, 1)
    torch.cuda.synchronize()
    if (out_dev[1] != out_host[1] or not torch.equal(out_dev[0], out_host[0])
            or not np.array_equal(out_dev[2], out_host[2])):
        fail("composed chain: resampled device PCM differs from the host-roundtrip chain")

    r = make_resampler(44100.0, 16000.0, FLAC_STREAMS, "cuda")
    dec_times, chain_times = [], []
    fk.reset_launch_counts()
    pk.reset_launch_counts()
    for _ in range(reps):
        t0 = time.perf_counter()
        bat.decode_streams_to_device(bodies)
        torch.cuda.synchronize()
        dec_times.append(time.perf_counter() - t0)
    for _ in range(reps):
        t0 = time.perf_counter()
        pcm, _ = bat.decode_streams_to_device(bodies)
        r.resample_stream(pcm, frames, 1)
        torch.cuda.synchronize()
        chain_times.append(time.perf_counter() - t0)
    launches = {"flac_frame": fk.flac_frame_cuda.launches,
                "polyphase_banded": pk.polyphase_banded_cuda.launches}
    if launches != want:
        fail(f"the composed chain launched {launches}, expected {want}")
    t0 = time.perf_counter()
    _parse_streams(bat.decoders, bodies)
    parse_s = time.perf_counter() - t0

    cpu = BatchedFLACDecoder(CMP_STREAMS, device="cpu")
    cpu.read_headers([composed_blob] * CMP_STREAMS)
    pcm_cpu, _ = cpu.decode_streams_to_device(bodies[:CMP_STREAMS])
    if not np.array_equal(pcm_cpu.numpy(), pcm_host[:CMP_STREAMS]):
        fail("composed fleet: CPU port PCM differs from the card's")
    ndiff, clips = compare_stream(out_dev, make_resampler(44100.0, 16000.0, CMP_STREAMS, "cpu")
                                  .resample_stream(pcm_cpu, frames, 1), "composed chain")
    n_in = FLAC_STREAMS * frames * 2
    med_d, med_c = float(np.median(dec_times)), float(np.median(chain_times))
    print(f"flac->16k composed {FLAC_STREAMS} streams x {FLAC_FRAMES} x {FLAC_BLOCK} stereo s16: "
          f"md5_ok all, device PCM = host PCM, device chain = host-roundtrip chain byte for byte, "
          f"{ndiff} samples of {CMP_STREAMS} streams differ by 1 LSB from the CPU port, {clips} "
          f"clipped; decode_streams_to_device {n_in / med_d / 1e6:.1f} Msamples/s "
          f"({med_d * 1e3:.2f} ms/call, min {min(dec_times) * 1e3:.2f}, max "
          f"{max(dec_times) * 1e3:.2f}), whole chain {n_in / med_c / 1e6:.1f} Msamples/s "
          f"({med_c * 1e3:.2f} ms/call, min {min(chain_times) * 1e3:.2f}, max "
          f"{max(chain_times) * 1e3:.2f}) at the median of {reps} calls; host parse of one call "
          f"{parse_s * 1e3:.2f} ms; gens {out_dev[1]}")
    print(f"launches on the composed path ({reps} decode calls, then {reps} chain calls): "
          f"{launches}")
    return launches


def flac_phases():
    """Phases 6-8; returns the kernels-line entry of flac_frame and the
    composed stream (phase 19 serves it again over a mesh)."""
    composed_blob = flac_stream(8)
    entry = flac_kernel_phase(composed_blob)
    flac_corpus_phase()
    entry["launches"] = flac_composed_phase(composed_blob)["flac_frame"]
    return entry, composed_blob


def same_bits(a, b) -> bool:
    """Equal f32 tensors bit for bit (NaN positions equal, any NaN payload)."""
    import torch
    if a.shape != b.shape or not torch.equal(a.isnan(), b.isnan()):
        return False
    keep = ~a.isnan()
    return torch.equal(a[keep].view(torch.int32), b[keep].view(torch.int32))


def exact_chunk_launches(src, dst, batch, data):
    """The first chunk of a fresh exact stream (the first ``FRAMES`` frames
    of ``data``'s first ``batch`` streams) through the resampler's own chunk
    body, ``Resampler._exact_chunk``, with the operands it hands to the
    biquad and the polyphase kernels recorded. Returns (the resampler, (x,
    valid_len) of each biquad launch, (xext, grid) of each polyphase
    launch)."""
    import dataclasses

    import torch

    from esp_audio_libs_tpu_torch.models import resampler as rm
    from esp_audio_libs_tpu_torch.ops import quantization as q

    r = make_resampler(src, dst, batch, "cuda", exact=True)
    out_max = math.ceil(FRAMES * float(r.sample_ratio)) + 8
    (grid_t,), (gen,), _ = r._schedule(dataclasses.replace(r.phase), FRAMES, out_max, 1)
    packed, clips = r._outputs((), out_max * 4)
    chunk = torch.as_tensor(data[:batch, : FRAMES * 4], device=r.device)
    biquads, polys = [], []
    real_b, real_p = rm.bq.biquad_apply, rm.polyphase_apply
    rm.bq.biquad_apply = lambda x, c, s, **kw: (biquads.append((x, kw.get("valid_len")))
                                               or real_b(x, c, s, **kw))
    rm.polyphase_apply = lambda xe, fb, *g, **kw: polys.append((xe, g)) or real_p(xe, fb, *g, **kw)
    try:
        r._exact_chunk(chunk, (r.history, r._biquad_states()), grid_t, gen, packed, clips,
                       hist_from=FRAMES, factor=q.gain_factor(16, 0.0), frames=FRAMES,
                       T=out_max, out_max=out_max)
    finally:
        rm.bq.biquad_apply, rm.polyphase_apply = real_b, real_p
    return r, biquads, polys


def biquad_operands(data):
    """The exact biquad's real launches: the main pre-filter chunk
    ([2048, 2, 8192] from the phase-4 bytes, zero state) and the exact
    upsampling post-filter chunk (16 kHz -> 44.1 kHz at batch 2048: the
    first chunk's polyphase output [2048, 2, out_max] with valid_len = its
    generated count), each the first launch of the resampler's chunk body
    (:func:`exact_chunk_launches`), with its resampler's coefficients.
    Returns {shape: (x, coeffs, state, valid_len)}."""
    import torch

    ops = {}
    for key, src, dst, batch in (("main", 44100.0, 16000.0, BATCH),
                                 ("upsample", 16000.0, 44100.0, BATCH)):
        r, ((x, vl), *_), _ = exact_chunk_launches(src, dst, batch, data)
        x = x.contiguous()
        zero = tuple(torch.zeros(x.shape[:-1], device="cuda") for _ in range(4))
        ops[key] = (x, r._coeffs_dev, zero, vl)
    return ops


def biquad_launcher(x, c, state, valid_len):
    """A function that launches biquad_exact on these operands through the
    C entry point, its arguments prepared once: the kernel alone, without
    the wrapper's per-call host work (broadcasts, the state stack, output
    allocation). Used only to time the kernel; its launches are not
    counted."""
    import torch

    from esp_audio_libs_tpu_torch.runtime import kernels
    T = x.shape[-1]
    n = x.numel() // T
    coef = c.contiguous()
    st_in = torch.stack([s.reshape(n) for s in state]).contiguous()
    y, st_out = torch.empty_like(x), torch.empty_like(st_in)
    args = (x.data_ptr(), y.data_ptr(), coef.data_ptr(), 0 if coef.dim() == 1 else 5,
            st_in.data_ptr(), st_out.data_ptr(), n, T, T if valid_len is None else valid_len, 0,
            torch.cuda.current_stream().cuda_stream)
    lib = kernels.library()

    def launch():
        if lib.eal_biquad_df1(*args) != 0:
            fail("eal_biquad_df1 refused its arguments")
        return x, coef, st_in, y, st_out          # keeps the operands alive
    return launch


def biquad_timing(x, c, state, valid_len):
    """Mean ms of one biquad_exact launch on ``x`` (direct launches: the
    kernel), of one wrapper call on it (host work included) and of a
    launch on its first lane alone, beside the launch's bound: x and y once
    plus state and coefficients at 3.35 TB/s, or 9 FP32 ops per step at 67
    TFLOP/s. Returns (ms, wrapper ms, one-lane ms, bytes, bound ms,
    bound_by, ops ms)."""
    from esp_audio_libs_tpu_torch.ops import biquad_kernels as bk
    T = x.shape[-1]
    lanes = x.numel() // T
    ms = cuda_time(biquad_launcher(x, c, state, valid_len), iters=20)
    ms_wrapper = cuda_time(lambda: bk.biquad_df1_cuda(x, c, state, valid_len=valid_len))
    one = tuple(s[:1, :1] for s in state)
    ms_one = cuda_time(biquad_launcher(x[:1, :1].contiguous(), c, one, valid_len), iters=20)
    nbytes = 2 * x.numel() * 4 + 8 * lanes * 4 + c.numel() * 4
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, 9 * x.numel() / PEAK_FP32 * 1e3
    bound_ms, by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return ms, ms_wrapper, ms_one, nbytes, bound_ms, by, t_ops


def polyphase_operands(data):
    """The exact polyphase kernel's real launches: the main chunk (44.1 ->
    16 kHz at batch 2048: history + the chunk after the two exact
    pre-filter stages, [4096, 8264] -> 2981 outputs) and the exact
    upsampling chunk (16 -> 44.1 kHz at batch 2048: history + the unpacked
    chunk, [4096, 8264] -> 22588 outputs), each the first chunk of a fresh
    stream through the resampler's chunk body (:func:`exact_chunk_launches`).
    Returns {shape: (xext [M, L], filters, grid, half, compute_second)}."""
    from esp_audio_libs_tpu_torch.ops import sinc

    ops = {}
    for key, src, dst, batch in (("main", 44100.0, 16000.0, BATCH),
                                 ("upsample", 16000.0, 44100.0, BATCH)):
        r, _, ((xext, grid),) = exact_chunk_launches(src, dst, batch, data)
        ops[key] = (xext.reshape(-1, xext.shape[-1]).contiguous(), r._filters,
                    grid, r.config.number_of_taps // 2,
                    bool(r.bank_flags & sinc.SUBSAMPLE_INTERPOLATE))
    return ops


def polyphase_launcher(xext, filters, grid, half, second, lib=None):
    """A function that launches polyphase_exact on these operands through
    the C entry point (of ``lib``, the package's library by default), its
    arguments prepared once: the kernel alone, without the wrapper's checks,
    conversions and output allocation. Used only to time the kernel; its
    launches are not counted. The function returns the output tensor."""
    import torch

    from esp_audio_libs_tpu_torch.runtime import kernels
    M, L = xext.shape
    T = grid[0].shape[0]
    x, fb = xext.contiguous(), filters.contiguous()
    g = [t.to(torch.int32).contiguous() for t in (grid[0], grid[1], grid[2], grid[4])]
    w = grid[3].to(torch.float32).contiguous()
    out = torch.empty((M, T), device=xext.device)
    args = (x.data_ptr(), fb.data_ptr(), g[0].data_ptr(), g[1].data_ptr(), g[2].data_ptr(),
            w.data_ptr(), g[3].data_ptr(), out.data_ptr(), M, L, T, fb.shape[0], fb.shape[1],
            half, int(second), torch.cuda.current_stream().cuda_stream)
    lib = lib or kernels.library()

    def launch():
        if lib.eal_polyphase_exact(*args) != 0:
            fail("eal_polyphase_exact refused its arguments")
        launch.keep = (x, fb, g, w)               # keeps the operands alive
        return out
    return launch


def polyphase_work(xext, filters, grid):
    """(bytes, FP32 ops) of one exact polyphase launch: x, the filterbank,
    the five grid arrays and the output each moved once; per row, 2 ops per
    tap for a mode-1 output and 4 per tap plus the 4 of the lerp for a
    mode-2 output (mode 0 is a copy)."""
    M, L = xext.shape
    T = grid[0].shape[0]
    modes = grid[4].cpu().numpy()
    taps = filters.shape[1]
    ops = M * (int((modes == 1).sum()) * 2 * taps + int((modes == 2).sum()) * (4 * taps + 4))
    return (xext.numel() + filters.numel() + 5 * T + M * T) * 4, ops


def polyphase_timing(xext, filters, grid, half, second, sms, mhz):
    """Mean ms of one polyphase_exact launch on these operands (20 direct
    launches: the kernel) and of one wrapper call (host work included),
    beside the bound (bytes at 3.35 TB/s or FP32 ops at 67 TFLOP/s) and the
    FMA-free issue floor, an estimate: the ops at one FP32 instruction per
    lane and cycle (``sms`` x 128 lanes at ``mhz``). Returns (ms, wrapper ms,
    bytes, ops, bound ms, bound_by, floor ms)."""
    from esp_audio_libs_tpu_torch.ops import polyphase_kernels as pk
    ms = cuda_time(polyphase_launcher(xext, filters, grid, half, second), iters=20)
    ms_wrapper = cuda_time(lambda: pk.polyphase_exact_cuda(xext, filters, *grid, half=half,
                                                          compute_second=second))
    nbytes, ops = polyphase_work(xext, filters, grid)
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_FP32 * 1e3
    bound_ms, by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    floor_ms = ops / (sms * 128 * mhz * 1e6) * 1e3
    return ms, ms_wrapper, nbytes, ops, bound_ms, by, floor_ms


def exact_kernels_phase(data):
    """Phase 9: the exact-mode kernels against their plain versions, bit for
    bit, at the main path's shapes; timed. Returns the two kernels-line
    entries without their launch counts."""
    import torch

    from esp_audio_libs_tpu_torch.ops import biquad_kernels as bk
    from esp_audio_libs_tpu_torch.ops import polyphase_kernels as pk

    ops = biquad_operands(data)
    x, c, zero, _ = ops["main"]                                             # [2048, 2, 8192]
    first = torch.tensor([0.3, 0.3, 0.0, -0.4, 0.0], device="cuda")
    burst = x.clone()
    burst[: BATCH // 2, :, 256:] = 0.0       # silence after a burst: the tail underflows
    xu, cu, zu, gen = ops["upsample"]                                      # [2048, 2, out_max]
    cases = [("second-order", x, c, zero, {}),
             ("first-order", x, first, zero, {"first_order": True}),
             ("valid_len 5000", x, c, zero, {"valid_len": 5000}),
             ("burst + silence", burst, c, zero, {}),
             (f"upsampling post-filter, valid_len {gen}", xu, cu, zu, {"valid_len": gen})]
    for label, xi, ci, si, kw in cases:
        y, st = bk.biquad_df1_cuda(xi, ci, si, **kw)
        y_p, st_p = bk.biquad_df1_plain(xi, ci, si, **kw)
        torch.cuda.synchronize()
        if not (same_bits(y, y_p) and all(same_bits(a, b) for a, b in zip(st, st_p))):
            fail(f"biquad_df1 ({label}) differs from its plain version at {tuple(xi.shape)}")
        if label.startswith("burst") and bool((y[: BATCH // 2, :, -64:] != 0).any()):
            fail("the burst's tail did not flush to zero")
    f2 = x.reshape(-1, FRAMES)
    p1, p2 = (torch.full((f2.shape[0],), float(c[i]), device="cuda") for i in (3, 4))
    y, st = bk.iir2_sequential_cuda(f2, p1, p2, zero[0].reshape(-1), zero[1].reshape(-1))
    y_p, st_p = bk.iir2_sequential_plain(f2, p1, p2, zero[0].reshape(-1), zero[1].reshape(-1))
    torch.cuda.synchronize()
    if not (same_bits(y, y_p) and all(same_bits(a, b) for a, b in zip(st, st_p))):
        fail("iir2_sequential differs from its plain version")
    del burst, y, y_p

    plain_b = cuda_time(lambda: bk.biquad_df1_plain(x, c, zero), iters=2, warmup=1)
    mhz = max_clock_mhz()
    timing = {}
    for key, (xi, ci, si, vl) in ops.items():
        ms, ms_wrapper, ms_one, nbytes, bound_ms, by, t_ops = biquad_timing(xi, ci, si, vl)
        T = xi.shape[-1]
        est_ms = T * BIQUAD_CHAIN_OPS * OP_CYCLES / (mhz * 1e6) * 1e3
        timing[key] = (ms, ms_one, bound_ms, by)
        print(f"kernel biquad_exact {key} {list(xi.shape)} ({xi.numel() // T} lanes, valid_len "
              f"{T if vl is None else vl}): {ms:.4f} ms per launch (one wrapper call "
              f"{ms_wrapper:.4f} ms), bound {bound_ms:.4f} ms ({by}: "
              f"{nbytes} B at 3.35 TB/s; 9 FP32 ops per step at 67 TFLOP/s take {t_ops:.4f}), "
              f"{bound_ms / ms:.1%} of the bound; one lane alone {ms_one:.4f} ms (measured chain "
              f"{ms_one / T * 1e6:.2f} ns per step); estimated serial chain {est_ms:.4f} ms (an "
              f"estimate, not measured: T x {BIQUAD_CHAIN_OPS} dependent ops x an assumed "
              f"{OP_CYCLES} cycles at {mhz:.0f} MHz)")
    print(f"kernel biquad_exact: bit-identical to the plain version second- and first-order, "
          f"with valid_len, through a flushed tail, at the upsampling post-filter shape and as "
          f"iir2; plain version {plain_b:.4f} ms at the main shape")
    ms_b, ms_one, bound_b, by_b = timing["main"]
    del ops, xu

    # the polyphase kernel on the main and the upsampling chunk's real operands
    pops = polyphase_operands(data)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ptime = {}
    for key, (xext, fb, grid, half, second) in pops.items():
        for sec, rows in ((second, None), (False, None), (second, 13)):
            xe = xext[:rows]
            got = pk.polyphase_exact_cuda(xe, fb, *grid, half=half, compute_second=sec)
            want = pk.polyphase_exact_plain(xe, fb, *grid, half=half, compute_second=sec)
            torch.cuda.synchronize()
            if not same_bits(got, want):
                fail(f"polyphase_exact ({key}, compute_second={sec}, {xe.shape[0]} rows) "
                     f"differs from its plain version")
        ms, ms_wrapper, nbytes, n_ops, bound_ms, by, floor_ms = polyphase_timing(
            xext, fb, grid, half, second, sms, mhz)
        ptime[key] = (ms, ms_wrapper, bound_ms, by, floor_ms)
        M, L = xext.shape
        modes = grid[4].cpu().numpy()
        print(f"kernel polyphase_exact {key} M={M} L={L} T={grid[0].shape[0]} taps={fb.shape[1]} "
              f"(modes 0/1/2: {int((modes == 0).sum())}/{int((modes == 1).sum())}/"
              f"{int((modes == 2).sum())}): bit-identical to the plain version with and without "
              f"the second dot and on 13 rows; {ms:.4f} ms per launch (one wrapper call "
              f"{ms_wrapper:.4f} ms), bound {bound_ms:.4f} ms ({by}: {nbytes} B at 3.35 TB/s, "
              f"{n_ops} FP32 ops at 67 TFLOP/s take {n_ops / PEAK_FP32 * 1e3:.4f}), "
              f"{bound_ms / ms:.1%} of the bound; FMA-free issue floor {floor_ms:.4f} ms (an "
              f"estimate, not measured: the ops at one FP32 instruction per lane and cycle, "
              f"{sms} SMs x 128 lanes at {mhz:.0f} MHz), {floor_ms / ms:.1%} of it")
    xext, fb, grid, half, second = pops["main"]
    plain_p = cuda_time(lambda: pk.polyphase_exact_plain(xext, fb, *grid, half=half))
    ms_p, ms_pw, bound_p, by_p, _ = ptime["main"]
    print(f"kernel polyphase_exact: plain version {plain_p:.4f} ms at the main shape")
    del pops
    return [{"name": "biquad_exact", "route": "cuda",
             "source": "esp_audio_libs_tpu_torch/csrc/biquad_exact.cu",
             "replaces": "esp_audio_libs_tpu/ops/biquad.py:197 / esp_audio_libs_tpu/ops/scan.py:41",
             "launches": 0, "max_abs_err": 0, "bit_exact": True, "ms": ms_b, "plain_ms": plain_b,
             "bound_ms": bound_b, "bound_by": by_b, "library_ms": None, "one_lane_ms": ms_one,
             "ms_upsample": timing["upsample"][0], "one_lane_ms_upsample": timing["upsample"][1],
             "bound_ms_upsample": timing["upsample"][2]},
            {"name": "polyphase_exact", "route": "cuda",
             "source": "esp_audio_libs_tpu_torch/csrc/polyphase_exact.cu",
             "replaces": "esp_audio_libs_tpu/ops/polyphase.py:236",
             "launches": 0, "max_abs_err": 0, "bit_exact": True, "ms": ms_p, "plain_ms": plain_p,
             "bound_ms": bound_p, "bound_by": by_p, "library_ms": None,
             "ms_upsample": ptime["upsample"][0], "bound_ms_upsample": ptime["upsample"][2],
             "ms_wrapper": ms_pw}]


QUANT_PAD = 0xA5   # the bytes around each quantize16 case's output rows


def quantize16_edges():
    """f32 samples at the edges of float_to_int(x, 16): NaN, infinities,
    +-2^31 and +-2^31 / 32768 (where x * 32768 meets the x86 cast's range)
    with their f32 neighbours, +-0, subnormals, values that overflow, exact
    half-ties (k + 0.5) / 32768 (near 0 and at full scale) and values just
    either side of +-1."""
    import numpy as np
    f32 = np.float32
    near = [f32(2.0 ** 31), f32(65536.0)]
    near = [v for a in near for v in (a, np.nextafter(a, f32(0)), np.nextafter(a, f32(np.inf)))]
    one = [v for a in (f32(1.0), f32(-1.0)) for v in (a, np.nextafter(a, f32(0)),
                                                      np.nextafter(a, 2 * a))]
    ties = (np.concatenate([np.arange(-40, 40), np.arange(32760, 32770),
                            np.arange(-32771, -32760)]) + 0.5) / 32768.0
    return np.concatenate([
        np.array([np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-40, -1e-40, 1e-45, -1e-45,
                  1.1754942e-38, 1.17549435e-38, 1e30, -1e30, 3.4e38, -3.4e38], f32),
        np.array(near, f32), -np.array(near, f32), np.array(one, f32), ties.astype(f32)])


def quantize16_cases(device):
    """Operands of quantize_pack16's checks: [(label, x, gen, buf, out)], x
    f32 [B, 2, T] (a strided view in some), ``out`` the view of the uint8
    rows ``buf`` (QUANT_PAD around it) that the frames go to. Samples are
    uniform in +-1.3 (so some clip) with about 10 % drawn from
    quantize16_edges, and the edges in order at the start of stream 0."""
    import numpy as np
    import torch
    rng = np.random.default_rng(2200)
    edges = quantize16_edges()

    def samples(shape):
        x = rng.uniform(-1.3, 1.3, shape).astype(np.float32)
        pick = rng.random(shape) < 0.1
        x[pick] = rng.choice(edges, int(pick.sum()))
        flat = x.reshape(-1)
        flat[:min(len(edges), flat.size)] = edges[:flat.size]
        return torch.as_tensor(x, device=device)

    cases = []
    for label, B, T, gen, layout in (
            ("edges, down chunk width", 3, 2981, 2960, "dense"),
            ("odd T of the up chunk, gen = T", 2, 22587, 22587, "dense"),
            ("gen < T", 5, 1000, 517, "dense"),
            ("gen = 0", 2, 515, 0, "dense"),
            ("gen past T", 2, 300, 345, "dense"),
            ("column view of wider rows, wider output pitch", 4, 777, 700, "columns"),
            ("channel-major planes", 3, 1031, 1031, "planes"),
            ("B = 1, T = 1", 1, 1, 1, "dense"),
            ("T = 0", 2, 0, 0, "dense")):
        if layout == "columns":       # x = wide[..., 5:5 + T]: stream and channel pitches > T
            x = samples((B, 2, T + 20))[..., 5:5 + T]
        elif layout == "planes":      # [2, B, T] seen as [B, 2, T]
            x = samples((2, B, T)).transpose(0, 1)
        else:
            x = samples((B, 2, T))
        col, pitch = (8, T * 4 + 24) if layout == "columns" else (0, T * 4)
        buf = torch.full((B, pitch), QUANT_PAD, dtype=torch.uint8, device=device)
        cases.append((f"{label}: B {B}, T {T}, gen {gen}", x, gen, buf, buf[:, col:col + T * 4]))
    return cases


def quantize16_mismatches(quantize, cases) -> list:
    """The labels of the cases where ``quantize(x, gen, out, clips)`` differs
    from quantize_pack16_plain in a byte of ``buf`` (the padding included)
    or in a clip count."""
    import torch

    from esp_audio_libs_tpu_torch.ops.quantization_kernels import quantize_pack16_plain
    bad = []
    for label, x, gen, buf, out in cases:
        want_buf = buf.cpu().clone()
        packed, counts = quantize_pack16_plain(x.cpu(), gen)
        col = out.data_ptr() - buf.data_ptr() if buf.numel() else 0
        want_buf[:, col:col + packed.shape[1]] = packed
        clips = torch.full((x.shape[0],), -1, dtype=torch.int64, device=x.device)
        quantize(x, gen, out, clips)
        if not (torch.equal(buf.cpu(), want_buf) and torch.equal(clips.cpu(), counts)):
            bad.append(label)
    return bad


def quantize16_bytes(B, T) -> int:
    """The bytes one launch must move: f32 [B, 2, T] in, s16 [B, T, 2] out,
    one int64 count a stream."""
    return B * T * 12 + B * 8


def quantize16_phase():
    """Phase 9b: the quantize-and-pack kernel byte for byte against its
    plain version on quantize16_cases, then at both cells' chunk shapes on
    hot and clipping samples; timed by direct launches (queued behind a
    sleeping kernel, so the host's enqueue does not count) beside its bytes
    bound, one wrapper call and the plain version. Returns the kernels-line
    entry without its launch count."""
    import torch

    from esp_audio_libs_tpu_torch.ops import quantization_kernels as qk

    bad = quantize16_mismatches(qk.quantize_pack16_cuda, quantize16_cases("cuda"))
    if bad:
        fail(f"quantize_pack16 differs from its plain version: {bad}")
    timing = {}
    gen = torch.Generator(device="cuda").manual_seed(22)
    for key, T in (("down", 2981), ("up", 22587)):
        x = torch.empty((BATCH, 2, T), device="cuda").uniform_(-1.06, 1.06, generator=gen)
        out = torch.empty((BATCH, T * 4), dtype=torch.uint8, device="cuda")
        clips = torch.empty(BATCH, dtype=torch.int64, device="cuda")
        g = T - 8
        qk.quantize_pack16_cuda(x, g, out, clips)
        p, c = qk.quantize_pack16_plain(x, g)
        if not (torch.equal(out, p) and torch.equal(clips, c)):
            fail(f"quantize_pack16 differs from its plain version at [{BATCH}, 2, {T}]")
        launch = direct_launcher("eal_quantize_pack16", x, x.stride(0), x.stride(1), out, T,
                                 clips, BATCH, T, g)
        ms = cuda_time_queued(launch, iters=40)
        ms_wrapper = cuda_time(lambda: qk.quantize_pack16_cuda(x, g, out, clips), iters=20)
        plain_ms = cuda_time(lambda: qk.quantize_pack16_plain(x, g), iters=5)
        nbytes = quantize16_bytes(BATCH, T)
        bound_ms = nbytes / PEAK_BYTES * 1e3
        timing[key] = (ms, bound_ms, plain_ms, ms_wrapper)
        print(f"kernel quantize_pack16 {key} [{BATCH}, 2, {T}] gen {g}: {ms:.4f} ms per launch "
              f"(queued; one wrapper call {ms_wrapper:.4f} ms), bound {bound_ms:.4f} ms (bytes: "
              f"{nbytes} B at 3.35 TB/s), {bound_ms / ms:.1%} of the bound; plain version "
              f"{plain_ms:.4f} ms; {int(c.sum())} clipped samples")
        del x, out, p
    print("kernel quantize_pack16: byte-identical to the plain version on quantize16_cases and "
          "at both chunk shapes")
    return {"name": "quantize_pack16", "route": "cuda",
            "source": "esp_audio_libs_tpu_torch/csrc/pcm_quantize16.cu",
            "replaces": "ops/quantization.py float_to_int + pack_pcm16_interleave2 (torch ops)",
            "launches": 0, "max_abs_err": 0, "bit_exact": True, "ms": timing["down"][0],
            "plain_ms": timing["down"][2], "bound_ms": timing["down"][1], "bound_by": "bytes",
            "library_ms": None, "ms_wrapper": timing["down"][3], "ms_upsample": timing["up"][0],
            "bound_ms_upsample": timing["up"][1], "plain_ms_upsample": timing["up"][2]}


UNPACK_FILL = float("nan")   # what the slab holds before an unpack16 case writes it
UNPACK_GAINS_DB = (0.0, -6.02, 12.0)


def unpack16_cases(device):
    """Operands of unpack16_extend's checks: [(label, data, frames, gain_db,
    hist, L)], ``data`` the view of a chunk's stereo s16 bytes inside wider
    uint8 rows, ``hist`` f32 [B, 2, H] or None. Samples are uniform int16
    with about 10 % at the edges (-32768, -32767, -1, 0, 1, 32766, 32767),
    and those in order at the start of stream 0: the cells' shapes scaled
    down (H = 72, 326 and 0, the fast slab's padded tail), a chunk inside a
    wider row, row starts at 1-, 2-, 4-, 8- and 16-byte alignment and pitches
    that move it from row to row, an odd L (channel 1's row off 16 bytes), a
    strided history, rows that span two blocks, the three gains, a subnormal
    gain factor, B = 1, frames = 0 and L = H + frames."""
    import numpy as np
    import torch
    rng = np.random.default_rng(2700)
    edges = np.array([-32768, -32767, -1, 0, 1, 32766, 32767], np.int16)

    def rows(B, frames, offset, pitch):
        """uint8 [B, pitch] rows (pitch bytes apart in one buffer), the
        chunk's frames at ``offset`` of each; returns the chunk's view."""
        s = rng.integers(-32768, 32768, B * pitch // 2 + 1).astype(np.int16)
        pick = rng.random(s.shape) < 0.1
        s[pick] = rng.choice(edges, int(pick.sum()))
        raw = s.view(np.uint8)[:B * pitch].copy()
        n = min(len(edges), 2 * frames)
        raw[offset:offset + 2 * n] = edges[:n].view(np.uint8)
        buf = torch.as_tensor(raw, device=device).view(B, pitch)
        return buf[:, offset:offset + frames * 4]

    def history(B, H, strided=False):
        if H == 0:
            return None
        h = torch.as_tensor(rng.standard_normal((B, 2, H + 7)).astype(np.float32) * 0.3,
                            device=device)
        h[0, 0, :4] = torch.tensor([-0.0, 1e-42, -1e-42, 3.0e38])   # copied bit for bit
        return h[..., 3:3 + H] if strided else h[..., :H].contiguous()

    cases = []
    for i, (label, B, frames, H, L, offset, pitch, strided) in enumerate((
            ("up cell scaled: H 72, L = H + frames", 3, 1000, 72, 1072, 0, 4000, False),
            ("fast cell scaled: H 326, padded tail", 3, 1000, 326, 1408, 0, 4000, False),
            ("exact down scaled: H 0, L = frames", 3, 1000, 0, 1000, 0, 4000, False),
            ("chunk 2 of 3 inside a wider row", 4, 512, 72, 584, 4096, 6144, False),
            ("rows 1-byte aligned, odd pitch", 5, 300, 326, 640, 1, 1203, False),
            ("rows 2-byte aligned, pitch 2 mod 4", 5, 300, 72, 372, 2, 1206, False),
            ("rows 4-byte aligned, pitch 4 mod 16", 5, 300, 0, 300, 4, 1204, False),
            ("rows 8-byte aligned", 3, 256, 72, 328, 8, 1032, False),
            ("rows 16-byte aligned", 3, 256, 326, 640, 16, 1040, False),
            ("odd L, strided history", 3, 97, 5, 103, 0, 388, True),
            ("rows of two blocks' groups", 2, 4200, 326, 4608, 0, 16800, False),
            ("B = 1, frames = 0, L = H", 1, 0, 72, 72, 0, 16, False),
            ("frames = 0, H = 0, zeros only", 2, 0, 0, 9, 0, 16, False),
            ("B = 1, frames = 1", 1, 1, 0, 1, 2, 16, False))):
        gain = UNPACK_GAINS_DB[i % 3]
        cases.append((f"{label}: B {B}, frames {frames}, H {H}, L {L}, {gain} dB",
                       rows(B, frames, offset, pitch), frames, gain,
                       history(B, H, strided), L))
    data = rows(2, 200, 0, 800)
    cases.append(("-700 dB: a subnormal gain factor: B 2, frames 200, H 0, L 200",
                  data, 200, -700.0, None, 200))
    return cases


def unpack16_mismatches(unpack, cases) -> list:
    """The labels of the cases where ``unpack(data, frames, factor, hist, L)``
    differs from unpack16_extend_plain on the CPU in a bit of the slab or
    in its shape."""
    import torch

    from esp_audio_libs_tpu_torch.ops import quantization as q
    from esp_audio_libs_tpu_torch.ops.quantization_kernels import unpack16_extend_plain
    bad = []
    for label, data, frames, gain_db, hist, L in cases:
        factor = q.gain_factor(16, gain_db)
        want = unpack16_extend_plain(data.cpu(), frames, factor,
                                     None if hist is None else hist.cpu(), L)
        got = unpack(data, frames, factor, hist, L).cpu()
        if got.shape != want.shape or not torch.equal(got.view(torch.int32),
                                                      want.view(torch.int32)):
            bad.append(label)
    return bad


def unpack16_bytes(B, frames, H, L) -> int:
    """The bytes one launch must move: 4 input bytes a frame read, the
    history read, the f32 slab [B, 2, L] written."""
    return B * (frames * 4 + 2 * H * 4 + 2 * L * 4)


UNPACK_SHAPES = (("up", 72, 8264), ("fast", 326, 8576), ("down", 0, 8192))


def unpack16_phase(data):
    """Phase 9c: the unpack-gain-extend kernel bit for bit against its plain
    version on unpack16_cases, then at the three cells' chunk shapes (2048
    streams, 8192 frames read in place from chunk 3 of the phase-4 bytes, H
    and L of the exact up, fast down and exact down bodies); timed by direct
    launches (queued behind a sleeping kernel) beside its bytes bound, one
    wrapper call and the plain version. Returns the kernels-line entry
    without its launch count."""
    import torch

    from esp_audio_libs_tpu_torch.ops import quantization as q
    from esp_audio_libs_tpu_torch.ops import quantization_kernels as qk

    bad = unpack16_mismatches(qk.unpack16_extend_cuda, unpack16_cases("cuda"))
    if bad:
        fail(f"unpack16_extend differs from its plain version: {bad}")
    rows = torch.as_tensor(data, device="cuda")
    chunk = rows[:, 3 * FRAMES * 4:4 * FRAMES * 4]
    factor = q.gain_factor(16, 0.0)
    gen = torch.Generator(device="cuda").manual_seed(27)
    timing = {}
    for key, H, L in UNPACK_SHAPES:
        hist = torch.empty((BATCH, 2, H), device="cuda").uniform_(-1, 1, generator=gen) if H \
            else None
        got = qk.unpack16_extend_cuda(chunk, FRAMES, factor, hist, L)
        want = qk.unpack16_extend_plain(chunk, FRAMES, factor, hist, L)
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            fail(f"unpack16_extend differs from its plain version at the {key} shape")
        del want
        h = (hist, *hist.stride()) if H else (0, 0, 0, 0)
        launch = direct_launcher("eal_unpack16_extend", chunk, chunk.stride(0), FRAMES,
                                 float(factor), *h, H, got, L, BATCH)
        ms = cuda_time_queued(launch, iters=40)
        ms_wrapper = cuda_time(lambda: qk.unpack16_extend_cuda(chunk, FRAMES, factor, hist, L),
                               iters=20)
        plain_ms = cuda_time(lambda: qk.unpack16_extend_plain(chunk, FRAMES, factor, hist, L),
                             iters=5)
        nbytes = unpack16_bytes(BATCH, FRAMES, H, L)
        bound_ms = nbytes / PEAK_BYTES * 1e3
        timing[key] = (ms, bound_ms, plain_ms, ms_wrapper)
        print(f"kernel unpack16_extend {key} [{BATCH}, {FRAMES}] H {H} L {L}: {ms:.4f} ms per "
              f"launch (queued; one wrapper call {ms_wrapper:.4f} ms), bound {bound_ms:.4f} ms "
              f"(bytes: {nbytes} B at 3.35 TB/s), {bound_ms / ms:.1%} of the bound; plain "
              f"version {plain_ms:.4f} ms")
        del got, hist
    print("kernel unpack16_extend: bit-identical to the plain version on unpack16_cases and "
          "at the three cells' chunk shapes")
    up, fast, down = (timing[k] for k, _, _ in UNPACK_SHAPES)
    return {"name": "unpack16_extend", "route": "cuda",
            "source": "esp_audio_libs_tpu_torch/csrc/pcm_unpack16.cu",
            "replaces": "ops/quantization.py unpack_pcm16_planar2 + int_to_float and the "
                        "resampler's history cat and pad (torch ops)",
            "launches": 0, "max_abs_err": 0, "bit_exact": True, "ms": up[0], "plain_ms": up[2],
            "bound_ms": up[1], "bound_by": "bytes", "library_ms": None, "ms_wrapper": up[3],
            "ms_fast": fast[0], "bound_ms_fast": fast[1], "plain_ms_fast": fast[2],
            "ms_down": down[0], "bound_ms_down": down[1], "plain_ms_down": down[2]}


def exact_stream(src, dst, batch, data, label, reps=5):
    """Phase 10's Resampler paths: exact resample_stream on the card with
    its launches counted and asserted, bytes, counts and state against a
    CPU run of the plain path on CMP_STREAMS streams. Returns the launches."""
    import numpy as np
    import torch

    from esp_audio_libs_tpu_torch.ops import biquad_kernels as bk
    from esp_audio_libs_tpu_torch.ops import polyphase_kernels as pk
    from esp_audio_libs_tpu_torch.ops import quantization_kernels as qk

    r = make_resampler(src, dst, batch, "cuda", exact=True)
    if not r.exact:
        fail(f"{label}: Resampler's default is not exact mode")
    data_dev = torch.as_tensor(data, device="cuda")
    bk.reset_launch_counts()
    pk.reset_launch_counts()
    qk.reset_launch_counts()
    first = r.resample_stream(data_dev, FRAMES, CHUNKS)
    torch.cuda.synchronize()
    state = r.get_state()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        r.resample_stream(data_dev, FRAMES, CHUNKS)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = {"biquad_exact": bk.biquad_df1_cuda.launches,
                "polyphase_exact": pk.polyphase_exact_cuda.launches,
                "quantize_pack16": qk.quantize_pack16_cuda.launches,
                "unpack16_extend": qk.unpack16_extend_cuda.launches,
                "polyphase_banded": pk.polyphase_banded_cuda.launches}
    want = {"biquad_exact": 2 * CHUNKS * (reps + 1), "polyphase_exact": CHUNKS * (reps + 1),
            "quantize_pack16": CHUNKS * (reps + 1), "unpack16_extend": CHUNKS * (reps + 1),
            "polyphase_banded": 0}
    if launches != want:
        fail(f"{label}: launched {launches}, expected {want}")
    ref = make_resampler(src, dst, CMP_STREAMS, "cpu", exact=True)
    pc, gc, cc = ref.resample_stream(data[:CMP_STREAMS], FRAMES, CHUNKS)
    pg, gg, cg = first
    if gg != gc or not torch.equal(pg[:, :CMP_STREAMS].cpu(), pc) or \
            not np.array_equal(cg[:, :CMP_STREAMS], cc):
        fail(f"{label}: bytes, counts or clip counts differ from the CPU plain path")
    sc = ref.get_state()
    if not np.array_equal(state["history"][:CMP_STREAMS].view(np.uint32),
                          sc["history"].view(np.uint32)) or any(
            not np.array_equal(a[:CMP_STREAMS].view(np.uint32), b.view(np.uint32))
            for sa, sb in zip(state["biquad"], sc["biquad"]) for a, b in zip(sa, sb)):
        fail(f"{label}: carried state differs from the CPU plain path")
    med = float(np.median(times))
    rate = CHUNKS * FRAMES * 2 * batch / med / 1e6
    print(f"{label}: {rate:.1f} input Msamples/s at the median of {reps} calls "
          f"({med * 1e3:.2f} ms/call, min {min(times) * 1e3:.2f}, max {max(times) * 1e3:.2f}), "
          f"gens {gg[0]}..{gg[-1]}; packed bytes, counts, history and biquad state of "
          f"{CMP_STREAMS} streams identical to the CPU plain path; launches {launches}")
    return launches


def exact_phase(data):
    """Phase 10: the exact path end to end. Returns the launch counts of the
    44.1 -> 16 kHz stream (the main path) and of the other paths."""
    import numpy as np
    import torch

    from esp_audio_libs_tpu_torch.models import BatchedResample
    from esp_audio_libs_tpu_torch.ops import biquad as tbq
    from esp_audio_libs_tpu_torch.ops import biquad_kernels as bk
    from esp_audio_libs_tpu_torch.ops import polyphase_kernels as pk
    from esp_audio_libs_tpu_torch.ops import sinc

    main = exact_stream(44100.0, 16000.0, BATCH, data, "exact e2e 44.1k->16k")
    up = exact_stream(16000.0, 44100.0, BATCH, data, f"exact upsample 16k->44.1k B={BATCH}")

    # BatchedResample on one chunk of the main path's pre-filtered-free input
    ratio = float(np.float32(np.float32(16000.0) / np.float32(44100.0)))
    x = torch.as_tensor(np.random.default_rng(0).standard_normal((BATCH, 2, FRAMES)),
                        dtype=torch.float32, device="cuda")
    n_out = math.ceil(FRAMES * ratio) + 8
    args = (64, 32, 0.84 * ratio, sinc.SUBSAMPLE_INTERPOLATE)
    br = BatchedResample((BATCH, 2), *args, exact=True)
    pk.reset_launch_counts()
    t0 = time.perf_counter()
    out, res = br.process(x, n_out, ratio)
    torch.cuda.synchronize()
    br_ms = (time.perf_counter() - t0) * 1e3
    br_launches = pk.polyphase_exact_cuda.launches
    if br_launches != 1:
        fail(f"BatchedResample.process launched polyphase_exact {br_launches} times")
    cpu = BatchedResample((CMP_STREAMS, 2), *args, exact=True, device="cpu")
    out_c, res_c = cpu.process(x[:CMP_STREAMS].cpu(), n_out, ratio)
    if (res.input_used, res.output_generated) != (res_c.input_used, res_c.output_generated) \
            or not same_bits(out[:CMP_STREAMS].cpu(), out_c) \
            or not same_bits(br.history[:CMP_STREAMS].cpu(), cpu.history):
        fail("BatchedResample on the card differs from the CPU plain path")
    print(f"BatchedResample(({BATCH}, 2), 64, 32, exact=True).process of {FRAMES} samples: "
          f"{res.output_generated} outputs, bit-identical to the CPU plain path on "
          f"{CMP_STREAMS} streams, {br_ms:.2f} ms (first call), 1 polyphase_exact launch")

    # bench_all.py's biquad_cascade_2x_stereo: conv form, and the exact kernel
    coeffs = tbq.biquad_init(tbq.biquad_lowpass(0.18), 1.0)
    fir_len = tbq.fir_len_for(coeffs)
    c = torch.as_tensor(coeffs, device="cuda")
    xb = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (CASCADE_B, 2, CASCADE_T), dtype=np.float32), device="cuda")
    zero = tbq.BiquadState.zeros((CASCADE_B, 2), device="cuda")

    def cascade(exact):
        y, _ = tbq.biquad_apply(xb, c, zero, exact=exact, fir_len=None if exact else fir_len)
        return tbq.biquad_apply(y, c, zero, exact=exact, fir_len=None if exact else fir_len)[0]

    def rate_of(exact, reps=5):
        cascade(exact)
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            cascade(exact)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        med = float(np.median(times))
        return CASCADE_B * 2 * CASCADE_T / med / 1e6, med * 1e3

    y_conv = cascade(False)
    bk.reset_launch_counts()
    y_exact = cascade(True)
    torch.cuda.synchronize()
    casc_launches = bk.biquad_df1_cuda.launches
    if casc_launches != 2:
        fail(f"the exact cascade launched biquad_exact {casc_launches} times")
    torch.testing.assert_close(y_conv, y_exact, **CASCADE_TOL)
    err = float((y_conv - y_exact).abs().max())
    del y_conv, y_exact
    rate_c, ms_c = rate_of(False)
    rate_e, ms_e = rate_of(True)
    print(f"biquad_cascade_2x_stereo B={CASCADE_B} x 2 x {CASCADE_T}: conv form (fir_len "
          f"{fir_len}) {rate_c:.1f} Msamples/s ({ms_c:.2f} ms), exact kernel {rate_e:.1f} "
          f"Msamples/s ({ms_e:.2f} ms), median of 5; conv within rtol 1e-4 / atol 1e-5 of the "
          f"exact output (max|d| {err:.3g})")
    del xb
    torch.cuda.empty_cache()
    return main, {"upsample": up, "batched_resample": br_launches, "cascade": casc_launches}


# ------------------------------------------------------------------ MP3

MP3_STREAMS, MP3_FRAMES = 256, 8   # bench_all.py's composed MP3 row (bench_mp3_resample_composed)
MP3_COMPOSED = dict(ver_bits=3, bitrate_idx=11, sr_idx=0, mode=0)   # 44.1 kHz stereo, 320 kbit/s


def mp3_zero_state(B, device):
    import torch
    return tuple(torch.zeros(s, dtype=torch.int32, device=device)
                 for s in ((B, 2, 288), (B, 2), (B, 2), (B, 2), (B, 2176)))


def mp3_check(fmt, vindex, huff, side, state, label, esc=None):
    """One mp3_granules launch (through the escape form when ``esc`` holds
    the int8 plane and its sideband) against the plain version on the same
    CUDA tensors, byte for byte, state included; returns the new state."""
    import torch

    from esp_audio_libs_tpu_torch.models import mp3_pipeline
    from esp_audio_libs_tpu_torch.ops import mp3_kernels as mk
    ver, sr_idx, nch, cutoff = fmt
    if esc is None:
        got = mk.mp3_granules_cuda(huff, side, *state, vindex, ver=ver, sr_idx=sr_idx, nch=nch,
                                   cutoff=cutoff)
    else:
        got = mp3_pipeline._granules_scan_esc_for(*fmt)(*esc, side, *state, vindex)
    want = mk.mp3_granules_plain(huff, side, *state, vindex, ver=ver, sr_idx=sr_idx, nch=nch,
                                 cutoff=cutoff)
    torch.cuda.synchronize()
    for name, a, b in zip(("pcm", "over", "prev_type", "prev_win_switch", "num_prev", "vbuf",
                           "ref_undef"), (got[0], *got[1], got[2]), (want[0], *want[1], want[2])):
        if not torch.equal(a, b):
            fail(f"mp3_granules differs from its plain version in {name}: {label}")
    return got[1]


def mp3_launcher(huff, side, state, fmt, vindex, lib=None):
    """A function that launches mp3_granules through the C entry point
    eal_mp3_granules (of ``lib``, by default the package's library), its
    arguments and buffers prepared once (the state buffers are updated in
    place launch after launch): the kernel alone. Used only to time the
    kernel; its launches are not counted."""
    import torch

    from esp_audio_libs_tpu_torch.ops import mp3_kernels as mk
    from esp_audio_libs_tpu_torch.runtime import kernels
    ver, sr_idx, nch, cutoff = fmt
    G, B = huff.shape[:2]
    st = tuple(t.clone() for t in state)
    pcm = torch.empty((B, G, 576 * nch), dtype=torch.int16, device=huff.device)
    undef = torch.zeros(B, dtype=torch.int32, device=huff.device)
    consts = mk.format_consts(ver, sr_idx, huff.device)
    args = (huff.data_ptr(), side.data_ptr(), consts.data_ptr(), *(t.data_ptr() for t in st),
            pcm.data_ptr(), undef.data_ptr(), G, B, nch, vindex, cutoff,
            torch.cuda.current_stream().cuda_stream)
    lib = lib or kernels.library()

    def launch():
        if lib.eal_mp3_granules(*args) != 0:
            fail("eal_mp3_granules refused its arguments")
        launch.keep = (huff, side, consts, st, pcm, undef)     # keeps the operands alive
        return pcm
    return launch


# Integer operations of one granule and channel, counted from the algorithm
# (csrc/mp3_granules.cu, the JAX package's _granule_body): a 32-bit add,
# subtraction, shift, logic op, compare, select or MULSHIFT32 (__mulhi)
# counts 1, a widening multiply-add (32 x 32 + 64 -> 64 bits) counts 2.
# Only the samples below a granule's nonzero bound need the stages before
# the IMDCT (past it the spectrum is zero), and a zero needs no dequantizer.
# Parts that depend on guard bits the kernel finds on the way (the es
# rescales) are left out.
MP3_DEQUANT_OPS = (12, 18, 40)   # per nonzero sample by magnitude: < 16, < 64, >= 64 (polynomial)
MP3_EXPAND_OPS = 10              # per sample below the bound: band, gain and reorder lookups
MP3_STEREO_OPS = 4               # per position below both channels' bound, and channel, when mode_ext != 0
MP3_BUTTERFLY_OPS = 8            # per butterfly: 4 MULSHIFT32, 2 adds, 2 shifts
MP3_IMDCT_OPS = 260              # per computed block: 2 idct9, chain, window, overlap
MP3_FDCT_OPS = 408               # per slot: 32 input shifts, 128 + 212 in the passes, 36 adds
MP3_PQMF_OPS = 8 * 2 * 2 + 6     # per output: 8 taps x 2 widening multiply-adds, round, clip
# INT32 rate outside the tensor cores: 64 INT32 lanes per SM and clock (the
# NVIDIA Hopper architecture white paper, the H100 SM) x 132 SMs x 1980 MHz,
# the maximum SM clock that max_clock_mhz() reads on the H100 SXM.
PEAK_INT32 = 64 * 132 * 1980e6


def mp3_work(huff, side, fmt):
    """The work of one mp3_granules launch, from its operands:
    (bytes, bound ms, bound_by, integer operations, bytes ms, operations ms).

    Bytes: the int16 spectra, the side rows, the constants, the carried
    state read and written, the PCM and the flags, each once, at 3.35 TB/s.
    Operations: per granule and channel the dequantizer on each nonzero
    sample by its magnitude, the parameter expansion of the samples below
    the nonzero bound, joint stereo below both channels' bound where the
    granule has it, the butterflies and IMDCT blocks the bound needs, FDCT32
    on 18 slots and the PQMF on 576 outputs (MP3_*_OPS), at PEAK_INT32. The
    bound is the larger of the two times."""
    import torch
    G, B, nch = huff.shape[:3]
    nbytes = (huff.numel() * 2 + side.numel() * 4 + 3069 * 4 + 2 * B * (576 + 6 + 2176) * 4
              + B * G * 576 * nch * 2 + B * 4)
    mag = (huff.to(torch.int32) & 0x7FFF)
    n_small = int(((mag > 0) & (mag < 16)).sum())
    n_mid = int(((mag >= 16) & (mag < 64)).sum())
    n_big = int((mag >= 64).sum())
    nzb = side[..., :nch].to(torch.int64).clamp(0, 576)
    blocks = torch.clamp((nzb + 7) // 18 + 1, max=32)
    joint = ((side[..., 3 * nch + 232] != 0) * nzb.amax(-1)).sum() if nch == 2 else 0
    units = G * B * nch                        # granule-channels
    n_ops = (n_small * MP3_DEQUANT_OPS[0] + n_mid * MP3_DEQUANT_OPS[1]
             + n_big * MP3_DEQUANT_OPS[2] + int(nzb.sum()) * MP3_EXPAND_OPS
             + int(joint) * 2 * MP3_STEREO_OPS
             + int((blocks - 1).sum()) * 8 * MP3_BUTTERFLY_OPS
             + int(blocks.sum()) * MP3_IMDCT_OPS
             + units * 18 * MP3_FDCT_OPS + units * 576 * MP3_PQMF_OPS)
    bytes_ms, ops_ms = nbytes / PEAK_BYTES * 1e3, n_ops / PEAK_INT32 * 1e3
    if ops_ms >= bytes_ms:
        return nbytes, ops_ms, "operations", n_ops, bytes_ms, ops_ms
    return nbytes, bytes_ms, "bytes", n_ops, bytes_ms, ops_ms


def mp3_streams(kind, B, n_frames, seed, cfg=None):
    mf = tools_import("mp3frames")
    cfg = cfg or MP3_COMPOSED
    if kind == "tonal":
        return [mf.tonal_stream(cfg, seed + i, n_frames) for i in range(B)]
    return [mf.mixed_stream(cfg, seed + i, n_frames, fuzz=kind == "fuzz") for i in range(B)]


def mp3_run_operands(streams, n_frames, device="cuda"):
    """The kernel operands of one decode_run of ``streams`` on a fresh fleet,
    per format group: [(fmt, vindex, huff_gs, side_gs)] on ``device``."""
    import torch

    from esp_audio_libs_tpu_torch.models.batch import BatchedMP3Decoder, parsed_runs
    bat = BatchedMP3Decoder(len(streams), device="cpu")
    return [(fmt, vindex, torch.as_tensor(h, device=device), torch.as_tensor(sd, device=device))
            for fmt, vindex, _, h, sd in parsed_runs(bat, streams, n_frames)]


def mp3_kernel_phase():
    """Phase 11: mp3_granules byte for byte against its plain version on real
    parsed runs (tools/mp3frames.py): the four formats of the JAX package's
    batched-decoder tests plus MPEG-1 and MPEG-2 intensity stereo, tonal and
    window-type frames (every block type over nonzero overlap) and fuzz
    frames (runs cut short by errors), two runs in a row (the second from
    the first's state, at another FIFO phase), and the escape tier; then
    timed by direct launches at B = 256 and 2048 x G = 16 (8 frames of
    MPEG-1 44.1 kHz stereo). Returns the kernels-line entry without its
    launch count."""
    import numpy as np
    import torch

    from esp_audio_libs_tpu_torch.models import mp3_pipeline
    from esp_audio_libs_tpu_torch.ops import mp3_kernels as mk

    mf = tools_import("mp3frames")
    cfgs = mf.BATCH_CFGS + [dict(ver_bits=3, bitrate_idx=9, sr_idx=1, mode=1, mode_ext=3),
                            dict(ver_bits=2, bitrate_idx=7, sr_idx=1, mode=1, mode_ext=1)]
    n_runs, shapes = 0, set()
    for ci, cfg in enumerate(cfgs):
        for kind, B, nf in (("mixed", 5, 8), ("fuzz", 7, 4)):
            streams = mp3_streams(kind, B, 2 * nf, 100 * ci, cfg)
            first = mp3_run_operands([s[: len(s) // 2] for s in streams], nf)
            for fmt, vindex, huff, side in first:
                st = mp3_check(fmt, vindex, huff, side, mp3_zero_state(huff.shape[1], "cuda"),
                               f"{cfg} {kind} run 0")
                if huff.shape[1] == B:     # the whole fleet: the next run continues its state
                    G = huff.shape[0]
                    for fmt2, _, huff2, side2 in mp3_run_operands(
                            [s[len(s) // 2:] for s in streams], nf):
                        if huff2.shape[1] == B:
                            mp3_check(fmt2, mp3_pipeline._advance_vindex(vindex, G), huff2,
                                      side2, st, f"{cfg} {kind} run 1")
                            n_runs += 1
                n_runs += 1
                shapes.add((fmt[2], huff.shape[0], huff.shape[1]))
    # the escape tier, forced on: fuzz spectra carry escapes
    esc_runs = 0
    for fmt, vindex, huff, side in mp3_run_operands(mp3_streams("fuzz", 6, 4, 700), 4):
        old = mp3_pipeline.ESC_MAX_DENSITY
        mp3_pipeline.ESC_MAX_DENSITY = 1.0
        try:
            plane8, pos, val = mp3_pipeline._pack_huff8(huff.cpu().numpy())
        finally:
            mp3_pipeline.ESC_MAX_DENSITY = old
        esc = tuple(torch.as_tensor(a, device="cuda") for a in (plane8, pos, val))
        mp3_check(fmt, vindex, huff, side, mp3_zero_state(huff.shape[1], "cuda"),
                  f"escape tier, {int((pos < huff.numel()).sum())} escapes", esc=esc)
        esc_runs += 1
    print(f"mp3 kernel: {n_runs} runs of {len(cfgs)} formats and {esc_runs} escape-tier runs "
          f"byte-identical to the plain version (PCM, state, UB flag); (channels, G, B) "
          f"{sorted(shapes)}")

    # the run shapes of the composed chain: B x G = 16, MPEG-1 44.1 kHz stereo tonal frames
    (fmt, vindex, huff, side), = mp3_run_operands(mp3_streams("tonal", MP3_STREAMS, MP3_FRAMES,
                                                              5000), MP3_FRAMES)
    res = {}
    for B in (MP3_STREAMS, 8 * MP3_STREAMS):
        h = huff.repeat(1, B // MP3_STREAMS, 1, 1).contiguous()
        sd = side.repeat(1, B // MP3_STREAMS, 1).contiguous()
        state = mp3_zero_state(B, "cuda")
        got = mk.mp3_granules_cuda(h, sd, *state, vindex, ver=fmt[0], sr_idx=fmt[1], nch=fmt[2],
                                   cutoff=fmt[3])
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        want = mk.mp3_granules_plain(h, sd, *state, vindex, ver=fmt[0], sr_idx=fmt[1],
                                     nch=fmt[2], cutoff=fmt[3])
        end.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(end)
        if not all(torch.equal(a, b) for a, b in zip((got[0], *got[1], got[2]),
                                                     (want[0], *want[1], want[2]))):
            fail(f"mp3_granules differs from its plain version at B={B} G={h.shape[0]}")
        if not int(got[0].abs().max()):
            fail("the tonal run decoded to silence")
        ms = cuda_time(mp3_launcher(h, sd, state, fmt, vindex), iters=20)
        ms_wrapper = cuda_time(lambda: mk.mp3_granules_cuda(h, sd, *state, vindex, ver=fmt[0],
                                                            sr_idx=fmt[1], nch=fmt[2],
                                                            cutoff=fmt[3]))
        nbytes, bound_ms, bound_by, n_ops, bytes_ms, ops_ms = mp3_work(h, sd, fmt)
        G = h.shape[0]
        res[B] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
        print(f"kernel mp3_granules B={B} G={G} stereo (MPEG-1 44.1 kHz, {B * G} granules, "
              f"{B * G * 1152 / 1e6:.3f} Msamples): byte-identical; {ms:.4f} ms per direct "
              f"launch (one wrapper call {ms_wrapper:.4f} ms; plain version {plain_ms:.1f} ms), "
              f"{B * G * 1152 / ms / 1e3:.1f} decoded Msamples/s; bound {bound_ms:.4f} ms "
              f"({bound_by}; bytes: {nbytes} B at 3.35 TB/s take {bytes_ms:.4f} ms, integer "
              f"operations: {n_ops} at {PEAK_INT32 / 1e12:.2f} TOP/s take {ops_ms:.4f} ms), "
              f"{bound_ms / ms:.1%} of it")
    r = res[MP3_STREAMS]
    return {"name": "mp3_granules", "route": "cuda",
            "source": "esp_audio_libs_tpu_torch/csrc/mp3_granules.cu",
            "replaces": "esp_audio_libs_tpu/models/mp3_pipeline.py:215",
            "launches": 0, "max_abs_err": 0, "byte_exact": True,
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
            "ms_b2048": res[8 * MP3_STREAMS]["ms"],
            "plain_ms_b2048": res[8 * MP3_STREAMS]["plain_ms"],
            "bound_ms_b2048": res[8 * MP3_STREAMS]["bound_ms"]}


# ---------------------------------------------------- MP3: the relaxed tiers

# FP32 operations of one granule and channel of the mirror tier, counted from
# csrc/mp3_granules_f32.cu (a multiply or an add counts 1, as the 67 TFLOP/s
# peak counts an FMA as 2); its integer work (the parameter expansion,
# masks, addressing) is left out. Only the samples the stages need are
# counted, as in mp3_work.
MP3F_DEQUANT_OPS = 30       # per nonzero sample: log2f, exp2f (about 10 each), exponent, clamps
MP3F_STEREO_OPS = 1         # per position below both bounds, and channel, with joint stereo
MP3F_BUTTERFLY_OPS = 6      # per butterfly: 4 multiplies, 2 adds
MP3F_IMDCT_OPS = 240        # per computed block: 29 suffix sums, 2 idct9 of 48, window 9 x 12
MP3F_FDCT_OPS = 296         # per slot: 96 + 164 in the two passes, 36 adds of the FIFO values
MP3F_PQMF_OPS = 8 * 4 + 4   # per output: 8 taps x (2 multiplies, 2 adds), round and clip


def mp3f32_work(huff, side):
    """The work of one mp3_granules_f32 launch, from its operands: (bytes,
    bound ms, bound_by, FP32 operations, bytes ms, operations ms). Bytes as
    mp3_work (the f32 state is as wide as the int32 one); operations
    MP3F_*_OPS at PEAK_FP32."""
    import torch
    G, B, nch = huff.shape[:3]
    nbytes = (huff.numel() * 2 + side.numel() * 4 + 3069 * 4 + 2 * B * (576 + 6 + 2176) * 4
              + B * G * 576 * nch * 2)
    n_nonzero = int(((huff.to(torch.int32) & 0x7FFF) > 0).sum())
    nzb = side[..., :nch].to(torch.int64).clamp(0, 576)
    blocks = torch.clamp((nzb + 7) // 18 + 1, max=32)
    joint = ((side[..., 3 * nch + 232] != 0) * nzb.amax(-1)).sum() if nch == 2 else 0
    units = G * B * nch
    n_ops = (n_nonzero * MP3F_DEQUANT_OPS + int(joint) * 2 * MP3F_STEREO_OPS
             + int((blocks - 1).sum()) * 8 * MP3F_BUTTERFLY_OPS + int(blocks.sum()) * MP3F_IMDCT_OPS
             + units * 18 * MP3F_FDCT_OPS + units * 576 * MP3F_PQMF_OPS)
    bytes_ms, ops_ms = nbytes / PEAK_BYTES * 1e3, n_ops / PEAK_FP32 * 1e3
    if ops_ms >= bytes_ms:
        return nbytes, ops_ms, "operations", n_ops, bytes_ms, ops_ms
    return nbytes, bytes_ms, "bytes", n_ops, bytes_ms, ops_ms


MP3F_KERNELS = ("mp3_granules_f32", "mp3_mxu_pre", "mp3_mxu_post")
PTXAS = {}   # kernel (mangled name) -> ptxas's report of it, filled by the build in main()


def ptxas_kernels(report: str) -> dict:
    """{mangled kernel name: {"registers", "stack", "spill_stores",
    "spill_loads"}} from nvcc's ``-Xptxas -v`` output."""
    import re
    out, name, frame = {}, None, None
    for line in report.splitlines():
        m = re.search(r"Function properties for (\w+)", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            frame = tuple(int(v) for v in m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and name and frame:
            out[name] = {"registers": int(m.group(1)), "stack": frame[0],
                         "spill_stores": frame[1], "spill_loads": frame[2]}
            name = frame = None
    return out


def ptxas_of(kernel: str) -> dict:
    """The ptxas figures of the kernel whose mangled name holds ``kernel``
    (empty when the build gave none)."""
    found = [v for k, v in PTXAS.items() if kernel in k]
    return found[0] if found else {}


def mxu_step_bytes(ip, keep, B, nch):
    """Bytes of one MXU granule step's two kernels on this step's data, each
    input read once and each output written once. pre reads 27 of a block's
    108 x-side products (the current window's 18 columns of A36 or A12 and 9
    of C36 or C12) where the block is long or short (block < max(ip[:, 0],
    ip[:, 1])) and none elsewhere, the parameters ``ip``, the overlap and the
    other carried values (read and written), the overlap operator and the
    channel's FIFO block (1088 floats), and writes the 1664-float GEMM row.
    post reads the accumulators and only the written FIFO slots of ``newv``
    (``keep`` [1088] the phase's survivor mask) and the mask, and writes
    those slots and the int16 PCM."""
    import torch
    rows = B * nch
    active = int(torch.clamp(torch.maximum(ip[:, 0], ip[:, 1]), 0, 32).sum())
    pre = (active * 27 * 4 + rows * 5 * 4 + 2 * rows * (288 + 3) * 4 + 9 * 72 * 4
           + rows * (1088 + 1664) * 4)
    return pre, mxu_post_bytes(keep, B, nch)


def mxu_post_bytes(keep, B, nch):
    """Bytes of one mp3_mxu_post launch on this step's data (see
    :func:`mxu_step_bytes`)."""
    rows = B * nch
    written = 1088 - int((keep == 1.0).sum())
    return rows * (576 + 2 * written) * 4 + 1088 * 4 + rows * 576 * 2


def mxu_step_flop(B, nch):
    """FP32 flop of one MXU granule step's two GEMMs."""
    return 2 * B * nch * (1664 * 576 + 576 * 1088)


MXU_POST_PAD = 0x5A5A   # fills the PCM rows around mp3_mxu_post's output in its direct check


def mxu_post_cases(keeps, device):
    """Operands of mp3_mxu_post's direct check: [(label, nch, acc, newv,
    vbuf, keep, buf, out)], ``out`` a view of the int16 buffer ``buf``. The
    accumulators mix values past the int16 range, exact half-ties (k + 0.5
    for negative and positive k), integers and the clip's edges; the masks
    are the probed ``keeps`` and random ones mixed within groups of four
    (beside groups kept or written whole); mono and stereo; B of 1, 3 and
    37; PCM rows wider than 576 nch (the step's pitch G 576 nch at g = 5 of
    G = 16, and 24 nch samples more than a row); ``buf`` holds MXU_POST_PAD
    outside ``out``."""
    import numpy as np
    import torch
    rng = np.random.default_rng(1800)
    edges = np.array([-32768.5, -32768.0, -32767.5, -32767.0, -2.5, -1.5, -0.5, -0.0, 0.0, 0.5,
                      1.5, 2.5, 32766.5, 32767.0, 32767.5, 32768.0, 0.49999997, -0.49999997,
                      1e9, -1e9], np.float32)

    def mixed_mask():
        keep = (rng.random(1088) < 0.5).astype(np.float32)
        keep[:4], keep[4:8] = 1.0, 0.0
        return keep

    def operands(B, nch):
        n = B * nch * 576
        kind = rng.integers(0, 4, n)
        acc = np.where(kind == 0, rng.standard_normal(n) * 30000.0,
                       np.where(kind == 1, rng.integers(-40000, 40000, n) + 0.5,
                                np.where(kind == 2, rng.integers(-40000, 40000, n).astype(float),
                                         rng.choice(edges, n)))).astype(np.float32)
        newv = (rng.standard_normal((B * nch, 1088)) * 1e5).astype(np.float32)
        vbuf = (rng.standard_normal((B, 2176)) * 1e5).astype(np.float32)
        return acc.reshape(B * nch, 576), newv, vbuf

    cases = []
    for nch in (1, 2):
        width = 576 * nch
        shapes = [(f"probed mask of phase {v}", keep, 3, 16 * width, 5 * width)
                  for v, keep in enumerate(keeps)]
        shapes += [("mixed mask, wide rows", mixed_mask(), 37, width + 24 * nch, 0),
                   ("mixed mask, B = 1", mixed_mask(), 1, width, 0)]
        for label, keep, B, pitch, col in shapes:
            acc, newv, vbuf = operands(B, nch)
            buf = torch.full((B, pitch), MXU_POST_PAD, dtype=torch.int16, device=device)
            cases.append((f"{label}, nch {nch}, B {B}, pitch {pitch}", nch,
                          *(torch.as_tensor(a, device=device) for a in (acc, newv, vbuf)),
                          torch.as_tensor(keep, dtype=torch.float32, device=device), buf,
                          buf[:, col:col + width]))
    return cases


def mxu_post_mismatches(post, cases) -> list:
    """``post(acc, newv, vbuf, keep, out, nch=...)`` (mp3_mxu_post's
    contract: vbuf and out in place) on each of ``cases``
    (:func:`mxu_post_cases`) against ``mxu_post_plain`` on the same inputs:
    the labels whose PCM, vbuf (bit for bit) or PCM row padding differ."""
    import torch

    from esp_audio_libs_tpu_torch.ops import mp3mxu
    bad = []
    for label, nch, acc, newv, vbuf, keep, buf, out in cases:
        want_pcm, want_vbuf = mp3mxu.mxu_post_plain(acc, newv, vbuf, keep, nch=nch)
        pad = buf.clone()
        pad[:, out.storage_offset():out.storage_offset() + out.shape[1]] = 0
        got_vbuf = vbuf.clone()
        post(acc, newv, got_vbuf, keep, out, nch=nch)
        if acc.is_cuda:
            torch.cuda.synchronize()
        rest = buf.clone()
        rest[:, out.storage_offset():out.storage_offset() + out.shape[1]] = 0
        for what, same in (("pcm", torch.equal(out, want_pcm)),
                           ("vbuf", same_bits(got_vbuf, want_vbuf)),
                           ("padding", torch.equal(rest, pad))):
            if not same:
                bad.append(f"{label}: {what}")
    return bad


def mp3_fast_check(fmt, vindex, huff, side, state, label, esc=None):
    """The mirror tier's kernel (through the escape form when ``esc`` holds
    the int8 plane and its sideband) and the MXU tier's step kernels, each
    against its plain version on the same CUDA tensors: PCM within 1 LSB,
    f32 state within MP3F_STATE_RTOL of its largest magnitude, the rest
    equal. The step kernels are held to theirs at every step, each step
    continuing from the kernel's results. Returns (the mirror run's new
    state, {kernel: [the worst absolute difference of its output (PCM in
    LSB; for mp3_mxu_pre, which writes no PCM, its f32 outputs), the worst
    f32 state difference relative to its scale]})."""
    import torch

    from esp_audio_libs_tpu_torch.models import mp3_pipeline
    from esp_audio_libs_tpu_torch.ops import mp3_kernels as mk
    from esp_audio_libs_tpu_torch.ops import mp3mxu
    ver, sr_idx, nch, cutoff = fmt
    kw = dict(ver=ver, sr_idx=sr_idx, nch=nch, cutoff=cutoff)
    worst = {k: [0, 0.0] for k in MP3F_KERNELS}

    def close(got_pcm, want_pcm, got_st, want_st, what):
        if got_pcm is not None:
            d = int((got_pcm.to(torch.int32) - want_pcm.to(torch.int32)).abs().max())
            worst[what][0] = max(worst[what][0], d)
            if d > 1:
                fail(f"{what} differs from its plain version by {d} LSB: {label}")
        for a, b in zip(got_st, want_st):
            if a.dtype == torch.float32:
                err = float((a - b).abs().max())
                rel = err / max(float(b.abs().max()), 1e-30)
                worst[what][1] = max(worst[what][1], rel)
                if got_pcm is None:
                    worst[what][0] = max(worst[what][0], err)
                if rel > MP3F_STATE_RTOL:
                    fail(f"{what}: f32 state differs by {rel:.3g} of its scale: {label}")
            elif not torch.equal(a, b):
                fail(f"{what}: integer state differs from its plain version: {label}")

    if esc is None:
        got = mk.mp3_granules_f32_cuda(huff, side, *state, vindex, **kw)
    else:
        got = mp3_pipeline._granules_scan_esc_for(*fmt, fast="mirror")(*esc, side, *state, vindex)
    want = mk.mp3_granules_f32_plain(huff, side, *state, vindex, **kw)
    torch.cuda.synchronize()
    close(got[0], want[0], got[1], want[1], "mp3_granules_f32")
    if got[2].any():
        fail(f"mp3_granules_f32 flagged the reference's undefined case: {label}")

    real_pre, real_post = mp3mxu.mp3_mxu_pre_cuda, mp3mxu.mp3_mxu_post_cuda

    def pre(yx, ip, over, pt, pws, npv, vbuf, px, *, nch):
        want = mp3mxu.mxu_pre_plain(yx, ip, over, pt, pws, npv, vbuf, px, nch=nch)
        ofvc = real_pre(yx, ip, over, pt, pws, npv, vbuf, px, nch=nch)
        torch.cuda.synchronize()
        close(None, None, (ofvc, over, pt, pws, npv), want, "mp3_mxu_pre")
        return ofvc

    def post(acc, newv, vbuf, keep, out, *, nch):   # no sum to reorder: bit for bit
        want_pcm, want_vbuf = mp3mxu.mxu_post_plain(acc, newv, vbuf, keep, nch=nch)
        real_post(acc, newv, vbuf, keep, out, nch=nch)
        torch.cuda.synchronize()
        if not (torch.equal(out, want_pcm) and same_bits(vbuf, want_vbuf)):
            fail(f"mp3_mxu_post differs from its plain version (PCM or vbuf): {label}")

    mp3mxu.mp3_mxu_pre_cuda, mp3mxu.mp3_mxu_post_cuda = pre, post
    try:
        if esc is None:
            mp3mxu.mxu_run(huff, side, *state, vindex, **kw)
        else:
            mp3_pipeline._granules_scan_esc_for(*fmt, fast="mxu")(*esc, side, *state, vindex)
    finally:
        mp3mxu.mp3_mxu_pre_cuda, mp3mxu.mp3_mxu_post_cuda = real_pre, real_post
    return got[1], worst


def direct_launcher(name, *args):
    """A function that launches C entry point ``name`` of the kernel library
    with ``args`` (tensors become their pointers, prepared once) on the
    current stream: the kernel alone, for timing; not counted."""
    import torch

    from esp_audio_libs_tpu_torch.runtime import kernels
    fn = getattr(kernels.library(), name)
    ptrs = tuple(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args)
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        if fn(*ptrs, stream) != 0:
            fail(f"{name} refused its arguments")
        launch.keep = args
    return launch


def mxu_post_launcher(sets, nch, lib=None):
    """A function that launches mp3_mxu_post through eal_mp3_mxu_post (of
    ``lib``, else the package's library) on the operand sets ``sets`` ([(acc,
    newv, vbuf, keep, out), ...]) in turn, one set a call, the pointers
    prepared once; not counted. Its timing reads device memory, not L2, when
    the sets together exceed L2."""
    import torch

    from esp_audio_libs_tpu_torch.runtime import kernels
    fn = (lib or kernels.library()).eal_mp3_mxu_post
    stream = torch.cuda.current_stream().cuda_stream
    args = [(acc.data_ptr(), newv.data_ptr(), vbuf.data_ptr(), keep.data_ptr(), out.data_ptr(),
             out.stride(0), vbuf.shape[0], nch, stream) for acc, newv, vbuf, keep, out in sets]
    turn = [0]

    def launch():
        if fn(*args[turn[0] % len(args)]) != 0:
            fail("eal_mp3_mxu_post refused its arguments")
        turn[0] += 1
    launch.keep = sets
    return launch


def mp3_fast_entry_points(streams):
    """Phase 11b(e): the fleet's other entry points under each relaxed tier
    on the card (``fast=True`` for the MXU tier): ``decode`` frame by frame,
    ``decode_run`` on the host path, ``decode_run_pipelined`` and a fleet on
    a 4-way mesh of the card, each within 1 LSB of one ``decode_run`` of the
    same tier, consumed bytes equal; the mesh runs one launch per shard."""
    import numpy as np

    from esp_audio_libs_tpu_torch.models import BatchedMP3Decoder
    from esp_audio_libs_tpu_torch.ops import mp3_kernels as mk
    from esp_audio_libs_tpu_torch.parallel.mesh import stream_mesh
    n, F = len(streams), 4

    def pcm_of(results):
        return [np.concatenate([np.asarray(p) for _, p, _ in r]).astype(np.int32)
                for r in results]

    def close(got, want, what):
        if [len(g) for g in got] != [len(w) for w in want]:
            fail(f"{what}: another PCM length than decode_run's")
        d = max(int(np.abs(g - w).max(initial=0)) for g, w in zip(got, want))
        if d > 1:
            fail(f"{what}: {d} LSB from decode_run of the same tier")

    for fast in ("mirror", True):
        tier = BatchedMP3Decoder(n, fast=fast).tier
        ref = BatchedMP3Decoder(n, fast=fast).decode_run(streams, F)
        want = pcm_of(ref)
        dec, pos, frames = BatchedMP3Decoder(n, fast=fast), [0] * n, [[] for _ in range(n)]
        for _ in range(F):
            got = dec.decode([s[p:] for s, p in zip(streams, pos)])
            for i, (_, p, c) in enumerate(got):
                frames[i].append((0, p, c))
                pos[i] += c
        close(pcm_of(frames), want, f"decode(fast={fast!r})")
        runs = list(BatchedMP3Decoder(n, fast=fast).decode_run_pipelined(streams, F // 2, 2))
        close([np.concatenate(p) for p in zip(*[pcm_of(r) for r in runs])], want,
              f"decode_run_pipelined(fast={fast!r})")
        mk.reset_launch_counts()
        meshed = BatchedMP3Decoder(n, fast=fast, mesh=stream_mesh(["cuda:0"] * 4))
        close(pcm_of(meshed.decode_run(streams, F)), want, f"a 4-way mesh, fast={fast!r}")
        per_shard = (mk.mp3_granules_f32_cuda.launches if tier == "mirror"
                     else mk.mp3_mxu_pre_cuda.launches // (2 * F))
        if per_shard != 4:
            fail(f"the mesh fleet (fast={fast!r}) made {per_shard} launches a run, expected 4")
    print(f"mp3 fast tiers' entry points ({n} streams x {F} frames, fast='mirror' and True): "
          f"decode frame by frame, decode_run_pipelined and a 4-way mesh of the card (4 launches "
          f"a run) within 1 LSB of decode_run, consumed equal")


def mp3_fast_phase():
    """Phase 11b: the relaxed tiers' kernels. (a) mp3_granules_f32 and (b)
    the MXU step kernels against their plain versions on phase 11's parsed
    runs (its formats and frame kinds, two runs in a row, the escape tier);
    (c) timed at B = 256 and 2048 x G = 16 (phase 11's tonal run) beside
    their bounds and plain versions; (d) phase 13's fleet through
    BatchedMP3Decoder(fast="mirror") and (fast="mxu"), decode_run(to_device=
    True), against the exact tier, launches counted. mp3_mxu_post is held to
    its plain version bit for bit, at every step and on mxu_post_cases.
    Returns the three kernels-line entries."""
    import numpy as np
    import torch

    from esp_audio_libs_tpu_torch.models import BatchedMP3Decoder, mp3_pipeline
    from esp_audio_libs_tpu_torch.ops import mp3_kernels as mk
    from esp_audio_libs_tpu_torch.ops import mp3mxu

    # (a, b) on phase 11's runs, from zero state and carried into a second run
    mf = tools_import("mp3frames")
    cfgs = mf.BATCH_CFGS + [dict(ver_bits=3, bitrate_idx=9, sr_idx=1, mode=1, mode_ext=3),
                            dict(ver_bits=2, bitrate_idx=7, sr_idx=1, mode=1, mode_ext=1)]
    n_runs, worst, shapes = 0, {k: [0, 0.0] for k in MP3F_KERNELS}, set()

    def zero_state(B):
        return (torch.zeros((B, 2, 288), device="cuda"), *mp3_zero_state(B, "cuda")[1:4],
                torch.zeros((B, 2176), device="cuda"))

    def note(w):
        for k, (d, rel) in w.items():
            worst[k] = [max(worst[k][0], d), max(worst[k][1], rel)]

    for ci, cfg in enumerate(cfgs):
        for kind, B, nf in (("mixed", 5, 8), ("fuzz", 7, 4)):
            streams = mp3_streams(kind, B, 2 * nf, 100 * ci, cfg)
            for fmt, vindex, huff, side in mp3_run_operands([s[: len(s) // 2] for s in streams],
                                                            nf):
                st, w = mp3_fast_check(fmt, vindex, huff, side, zero_state(huff.shape[1]),
                                       f"{cfg} {kind} run 0")
                note(w)
                n_runs += 1
                shapes.add((fmt[2], huff.shape[0], huff.shape[1]))
                if huff.shape[1] != B:
                    continue
                for fmt2, _, huff2, side2 in mp3_run_operands([s[len(s) // 2:] for s in streams],
                                                              nf):
                    if huff2.shape[1] == B:
                        note(mp3_fast_check(fmt2, mp3_pipeline._advance_vindex(vindex,
                                                                               huff.shape[0]),
                                            huff2, side2, st, f"{cfg} {kind} run 1")[1])
                        n_runs += 1
    esc_runs = 0
    for fmt, vindex, huff, side in mp3_run_operands(mp3_streams("fuzz", 6, 4, 700), 4):
        old = mp3_pipeline.ESC_MAX_DENSITY
        mp3_pipeline.ESC_MAX_DENSITY = 1.0
        try:
            narrowed = mp3_pipeline._pack_huff8(huff.cpu().numpy())
        finally:
            mp3_pipeline.ESC_MAX_DENSITY = old
        esc = tuple(torch.as_tensor(a, device="cuda") for a in narrowed)
        note(mp3_fast_check(fmt, vindex, huff, side, zero_state(huff.shape[1]), "escape tier",
                            esc=esc)[1])
        esc_runs += 1
    post_cases = mxu_post_cases(list(mp3mxu.device_operators(torch.device("cuda"))["keep"]),
                                "cuda")
    bad = mxu_post_mismatches(mk.mp3_mxu_post_cuda, post_cases)
    if bad:
        fail(f"mp3_mxu_post differs from its plain version: {'; '.join(bad[:4])}")
    print(f"mp3_mxu_post bit for bit on {len(post_cases)} direct cases (mxu_post_cases: "
          f"accumulators past int16 and on half-ties, the probed and mixed masks, mono and "
          f"stereo, B 1 / 3 / 37, wide PCM rows, the padding untouched)")
    regs = {k: ptxas_of(k + "_kernel") for k in ("mp3_granules_f32", "mp3_mxu_pre")}
    regs["mp3_mxu_post"] = ptxas_of("mp3_mxu_post_kernelILi2E")   # the stereo instance
    print("ptxas (sm_90a): " + "; ".join(
        f"{k}_kernel {r['registers']} registers, {r['stack']} bytes stack frame, "
        f"{r['spill_stores']} / {r['spill_loads']} bytes spill stores / loads" if r else
        f"{k}_kernel: no report" for k, r in regs.items()) + " (mp3_mxu_post: nch = 2)")
    print(f"mp3 fast kernels: {n_runs} runs of {len(cfgs)} formats and {esc_runs} escape-tier "
          f"runs, mp3_granules_f32 and both MXU step kernels (at every step) against their "
          f"plain versions, PCM within 1 LSB and f32 state within {MP3F_STATE_RTOL} of its "
          f"scale: "
          + ", ".join(f"{k} {d:.3g} {'(f32 outputs)' if k == 'mp3_mxu_pre' else 'LSB'}, "
                      f"{rel:.3g}" for k, (d, rel) in worst.items())
          + f"; (channels, G, B) {sorted(shapes)}; operators {mp3mxu.mxu_operators.origin}")

    # (c) timing at phase 11's run shapes: B x G = 16, MPEG-1 44.1 kHz stereo tonal frames
    (fmt, vindex, huff, side), = mp3_run_operands(mp3_streams("tonal", MP3_STREAMS, MP3_FRAMES,
                                                              5000), MP3_FRAMES)
    ver, sr_idx, nch, cutoff = fmt
    kw = dict(ver=ver, sr_idx=sr_idx, nch=nch, cutoff=cutoff)
    ops = mp3mxu.device_operators(torch.device("cuda"))
    res = {}
    for B in (MP3_STREAMS, 8 * MP3_STREAMS):
        h = huff.repeat(1, B // MP3_STREAMS, 1, 1).contiguous()
        sd = side.repeat(1, B // MP3_STREAMS, 1).contiguous()
        G = h.shape[0]
        state = zero_state(B)
        st = tuple(t.clone() for t in state)
        pcm = torch.empty((B, G, 576 * nch), dtype=torch.int16, device="cuda")
        f32_ms = cuda_time(direct_launcher(
            "eal_mp3_granules_f32", h, sd, mk.format_consts(ver, sr_idx, h.device), *st, pcm, G, B,
            nch, vindex, cutoff), iters=20)
        f32_wrapper_ms = cuda_time(lambda: mk.mp3_granules_f32_cuda(h, sd, *state, vindex, **kw))
        nbytes, f32_bound, f32_by, n_ops, bytes_ms, ops_ms = mp3f32_work(h, sd)
        r = res[B] = dict(ms=f32_ms, bound_ms=f32_bound, bound_by=f32_by)
        # the MXU tier: the whole run, its prelude, the step loop, each step
        # kernel by direct launches, and the two GEMMs alone
        run_ms = cuda_time(lambda: mp3mxu.mxu_run(h, sd, *state, vindex, **kw), iters=5, warmup=1)
        with torch.no_grad():
            prelude_ms = cuda_time(lambda: mp3mxu.mxu_prelude(h, sd, **kw), iters=5, warmup=1)
            yx, ip = mp3mxu.mxu_prelude(h, sd, **kw)
            st2 = tuple(t.clone() for t in state)
            steps_ms = cuda_time(lambda: mp3mxu.mxu_steps(yx, ip, st2, vindex, pcm, nch=nch),
                                 iters=5, warmup=1)
            rows = B * nch
            ofvc = torch.empty((rows, mk.MXU_IN), device="cuda")
            acc = torch.empty((rows, 576), device="cuda")
            newv = torch.empty((rows, 1088), device="cuda")
            pre_launch = direct_launcher("eal_mp3_mxu_pre", yx[0], ip[0], *st2[:5], ops["PX"],
                                         ofvc, B, nch)
            pre_direct_ms = cuda_time(pre_launch, iters=20)
            pre_ms = cuda_time_queued(pre_launch, iters=20)   # shorter than a ctypes launch
            post_launch = mxu_post_launcher([(acc, newv, st2[4], ops["keep"][vindex],
                                              pcm[:, 0])], nch)
            post_direct_ms = cuda_time(post_launch, iters=20)
            post_ms = cuda_time_queued(post_launch, iters=20)

            def gemms():
                torch.matmul(ofvc, ops["S"][vindex], out=acc)
                torch.matmul(ofvc[:, :576], ops["W"][vindex], out=newv)
            gemm_ms = cuda_time(gemms, iters=20)
            gemm_one_ms = cuda_time(lambda: torch.matmul(ofvc, ops["S"][vindex], out=acc),
                                    iters=20)
        pre_bytes, post_bytes = mxu_step_bytes(ip[0], ops["keep"][vindex], B, nch)
        flop = mxu_step_flop(B, nch)
        step_bound = max(flop / PEAK_FP32 * 1e3, (pre_bytes + post_bytes) / PEAK_BYTES * 1e3)
        r.update(run_ms=run_ms, prelude_ms=prelude_ms, step_ms=steps_ms / G, pre_ms=pre_ms,
                 pre_direct_ms=pre_direct_ms, post_ms=post_ms, post_direct_ms=post_direct_ms, gemm_ms=gemm_ms, pre_bound=pre_bytes / PEAK_BYTES * 1e3,
                 post_bound=post_bytes / PEAK_BYTES * 1e3, step_bound=step_bound)
        if B == MP3_STREAMS:   # the plain versions, at B = 256 only
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            mk.mp3_granules_f32_plain(h, sd, *state, vindex, **kw)
            end.record()
            torch.cuda.synchronize()
            r["plain_ms"] = start.elapsed_time(end)
            r["pre_plain_ms"] = cuda_time(lambda: mp3mxu.mxu_pre_plain(
                yx[0], ip[0], *st2, ops["PX"], nch=nch), iters=5, warmup=1)
            r["post_plain_ms"] = cuda_time(lambda: mp3mxu.mxu_post_plain(
                acc, newv, st2[4], ops["keep"][vindex], nch=nch), iters=5, warmup=1)
        print(f"kernel mp3_granules_f32 B={B} G={G} stereo (MPEG-1 44.1 kHz, {B * G} granules, "
              f"{B * G * 1152 / 1e6:.3f} Msamples): {f32_ms:.4f} ms per direct launch (one "
              f"wrapper call {f32_wrapper_ms:.4f} ms"
              + (f"; plain version {r['plain_ms']:.1f} ms" if "plain_ms" in r else "")
              + f"), {B * G * 1152 / f32_ms / 1e3:.1f} decoded Msamples/s; bound "
              f"{f32_bound:.4f} ms ({f32_by}; bytes: {nbytes} B at 3.35 TB/s take "
              f"{bytes_ms:.4f} ms, FP32 operations: {n_ops} at 67 TFLOP/s take {ops_ms:.4f} ms), "
              f"{f32_bound / f32_ms:.1%} of it")
        print(f"mxu tier B={B} G={G} stereo: run {run_ms:.3f} ms ({run_ms / G:.4f} ms a granule: "
              f"prelude {prelude_ms:.3f} ms a run, steps {steps_ms / G:.4f} ms a granule, 2 step "
              f"launches and 2 GEMMs each); mp3_mxu_pre {pre_ms:.4f} ms per direct launch queued "
              f"behind a sleeping kernel ({pre_direct_ms:.4f} unqueued; bound "
              f"{r['pre_bound']:.4f}, bytes: {pre_bytes} B, {r['pre_bound'] / pre_ms:.1%} of it), "
              f"mp3_mxu_post {post_ms:.4f} ms queued ({post_direct_ms:.4f} unqueued; bound "
              f"{r['post_bound']:.4f}, bytes: {post_bytes} B, {r['post_bound'] / post_ms:.1%} of "
              f"it)"
              + (f", plain {r['pre_plain_ms']:.4f} / {r['post_plain_ms']:.4f} ms"
                 if "pre_plain_ms" in r else "")
              + f"; the two GEMMs alone {gemm_ms:.4f} ms a step ([{rows}, 1664] x [1664, 576] "
              f"alone {gemm_one_ms:.4f}); step bound {step_bound:.4f} ms ({flop / 1e9:.3f} GFLOP "
              f"at 67 TFLOP/s), {step_bound / (steps_ms / G):.1%} of the step")
        del yx, ip, ofvc, acc, newv
        torch.cuda.empty_cache()

    # (d) phase 13's fleet through each tier, decode_run(to_device=True)
    Bs, F = MP3_STREAMS, MP3_FRAMES
    streams = mp3_streams("tonal", Bs, F, 9000)
    n_in = Bs * F * 1152 * 2
    exact = BatchedMP3Decoder(Bs)
    ref = exact.decode_run(streams, F, to_device=True)
    pcm_ref = ref[0].cpu().numpy().astype(np.int32)
    sat = float(np.mean(np.abs(pcm_ref) >= 32767))
    times = {"exact": []}
    for _ in range(5):
        t0 = time.perf_counter()
        exact.decode_run(streams, F, to_device=True)
        torch.cuda.synchronize()
        times["exact"].append(time.perf_counter() - t0)
    launches = {}
    for tier in ("mirror", "mxu"):
        bat = BatchedMP3Decoder(Bs, fast=tier)
        got = bat.decode_run(streams, F, to_device=True)
        torch.cuda.synchronize()
        d = np.abs(got[0].cpu().numpy().astype(np.int32) - pcm_ref)
        if got[1] != ref[1] or got.next_pos != ref.next_pos:
            fail(f"fast={tier!r}: consumed bytes or next_pos differ from the exact tier's")
        # these frames clip (sat of the samples at full scale), where the
        # exact tier truncates guard bits: the hot-clipping bound applies
        if d.max() > 4 or np.mean(d > 1) >= 0.005:
            fail(f"fast={tier!r}: {int(d.max())} LSB from the exact tier, "
                 f"{np.mean(d > 1):.3%} of samples over 1 LSB")
        cpu = BatchedMP3Decoder(CMP_STREAMS, device="cpu", fast=tier).decode_run(
            streams[:CMP_STREAMS], F, to_device=True)[0].numpy().astype(np.int32)
        d_cpu = np.abs(got[0][:CMP_STREAMS].cpu().numpy().astype(np.int32) - cpu)
        if d_cpu.max() > 1:
            fail(f"fast={tier!r}: the card's PCM is {int(d_cpu.max())} LSB from the CPU plain path")
        times[tier] = []
        mk.reset_launch_counts()
        for _ in range(5):
            t0 = time.perf_counter()
            bat.decode_run(streams, F, to_device=True)
            torch.cuda.synchronize()
            times[tier].append(time.perf_counter() - t0)
        launches[tier] = {"mp3_granules": mk.mp3_granules_cuda.launches,
                          "mp3_granules_f32": mk.mp3_granules_f32_cuda.launches,
                          "mp3_mxu_pre": mk.mp3_mxu_pre_cuda.launches,
                          "mp3_mxu_post": mk.mp3_mxu_post_cuda.launches}
        G = F * 2
        want = ({"mp3_granules": 0, "mp3_granules_f32": 5, "mp3_mxu_pre": 0, "mp3_mxu_post": 0}
                if tier == "mirror" else
                {"mp3_granules": 0, "mp3_granules_f32": 0, "mp3_mxu_pre": 5 * G,
                 "mp3_mxu_post": 5 * G})
        if launches[tier] != want:
            fail(f"decode_run(fast={tier!r}) launched {launches[tier]}, expected {want}")
        print(f"mp3 fast={tier!r} {Bs} streams x {F} frames: within {int(d.max())} LSB of the "
              f"exact tier ({np.mean(d > 1):.4%} of samples over 1 LSB, {np.mean(d > 0):.2%} "
              f"differ; {sat:.1%} of the exact PCM at full scale: the hot-clipping bound, at "
              f"most 4 LSB on under 0.5 %), consumed and next_pos equal, {int(d_cpu.max())} LSB "
              f"from the CPU plain path on {CMP_STREAMS} streams; launches in 5 calls "
              f"{launches[tier]}")
    med = {k: float(np.median(v)) for k, v in times.items()}
    print("mp3 tiers decode_run(to_device) at the median of 5 calls: "
          + ", ".join(f"{k} {n_in / med[k] / 1e6:.1f} decoded Msamples/s ({med[k] * 1e3:.2f} ms, "
                      f"min {min(times[k]) * 1e3:.2f}, max {max(times[k]) * 1e3:.2f})"
                      for k in ("exact", "mirror", "mxu")))

    mp3_fast_entry_points(streams[:CMP_STREAMS])

    r, r8 = res[MP3_STREAMS], res[8 * MP3_STREAMS]
    def common(name):
        return {"route": "cuda", "max_abs_err": worst[name][0], "state_rel_err": worst[name][1],
                "library_ms": None}
    return [
        {"name": "mp3_granules_f32", **common("mp3_granules_f32"), **regs["mp3_granules_f32"],
         "source": "esp_audio_libs_tpu_torch/csrc/mp3_granules_f32.cu",
         "replaces": "esp_audio_libs_tpu/models/mp3_pipeline.py:271",
         "launches": launches["mirror"]["mp3_granules_f32"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "ms_b2048": r8["ms"], "bound_ms_b2048": r8["bound_ms"],
         "decode_msps": n_in / med["mirror"] / 1e6, "exact_decode_msps": n_in / med["exact"] / 1e6},
        {"name": "mp3_mxu_pre", **common("mp3_mxu_pre"), **regs["mp3_mxu_pre"],
         "source": "esp_audio_libs_tpu_torch/csrc/mp3_mxu_step.cu",
         "replaces": "esp_audio_libs_tpu/models/mp3_pipeline.py:315",
         "launches": launches["mxu"]["mp3_mxu_pre"], "ms": r["pre_ms"],
         "plain_ms": r["pre_plain_ms"], "bound_ms": r["pre_bound"], "bound_by": "bytes",
         "ms_b2048": r8["pre_ms"], "ms_unqueued": r["pre_direct_ms"],
         "step": {"ms_per_granule": r["step_ms"], "gemm_ms_per_granule": r["gemm_ms"],
                  "launches_per_granule": 2, "bound_ms": r["step_bound"],
                  "bound_by": "operations", "run_ms": r["run_ms"], "prelude_ms": r["prelude_ms"],
                  "ms_per_granule_b2048": r8["step_ms"], "gemm_ms_b2048": r8["gemm_ms"],
                  "decode_msps": n_in / med["mxu"] / 1e6}},
        {"name": "mp3_mxu_post", **common("mp3_mxu_post"), **regs["mp3_mxu_post"],
         "source": "esp_audio_libs_tpu_torch/csrc/mp3_mxu_step.cu",
         "replaces": "esp_audio_libs_tpu/models/mp3_pipeline.py:315",
         "launches": launches["mxu"]["mp3_mxu_post"], "ms": r["post_ms"],
         "plain_ms": r["post_plain_ms"], "bound_ms": r["post_bound"], "bound_by": "bytes",
         "ms_b2048": r8["post_ms"], "ms_unqueued": r["post_direct_ms"],
         "ms_b2048_unqueued": r8["post_direct_ms"]}]


def mp3_corpus_phase():
    """Phase 12: every corpus/independent_mp3 file decoded frame by frame by
    MP3Decoder(device="cuda"): the per-frame error and consumed ladder and
    the PCM SHA256 of signatures.json, which the reference decoder pinned."""
    import hashlib
    from pathlib import Path

    import numpy as np

    from esp_audio_libs_tpu_torch.models import MP3Decoder
    corpus = Path(__file__).resolve().parent / "corpus" / "independent_mp3"
    sigs = json.loads((corpus / "signatures.json").read_text())
    files = sorted(corpus.glob("*.mp3"))
    if len(files) < 10:
        fail(f"corpus/independent_mp3 holds {len(files)} files")
    n_frames = 0
    for path in files:
        data, dec = path.read_bytes(), MP3Decoder(device="cuda")
        h, errs, consumed, n_pcm, pos = hashlib.sha256(), [], [], 0, 0
        for _ in range(64):
            err, pcm, c = dec.decode(data[pos:])
            errs.append(int(err))
            consumed.append(int(c))
            if err == 0 and pcm is not None:
                h.update(np.asarray(pcm, dtype="<i2").tobytes())
                n_pcm += len(pcm)
            pos += c
            if pos >= len(data):
                break
        sig = sigs[path.name]
        if (errs != sig["frame_errs"] or consumed != sig["frame_consumed"]
                or n_pcm != sig["pcm_samples"] or h.hexdigest() != sig["pcm_sha256"]):
            fail(f"{path.name}: the card's decode does not match signatures.json")
        n_frames += len(errs)
    print(f"mp3 corpus: {len(files)} corpus/independent_mp3 files ({n_frames} frames) decoded "
          f"on the card, error ladders, consumed bytes and PCM SHA256 equal to signatures.json")


def mp3_composed_phase(reps=5):
    """Phase 13: 256 streams x 8 frames of MPEG-1 44.1 kHz stereo tonal frames:
    BatchedMP3Decoder.decode_run(to_device=True) -> fast Resampler -> 16 kHz,
    checked and timed; returns the launch counts of the timed calls."""
    import numpy as np
    import torch

    from esp_audio_libs_tpu_torch.models import BatchedMP3Decoder
    from esp_audio_libs_tpu_torch.ops import mp3_kernels as mk
    from esp_audio_libs_tpu_torch.ops import polyphase_kernels as pk
    from esp_audio_libs_tpu_torch.runtime.transport import MP3_SLICE_PCM_BYTES

    B, F = MP3_STREAMS, MP3_FRAMES
    streams = mp3_streams("tonal", B, F, 9000)
    samples = F * 1152                                # stereo frames per stream
    host = BatchedMP3Decoder(B).decode_run(streams, F)
    pcm_host = np.stack([np.concatenate([p for _, p, _ in r]) for r in host])
    n_slices = -(-B * samples * 2 * 2 // MP3_SLICE_PCM_BYTES)
    bat = BatchedMP3Decoder(B)
    mk.reset_launch_counts()
    pcm_dev, consumed = bat.decode_run(streams, F, to_device=True)
    torch.cuda.synchronize()
    if mk.mp3_granules_cuda.launches != 1:
        fail(f"decode_run(to_device=True) launched mp3_granules {mk.mp3_granules_cuda.launches} "
             f"times, expected 1")
    if not pcm_dev.is_cuda or not np.array_equal(pcm_dev.cpu().numpy(), pcm_host):
        fail("composed mp3 fleet: device PCM differs from the host-roundtrip PCM")
    if not int(np.abs(pcm_host).max()):
        fail("composed mp3 fleet decoded to silence")
    cpu = BatchedMP3Decoder(CMP_STREAMS, device="cpu")
    pcm_cpu, _ = cpu.decode_run(streams[:CMP_STREAMS], F, to_device=True)
    if not np.array_equal(pcm_cpu.numpy(), pcm_host[:CMP_STREAMS]):
        fail("composed mp3 fleet: the CPU plain path's PCM differs from the card's")
    out_dev = make_resampler(44100.0, 16000.0, B, "cuda").resample_stream(
        pcm_dev.view(torch.uint8), samples, 1)
    out_host = make_resampler(44100.0, 16000.0, B, "cuda").resample_stream(
        torch.as_tensor(pcm_host, device="cuda").view(torch.uint8), samples, 1)
    torch.cuda.synchronize()
    if (out_dev[1] != out_host[1] or not torch.equal(out_dev[0], out_host[0])
            or not np.array_equal(out_dev[2], out_host[2])):
        fail("composed mp3 chain: resampled device PCM differs from the host-roundtrip chain")

    r = make_resampler(44100.0, 16000.0, B, "cuda")
    dec_times, chain_times = [], []
    mk.reset_launch_counts()
    pk.reset_launch_counts()
    for _ in range(reps):
        t0 = time.perf_counter()
        bat.decode_run(streams, F, to_device=True)
        torch.cuda.synchronize()
        dec_times.append(time.perf_counter() - t0)
    for _ in range(reps):
        t0 = time.perf_counter()
        pcm, _ = bat.decode_run(streams, F, to_device=True)
        r.resample_stream(pcm.view(torch.uint8), samples, 1)
        torch.cuda.synchronize()
        chain_times.append(time.perf_counter() - t0)
    launches = {"mp3_granules": mk.mp3_granules_cuda.launches,
                "polyphase_banded": pk.polyphase_banded_cuda.launches}
    want = {"mp3_granules": 2 * reps, "polyphase_banded": reps}
    if launches != want:
        fail(f"the composed mp3 chain launched {launches}, expected {want}")
    t0 = time.perf_counter()
    BatchedMP3Decoder(B)._parse_run([np.frombuffer(s, np.uint8) for s in streams], [0] * B, F)
    parse_s = time.perf_counter() - t0
    ndiff, clips = compare_stream(out_dev, make_resampler(44100.0, 16000.0, CMP_STREAMS, "cpu")
                                  .resample_stream(pcm_cpu.view(torch.uint8), samples, 1),
                                  "composed mp3 chain")
    n_in = B * samples * 2
    med_d, med_c = float(np.median(dec_times)), float(np.median(chain_times))
    print(f"mp3->16k composed {B} streams x {F} frames (MPEG-1 44.1 kHz stereo, tonal): device "
          f"PCM = host PCM ({n_slices} dispatch slices there, 1 launch to the device) = CPU "
          f"plain path on {CMP_STREAMS} streams, device chain = host-roundtrip chain byte for "
          f"byte, {ndiff} samples of {CMP_STREAMS} streams differ by 1 LSB from the CPU port, "
          f"{clips} clipped; decode_run(to_device) {n_in / med_d / 1e6:.1f} decoded Msamples/s "
          f"({med_d * 1e3:.2f} ms/call, min {min(dec_times) * 1e3:.2f}, max "
          f"{max(dec_times) * 1e3:.2f}), whole chain {n_in / med_c / 1e6:.1f} Msamples/s "
          f"({med_c * 1e3:.2f} ms/call, min {min(chain_times) * 1e3:.2f}, max "
          f"{max(chain_times) * 1e3:.2f}) at the median of {reps} calls; host parse of one run "
          f"{parse_s * 1e3:.2f} ms; gens {out_dev[1]}")
    print(f"launches on the composed mp3 path ({reps} decode calls, then {reps} chain calls): "
          f"{launches}")
    return launches


def mp3_phases(lap):
    """Phases 11-13 (11b: the relaxed tiers); returns the kernels-line
    entries of mp3_granules and of the relaxed tiers' kernels."""
    entry = mp3_kernel_phase()
    lap("11 mp3 kernel")
    fast = mp3_fast_phase()
    lap("11b mp3 fast tiers")
    mp3_corpus_phase()
    entry["launches"] = mp3_composed_phase()["mp3_granules"]
    return entry, fast


# ------------------------------------------------------------------ DSP

DOT_SHAPES = ((4096, 8192), (65536, 64))   # 2048 stereo streams x one 8192 chunk; 64-tap FIRs
# operand sets a [65536, 64] timing rotates through: one set (33.8 MB) fits
# in the card's 50 MB L2, so back-to-back launches on it could read faster
# than device memory allows; four (135 MB) do not
DOT_ROTATION = 4
DSP_S, DSP_ROWS, DSP_CPU_ROWS = 4, 2048, 128   # mix_s16: S streams of [DSP_ROWS, 2 x 8192]
DSP_SHIFTS = (0, 15, 31, 32, 40, -1)


def sm_clock_under_load(launch, n=4000) -> float:
    """The SM clock (MHz) nvidia-smi reads while ``n`` queued launches of
    ``launch`` keep the card busy (nan if it reads none)."""
    import torch
    for _ in range(n):
        launch()
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
                           capture_output=True, text=True, timeout=60).stdout.split()
    torch.cuda.synchronize()
    return float(clock[0]) if clock else float("nan")


def dot_launcher(a, b, lib=None):
    """A function that launches dotprod_exact on rows a, b ([R, n] f32,
    contiguous) through the C entry point eal_dotprod_exact, its output
    allocated once: the kernel alone. Used only to time the kernel; its
    launches are not counted."""
    import torch

    from esp_audio_libs_tpu_torch.runtime import kernels
    R, n = a.shape
    out = torch.empty(R, dtype=torch.float32, device=a.device)
    args = (a.data_ptr(), a.stride(0), b.data_ptr(), b.stride(0), out.data_ptr(), R, n,
            torch.cuda.current_stream().cuda_stream)
    lib = lib or kernels.library()

    def launch():
        if lib.eal_dotprod_exact(*args) != 0:
            fail("eal_dotprod_exact refused its arguments")
        launch.keep = (a, b, out)
        return out
    return launch


def dot_rotated_launcher(sets, lib=None):
    """A function that launches dotprod_exact through eal_dotprod_exact on
    the operand sets ``sets`` ([(a, b), ...]) in turn, one set a call: its
    timing reads device memory, not L2, when the sets together exceed L2."""
    launchers = [dot_launcher(a, b, lib=lib) for a, b in sets]
    turn = [0]

    def launch():
        out = launchers[turn[0] % len(launchers)]()
        turn[0] += 1
        return out
    return launch


def dot_work(R, n):
    """(bytes, bound ms, bound_by) of one exact dot over [R, n]: a and b read
    once and the R sums written once at 3.35 TB/s, against R * n multiplies
    and R * n adds at PEAK_FP32 (each one FP32 op)."""
    nbytes = 2 * R * n * 4 + R * 4
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, 2.0 * R * n / PEAK_FP32 * 1e3
    return (nbytes, t_bytes, "bytes") if t_bytes >= t_ops else (nbytes, t_ops, "operations")


def dot_ragged_cases():
    """(label, a, b) on the card: ragged n, rows past a row group, an
    unaligned row pitch and base (views), products and sums in the
    subnormal range; R not a multiple of the 32 rows of a group, R below
    the SM count, more row groups than resident blocks (the persistent
    blocks walk several), a tensor-copy box wider than the rows and taller
    than R, rows that the tensor copies take, the same rows at an unaligned
    base (4-byte copies), and a pitch that is not a multiple of 4 floats
    (4-byte copies)."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(14)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device="cuda") * scale
    cases = [(f"n={n}", rnd(37, n), rnd(37, n)) for n in (0, 1, 17, 4099)]
    wide = rnd(40, 131)
    cases.append(("row pitch 131 floats, base +4 bytes", wide[:, 1:130], rnd(40, 129)))
    tiny = rnd(65, 300, scale=1e-20)
    tiny[0] = 1e-39
    cases.append(("subnormal products and sums", tiny, rnd(65, 300, scale=1e-19)))
    cases.append(("R = 1000 (31 groups and 8 rows)", rnd(1000, 256), rnd(1000, 256)))
    cases.append(("R = 5, below the SM count", rnd(5, 777), rnd(5, 777)))
    cases.append(("R = 5 x n = 20: one box past the rows and the columns", rnd(5, 20),
                  rnd(5, 20)))
    cases.append(("R = 20000 x n = 96: 625 groups", rnd(20000, 96), rnd(20000, 96)))
    a, b = rnd(300, 1024), rnd(300, 1024)
    cases.append(("tensor-copied rows [300, 1024]", a, b))
    odd_a, odd_b = rnd(300, 1028), rnd(300, 1028)
    odd_a[:, 1:1025], odd_b[:, 1:1025] = a, b
    cases.append(("the same rows at base +4 bytes: 4-byte copies", odd_a[:, 1:1025],
                  odd_b[:, 1:1025]))
    mix_a, mix_b = rnd(300, 1026), rnd(300, 1026)
    cases.append(("pitch 1026 floats: 4-byte copies", mix_a[:, :1024], mix_b[:, :1024]))
    return cases


def dsp_phase():
    """Phase 14: the DSP layer (ops/dsp.py) on the card. The main path:
    dotprod_f32 (exact) at both DOT_SHAPES, biquad_f32 (exact) at [4096,
    8192] and the int16 ops at S = 4 x [2048, 2 x 8192], launches counted;
    their outputs held to the plain versions (the dot bit for bit on the
    card; the biquad and the int16 ops against a CPU run); the dot's ragged
    cases; then the dot timed by queued direct launches ([65536, 64] over
    DOT_ROTATION operand sets in turn, past L2) beside one wrapper call,
    the plain version, its bound, an estimated serial chain and
    torch.linalg.vecdot (another rounding order). Returns the launches of
    the counted path and the kernels-line entry of dotprod_exact."""
    import numpy as np
    import torch

    from esp_audio_libs_tpu_torch.ops import biquad_kernels as bk
    from esp_audio_libs_tpu_torch.ops import dsp
    from esp_audio_libs_tpu_torch.ops import dsp_kernels as dk

    g = torch.Generator(device="cuda").manual_seed(1400)
    dots = [(torch.randn(shape, generator=g, device="cuda"),
             torch.randn(shape, generator=g, device="cuda")) for shape in DOT_SHAPES]
    x = torch.randn((DOT_SHAPES[0]), generator=g, device="cuda")
    coef = torch.tensor([0.097631, 0.195262, 0.097631, -0.942809, 0.333333], device="cuda")
    w = torch.randn((DOT_SHAPES[0][0], 2), generator=g, device="cuda") * 0.1
    s16 = torch.randint(-32768, 32768, (DSP_S, DSP_ROWS, 2 * FRAMES), generator=g,
                        device="cuda", dtype=torch.int32).to(torch.int16)
    gains = torch.tensor([32767, 23170, -16384, 11585], dtype=torch.int16, device="cuda")
    tshift = torch.randint(-2, 41, (2 * FRAMES,), generator=g, device="cuda", dtype=torch.int32)

    # the main path, counted
    dk.reset_launch_counts()
    bk.reset_launch_counts()
    sums = [dsp.dotprod_f32(a, b) for a, b in dots]
    y, nw = dsp.biquad_f32(x, coef, w)
    mixes = [dsp.mix_s16(s16, gains, sh) for sh in (*DSP_SHIFTS, tshift)]
    adds = [dsp.add_s16(s16[0], s16[1], sh) for sh in (*DSP_SHIFTS, tshift)]
    mulcs = [dsp.mulc_s16(s16[0], c) for c in (0, -1, 32767, -32768)]
    torch.cuda.synchronize()
    launches = {"dotprod_exact": dk.dotprod_exact_cuda.launches,
                "biquad_exact (iir2)": bk.iir2_sequential_cuda.launches}
    if launches != {"dotprod_exact": len(DOT_SHAPES), "biquad_exact (iir2)": 1}:
        fail(f"the DSP path launched {launches}, expected one dot per call and one iir2 "
             f"launch per biquad_f32 call")

    for (a, b), got in zip(dots, sums):
        if not same_bits(got, dk.dotprod_exact_plain(a, b)):
            fail(f"dotprod_exact differs from its plain version at {tuple(a.shape)}")
    ragged = dot_ragged_cases()
    for label, a, b in ragged:
        if not same_bits(dk.dotprod_exact_cuda(a, b), dk.dotprod_exact_plain(a, b)):
            fail(f"dotprod_exact differs from its plain version: {label}")
    y_c, nw_c = dsp.biquad_f32(x[:CMP_STREAMS].cpu(), coef.cpu(), w[:CMP_STREAMS].cpu())
    if not (same_bits(y[:CMP_STREAMS].cpu(), y_c) and same_bits(nw[:CMP_STREAMS].cpu(), nw_c)):
        fail("biquad_f32 (exact) on the card differs from the CPU plain path")
    rows = s16[:, :DSP_CPU_ROWS].cpu()
    for sh, got_mix, got_add in zip((*DSP_SHIFTS, tshift), mixes, adds):
        sh_c = sh.cpu() if isinstance(sh, torch.Tensor) else sh
        if not (torch.equal(got_mix[:DSP_CPU_ROWS].cpu(), dsp.mix_s16(rows, gains.cpu(), sh_c))
                and torch.equal(got_add[:DSP_CPU_ROWS].cpu(), dsp.add_s16(rows[0], rows[1], sh_c))):
            fail(f"mix_s16 / add_s16 on the card differ from the CPU at shift {sh_c}")
    for c, got in zip((0, -1, 32767, -32768), mulcs):
        if not torch.equal(got[:DSP_CPU_ROWS].cpu(), dsp.mulc_s16(rows[0], c)):
            fail(f"mulc_s16 on the card differs from the CPU at c = {c}")
    print(f"dsp: dotprod_exact bit-identical to its plain version at {list(DOT_SHAPES)} and on "
          f"{len(ragged)} ragged cases (n = 0, 1, 17, 4099, an unaligned pitch, subnormals, "
          f"R = 1000, 5 and 20000, a box past R and n, tensor-copied and 4-byte-copied rows); "
          f"biquad_f32 (exact) at {list(x.shape)} bit-identical to the CPU plain "
          f"path on {CMP_STREAMS} rows; add_s16 / mix_s16 (S = {DSP_S}) at shifts "
          f"{list(DSP_SHIFTS)} and a tensor shift and mulc_s16 equal to the CPU on "
          f"{DSP_CPU_ROWS} rows; launches {launches}")

    bq_ms = cuda_time(lambda: dsp.biquad_f32(x, coef, w))
    mix_ms = cuda_time(lambda: dsp.mix_s16(s16, gains, 1))
    print(f"dsp: biquad_f32 (exact) {list(x.shape)} {bq_ms:.4f} ms per call (one iir2 launch "
          f"and the output taps as torch ops); mix_s16 S = {DSP_S} x {list(s16.shape[1:])} "
          f"{mix_ms:.4f} ms per call (torch ops)")

    # [65536, 64] is timed over DOT_ROTATION operand sets in turn, so that
    # device memory serves it and not L2; [4096, 8192] (268 MB) needs none.
    # Both queued behind a sleep: a launch through ctypes takes the host
    # longer to enqueue than the card takes to run [65536, 64]
    rotation = [dots[1]] + [tuple(torch.randn(DOT_SHAPES[1], generator=g, device="cuda")
                                  for _ in range(2)) for _ in range(DOT_ROTATION - 1)]
    res = {}
    for (a, b), (R, n) in zip(dots, DOT_SHAPES):
        launch = dot_launcher(a, b)
        rotated = (R, n) == DOT_SHAPES[1]
        ms = cuda_time_queued(dot_rotated_launcher(rotation) if rotated else launch)
        ms_one_set = cuda_time_queued(launch) if rotated else ms
        ms_wrapper = cuda_time(lambda: dk.dotprod_exact_cuda(a, b))
        plain_ms = cuda_time(lambda: dk.dotprod_exact_plain(a, b), iters=1, warmup=1)
        vecdot_ms = cuda_time(lambda: torch.linalg.vecdot(a, b))
        mhz = sm_clock_under_load(launch, n=max(200, int(200 / max(ms, 1e-3))))
        chain_ms = n * OP_CYCLES / (mhz * 1e3)
        nbytes, bound_ms, by = dot_work(R, n)
        res[(R, n)] = dict(ms=ms, ms_one_set=ms_one_set, ms_wrapper=ms_wrapper,
                           plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
                           vecdot_ms=vecdot_ms, chain_ms_estimate=chain_ms, sm_mhz=mhz)
        how = (f"over {DOT_ROTATION} operand sets in turn; {ms_one_set:.4f} ms on one set, "
               f"which L2 can hold" if rotated else "one operand set, 268 MB")
        print(f"kernel dotprod_exact [{R}, {n}]: bit-identical; {ms:.4f} ms per direct launch "
              f"({how}; one wrapper call {ms_wrapper:.4f} ms; plain version {plain_ms:.2f} ms); bound "
              f"{bound_ms:.4f} ms ({by}: {nbytes} B at 3.35 TB/s), {bound_ms / ms:.1%} of it; "
              f"serial chain (an estimate, not measured: {n} dependent adds x {OP_CYCLES} "
              f"cycles at {mhz:.0f} MHz, the SM clock under load) {chain_ms:.4f} ms; "
              f"torch.linalg.vecdot {vecdot_ms:.4f} ms (not the same rounding order)")
    main, second = res[DOT_SHAPES[0]], res[DOT_SHAPES[1]]
    return launches, {"name": "dotprod_exact", "route": "cuda",
            "source": "esp_audio_libs_tpu_torch/csrc/dotprod_exact.cu",
            "replaces": "esp_audio_libs_tpu/ops/dsp.py:32",
            "launches": launches["dotprod_exact"], "max_abs_err": 0, "bit_exact": True,
            "ms": main["ms"], "ms_wrapper": main["ms_wrapper"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"], "library_ms": None,
            "vecdot_ms_other_rounding_order": main["vecdot_ms"],
            "shape": list(DOT_SHAPES[0]),
            "second_shape": {"shape": list(DOT_SHAPES[1]),
                             **{k: second[k] for k in ("ms", "ms_one_set", "ms_wrapper",
                                                       "plain_ms", "bound_ms", "bound_by")},
                             "rotated_sets": DOT_ROTATION,
                             "vecdot_ms_other_rounding_order": second["vecdot_ms"]}}


# ------------------------------------------------------------- MP3 serving

MP3_RUNS = 4


def mp3_serving_phase():
    """Phase 15: phase 13's 256 tonal streams lengthened to MP3_RUNS runs x
    MP3_FRAMES frames: decode_run_pipelined(to_device=True) against
    sequential decode_run(to_device=True) calls on a second fleet (PCM,
    consumed and absolute next_pos byte for byte), both timed; then a fleet
    checkpointed after run 1 (get_state, pickle), restored into a new fleet
    whose run 2 equals the uninterrupted run 2. Returns the mp3_granules
    launches of the timed pipelined pass."""
    import pickle

    import numpy as np
    import torch

    from esp_audio_libs_tpu_torch.models import BatchedMP3Decoder
    from esp_audio_libs_tpu_torch.ops import mp3_kernels as mk

    B, F = MP3_STREAMS, MP3_FRAMES
    streams = mp3_streams("tonal", B, MP3_RUNS * F, 9000)

    def sequential():
        bat, pos, out = BatchedMP3Decoder(B), [0] * B, []
        for _ in range(MP3_RUNS):
            pcm, con = r = bat.decode_run([s[p:] for s, p in zip(streams, pos)], F,
                                          to_device=True)
            pos = [p + q for p, q in zip(pos, r.next_pos)]
            torch.cuda.synchronize()
            out.append((pcm, list(con), list(pos)))
        return out

    def pipelined():
        out = []
        for r in BatchedMP3Decoder(B).decode_run_pipelined(streams, F, MP3_RUNS, to_device=True):
            torch.cuda.synchronize()
            out.append((r[0], list(r[1]), list(r.next_pos)))
        return out

    times = {"sequential": [], "pipelined": []}
    runs = {}
    for turn in ("sequential", "pipelined", "pipelined", "sequential"):
        if turn == "pipelined":
            mk.reset_launch_counts()
        t0 = time.perf_counter()
        runs[turn] = (sequential if turn == "sequential" else pipelined)()
        times[turn].append(time.perf_counter() - t0)
        if turn == "pipelined":
            launches = mk.mp3_granules_cuda.launches
    if launches != MP3_RUNS:
        fail(f"decode_run_pipelined launched mp3_granules {launches} times, expected {MP3_RUNS}")
    seq, pipe = runs["sequential"], runs["pipelined"]
    if len(seq) != MP3_RUNS or len(pipe) != MP3_RUNS:
        fail(f"{len(seq)} sequential and {len(pipe)} pipelined runs, expected {MP3_RUNS}")
    for k, ((p_s, c_s, n_s), (p_p, c_p, n_p)) in enumerate(zip(seq, pipe)):
        if not (p_p.is_cuda and torch.equal(p_s, p_p) and c_s == c_p and n_s == n_p):
            fail(f"decode_run_pipelined run {k} differs from sequential decode_run")
    if not int(seq[-1][0].abs().max()):
        fail("the serving fleet decoded to silence")

    first = BatchedMP3Decoder(B)
    r1 = first.decode_run(streams, F, to_device=True)
    blob = pickle.dumps(first.get_state())
    restored = BatchedMP3Decoder(B)
    restored.set_state(pickle.loads(blob))
    pcm2, con2 = r2 = restored.decode_run([s[p:] for s, p in zip(streams, r1.next_pos)], F,
                                          to_device=True)
    if not (torch.equal(pcm2, seq[1][0]) and list(con2) == seq[1][1]
            and [p + q for p, q in zip(r1.next_pos, r2.next_pos)] == seq[1][2]):
        fail("a fleet restored after run 1 does not continue as the uninterrupted fleet")

    n_in = B * MP3_RUNS * F * 1152 * 2
    rate = {k: n_in / min(v) / 1e6 for k, v in times.items()}
    print(f"mp3 serving {B} streams x {MP3_RUNS} runs x {F} frames (MPEG-1 44.1 kHz stereo, "
          f"tonal): decode_run_pipelined(to_device) = sequential decode_run(to_device) calls "
          f"(PCM, consumed, absolute next_pos), {launches} mp3_granules launches; sequential "
          f"{rate['sequential']:.1f} decoded Msamples/s (passes "
          f"{', '.join(f'{t * 1e3:.1f}' for t in times['sequential'])} ms), pipelined "
          f"{rate['pipelined']:.1f} (passes "
          f"{', '.join(f'{t * 1e3:.1f}' for t in times['pipelined'])} ms), the better pass of "
          f"each, turns sequential, pipelined, pipelined, sequential; checkpoint after run 1 "
          f"({len(blob)} pickled bytes) restored into a new fleet: run 2 byte-identical")
    return launches


# ------------------------------------------------------------ serving surface

REPO_ROOT = os.path.dirname(os.path.abspath(__file__))
SERVE_SLOTS, SERVE_TOTAL, SERVE_FRAMES, SERVE_RUN, SERVE_SEED = 2048, 4096, (4, 16), 8, 7
SERVE_SAMPLE = 32                 # sampled streams from first-admitted and from recycled slots each
VERIFY_SLOTS, VERIFY_TOTAL = 64, 160
COMPOSED_FRAMES, COMPOSED_RUN, COMPOSED_RATE = 8, 4, 16000
FLAC_SERVE_STREAMS, FLAC_SERVE_FRAMES, FLAC_SERVE_CALLS = 256, (8, 16), 3
SOAK_MP3, SOAK_FLAC, SOAK_WARMUP, SOAK_CYCLES, SOAK_CHURN = 64, 8, 5, 40, 300
SOAK_ALLOC_SLACK = 1 << 20        # bytes: under one 2 MiB segment of the caching allocator
CONFORMANCE_WORKERS = 2
CHILDREN = {}                     # corpus generators by kind, stopped by fail() and at exit
# the arguments of each serving corpus (serve_fleet.mp3_corpus, .flac_corpus)
SERVE_CORPORA = {"mp3_ragged": [SERVE_TOTAL, *SERVE_FRAMES, SERVE_SEED, False],
                 "mp3_composed": [SERVE_SLOTS, COMPOSED_FRAMES, COMPOSED_FRAMES, SERVE_SEED, True],
                 "flac": [FLAC_SERVE_STREAMS, *FLAC_SERVE_FRAMES, SERVE_SEED]}

# Runs in a child process (``python -c``): builds one corpus into a
# directory, importing only the port and tools/ (no JAX).
CORPUS_JOB = """
import json, pickle, sys, time
from pathlib import Path
from esp_audio_libs_tpu_torch.cli import flac_conformance as fc, serve_fleet as sf
from esp_audio_libs_tpu_torch.cli import mp3_conformance as mc
t0 = time.perf_counter()
kind, out, spec = sys.argv[1], Path(sys.argv[2]), json.loads(sys.argv[3])
if kind == "conformance":
    fc.generate_corpus(out / "flac_corpus")
    fc.install_independent_corpus(out / "flac_corpus")
elif kind == "mp3_conformance":
    mc.generate_corpus(out / "mp3_corpus")
    mc.install_independent_corpus(out / "mp3_corpus")
else:
    make = sf.flac_corpus if kind == "flac" else sf.mp3_corpus
    (out / f"{kind}.tmp").write_bytes(pickle.dumps(make(*spec)))
    (out / f"{kind}.tmp").rename(out / f"{kind}.pkl")
print(f"{kind} corpus built in {time.perf_counter() - t0:.1f} s")
"""


def stop_children() -> None:
    for proc in CHILDREN.values():
        if proc.poll() is None:
            proc.kill()
        proc.wait()


def start_corpus(out_dir: str, kind: str, spec=None) -> None:
    """Start the generator of ``kind`` in the background, one core: the
    FLAC or the MP3 conformance corpus, or a serving corpus of
    ``SERVE_CORPORA``; ``corpus`` waits for it."""
    if not CHILDREN:
        import atexit
        atexit.register(stop_children)
    CHILDREN[kind] = subprocess.Popen(
        [sys.executable, "-c", CORPUS_JOB, kind, out_dir, json.dumps(spec)],
        cwd=REPO_ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def corpus(out_dir: str, kind: str):
    """Wait for the generator of ``kind``; the serving corpus, or a
    conformance corpus's directory."""
    import pickle
    proc = CHILDREN[kind]
    t0 = time.perf_counter()
    log, _ = proc.communicate()
    if proc.returncode != 0:
        fail(f"building the {kind} corpus failed:\n{log}")
    print(f"{log.strip()} (waited {time.perf_counter() - t0:.1f} s)")
    if kind == "conformance":
        return os.path.join(out_dir, "flac_corpus")
    if kind == "mp3_conformance":
        return os.path.join(out_dir, "mp3_corpus")
    with open(os.path.join(out_dir, f"{kind}.pkl"), "rb") as f:
        return pickle.load(f)


def serving_corpora(out_dir: str) -> dict:
    """Phase 16's corpora, one generator each, all started together."""
    for kind, spec in SERVE_CORPORA.items():
        start_corpus(out_dir, kind, spec)
    return {kind: corpus(out_dir, kind) for kind in SERVE_CORPORA}


def serve_args(*argv):
    from esp_audio_libs_tpu_torch.cli import serve_fleet
    return serve_fleet.parser().parse_args([*map(str, argv), "--device", "cuda"])


def run_times(runs) -> str:
    import numpy as np
    ms = [r["ms"] for r in runs]
    return f"{len(ms)} runs, slowest {max(ms):.2f} ms, median {float(np.median(ms)):.2f} ms"


def serving_phase(corp):
    """Phase 16: the port's serve_fleet entry points in-process at full width.
    (a) ragged MP3 with continuous batching: 2048 slots serving 4096 tonal
    streams of 4-16 frames (every third one mono: two format groups), runs of
    8 frames, seed 7; all 2048 slots recycle, each stream's PCM has its
    frames x 1152 x channels samples and is nonzero, and a seeded sample of
    64 streams (32 first-admitted, 32 admitted into recycled slots) equals
    single-stream MP3Decoder decodes byte for byte; then the whole --verify at
    64 slots over the corpus's first 160 streams. (b) composed --rate 16000:
    2048 stereo streams x 8 frames in runs of 4; exactly 1 mp3_granules launch
    per run, the PCM a card tensor between the stages, run 1's resampled
    output equal to a fresh Resampler's on the same decoded PCM. (c) the FLAC
    fleet: 256 flacgen streams (16-bit stereo, order-8 LPC, 8-16 frames of
    1024), every one md5_ok, served 3 times. The MP3 PCM is read through
    serve_mp3's on_run hook (the serve itself keeps none). Prints each
    mode's aggregate and its slowest and median run. Returns the launch
    counts of each mode."""
    import numpy as np
    import torch

    from esp_audio_libs_tpu_torch.cli import serve_fleet as sf
    from esp_audio_libs_tpu_torch.models import Resampler, ResamplerConfiguration
    from esp_audio_libs_tpu_torch.ops import flac_kernels as fk
    from esp_audio_libs_tpu_torch.ops import mp3_kernels as mk
    from esp_audio_libs_tpu_torch.ops import polyphase_kernels as pk

    launches = {}
    # (a) ragged, continuous batching
    streams, metas = corp["mp3_ragged"]
    args = serve_args("--streams", SERVE_SLOTS, "--total-streams", SERVE_TOTAL,
                      "--min-frames", SERVE_FRAMES[0], "--max-frames", SERVE_FRAMES[1],
                      "--run-frames", SERVE_RUN, "--seed", SERVE_SEED)
    rng = np.random.default_rng(SERVE_SEED)
    sample = np.concatenate([rng.choice(SERVE_SLOTS, SERVE_SAMPLE, replace=False),
                             SERVE_SLOTS + rng.choice(SERVE_TOTAL - SERVE_SLOTS, SERVE_SAMPLE,
                                                      replace=False)])
    kept = {int(i): [] for i in sample}
    counts, nonzero = [0] * SERVE_TOTAL, [False] * SERVE_TOTAL

    def gather(_r, slots, _bufs, res, _out):
        for i, sid in enumerate(slots):
            if sid is None:
                continue
            for _e, p, _c in res[i]:
                if p is not None:
                    counts[sid] += p.size
                    nonzero[sid] = nonzero[sid] or bool(p.any())
                    if sid in kept:
                        kept[sid].append(p)

    mk.reset_launch_counts()
    _, runs, agg = sf.serve_mp3(args, streams, metas, gather)
    launches["ragged"] = mk.mp3_granules_cuda.launches
    recycled = sum(r["recycled"] for r in runs)
    if recycled != SERVE_TOTAL - SERVE_SLOTS:
        fail(f"serve_mp3 recycled {recycled} slots, expected {SERVE_TOTAL - SERVE_SLOTS}")
    if agg["streams"] != SERVE_TOTAL or agg["slots"] != SERVE_SLOTS:
        fail(f"serve_mp3 aggregate {agg}")
    nch = [1 if cfg["mode"] == 3 else 2 for cfg, _ in metas]
    for i, (cfg, n) in enumerate(metas):
        if counts[i] != n * 1152 * nch[i]:
            fail(f"served stream {i}: {counts[i]} samples, expected {n} x 1152 x {nch[i]}")
    if not all(nonzero):
        fail("a served stream decoded to silence")
    if sum(counts) != agg["samples"]:
        fail("the per-stream PCM does not add up to the aggregate's samples")
    for i, got in kept.items():
        want = [p for _e, p in sf.mp3_single_decode(streams[i], metas[i][1], "cuda")
                if p is not None]
        if not np.array_equal(np.concatenate(got), np.concatenate(want)):
            fail(f"served stream {i} differs from its single-stream decode")
    print(f"serve mp3 ragged: {SERVE_TOTAL} streams ({nch.count(1)} mono) of "
          f"{SERVE_FRAMES[0]}-{SERVE_FRAMES[1]} frames on {SERVE_SLOTS} slots, runs of "
          f"{SERVE_RUN} frames: {recycled} slots recycled, every stream's samples = frames x "
          f"1152 x channels and nonzero, {len(sample)} sampled streams ({SERVE_SAMPLE} from "
          f"recycled slots) = single-stream MP3Decoder(device='cuda') byte for byte; "
          f"samples {agg['samples']}, runs {agg['runs']}, msps {agg['msps']}, realtime_streams "
          f"{agg['realtime_streams']}; {run_times(runs)}; {launches['ragged']} mp3_granules "
          f"launches")
    print(json.dumps({"serve": "mp3_ragged", **agg, "run_ms": [r["ms"] for r in runs]}))

    vargs = serve_args("--streams", VERIFY_SLOTS, "--total-streams", VERIFY_TOTAL,
                       "--min-frames", SERVE_FRAMES[0], "--max-frames", SERVE_FRAMES[1],
                       "--run-frames", SERVE_RUN, "--seed", SERVE_SEED, "--verify")
    _, vruns, vagg = sf.serve_mp3(vargs, streams[:VERIFY_TOTAL], metas[:VERIFY_TOTAL])
    if vagg["verified"] is not True:
        fail(f"serve_mp3 --verify at {VERIFY_SLOTS} slots: {vagg}")
    print(f"serve mp3 --verify: {VERIFY_TOTAL} streams on {VERIFY_SLOTS} slots, "
          f"{sum(r['recycled'] for r in vruns)} recycled, verified {vagg['verified']}")

    # (b) composed decode -> 16 kHz, the PCM on the card between the stages
    cstreams, cmetas = corp["mp3_composed"]
    cargs = serve_args("--streams", SERVE_SLOTS, "--min-frames", COMPOSED_FRAMES,
                       "--max-frames", COMPOSED_FRAMES, "--run-frames", COMPOSED_RUN,
                       "--rate", COMPOSED_RATE, "--seed", SERVE_SEED)
    per_run, first, off_card = [], {}, []

    def on_run(r, _slots, _bufs, res, out):
        per_run.append((mk.mp3_granules_cuda.launches, pk.polyphase_banded_cuda.launches))
        if not (res[0].is_cuda and out[0].is_cuda):
            off_card.append(r)
        if r == 0:
            first["pcm"], first["out"] = res[0], out

    mk.reset_launch_counts()
    pk.reset_launch_counts()
    _, cruns, cagg = sf.serve_mp3(cargs, cstreams, cmetas, on_run)
    launches["composed"] = {"mp3_granules": mk.mp3_granules_cuda.launches,
                            "polyphase_banded": pk.polyphase_banded_cuda.launches}
    steps = [(a - pa, b - pb) for (a, b), (pa, pb) in zip(per_run, [(0, 0)] + per_run[:-1])]
    if [m for m, _ in steps] != [1] * len(cruns):
        fail(f"the composed serving runs launched mp3_granules {[m for m, _ in steps]} times, "
             f"expected 1 per run")
    if off_card:
        fail(f"composed runs {off_card} left the card between the stages")
    n_samples = SERVE_SLOTS * COMPOSED_FRAMES * 1152 * 2
    if cagg["samples"] != n_samples or not int(first["pcm"].abs().max()):
        fail(f"composed serving: {cagg['samples']} samples (expected {n_samples}) or silence")
    fresh = Resampler(batch=SERVE_SLOTS, exact=False, device="cuda")
    fresh.initialize(ResamplerConfiguration(44100.0, float(COMPOSED_RATE), 16, 16, 2, True, True,
                                            64, 32))
    pcm0 = first["pcm"]
    want = fresh.resample_stream(pcm0.contiguous().view(torch.uint8), pcm0.shape[1] // 2, 1)
    torch.cuda.synchronize()
    got = first["out"]
    if not (torch.equal(got[0], want[0]) and list(got[1]) == list(want[1])
            and np.array_equal(got[2], want[2])):
        fail("composed serving: run 1's output differs from a fresh Resampler's")
    print(f"serve mp3 composed -> {COMPOSED_RATE} Hz: {SERVE_SLOTS} stereo streams x "
          f"{COMPOSED_FRAMES} frames, runs of {COMPOSED_RUN}: PCM on the card between the "
          f"stages, run 1 = a fresh Resampler on the same PCM (gens {list(got[1])}); samples "
          f"{cagg['samples']}, runs {cagg['runs']}, msps {cagg['msps']}, realtime_streams "
          f"{cagg['realtime_streams']}; {run_times(cruns)}; launches per run (mp3_granules, "
          f"polyphase_banded) {steps}")
    print(json.dumps({"serve": "mp3_composed", **cagg, "run_ms": [r["ms"] for r in cruns],
                      "launches_per_run": steps}))

    # (c) the FLAC fleet
    fargs = serve_args("--codec", "flac", "--streams", FLAC_SERVE_STREAMS,
                       "--min-frames", FLAC_SERVE_FRAMES[0], "--max-frames", FLAC_SERVE_FRAMES[1],
                       "--seed", SERVE_SEED)
    fk.reset_launch_counts()
    calls = []
    for _ in range(FLAC_SERVE_CALLS):
        t0 = time.perf_counter()
        results, fagg = sf.serve_flac(fargs, corp["flac"])
        calls.append((time.perf_counter() - t0) * 1e3)
        if not (fagg["verified"] and all(info["md5_ok"] is True for _, info in results)):
            fail("serve_flac: a stream is not md5_ok")
    launches["flac"] = fk.flac_frame_cuda.launches
    print(f"serve flac: {FLAC_SERVE_STREAMS} streams (16-bit stereo, order-8 LPC, "
          f"{FLAC_SERVE_FRAMES[0]}-{FLAC_SERVE_FRAMES[1]} frames of 1024), every stream md5_ok; "
          f"samples {fagg['samples']}, msps {fagg['msps']}, realtime_streams "
          f"{fagg['realtime_streams']} (last of {FLAC_SERVE_CALLS} calls); calls slowest "
          f"{max(calls):.2f} ms, median {float(np.median(calls)):.2f} ms (whole serve_flac, "
          f"the fleet's construction included); {launches['flac']} flac_frame launches")
    print(json.dumps({"serve": "flac", **fagg, "call_ms": calls}))
    return launches


def soak_phase():
    """Phase 17: the counterpart of tests/test_soak.py on the card. One MP3
    fleet of 64 tonal streams and one FLAC fleet of 8 cycle (reset every MP3
    slot, decode_run of 3 frames, decode_streams with MD5) 5 times to warm up,
    then 40 times: torch.cuda.memory_allocated() returns to its post-warm-up
    value within SOAK_ALLOC_SLACK, the live CUDA tensors (a gc scan) within 4,
    and RSS grows less than 64 MB; then 300 create/destroy cycles of
    FLACDecoder and MP3Decoder on the card (a header read, a frame decode)
    grow RSS less than 16 MB."""
    import gc

    import numpy as np
    import torch

    from esp_audio_libs_tpu_torch.models import (BatchedFLACDecoder, BatchedMP3Decoder,
                                                 FLACDecoder, MP3Decoder)
    from esp_audio_libs_tpu_torch.utils.errors import FLACDecoderResult

    mf = tools_import("mp3frames")
    fg = tools_import("flacgen")
    stereo = dict(ver_bits=3, bitrate_idx=9, sr_idx=0, mode=0)
    mp3_bufs = []
    for i in range(SOAK_MP3):
        rng = np.random.default_rng(700 + i)
        mp3_bufs.append(b"".join(mf.craft_tonal_frame(stereo, rng) for _ in range(6)))
    plans = [[[fg.SubframePlan("lpc", order=8), fg.SubframePlan("fixed", order=2)]] * 2,
             [[fg.SubframePlan("lpc", order=4), fg.SubframePlan("constant")]] * 2]
    flac_bufs = [fg.make_flac(rng_seed=61 + i, depth=16, channels=2, block_size=1024, n_frames=2,
                              plans=plans[i % 2])[0] for i in range(SOAK_FLAC)]

    mp3 = BatchedMP3Decoder(SOAK_MP3, device="cuda")
    flac = BatchedFLACDecoder(SOAK_FLAC, device="cuda")
    if not all(h == FLACDecoderResult.SUCCESS for h in flac.read_headers(flac_bufs)):
        fail("soak: FLAC header parse failed")
    flac_frames = [b[d.get_bytes_index():] for b, d in zip(flac_bufs, flac.decoders)]

    def cycle():
        for s in range(SOAK_MP3):
            mp3.reset_stream(s)
        r = mp3.decode_run(mp3_bufs, 3)
        if not all(len(frames) == 3 for frames in r):
            fail("soak: a stream decoded fewer than 3 frames")
        if not all(info["md5_ok"] for _, info in flac.decode_streams(flac_frames)):
            fail("soak: a FLAC stream is not md5_ok")

    def live_cuda():
        return sum(1 for o in gc.get_objects()
                   if issubclass(type(o), torch.Tensor) and o.is_cuda)

    def settle():
        torch.cuda.synchronize()
        gc.collect()

    for _ in range(SOAK_WARMUP):
        cycle()
    settle()
    base = (torch.cuda.memory_allocated(), live_cuda(), rss_mb())
    t0 = time.perf_counter()
    for _ in range(SOAK_CYCLES):
        cycle()
    settle()
    t_cycles = time.perf_counter() - t0
    now = (torch.cuda.memory_allocated(), live_cuda(), rss_mb())
    if now[0] - base[0] > SOAK_ALLOC_SLACK:
        fail(f"soak: memory_allocated grew {base[0]} -> {now[0]} bytes over {SOAK_CYCLES} cycles")
    if now[1] > base[1] + 4:
        fail(f"soak: live CUDA tensors grew {base[1]} -> {now[1]} over {SOAK_CYCLES} cycles")
    if now[2] - base[2] >= 64.0:
        fail(f"soak: RSS grew {now[2] - base[2]:.1f} MB over {SOAK_CYCLES} cycles")

    blob = flac_bufs[0]
    mp3_blob = b"".join(mf.craft_tonal_frame(stereo, np.random.default_rng(700)) for _ in range(2))

    def churn():
        d = FLACDecoder(device="cuda")
        if d.read_header(blob) != FLACDecoderResult.SUCCESS:
            fail("churn: FLAC header parse failed")
        m = MP3Decoder(device="cuda")
        m.decode(mp3_blob)
        del d, m

    for _ in range(20):
        churn()
    settle()
    rss0 = rss_mb()
    t0 = time.perf_counter()
    for _ in range(SOAK_CHURN):
        churn()
    settle()
    t_churn = time.perf_counter() - t0
    churn_mb = rss_mb() - rss0
    if churn_mb >= 16.0:
        fail(f"churn: RSS grew {churn_mb:.1f} MB over {SOAK_CHURN} create/destroy cycles")
    print(f"soak: {SOAK_CYCLES} cycles after {SOAK_WARMUP} warm-up ({SOAK_MP3} MP3 slots reset "
          f"and run 3 frames, {SOAK_FLAC} FLAC streams with MD5; {t_cycles:.1f} s): "
          f"memory_allocated {base[0]} -> {now[0]} bytes (slack {SOAK_ALLOC_SLACK}), live CUDA "
          f"tensors {base[1]} -> {now[1]}, RSS {base[2]:.1f} -> {now[2]:.1f} MB "
          f"(+{now[2] - base[2]:.1f}, bound 64); churn: {SOAK_CHURN} FLACDecoder + MP3Decoder "
          f"create/decode/destroy cycles ({t_churn:.1f} s), RSS +{churn_mb:.1f} MB (bound 16)")


def rss_mb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024.0
    fail("no VmRSS in /proc/self/status")


def conformance_phase(corpus_dir: str, out_dir: str):
    """Phase 18: the port's FLAC conformance runner on the card over its
    generated corpus (114 files: subset 64, uncommon 12, faulty 13,
    independent 25), the flac_to_wav CLI driven through a WarmCliPool of 2
    card workers. Every file passes, and its status, parity and md5 equal the
    committed JAX report (build/test_results/test_report.json); its
    reference_match (the C oracle's) is not compared."""
    from pathlib import Path

    from esp_audio_libs_tpu_torch.cli import flac_conformance as fc

    with open(os.path.join(REPO_ROOT, "build", "test_results", "test_report.json")) as f:
        want = json.load(f)
    t0 = time.perf_counter()
    report = fc.run_suite(Path(corpus_dir), Path(out_dir), device="cuda", cli=True,
                          workers=CONFORMANCE_WORKERS)
    wall = time.perf_counter() - t0
    s = report["summary"]
    failed = [r["file"] for rs in report["categories"].values() for r in rs
              if r["status"] != "pass"]
    if failed or s["passed"] != s["total"] or s["total"] != want["summary"]["total"]:
        fail(f"conformance: {s['passed']}/{s['total']} passed, failing {failed}")
    for cat, rows in want["categories"].items():
        got = {r["file"]: r for r in report["categories"].get(cat, [])}
        if set(got) != {r["file"] for r in rows}:
            fail(f"conformance: the {cat} files differ from the committed report's")
        for r in rows:
            for key in ("status", "parity", "md5"):
                if got[r["file"]][key] != r[key]:
                    fail(f"conformance {cat}/{r['file']}: {key} {got[r['file']][key]!r}, "
                         f"the committed report has {r[key]!r}")
    counts = {cat: len(rows) for cat, rows in report["categories"].items()}
    print(f"flac conformance on the card: {s['passed']}/{s['total']} passed ({s['decode_parity']} "
          f"decode-parity, {s['reject_parity']} reject-parity; {counts}), status, parity and md5 "
          f"of every file = the committed JAX report; CLI through a WarmCliPool of "
          f"{CONFORMANCE_WORKERS} workers; wall {wall:.1f} s (the pool's start included)")


def long_run_plan(ladder, chunk: int) -> list[int]:
    """The decode_run calls of the long-stream loop (mp3_conformance.
    our_decode_run_loop) over a file whose ladder is ``ladder``: the
    attempts of each call. A run ends after ``chunk`` attempts or at its
    first error frame (BatchedMP3Decoder._parse_run)."""
    runs, n = [], 0
    for err, _, _ in ladder:
        n += 1
        if n == chunk or err != 0:
            runs.append(n)
            n = 0
    return runs + [n] if n else runs


# the long streams whose first runs phase 20 holds to the plain version, with
# the granules of one run (decode_run of mc.LONG_CHUNK frames, B = 1)
LONG_KERNEL_CHECKS = {"long_reservoir_mpeg1_stereo.mp3": 256, "long_tonal_mpeg2_stereo.mp3": 128}
LONG_KERNEL_RUNS = 2


def mp3_long_kernel_check(corpus_dir, sigs) -> None:
    """mp3_granules at the long loop's launch shape, B = 1 x G = 256
    (MPEG-1) or 128 (MPEG-2): one block for the whole run. The first
    LONG_KERNEL_RUNS runs of each LONG_KERNEL_CHECKS stream, parsed on one
    fleet each from where the last run stopped (the host reservoir carried),
    launched one run a launch from the last run's state on the card
    (overlap, vbuf ring, FIFO phase), and held byte for byte to the plain
    version on the same CUDA tensors. The plain version takes the runs that
    start at one FIFO phase together, each run one stream of its fleet (the
    streams of a fleet are independent, and a run of 128 or 256 granules
    ends at the phase it started at): it takes 0.3-0.45 s a granule step
    here, about as long at B = 2 as at B = 1. Run k starts after the bytes
    the signature ladder's attempts of run k - 1 consumed (these runs end on
    no error, so their frames lie back to back: a sync word must start
    there)."""
    import torch

    from esp_audio_libs_tpu_torch.cli import mp3_conformance as mc
    from esp_audio_libs_tpu_torch.models import mp3_pipeline
    from esp_audio_libs_tpu_torch.models.batch import BatchedMP3Decoder, parsed_runs
    from esp_audio_libs_tpu_torch.models.mp3 import MP3Decoder
    from esp_audio_libs_tpu_torch.ops import mp3_kernels as mk

    t0 = time.perf_counter()
    for name, G in LONG_KERNEL_CHECKS.items():
        blob = (corpus_dir / "long" / name).read_bytes()
        ladder = sigs[name]["ladder"]
        bat = BatchedMP3Decoder(1, device="cpu")
        state, pos, runs = mp3_zero_state(1, "cuda"), 0, []
        for run in range(LONG_KERNEL_RUNS):
            (fmt, vindex, _, h, sd), = parsed_runs(bat, [blob[pos:]], mc.LONG_CHUNK)
            if h.shape[:2] != (G, 1):
                fail(f"long/{name} run {run}: a launch of (G, B) {h.shape[:2]}, not ({G}, 1)")
            if runs and fmt != runs[0][0]:
                fail(f"long/{name} run {run}: format {fmt}, run 0's {runs[0][0]}")
            h, sd = torch.as_tensor(h, device="cuda"), torch.as_tensor(sd, device="cuda")
            got = mk.mp3_granules_cuda(h, sd, *state, vindex, ver=fmt[0], sr_idx=fmt[1],
                                       nch=fmt[2], cutoff=fmt[3])
            runs.append((fmt, vindex, h, sd, state, got))
            state = got[1]
            bat._vindex[0] = mp3_pipeline._advance_vindex(vindex, G)
            attempts = ladder[run * mc.LONG_CHUNK:(run + 1) * mc.LONG_CHUNK]
            if any(e != 0 for e, _, _ in attempts):
                fail(f"long/{name} run {run} holds an error frame: runs are not back to back")
            pos += sum(c for _, c, _ in attempts)
            if MP3Decoder.find_sync_word(blob[pos:]) != 0:
                fail(f"long/{name}: no sync word where run {run + 1} starts ({pos})")
        ver, sr_idx, nch, cutoff = runs[0][0]
        for v in sorted({r[1] for r in runs}):
            idx = [k for k, r in enumerate(runs) if r[1] == v]
            rs = [runs[k] for k in idx]
            want = mk.mp3_granules_plain(
                torch.cat([r[2] for r in rs], 1), torch.cat([r[3] for r in rs], 1),
                *(torch.cat(ts) for ts in zip(*(r[4] for r in rs))), v, ver=ver,
                sr_idx=sr_idx, nch=nch, cutoff=cutoff)
            torch.cuda.synchronize()
            got = (torch.cat([r[5][0] for r in rs], 1),
                   *(torch.cat(ts) for ts in zip(*(r[5][1] for r in rs))),
                   torch.cat([r[5][2] for r in rs]))
            for what, a, b in zip(("pcm", "over", "prev_type", "prev_win_switch", "num_prev",
                                   "vbuf", "ref_undef"), got, (want[0], *want[1], want[2])):
                if not torch.equal(a, b):
                    fail(f"mp3_granules differs from its plain version in {what}: long/{name} "
                         f"runs {idx}")
    print(f"mp3 kernel at the long loop's shapes: the first {LONG_KERNEL_RUNS} runs of "
          f"{', '.join(f'long/{n} (B = 1 x G = {g})' for n, g in LONG_KERNEL_CHECKS.items())}, "
          f"state carried from run to run on the card, byte-identical to the plain version "
          f"(PCM, state, UB flag; a stream's runs in one plain pass); "
          f"{time.perf_counter() - t0:.1f} s")


def mp3_conformance_phase(corpus_dir: str, out_dir: str) -> int:
    """Phase 20: the port's MP3 conformance runner (cli/mp3_conformance.py)
    on the card over its generated corpus (53 files: standard 26, modes 3,
    long 4, faulty 10, independent 10), the mp3_to_wav CLI driven through a
    WarmCliPool of 2 card workers. The generated files' bytes equal the
    signature file's hashes (the files JAX signed); every file passes with
    signature_match true (its frame ladder, decoded frames and payload
    SHA256 equal JAX's decode), and its status, parity and frames equal the
    committed JAX report (build/test_results/mp3_test_report.json, pinned by
    the C oracle). The mp3_granules launches of the runner's own decodes
    (the CLI workers are other processes) are counted per file: a long
    stream makes one per decode_run call that decoded frames (B = 1: one
    format group and one dispatch slice a run), a short file one per
    successful frame and none for a frame that fails before its first
    granule. Before the drive, mp3_long_kernel_check holds the kernel to
    its plain version at the long loop's launch shape. Returns the phase's
    launches."""
    import hashlib
    from pathlib import Path

    from esp_audio_libs_tpu_torch.cli import mp3_conformance as mc
    from esp_audio_libs_tpu_torch.ops import mp3_kernels as mk

    with open(os.path.join(REPO_ROOT, "build", "test_results", "mp3_test_report.json")) as f:
        want = json.load(f)
    sigs = mc.load_signatures()["files"]
    corpus_dir = Path(corpus_dir)
    on_disk = {p.name: p for p in corpus_dir.glob("*/*.mp3")}
    if on_disk.keys() != sigs.keys():
        fail(f"mp3 conformance: the corpus's files differ from the signature file's: "
             f"{sorted(on_disk.keys() ^ sigs.keys())}")
    for name, p in on_disk.items():
        if (p.parent.name != sigs[name]["category"]
                or hashlib.sha256(p.read_bytes()).hexdigest() != sigs[name]["sha256"]):
            fail(f"mp3 conformance: {p.parent.name}/{name} is not the file JAX signed")
    mp3_long_kernel_check(corpus_dir, sigs)

    launches = {}

    def on_file(cat, r):
        launches[r["file"]] = mk.mp3_granules_cuda.launches
        mk.reset_launch_counts()

    reset_all_counts()
    t0 = time.perf_counter()
    report = mc.run_suite(corpus_dir, Path(out_dir), device="cuda", cli=True,
                          workers=CONFORMANCE_WORKERS, on_file=on_file)
    wall = time.perf_counter() - t0
    others = {k: v for k, v in launch_counts().items() if v}
    if others:
        fail(f"mp3 conformance launched kernels outside its files' decodes: {others}")
    s = report["summary"]
    rows = {r["file"]: (cat, r) for cat, rs in report["categories"].items() for r in rs}
    failed = [n for n, (_, r) in rows.items() if r["status"] != "pass"]
    if failed or s["passed"] != s["total"] or s["total"] != want["summary"]["total"]:
        fail(f"mp3 conformance: {s['passed']}/{s['total']} passed, failing {failed}")
    for cat, want_rows in want["categories"].items():
        if {r["file"] for r in want_rows} != {r["file"] for r in report["categories"][cat]}:
            fail(f"mp3 conformance: the {cat} files differ from the committed report's")
        for w in want_rows:
            r = rows[w["file"]][1]
            for key in ("status", "parity", "frames"):
                if r[key] != w[key]:
                    fail(f"mp3 conformance {cat}/{w['file']}: {key} {r[key]!r}, the committed "
                         f"report has {w[key]!r}")
            if r["signature_match"] is not True:
                fail(f"mp3 conformance {cat}/{w['file']}: signature_match "
                     f"{r['signature_match']!r}")
    # the fleet's dispatch rule: a run is one group per format, cut into
    # n = ceil(B * G * 576 * nch * 2 / MP3_SLICE_PCM_BYTES) slices of
    # ceil(B / n) streams; at B = 1 that is one slice, so one launch a run
    long_lines, per_cat, long_samples = [], {}, 0
    for name, (cat, r) in rows.items():
        sig, n = sigs[name], launches[name]
        if cat == "long":
            runs = long_run_plan(sig["ladder"], mc.LONG_CHUNK)
            if n != len(runs) or len(runs) != -(-len(sig["ladder"]) // mc.LONG_CHUNK):
                fail(f"mp3 conformance long/{name}: {n} mp3_granules launches, decode_run "
                     f"calls that decoded frames: {runs}")
            samples = sig["payload_bytes"] // 2
            long_samples += samples
            long_lines.append(f"  long/{name}: {r['frames']} frames in {n} decode_run calls, "
                              f"{n} launches, {samples} samples (all channels) in "
                              f"{r['seconds']:.3f} s = {samples / r['seconds'] / 1e6:.2f} "
                              f"Msamples/s at B = 1")
        elif not sig["n_ok"] <= n <= len(sig["ladder"]):
            fail(f"mp3 conformance {cat}/{name}: {n} mp3_granules launches for "
                 f"{sig['n_ok']} decoded frames of {len(sig['ladder'])} attempts")
        c = per_cat.setdefault(cat, {"files": 0, "seconds": 0.0, "launches": 0})
        c["files"] += 1
        c["seconds"] += r["seconds"]
        c["launches"] += n
    long_s = per_cat["long"]["seconds"]
    print(f"mp3 conformance on the card: {s['passed']}/{s['total']} passed "
          f"({s['decode_parity']} decode-parity, {s['reject_parity']} reject-parity); file "
          f"bytes, frame ladders and payload SHA256 of every file = the signature file (JAX's "
          f"decode); status, parity and frames = the committed JAX report; CLI through a "
          f"WarmCliPool of {CONFORMANCE_WORKERS} workers")
    for cat, c in per_cat.items():
        print(f"  {cat}: {c['files']} files, decode {c['seconds']:.3f} s (the CLI drives "
              f"run beside it), {c['launches']} mp3_granules launches")
    print("\n".join(long_lines))
    print(f"  long: {long_samples} samples in {long_s:.3f} s = "
          f"{long_samples / long_s / 1e6:.2f} Msamples/s at B = 1 (one stream's latency, "
          f"not a serving rate); suite wall {wall:.1f} s (the pool's start and the CLI "
          f"included); {sum(launches.values())} mp3_granules launches")
    return sum(launches.values())


MESH_SHARDS = 4                     # phase 19: one card named 4 times (stream_mesh(["cuda:0"] * 4))
SEQ_STREAMS, SEQ_SECONDS = 4, 120   # sequence parallelism: 4 stereo streams x 120 s at 44.1 kHz
IIR_ROWS, IIR_T = 64, 4 << 20
LPC_ROWS, LPC_T, LPC_SEED = 16, 1 << 18, 19
LPC_FIXED = {1: [1], 2: [-1, 2], 3: [1, -3, 3], 4: [-1, 4, -6, 4]}

# Runs in a child process (``python -c``) while the card runs phase 19's
# first checks: the sequential LPC restoration of the lpc_companion_scan
# check on the CPU (ops/lpc.py::lpc_restore, shift 0), a loop over 2^18 steps.
LPC_JOB = """
import sys, numpy as np, torch
torch.set_num_threads(1)
import chip_smoke
from esp_audio_libs_tpu_torch.ops.lpc import lpc_restore
data, coeffs, order = (torch.from_numpy(a) for a in chip_smoke.lpc_operands())
out = lpc_restore(data, coeffs, order, torch.zeros_like(order), use64=True, max_order=4)
np.save(sys.argv[1], out.numpy())
"""


def lpc_operands():
    """The lpc_companion_scan check's shift-0 subframes: int32 [16, 2^18]
    residuals (seeded), the fixed predictors of orders 1-4 in turn."""
    import numpy as np
    rng = np.random.default_rng(LPC_SEED)
    data = rng.integers(-3000, 3000, (LPC_ROWS, LPC_T)).astype(np.int32)
    order = (1 + np.arange(LPC_ROWS) % 4).astype(np.int32)
    coeffs = np.zeros((LPC_ROWS, 32), np.int32)
    for b, o in enumerate(order):
        coeffs[b, :o] = LPC_FIXED[int(o)]
    return data, coeffs, order


def launch_counts() -> dict:
    """Every kernel's launch count (the sharded wrappers' per-shard ones too)."""
    from esp_audio_libs_tpu_torch.ops import biquad_kernels as bk
    from esp_audio_libs_tpu_torch.ops import dsp_kernels as dk
    from esp_audio_libs_tpu_torch.ops import flac_kernels as fk
    from esp_audio_libs_tpu_torch.ops import mp3_kernels as mk
    from esp_audio_libs_tpu_torch.ops import polyphase_kernels as pk
    from esp_audio_libs_tpu_torch.ops import quantization_kernels as qk
    return {"polyphase_banded": pk.polyphase_banded_cuda.launches,
            "polyphase_fused16": pk.polyphase_fused16_cuda.launches,
            "polyphase_banded_sharded": pk.polyphase_banded_sharded.launches,
            "polyphase_fused16_sharded": pk.polyphase_fused16_sharded.launches,
            "polyphase_exact": pk.polyphase_exact_cuda.launches,
            "biquad_exact": bk.biquad_df1_cuda.launches + bk.iir2_sequential_cuda.launches,
            "flac_frame": fk.flac_frame_cuda.launches,
            "mp3_granules": mk.mp3_granules_cuda.launches,
            "mp3_granules_f32": mk.mp3_granules_f32_cuda.launches,
            "mp3_mxu_pre": mk.mp3_mxu_pre_cuda.launches,
            "mp3_mxu_post": mk.mp3_mxu_post_cuda.launches,
            "dotprod_exact": dk.dotprod_exact_cuda.launches,
            "quantize_pack16": qk.quantize_pack16_cuda.launches,
            "unpack16_extend": qk.unpack16_extend_cuda.launches}


def reset_all_counts() -> None:
    from esp_audio_libs_tpu_torch.ops import biquad_kernels as bk
    from esp_audio_libs_tpu_torch.ops import dsp_kernels as dk
    from esp_audio_libs_tpu_torch.ops import flac_kernels as fk
    from esp_audio_libs_tpu_torch.ops import mp3_kernels as mk
    from esp_audio_libs_tpu_torch.ops import polyphase_kernels as pk
    from esp_audio_libs_tpu_torch.ops import quantization_kernels as qk
    for mod in (bk, dk, fk, mk, pk, qk):
        mod.reset_launch_counts()


class MeshPath:
    """Phase 19's drives of the mesh path: each ``run(fn)`` sets every launch
    count to 0 just before ``fn``, reads them just after, and adds them to
    the phase's totals. Launches that make the single-device references
    run outside it and are not counted."""

    def __init__(self):
        self.total = {}

    def run(self, fn):
        import torch
        reset_all_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = launch_counts()
        for k, v in counts.items():
            self.total[k] = self.total.get(k, 0) + v
        return out, counts, ms


def mesh_kernels(m, data):
    """Phase 19(a): the two sharded wrappers at phase 3's main shape (the
    first chunk of the bench configuration: 2048 x 2 rows, 4 shards of 1024)
    against the single-device launches on the same rows (bit for bit) and
    their plain versions; each shard's launch timed with CUDA events beside
    its plain version, its bound and the library call on the same rows.
    Returns the two kernels-line entries (launches filled in later)."""
    import torch

    from esp_audio_libs_tpu_torch.ops import polyphase_kernels as pk
    from esp_audio_libs_tpu_torch.ops.polyphase import polyphase_banded
    from esp_audio_libs_tpu_torch.parallel.mesh import shard_streams

    t0 = time.perf_counter()
    down = make_resampler(44100.0, 16000.0, BATCH, "cuda")
    xf, x2, Wt, starts, out_max, factor = chunk_operands(down, torch.as_tensor(data, device="cuda"))
    M = xf.shape[0]
    Ms = M // m.size
    entries = []
    for name, x, W in (("polyphase_banded_sharded", xf, Wt),
                       ("polyphase_fused16_sharded", x2, Wt * factor)):
        fused = name == "polyphase_fused16_sharded"
        if fused:
            got = pk.polyphase_fused16_sharded(x, W, starts, mesh=m)
            one = pk.polyphase_fused16_cuda(x, W, starts)
            per = [pk.polyphase_fused16_cuda(p, W, starts) for p in shard_streams(x, m).parts]
            torch.cuda.synchronize()
            for i in range(m.size):
                s, c = got[0].parts[i], got[1].parts[i]
                if not (torch.equal(s, per[i][0]) and torch.equal(c, per[i][1])):
                    fail(f"{name}: shard {i} differs from the single-device launch on its rows")
            s_all, c_all = got[0].gather(), got[1].gather()
            err = int((s_all.int() - one[0].int()).abs().max())
            same_whole = torch.equal(s_all, one[0]) and torch.equal(c_all, one[1])
            err_plain = check_fused(s_all, c_all, *pk.polyphase_fused16_plain(x, W, starts),
                                    f"{name} vs plain")
        else:
            got = pk.polyphase_banded_sharded(x, W, starts, T=out_max, mesh=m)
            one = pk.polyphase_banded_cuda(x, W, starts, T=out_max)
            per = [pk.polyphase_banded_cuda(p, W, starts, T=out_max)
                   for p in shard_streams(x, m).parts]
            torch.cuda.synchronize()
            for i in range(m.size):
                if not same_bits(got.parts[i], per[i]):
                    fail(f"{name}: shard {i} differs from the single-device launch on its rows")
            y = got.gather()
            err = float((y - one).abs().max())
            same_whole = same_bits(y, one)
            torch.testing.assert_close(y, one, **TOL_BANDED)
            p = polyphase_banded(x, W, starts, T=out_max)
            torch.testing.assert_close(y, p, **TOL_BANDED)
            err_plain = float((y - p).abs().max())
        xs = shard_streams(x, m).parts
        if fused:
            shard_ms = [cuda_time(lambda p=p: pk.polyphase_fused16_cuda(p, W, starts)) for p in xs]
            call_ms = cuda_time(lambda: pk.polyphase_fused16_sharded(x, W, starts, mesh=m))
            plain_ms = cuda_time(lambda: pk.polyphase_fused16_plain(xs[0], W, starts))
            bnd, by = contraction_bound(Ms, xs[0], W, Ms * W.shape[0] * 128 * 3)
        else:
            shard_ms = [cuda_time(lambda p=p: pk.polyphase_banded_cuda(p, W, starts, T=out_max))
                        for p in xs]
            call_ms = cuda_time(lambda: pk.polyphase_banded_sharded(x, W, starts, T=out_max,
                                                                    mesh=m))
            plain_ms = cuda_time(lambda: polyphase_banded(xs[0], W, starts, T=out_max))
            bnd, by = contraction_bound(Ms, xs[0], W, Ms * out_max * 4)
        lib_ms = library_time(xs[0], W, starts)
        ms = sum(shard_ms) / len(shard_ms)
        print(f"mesh (a) {name}: {m.size} shards x {Ms} rows (L={x.shape[1]}, nt={W.shape[0]}, "
              f"K={W.shape[1]}), each shard equal bit for bit to the single-device launch on its "
              f"rows; whole output {'equal bit for bit to' if same_whole else 'within tolerance of'} "
              f"one launch on all {M} rows (max|d| {err:.3g}), plain version max|d| "
              f"{err_plain:.3g}; per-shard launch {ms:.4f} ms (shards {', '.join(f'{t:.4f}' for t in shard_ms)}), "
              f"one sharded call {call_ms:.4f} ms, plain {plain_ms:.4f} ms, library {lib_ms:.4f} "
              f"ms, bound {bnd:.4f} ms ({by}), {bnd / ms:.1%} of it; "
              f"{(time.perf_counter() - t0) * 1e3:.0f} ms")
        entries.append({"name": name, "route": "cuda",
                        "source": "esp_audio_libs_tpu_torch/csrc/" + (
                            "polyphase_fused16.cu" if fused else "polyphase_banded.cu"),
                        "split": "esp_audio_libs_tpu_torch/ops/polyphase_kernels.py",
                        "replaces": "esp_audio_libs_tpu/ops/polyphase_pallas.py:" + (
                            "319" if fused else "201"),
                        "launches": 0, "launches_of": (
                            "polyphase_fused16" if fused else "polyphase_banded") + (
                            " made through this wrapper, one per shard; not counted again in "
                            "that entry's launches_other_paths.mesh"),
                        "shards": m.size, "max_abs_err": err,
                        "max_abs_err_plain": err_plain, "ms": ms, "ms_sharded_call": call_ms,
                        "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
                        "library_ms": lib_ms})
        del got, one, per
    del xf, x2, Wt, down
    torch.cuda.empty_cache()
    return entries


def mesh_resampler(m, data, path):
    """Phase 19(b): Resampler(2048, mesh=m) at the bench configuration, fast
    mode with the fused tier off and on and exact mode, against the
    single-device Resampler on the same bytes (exact byte-equal; fast: the
    count of differing samples printed, more than 1 LSB fails), with 4
    launches per contraction per chunk; then stream_mesh() (the visible
    cards) with one card takes the single-device route."""
    import numpy as np
    import torch

    from esp_audio_libs_tpu_torch.models import Resampler, ResamplerConfiguration
    from esp_audio_libs_tpu_torch.parallel.mesh import Sharded, stream_mesh

    cfg = ResamplerConfiguration(44100.0, 16000.0, 16, 16, 2, True, True, 64, 32)
    data_dev = torch.as_tensor(data, device="cuda")
    S = m.size
    for label, exact, fused in (("fast", False, False), ("fast fused", False, True),
                                ("exact", True, False)):
        if fused:
            os.environ["EAL_RESAMPLE_FUSED16"] = "1"
        else:
            os.environ.pop("EAL_RESAMPLE_FUSED16", None)
        one = Resampler(BATCH, exact=exact, device="cuda")
        one.initialize(cfg)
        t0 = time.perf_counter()
        want = one.resample_stream(data_dev, FRAMES, CHUNKS)
        torch.cuda.synchronize()
        one_ms = (time.perf_counter() - t0) * 1e3
        msh = Resampler(BATCH, exact=exact, device="cuda", mesh=m)
        msh.initialize(cfg)
        got, counts, ms = path.run(lambda: msh.resample_stream(data_dev, FRAMES, CHUNKS))
        expect = ({"polyphase_exact": S * CHUNKS, "biquad_exact": 2 * S * CHUNKS,
                   "quantize_pack16": S * CHUNKS, "unpack16_extend": S * CHUNKS} if exact else
                  {"polyphase_fused16": S * CHUNKS, "polyphase_fused16_sharded": S * CHUNKS}
                  if fused else
                  {"polyphase_banded": S * CHUNKS, "polyphase_banded_sharded": S * CHUNKS,
                   "quantize_pack16": S * CHUNKS, "unpack16_extend": S * CHUNKS})
        if {k: counts[k] for k in expect} != expect or sum(counts.values()) != sum(expect.values()):
            fail(f"mesh resampler {label}: launches {counts}, expected {expect}")
        if not (isinstance(got[0], Sharded) and got[0].axis == 1
                and isinstance(msh.history, Sharded)):
            fail(f"mesh resampler {label}: output or history not split over the mesh")
        a = got[0].gather().cpu().numpy().view(np.int16).astype(np.int32)
        b = want[0].cpu().numpy().view(np.int16).astype(np.int32)
        d = np.abs(a - b)
        ndiff = int((d > 0).sum())
        if got[1] != want[1] or d.max() > (0 if exact else 1):
            fail(f"mesh resampler {label}: {ndiff} samples differ (max {d.max()} LSB)")
        if exact and not np.array_equal(got[2], want[2]):
            fail(f"mesh resampler {label}: clip counts differ")
        if not torch.equal(msh.history.gather(), one.history):
            fail(f"mesh resampler {label}: carried history differs")
        t0 = time.perf_counter()
        msh.resample_stream(data_dev, FRAMES, CHUNKS)
        torch.cuda.synchronize()
        ms2 = (time.perf_counter() - t0) * 1e3
        print(f"mesh (b) Resampler({BATCH}, {label}) over {S} shards: {ndiff} samples differ "
              f"from the single-device Resampler (max {d.max()} LSB), gens and history equal; "
              f"launches {expect}; {ms:.2f} ms first call, {ms2:.2f} ms second (single device "
              f"first call {one_ms:.2f} ms)")
    os.environ.pop("EAL_RESAMPLE_FUSED16", None)
    visible = stream_mesh()
    r1 = Resampler(BATCH, exact=False, device="cuda", mesh=visible)
    r1.initialize(cfg)
    one = Resampler(BATCH, exact=False, device="cuda")
    one.initialize(cfg)
    want = one.resample_stream(data_dev, FRAMES, CHUNKS)
    got, counts, ms = path.run(lambda: r1.resample_stream(data_dev, FRAMES, CHUNKS))
    if visible.size == 1 and (counts["polyphase_banded"] != CHUNKS
                              or counts["polyphase_banded_sharded"] != 0
                              or isinstance(got[0], Sharded) or not torch.equal(got[0], want[0])):
        fail(f"stream_mesh() of one card did not take the single-device route: {counts}")
    print(f"mesh (b) Resampler over stream_mesh() ({visible.size} visible card(s)): "
          f"{'the single-device route, ' if visible.size == 1 else ''}launches {counts}; "
          f"{ms:.2f} ms")
    del data_dev
    torch.cuda.empty_cache()


def mesh_flac(m, composed_blob, path):
    """Phase 19(c): phase 8's composed FLAC -> 16 kHz chain (256 streams) over
    m: decode_streams md5_ok and equal to the single-device fleet's, the
    device PCM split over the mesh and equal to the unsharded PCM, the
    resampled output equal to the unsharded chain's; 4 flac_frame launches
    (the one bucket, whole, split in 4) and 4 banded launches."""
    import numpy as np
    import torch

    from esp_audio_libs_tpu_torch.models import BatchedFLACDecoder, Resampler
    from esp_audio_libs_tpu_torch.models import ResamplerConfiguration
    from esp_audio_libs_tpu_torch.parallel.mesh import Sharded

    frames = FLAC_FRAMES * FLAC_BLOCK
    cfg = ResamplerConfiguration(44100.0, 16000.0, 16, 16, 2, True, True, 64, 32)
    one = BatchedFLACDecoder(FLAC_STREAMS, device="cuda")
    one.read_headers([composed_blob] * FLAC_STREAMS)
    bodies = [composed_blob[d.get_bytes_index():] for d in one.decoders]
    host1 = one.decode_streams(bodies)
    pcm1, _ = one.decode_streams_to_device(bodies)
    r1 = Resampler(FLAC_STREAMS, exact=False, device="cuda")
    r1.initialize(cfg)
    out1 = r1.resample_stream(pcm1, frames, 1)

    msh = BatchedFLACDecoder(FLAC_STREAMS, device="cuda", mesh=m)
    msh.read_headers([composed_blob] * FLAC_STREAMS)
    hostm, counts_h, ms_h = path.run(lambda: msh.decode_streams(bodies))
    if not all(r["md5_ok"] is True for _, r in hostm) or [p for p, _ in hostm] != \
            [p for p, _ in host1]:
        fail("mesh flac: decode_streams over the mesh is not md5_ok or differs")
    rm = Resampler(FLAC_STREAMS, exact=False, device="cuda", mesh=m)
    rm.initialize(cfg)

    def chain():
        pcm, _ = msh.decode_streams_to_device(bodies)
        return pcm, rm.resample_stream(pcm, frames, 1)

    (pcmm, outm), counts, ms = path.run(chain)
    want = {"flac_frame": m.size, "polyphase_banded": m.size}
    if counts_h["flac_frame"] != m.size or {k: counts[k] for k in want} != want:
        fail(f"mesh flac: launches {counts_h} / {counts}, expected {want}")
    if not isinstance(pcmm, Sharded) or not torch.equal(pcmm.gather(), pcm1):
        fail("mesh flac: the device PCM is not split over the mesh or differs")
    if outm[1] != out1[1] or not torch.equal(outm[0].gather(), out1[0]) or \
            not np.array_equal(outm[2], out1[2]):
        fail("mesh flac: the resampled chain differs from the unsharded chain")
    n_in = FLAC_STREAMS * frames * 2
    print(f"mesh (c) flac->16k composed {FLAC_STREAMS} streams over {m.size} shards: md5_ok all, "
          f"host decode, device PCM (split) and resampled output equal to the unsharded chain "
          f"byte for byte; launches decode {counts_h['flac_frame']} flac_frame, chain {counts}; "
          f"decode_streams {ms_h:.2f} ms, chain {ms:.2f} ms ({n_in / ms / 1e3:.1f} decoded "
          f"Msamples/s, one call)")


def mesh_mp3(m, path):
    """Phase 19(d): phase 13's 256 x 8 tonal frames, decode_run(to_device)
    over m then the mesh Resampler: PCM and output byte-equal to the
    unsharded chain, 4 mp3_granules launches per run."""
    import numpy as np
    import torch

    from esp_audio_libs_tpu_torch.models import BatchedMP3Decoder, Resampler
    from esp_audio_libs_tpu_torch.models import ResamplerConfiguration
    from esp_audio_libs_tpu_torch.parallel.mesh import Sharded

    B, F = MP3_STREAMS, MP3_FRAMES
    streams = mp3_streams("tonal", B, F, 9000)
    samples = F * 1152
    cfg = ResamplerConfiguration(44100.0, 16000.0, 16, 16, 2, True, True, 64, 32)
    pcm1, con1 = BatchedMP3Decoder(B).decode_run(streams, F, to_device=True)
    r1 = Resampler(B, exact=False, device="cuda")
    r1.initialize(cfg)
    out1 = r1.resample_stream(pcm1.view(torch.uint8), samples, 1)
    msh = BatchedMP3Decoder(B, mesh=m)
    rm = Resampler(B, exact=False, device="cuda", mesh=m)
    rm.initialize(cfg)

    def chain():
        pcm, con = msh.decode_run(streams, F, to_device=True)
        return pcm, con, rm.resample_stream(pcm.map(lambda p: p.view(torch.uint8)), samples, 1)

    (pcmm, conm, outm), counts, ms = path.run(chain)
    want = {"mp3_granules": m.size, "polyphase_banded": m.size}
    if {k: counts[k] for k in want} != want:
        fail(f"mesh mp3: launches {counts}, expected {want}")
    if not (isinstance(pcmm, Sharded) and isinstance(msh._vbuf, Sharded)) or conm != con1 \
            or not torch.equal(pcmm.gather(), pcm1):
        fail("mesh mp3: the device PCM or state is not split, or the PCM differs")
    if outm[1] != out1[1] or not torch.equal(outm[0].gather(), out1[0]) or \
            not np.array_equal(outm[2], out1[2]):
        fail("mesh mp3: the resampled chain differs from the unsharded chain")
    print(f"mesh (d) mp3->16k composed {B} streams x {F} frames over {m.size} shards: PCM, "
          f"consumed and resampled output equal to the unsharded chain byte for byte, state "
          f"split; launches {counts}; chain {ms:.2f} ms ({B * samples * 2 / ms / 1e3:.1f} "
          f"decoded Msamples/s, one call)")


def mesh_sequence(m, path, lpc_ref_path):
    """Phase 19(e): sequence parallelism over m read as a time mesh:
    sequence_parallel_resample of 4 stereo streams x 120 s at 44.1 kHz (the
    bench configuration's folded filterbank) against the single-device
    banded contraction of the whole chunk (TOL_BANDED); sequence_parallel_iir2
    on f32 [64, 4 x 2^20] bit for bit against one sequential solve;
    lpc_companion_scan on int32 [16, 2^18], orders 1-4, whole and split over
    the time mesh, bit for bit against ops/lpc.py::lpc_restore(shift=0)
    (run on the CPU by a child process meanwhile)."""
    import numpy as np
    import torch

    from esp_audio_libs_tpu_torch.ops import polyphase_kernels as pk
    from esp_audio_libs_tpu_torch.ops.polyphase import banded_weights_device
    from esp_audio_libs_tpu_torch.ops.scan import iir2_sequential
    from esp_audio_libs_tpu_torch.parallel.mesh import shard_streams
    from esp_audio_libs_tpu_torch.parallel.sequence import (lpc_companion_scan,
                                                            sequence_parallel_iir2,
                                                            sequence_parallel_resample)
    from esp_audio_libs_tpu_torch.runtime.phase_grid import PhaseState, phase_grid

    r = make_resampler(44100.0, 16000.0, 1, "cuda")
    filt, direct = r._filters.cpu().numpy(), r._direct.cpu().numpy()
    taps_p, K, off, halo = r._taps_p, r._K, r._fold_offset, r._taps_p + 8
    T_in = SEQ_SECONDS * 44100
    st = PhaseState.initial(64)
    st.advance(32.0)
    grid = phase_grid(st, 32, r.bank_flags, r.sample_ratio, T_in,
                      int(T_in * float(r.sample_ratio)) + 8)
    gen = int(grid.output_generated)

    class G:                       # the grid with the fold offset applied to win0
        win0 = grid.win0 - off
        idx1, idx2, weight, mode = grid.idx1, grid.idx2, grid.weight, grid.mode
        output_generated = gen

    gen_t = torch.Generator(device="cuda").manual_seed(23)
    x = torch.randn((SEQ_STREAMS, 2, T_in), generator=gen_t, device="cuda") * 0.3
    (y, counts_d), counts, ms = path.run(lambda: sequence_parallel_resample(
        x, filt, direct, G, m, taps_p=taps_p, K=K, halo=halo))
    if counts["polyphase_banded"] != m.size:
        fail(f"sequence_parallel_resample launched {counts}, expected {m.size} banded")
    To = y.shape[-1] // m.size
    got = torch.cat([p[..., :int(c)] for p, c in zip(y.parts, counts_d)], dim=-1)
    if got.shape[-1] != gen or any(bool(p[..., int(c):].any()) for p, c in zip(y.parts, counts_d)):
        fail("sequence_parallel_resample: output count or nonzero padded slots")
    del y
    L = -(-max(halo + T_in, K) // 128) * 128
    T_pad = -(-gen // 128) * 128
    win0x = np.zeros(T_pad, np.int32)
    win0x[:gen] = G.win0[:gen] + halo
    win0x[gen:] = win0x[gen - 1]
    pad = lambda a: torch.as_tensor(np.pad(np.asarray(a)[:gen], (0, T_pad - gen)), device="cuda")
    Wt, starts = banded_weights_device(
        r._filters, r._direct, torch.as_tensor(win0x, device="cuda"), pad(G.idx1), pad(G.idx2),
        pad(G.weight), pad(G.mode.astype(np.int32)), gen, K=K, taps_p=taps_p, L=L)
    xp = torch.nn.functional.pad(x, (halo, L - halo - T_in))
    ref = pk.polyphase_banded_cuda(xp, Wt, starts, T=gen)
    torch.cuda.synchronize()
    del Wt, xp
    torch.testing.assert_close(got, ref, **TOL_BANDED)
    err = float((got - ref).abs().max())
    del got, ref
    torch.cuda.empty_cache()
    print(f"mesh (e) sequence_parallel_resample {SEQ_STREAMS} stereo streams x {SEQ_SECONDS} s "
          f"({T_in} frames, {gen} outputs) over {m.size} segments (To={To}, halo {halo}): within "
          f"TOL_BANDED of the single-device contraction (max|d| {err:.3g}), padded slots zero; "
          f"{counts['polyphase_banded']} banded launches; {ms:.2f} ms")

    f = torch.randn((IIR_ROWS, IIR_T), generator=gen_t, device="cuda")
    p1 = torch.tensor(float(r.lowpass_coeffs[3]), device="cuda")
    p2 = torch.tensor(float(r.lowpass_coeffs[4]), device="cuda")
    z = torch.zeros(IIR_ROWS, device="cuda")
    (ys, (a, b)), counts, ms = path.run(lambda: sequence_parallel_iir2(f, p1, p2, z, z, m))
    ref, (ra, rb) = iir2_sequential(f, p1, p2, z, z)
    torch.cuda.synchronize()
    if counts["biquad_exact"] != m.size:
        fail(f"sequence_parallel_iir2 launched {counts}, expected {m.size} iir2")
    if not (same_bits(ys.gather(), ref) and same_bits(a, ra) and same_bits(b, rb)):
        fail("sequence_parallel_iir2 differs from one sequential solve")
    print(f"mesh (e) sequence_parallel_iir2 f32 [{IIR_ROWS}, {IIR_T}] over {m.size} segments: "
          f"output and final state bit for bit equal to one sequential solve; "
          f"{counts['biquad_exact']} iir2 launches; {ms:.2f} ms")
    del f, ys, ref
    torch.cuda.empty_cache()

    data, coeffs, order = (torch.as_tensor(a, device="cuda") for a in lpc_operands())
    whole, _, ms_w = path.run(lambda: lpc_companion_scan(data, coeffs, order))
    split, _, ms_s = path.run(lambda: lpc_companion_scan(shard_streams(data, m, axis=1), coeffs,
                                                         order))
    t0 = time.perf_counter()
    proc = CHILDREN["lpc"]
    log, _ = proc.communicate()
    if proc.returncode != 0:
        fail(f"the lpc_restore reference failed:\n{log}")
    want = torch.as_tensor(np.load(lpc_ref_path), device="cuda")
    if not (torch.equal(whole, want) and torch.equal(split.gather(), want)):
        fail("lpc_companion_scan differs from lpc_restore(shift=0)")
    print(f"mesh (e) lpc_companion_scan int32 [{LPC_ROWS}, {LPC_T}] orders 1-4: whole and split "
          f"over {m.size} segments bit for bit equal to lpc_restore(shift=0) on the CPU (waited "
          f"{time.perf_counter() - t0:.1f} s for it); {ms_w:.2f} ms whole, {ms_s:.2f} ms split")
    del data, whole, split
    torch.cuda.empty_cache()


def mesh_serving(m, corp, path):
    """Phase 19(f): serve_fleet's serve_mp3, composed, in-process over m at
    2048 slots x 8 frames in runs of 4 with --verify: verified, the PCM and
    the output split over the mesh in every run, 4 mp3_granules and 4 banded
    launches a run, run 1's output equal to a single-device Resampler's on
    the same PCM."""
    import numpy as np
    import torch

    from esp_audio_libs_tpu_torch.cli import serve_fleet as sf
    from esp_audio_libs_tpu_torch.models import Resampler, ResamplerConfiguration
    from esp_audio_libs_tpu_torch.ops import mp3_kernels as mk
    from esp_audio_libs_tpu_torch.ops import polyphase_kernels as pk
    from esp_audio_libs_tpu_torch.parallel.mesh import Sharded

    cstreams, cmetas = corp["mp3_composed"]
    cargs = serve_args("--streams", SERVE_SLOTS, "--min-frames", COMPOSED_FRAMES,
                       "--max-frames", COMPOSED_FRAMES, "--run-frames", COMPOSED_RUN,
                       "--rate", COMPOSED_RATE, "--seed", SERVE_SEED, "--verify")
    per_run, first, bad = [], {}, []

    def on_run(r, _slots, _bufs, res, out):
        per_run.append((mk.mp3_granules_cuda.launches, pk.polyphase_banded_cuda.launches))
        if not (isinstance(res[0], Sharded) and isinstance(out[0], Sharded)):
            bad.append(r)
        if r == 0:
            first["pcm"], first["out"] = res[0], out

    (_, runs, agg), counts, ms = path.run(lambda: sf.serve_mp3(cargs, cstreams, cmetas, on_run,
                                                                mesh=m))
    steps = [(a - pa, b - pb) for (a, b), (pa, pb) in zip(per_run, [(0, 0)] + per_run[:-1])]
    # --verify's single-stream decodes (MP3Decoder on one device) are not the mesh path
    verify = counts["mp3_granules"] - sum(a for a, _ in steps)
    path.total["mp3_granules"] -= verify
    if agg["verified"] is not True or bad or steps != [(m.size, m.size)] * len(runs):
        fail(f"mesh serving: verified {agg['verified']}, runs not split {bad}, launches per "
             f"run {steps}")
    fresh = Resampler(batch=SERVE_SLOTS, exact=False, device="cuda")
    fresh.initialize(ResamplerConfiguration(44100.0, float(COMPOSED_RATE), 16, 16, 2, True, True,
                                            64, 32))
    pcm0 = first["pcm"].gather()
    want = fresh.resample_stream(pcm0.view(torch.uint8), pcm0.shape[1] // 2, 1)
    got = first["out"]
    if not (torch.equal(got[0].gather(), want[0]) and np.array_equal(got[2], want[2])):
        fail("mesh serving: run 1's output differs from a single-device Resampler's")
    print(f"mesh (f) serve mp3 composed -> {COMPOSED_RATE} Hz over {m.size} shards: "
          f"{SERVE_SLOTS} streams x {COMPOSED_FRAMES} frames, runs of {COMPOSED_RUN}, --verify "
          f"{agg['verified']}, PCM and output split in every run, run 1 = a single-device "
          f"Resampler on the same PCM; launches per run (mp3_granules, polyphase_banded) "
          f"{steps}; samples {agg['samples']}, msps {agg['msps']}, realtime_streams "
          f"{agg['realtime_streams']}; {run_times(runs)}; {ms:.0f} ms with the verify (its "
          f"{verify} single-stream mp3_granules launches not counted as the mesh path's)")


def mesh_phase(data, composed_blob, corp, scratch_dir):
    """Phase 19: the multi-device surface on one card, split 4 ways
    (stream_mesh(["cuda:0"] * 4)). Returns (the two sharded wrappers'
    kernels-line entries, the mesh path's launch counts)."""
    import torch

    from esp_audio_libs_tpu_torch.parallel.mesh import stream_mesh

    lpc_ref = os.path.join(scratch_dir, "lpc_restore.npy")
    CHILDREN["lpc"] = subprocess.Popen([sys.executable, "-c", LPC_JOB, lpc_ref], cwd=REPO_ROOT,
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    m = stream_mesh(["cuda:0"] * MESH_SHARDS)
    entries = mesh_kernels(m, data)
    path = MeshPath()
    mesh_resampler(m, data, path)
    mesh_flac(m, composed_blob, path)
    mesh_mp3(m, path)
    mesh_sequence(m, path, lpc_ref)
    torch.cuda.empty_cache()
    mesh_serving(m, corp, path)
    for e in entries:
        e["launches"] = path.total[e["name"]]
    print(f"launches on the mesh path: {path.total}")
    for name in ("polyphase_banded_sharded", "polyphase_fused16_sharded", "polyphase_exact",
                 "biquad_exact", "flac_frame", "mp3_granules"):
        if not path.total.get(name):
            fail(f"the mesh path never launched {name}")
    return entries, path.total


def main() -> None:
    import numpy as np
    import torch

    # 1. device
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs an NVIDIA GPU")
    card = card_line()
    print(f"device: {card} | torch {torch.__version__} cuda {torch.version.cuda} | "
          f"{torch.cuda.device_count()} device(s)")
    try:
        from esp_audio_libs_tpu_torch.ops import polyphase_kernels as pk
        from esp_audio_libs_tpu_torch.ops.polyphase import polyphase_banded
        from esp_audio_libs_tpu_torch.runtime import kernels, native
    except ImportError as e:
        fail(f"the port is not importable ({e}): run from the repository root")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import tempfile
    scratch = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    start_corpus(scratch.name, "conformance")    # phase 18's input, built on one core meanwhile
    start_corpus(scratch.name, "mp3_conformance")    # phase 20's, a few seconds

    # 2. build
    t0 = time.perf_counter()
    native.host_lib()
    t1 = time.perf_counter()
    kernels.LIB_PATH.unlink(missing_ok=True)    # always compile from this checkout's sources
    report = kernels.compile_library(kernels.CSRC, kernels.LIB_PATH, ptxas_report=True)
    print(report)
    PTXAS.update(ptxas_kernels(report))
    kernels.library()
    t2 = time.perf_counter()
    from esp_audio_libs_tpu_torch.ops import mp3mxu
    mp3mxu.mxu_operators()
    t3 = time.perf_counter()
    print(f"build: libeal_host.so {t1 - t0:.1f} s, CUDA kernels {t2 - t1:.1f} s, the MXU tier's "
          f"operators {mp3mxu.mxu_operators.origin} on the host's CPU in {t3 - t2:.1f} s")
    clock = [time.perf_counter()]

    def lap(label):
        # a phase that ends while the conformance corpus is still building shared the host
        now = time.perf_counter()
        busy = CHILDREN["conformance"].poll() is None
        print(f"phase {label}: {now - clock[0]:.1f} s"
              f"{' (the conformance corpus building meanwhile)' if busy else ''}")
        clock[0] = now

    # 3. kernels against their plain versions at the slice's shapes
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, (BATCH, CHUNKS * FRAMES * 4), dtype=np.uint8)
    down = make_resampler(44100.0, 16000.0, BATCH, "cuda")
    xf, x2, Wt, starts, out_max, factor = chunk_operands(down, torch.as_tensor(data, device="cuda"))
    M, L = xf.shape
    if not torch.equal(pk.band_ranges_cuda(Wt), pk.band_ranges(Wt)):
        fail("band_ranges disagrees with its plain version at the main shape")
    ms_r = cuda_time(band_ranges_launcher(Wt), iters=20)
    ms_rw = cuda_time(lambda: pk.band_ranges_cuda(Wt))
    ms_rp = cuda_time(lambda: pk.band_ranges(Wt))
    bound_r = (Wt[:1].numel() if Wt.stride(0) == 0 else Wt.numel()) * 4 / PEAK_BYTES * 1e3
    print(f"kernel band_ranges (helper of both banded kernels) nt={Wt.shape[0]} K={Wt.shape[1]}: "
          f"equal to its plain version; {ms_r:.4f} ms per direct launch (one wrapper call "
          f"{ms_rw:.4f} ms; plain version {ms_rp:.4f} ms), bound {bound_r:.4f} ms (bytes: "
          f"the weight tiles once), {bound_r / ms_r:.1%} of it")
    k = pk.polyphase_banded_cuda(xf, Wt, starts, T=out_max)
    p = polyphase_banded(xf, Wt, starts, T=out_max)
    torch.cuda.synchronize()
    torch.testing.assert_close(k, p, **TOL_BANDED)
    err_banded = float((k - p).abs().max())
    ms_b = cuda_time(lambda: pk.polyphase_banded_cuda(xf, Wt, starts, T=out_max))
    ms_bp = cuda_time(lambda: polyphase_banded(xf, Wt, starts, T=out_max))
    lib_b = library_time(xf, Wt, starts)
    bound_b, by_b = contraction_bound(M, xf, Wt, M * out_max * 4)
    print(f"kernel polyphase_banded M={M} L={L} nt={Wt.shape[0]} K={Wt.shape[1]}: "
          f"max|d|={err_banded:.3g}, {ms_b:.4f} ms vs plain {ms_bp:.4f} ms, "
          f"library {lib_b:.4f} ms, bound {bound_b:.4f} ms ({by_b}), "
          f"{bound_b / ms_b:.1%} of the bound")

    up = make_resampler(16000.0, 44100.0, 256, "cuda")
    out_up = math.ceil(FRAMES * float(up.sample_ratio)) + 8
    nt2 = -(-out_up // 128)
    L2 = -(-(up._post_Hlen + out_up + up._post_K) // 128) * 128
    xe = torch.randn(512, L2, device="cuda") * 0.3
    W2 = up._post_W2[None].expand(nt2, up._post_K, 128)
    st2 = torch.arange(nt2, dtype=torch.int32, device="cuda") * 128
    if not torch.equal(pk.band_ranges_cuda(W2), pk.band_ranges(W2)):
        fail("band_ranges disagrees with its plain version on the shared post-filter tile")
    k2 = pk.polyphase_banded_cuda(xe, W2, st2, T=out_up)
    p2 = polyphase_banded(xe, W2, st2, T=out_up)
    torch.cuda.synchronize()
    torch.testing.assert_close(k2, p2, **TOL_BANDED)
    err_banded = max(err_banded, float((k2 - p2).abs().max()))
    ms_b2 = cuda_time(lambda: pk.polyphase_banded_cuda(xe, W2, st2, T=out_up))
    ms_b2p = cuda_time(lambda: polyphase_banded(xe, W2, st2, T=out_up))
    lib_b2 = library_time(xe, W2, st2)
    bound_b2, by_b2 = contraction_bound(512, xe, W2, 512 * out_up * 4)
    print(f"kernel polyphase_banded (post-filter) M=512 L={L2} nt={nt2} K={up._post_K}: "
          f"max|d|={float((k2 - p2).abs().max()):.3g}, {ms_b2:.4f} ms vs plain {ms_b2p:.4f} ms, "
          f"library {lib_b2:.4f} ms, bound {bound_b2:.4f} ms ({by_b2}), "
          f"{bound_b2 / ms_b2:.1%} of the bound")

    Wf = Wt * factor
    s_k, c_k = pk.polyphase_fused16_cuda(x2, Wf, starts)
    s_p, c_p = pk.polyphase_fused16_plain(x2, Wf, starts)
    torch.cuda.synchronize()
    err_fused = check_fused(s_k, c_k, s_p, c_p, "main shape")
    ndiff16 = int((s_k != s_p).sum())
    ms_f = cuda_time(lambda: pk.polyphase_fused16_cuda(x2, Wf, starts))
    ms_fp = cuda_time(lambda: pk.polyphase_fused16_plain(x2, Wf, starts))
    lib_f = library_time(x2, Wf, starts)
    width = Wt.shape[0] * 128
    bound_f, by_f = contraction_bound(M, x2, Wf, M * width * 3)
    print(f"kernel polyphase_fused16 M={M} L={L} nt={Wt.shape[0]} K={Wt.shape[1]}: "
          f"max|d|={err_fused} LSB ({ndiff16} samples), {ms_f:.4f} ms vs plain {ms_fp:.4f} ms, "
          f"library {lib_f:.4f} ms, bound {bound_f:.4f} ms ({by_f}), "
          f"{bound_f / ms_f:.1%} of the bound")

    # a ragged shape: rows past M in every block, unaligned (odd) starts
    rxf, rx2, rW, rst = ragged_operands(rng, 37, 2176, 6, 512, 318, 301, "cuda")
    rk = pk.polyphase_banded_cuda(rxf, rW, rst, T=6 * 128 - 11)
    rp = polyphase_banded(rxf, rW, rst, T=6 * 128 - 11)
    rW16 = rW * (0.05 / 32768.0)
    err_fused = max(err_fused, check_fused(*pk.polyphase_fused16_cuda(rx2, rW16, rst),
                                           *pk.polyphase_fused16_plain(rx2, rW16, rst),
                                           "ragged shape"))
    torch.cuda.synchronize()
    torch.testing.assert_close(rk, rp, **TOL_BANDED)
    err_banded = max(err_banded, float((rk - rp).abs().max()))
    print(f"kernels at the ragged shape M=37 L=2176 nt=6 K=512, starts {rst.tolist()}: "
          f"banded max|d|={float((rk - rp).abs().max()):.3g}, fused16 within 1 LSB")
    del xf, x2, Wt, Wf, k, p, k2, p2, s_k, c_k, s_p, c_p, xe, down, up
    torch.cuda.empty_cache()

    lap("3 kernels")

    # 4-5. the main path, counted
    pk.reset_launch_counts()
    os.environ.pop("EAL_RESAMPLE_FUSED16", None)
    run_stream(44100.0, 16000.0, BATCH, data, "e2e 44.1k->16k fused tier off")
    os.environ["EAL_RESAMPLE_FUSED16"] = "1"
    run_stream(44100.0, 16000.0, BATCH, data, "e2e 44.1k->16k fused tier on")
    os.environ.pop("EAL_RESAMPLE_FUSED16")
    up_data = data[:256, : CHUNKS * FRAMES * 4]
    run_stream(16000.0, 44100.0, 256, up_data, "upsample 16k->44.1k post-filter B=256")
    launches = {"polyphase_banded": pk.polyphase_banded_cuda.launches,
                "polyphase_fused16": pk.polyphase_fused16_cuda.launches}
    print(f"launches on the main path: {launches}")
    for name, n in launches.items():
        if n == 0:
            fail(f"the main path never launched {name}")

    lap("4-5 main path")

    # 6-8. FLAC
    flac, composed_blob = flac_phases()

    lap("6-8 flac")

    # 9-10. exact mode
    exact_entries = exact_kernels_phase(data)
    torch.cuda.empty_cache()
    exact_entries.append(quantize16_phase())
    torch.cuda.empty_cache()
    exact_entries.append(unpack16_phase(data))
    torch.cuda.empty_cache()
    exact_main, exact_other = exact_phase(data)
    exact_entries[0]["launches"] = exact_main["biquad_exact"]
    exact_entries[1]["launches"] = exact_main["polyphase_exact"]
    exact_entries[2]["launches"] = exact_main["quantize_pack16"]
    exact_entries[3]["launches"] = exact_main["unpack16_extend"]
    exact_entries[0]["launches_other_paths"] = {
        "upsample": exact_other["upsample"]["biquad_exact"], "cascade": exact_other["cascade"]}
    exact_entries[1]["launches_other_paths"] = {
        "upsample": exact_other["upsample"]["polyphase_exact"],
        "batched_resample": exact_other["batched_resample"]}
    print(f"launches on the exact path (6 resample_stream calls of 8 chunks): {exact_main}")

    lap("9-10 exact mode")

    # 11-13. MP3
    torch.cuda.empty_cache()
    mp3, mp3_fast = mp3_phases(lap)

    lap("12-13 mp3")

    # 14. DSP
    torch.cuda.empty_cache()
    dsp_launches, dot = dsp_phase()
    exact_entries[0]["launches_other_paths"]["dsp_biquad_f32"] = dsp_launches["biquad_exact (iir2)"]

    lap("14 dsp")

    # 15. MP3 serving: pipelined runs and checkpoint/resume
    torch.cuda.empty_cache()
    mp3["launches_other_paths"] = {"decode_run_pipelined": mp3_serving_phase()}

    lap("15 mp3 serving")

    # 16-18. the serving surface: serve_fleet, the soak, the conformance runner
    torch.cuda.empty_cache()
    corp = serving_corpora(scratch.name)
    clock[0] = time.perf_counter()    # phase 16 proper starts after its corpora
    serve_launches = serving_phase(corp)
    mp3["launches_other_paths"]["serve_fleet_ragged"] = serve_launches["ragged"]
    mp3["launches_other_paths"]["serve_fleet_composed"] = serve_launches["composed"]["mp3_granules"]
    banded_serve = serve_launches["composed"]["polyphase_banded"]
    flac["launches_other_paths"] = {"serve_fleet": serve_launches["flac"]}

    lap("16 serving")

    torch.cuda.empty_cache()
    soak_phase()

    lap("17 soak")

    torch.cuda.empty_cache()
    conformance_phase(corpus(scratch.name, "conformance"),
                      os.path.join(scratch.name, "conformance_out"))

    lap("18 conformance")

    # 19. the multi-device surface, split 4 ways on the card
    torch.cuda.empty_cache()
    sharded_entries, mesh_launches = mesh_phase(data, composed_blob, corp, scratch.name)

    lap("19 mesh")

    # 20. the MP3 conformance runner
    torch.cuda.empty_cache()
    mp3["launches_other_paths"]["mp3_conformance"] = mp3_conformance_phase(
        corpus(scratch.name, "mp3_conformance"),
        os.path.join(scratch.name, "mp3_conformance_out"))
    scratch.cleanup()

    lap("20 mp3 conformance")

    kernels_line = {"kernels": [
        {"name": "polyphase_banded", "route": "cuda",
         "source": "esp_audio_libs_tpu_torch/csrc/polyphase_banded.cu",
         "replaces": "esp_audio_libs_tpu/ops/polyphase_pallas.py:155",
         "launches": launches["polyphase_banded"], "max_abs_err": err_banded,
         "ms": ms_b, "plain_ms": ms_bp, "bound_ms": bound_b, "bound_by": by_b,
         "library_ms": lib_b,
         "launches_other_paths": {"serve_fleet_composed": banded_serve},
         "post_filter": {"ms": ms_b2, "plain_ms": ms_b2p, "bound_ms": bound_b2,
                         "bound_by": by_b2, "library_ms": lib_b2}},
        {"name": "polyphase_fused16", "route": "cuda",
         "source": "esp_audio_libs_tpu_torch/csrc/polyphase_fused16.cu",
         "replaces": "esp_audio_libs_tpu/ops/polyphase_pallas.py:270",
         "launches": launches["polyphase_fused16"], "max_abs_err": err_fused,
         "ms": ms_f, "plain_ms": ms_fp, "bound_ms": bound_f, "bound_by": by_f,
         "library_ms": lib_f},
        {"name": "band_ranges", "route": "cuda",
         "source": "esp_audio_libs_tpu_torch/csrc/band_ranges.cu",
         "replaces": "esp_audio_libs_tpu/ops/polyphase_pallas.py:155",
         "helper_of": ["polyphase_banded", "polyphase_fused16", "polyphase_banded_sharded",
                       "polyphase_fused16_sharded"],
         "launches": launches["polyphase_banded"] + launches["polyphase_fused16"],
         "max_abs_err": 0, "ms": ms_r, "ms_wrapper": ms_rw, "plain_ms": ms_rp,
         "bound_ms": bound_r, "bound_by": "bytes", "library_ms": None},
        flac, *exact_entries, mp3, *mp3_fast, dot, *sharded_entries]}
    for e in kernels_line["kernels"][:-len(sharded_entries)]:
        n = mesh_launches.get(e["name"], 0)
        if e["name"] == "band_ranges":
            n = mesh_launches["polyphase_banded"] + mesh_launches["polyphase_fused16"]
        elif e["name"] in ("polyphase_banded", "polyphase_fused16"):
            # net of the launches made through the sharded wrapper: those
            # are its entry's launches, each counted once in this line
            n -= mesh_launches[e["name"] + "_sharded"]
        e.setdefault("launches_other_paths", {})["mesh"] = n
    print(card)
    print(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
