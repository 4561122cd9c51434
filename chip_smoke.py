#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (esp_audio_libs_tpu_torch) on one
NVIDIA GPU: the quickest proof that the port builds and runs on the card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each printing a line:
  1. device  - the card's name and power limit (nvidia-smi); fails without CUDA.
  2. build   - libeal_host.so (native/build_host.sh) and the CUDA kernels
               (csrc/*.cu, nvcc for sm_90a), timed.
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
The launch counts of phases 4-5 show that the main path ran through the
kernels. The last three lines are the card line, one JSON object describing
the kernels, and ``{"ok": true, "device": {...}}``. Any failure exits
non-zero before those lines. Imports nothing of JAX.
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


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if res.returncode != 0 or not res.stdout.strip():
        fail(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


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


def make_resampler(src, dst, batch, device):
    from esp_audio_libs_tpu_torch.models import Resampler, ResamplerConfiguration
    r = Resampler(batch=batch, exact=False, device=device)
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
    from esp_audio_libs_tpu_torch.runtime.phase_grid import phase_grid

    out_max = math.ceil(FRAMES * float(r.sample_ratio)) + 8
    g = phase_grid(dataclasses.replace(r.phase), r.config.number_of_filters, r.bank_flags,
                   r.sample_ratio, FRAMES, out_max)
    L = r._slab_len(FRAMES)
    Wt, starts = banded_weights_device(r._filters, r._direct, *r._device_grids([g], out_max)[0],
                                       g.output_generated, K=r._K, taps_p=r._taps_p, L=L)
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

    # 2. build
    t0 = time.perf_counter()
    native.host_lib()
    t1 = time.perf_counter()
    kernels.LIB_PATH.unlink(missing_ok=True)    # always compile from this checkout's sources
    kernels.build(verbose=True)
    kernels.library()
    t2 = time.perf_counter()
    print(f"build: libeal_host.so {t1 - t0:.1f} s, CUDA kernels {t2 - t1:.1f} s")

    # 3. kernels against their plain versions at the slice's shapes
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, (BATCH, CHUNKS * FRAMES * 4), dtype=np.uint8)
    down = make_resampler(44100.0, 16000.0, BATCH, "cuda")
    xf, x2, Wt, starts, out_max, factor = chunk_operands(down, torch.as_tensor(data, device="cuda"))
    M, L = xf.shape
    if not torch.equal(pk.band_ranges_cuda(Wt), pk.band_ranges(Wt)):
        fail("band_ranges disagrees with its plain version at the main shape")
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

    kernels_line = {"kernels": [
        {"name": "polyphase_banded", "route": "cuda",
         "source": "esp_audio_libs_tpu_torch/csrc/polyphase_banded.cu",
         "replaces": "esp_audio_libs_tpu/ops/polyphase_pallas.py:155",
         "launches": launches["polyphase_banded"], "max_abs_err": err_banded,
         "ms": ms_b, "plain_ms": ms_bp, "bound_ms": bound_b, "bound_by": by_b,
         "library_ms": lib_b,
         "post_filter": {"ms": ms_b2, "plain_ms": ms_b2p, "bound_ms": bound_b2,
                         "bound_by": by_b2, "library_ms": lib_b2}},
        {"name": "polyphase_fused16", "route": "cuda",
         "source": "esp_audio_libs_tpu_torch/csrc/polyphase_fused16.cu",
         "replaces": "esp_audio_libs_tpu/ops/polyphase_pallas.py:270",
         "launches": launches["polyphase_fused16"], "max_abs_err": err_fused,
         "ms": ms_f, "plain_ms": ms_fp, "bound_ms": bound_f, "bound_by": by_f,
         "library_ms": lib_f}]}
    print(card)
    print(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
