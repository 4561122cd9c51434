#!/usr/bin/env python3
"""Probe variants of the port's hand kernels on one GPU.

Each variant is the checkout's ``esp_audio_libs_tpu_torch/csrc`` with one
text edit, built into its own library under ``build/variants/<name>/`` by
the package's build recipe, all variants at once, and timed against the
others in turns (first to last, then last to first) in one process.

Default mode: the banded kernels' shared main loop (``banded_tile.cuh``):

  as_is       the sources unchanged;
  one_pass    only big*big: one mma per fragment instead of three (a speed
              probe; its results are wrong by TF32 rounding);
  direct_acc  the tensor core carries the running sum (no fresh fragment
              per 8-row step, no FADD): a numerics probe;
  no_copies   every cp.async zero-fills instead of reading device memory
              (a speed probe: the compute alone);
  no_compute  the mma steps are dropped (a speed probe: the copies, barriers
              and epilogue alone).

It times the banded kernel at the main shape (the bench configuration's
first chunk, M 4096 x L 8576, 24 tiles, K 768), the fused int16 kernel at
the same shape and the banded kernel at the post-filter shape (M 512, 177
tiles sharing one tile), by CUDA events over 20 launches after 2 warm-ups,
and reports the largest error against the plain version on those operands
and, at the random main shape of tests/test_torch_kernels.py, the largest
ratio of |kernel - plain| and |kernel - exact f64| to the banded tolerance.
It also counts the mma.sync the band ranges ask for at the main shape.

``--biquad``: the exact biquad kernel (``biquad_exact.cu``, built alone):

  as_is       the sources unchanged;
  s64         tiles of 64 steps instead of 128;
  nst4        a ring of 4 stages instead of 8;
  rows32      32 lanes per block whatever the lane count (the first layout
              of this design) instead of the fewest that fill the SMs;
  no_memory   LOAD and STORE copy nothing (a speed probe: the chain and
              its hand-offs without device memory; not exact);
  <dir>       with ``--biquad-parent DIR/biquad_exact.cu ...``: each such
              file as biquad_exact.cu, named by its directory (an earlier
              design, timed in the same process).

It times one launch (CUDA events, mean of 20 direct launches through the C
entry point after 2 warm-ups, and one call through the wrapper) at the main
pre-filter chunk ([2048, 2, 8192]) and at the exact upsampling post-filter
chunk ([256, 2, 22588] with its valid_len), the operands of chip_smoke.py
phase 9, each also on its first lane alone (the measured step time), and
checks each variant's outputs and state bit for bit against the plain
version.

``--polyphase-exact``: the exact polyphase kernel (``polyphase_exact.cu``
with ``exact_async.cuh``, built alone):

  as_is       the sources unchanged;
  r8          8 rows per work item on the fast path instead of 16;
  nst3        a ring of 3 stages instead of 2;
  spread1     consumer lanes on neighbouring outputs, whatever the windows
              (no spread picked per item);
  no_stage    the producer copies no window (a speed probe: the dots on
              stale stages; not exact);
  no_dot      one 4-tap step of the dots instead of taps / 4 (a speed
              probe: the copies, hand-offs and stores; not exact);
  <dir>       with ``--polyphase-exact-parent DIR/polyphase_exact.cu ...``:
              each such file as polyphase_exact.cu, named by its directory;
              with ``--parent-probes`` also that file's probes ``no_stage``
              (windows not staged), ``no_bank`` (the filterbank read from
              global memory) and ``no_dot`` (one tap), edits of the first
              design (``git show 54d10d9:esp_audio_libs_tpu_torch/csrc/
              polyphase_exact.cu``), named ``<dir>_<probe>``.

It times one launch (CUDA events, mean of 20 direct launches through the C
entry point after 2 warm-ups) at the main chunk ([4096, 8264] -> 2981
outputs) and the exact upsampling chunk ([512, 8264] -> 22588), the
operands of chip_smoke.py phase 9, checks each variant bit for bit against
the plain version there (with and without the second dot, and on 13 rows),
and prints each library's ptxas report and SASS opcode counts (cuobjdump).
``--variants`` with no names times only the parents.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 tools/kernel_variants.py [--variants as_is one_pass ...]
    python3 tools/kernel_variants.py --biquad [--biquad-parent build/parent/biquad_exact.cu]
    python3 tools/kernel_variants.py --polyphase-exact \
        [--polyphase-exact-parent build/pr4/polyphase_exact.cu --parent-probes no_dot]

The last line is one JSON object with the means.
"""

from __future__ import annotations

import argparse
import ctypes as C
import json
import math
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from esp_audio_libs_tpu_torch.ops import biquad_kernels as bk  # noqa: E402
from esp_audio_libs_tpu_torch.ops import polyphase_kernels as pk  # noqa: E402
from esp_audio_libs_tpu_torch.ops.polyphase import polyphase_banded  # noqa: E402
from esp_audio_libs_tpu_torch.runtime import kernels  # noqa: E402

OUT = REPO / "build" / "variants"
RTOL, ATOL = cs.TOL_BANDED["rtol"], cs.TOL_BANDED["atol"]

_THREE_PASSES = '''          mma_tf32(d[ni], as, bb[ni]);
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_tf32(d[ni], ab, bs[ni]);
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_tf32(d[ni], ab, bb[ni]);
'''
_FRESH_SUM = _THREE_PASSES.join(['''        float d[4][4];
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
          for (int e = 0; e < 4; ++e) d[ni][e] = 0.0f;
''', '''#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[4 * q + ni][e] = __fadd_rn(acc[4 * q + ni][e], d[ni][e]);
'''])
_COMPUTE_HEAD = '''#pragma unroll
    for (int sub = 0; sub < BK / 8; ++sub) {
      const int ka = k0 + 8 * sub;
      if (ka > ke || ka + 7 < kb) continue;
'''

VARIANTS = {
    "as_is": [],
    "one_pass": [(_THREE_PASSES, '''          mma_tf32(d[ni], ab, bb[ni]);
        }
''')],
    "direct_acc": [(_FRESH_SUM, '''#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_tf32(acc[4 * q + ni], as, bb[ni]);
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_tf32(acc[4 * q + ni], ab, bs[ni]);
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_tf32(acc[4 * q + ni], ab, bb[ni]);
''')],
    "no_copies": [('"r"(valid ? 16 : 0)', '"r"(0)')],
    "no_compute": [(_COMPUTE_HEAD, '''    if (sh == 99 && As[0] == Tin(1) && Bs[0] == 2.0f) acc[0][0] += 1.0f;
#pragma unroll
    for (int sub = 0; sub < 0; ++sub) {
      const int ka = k0 + 8 * sub;
      if (ka > ke || ka + 7 < kb) continue;
''')],
}


_LANES = "return static_cast<int>(min(static_cast<long long>(a.rows), a.n - lane0));"

BIQUAD_VARIANTS = {
    "as_is": [],
    "s64": [("constexpr int S = 128;", "constexpr int S = 64;")],
    "nst4": [("constexpr int NST = 8;", "constexpr int NST = 4;")],
    "rows32": [("  a.rows = 1;\n", "  a.rows = LANES;\n")],
    "no_memory": [(_LANES, "return 0;")],
}
BIQUAD_ENTRIES = ("eal_biquad_df1", "eal_iir2_sequential")

# probes of the first exact polyphase kernel (the parent of its redesign:
# `git show 54d10d9:esp_audio_libs_tpu_torch/csrc/polyphase_exact.cu`)
PR4_PROBES = {
    "no_stage": [("for (int c = tid; c < span; c += TT)", "for (int c = tid; c < 0; c += TT)")],
    "no_bank": [("a.bank_smem = static_cast<long long>(nf) * (taps + 1) * 4 <= BANK_SMEM_MAX;",
                 "a.bank_smem = false;")],
    "no_dot": [("for (int k = 0; k < a.taps; ++k) {", "for (int k = a.taps - 1; k < a.taps; ++k) {")],
}
EXACT_VARIANTS = {
    "as_is": [],
    "r8": [("constexpr int R = 16;", "constexpr int R = 8;")],
    "nst3": [("constexpr int NST = 2;", "constexpr int NST = 3;")],
    "spread1": [("const int spread = pick_spread(w, pend);", "const int spread = 1;")],
    "no_stage": [("bytes = static_cast<uint32_t>(rows) * (hc - lo) * 4u;", "bytes = 0;")],
    "no_dot": [("for (int k = 0; k < taps; k += 4) {", "for (int k = taps - 4; k < taps; k += 4) {")],
}


def make_variant(name: str, target: str, edits, sources, replace_with=None) -> Path:
    """``sources`` copied into build/variants/<name>/, then ``target`` (there)
    replaced by the file ``replace_with`` if given, and edited by ``edits``."""
    dst = OUT / name
    shutil.rmtree(dst, ignore_errors=True)
    dst.mkdir(parents=True)
    for src in sources:
        shutil.copy(src, dst / src.name)
    if replace_with is not None:
        shutil.copy(replace_with, dst / target)
    path = dst / target
    text = path.read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name}: its edit no longer matches {target}")
        text = text.replace(old, new)
    path.write_text(text)
    return dst


def build_all(dirs, entries=tuple(kernels.SIGNATURES)):
    """Build every variant directory with the package's own recipe
    (``kernels.compile_library``), all at once, and bind the C entry points
    ``entries``; returns {name: (CDLL, ptxas lines)}."""
    with ThreadPoolExecutor(len(dirs)) as pool:
        outs = dict(zip(dirs, pool.map(
            lambda d: kernels.compile_library(d, d / "lib.so", ptxas_report=True), dirs.values())))
    libs = {}
    for name, out in outs.items():
        report = [ln.strip() for ln in out.splitlines() if "registers" in ln or "spill" in ln]
        libs[name] = (kernels.bind(C.CDLL(str(dirs[name] / "lib.so")), entries), report)
    return libs


def mma_count(Wt: torch.Tensor, M: int) -> int:
    """mma.sync m16n8k8 of one launch: per tile and 32-column group, the
    8-row steps (aligned to the block's 32-row stages) that meet the group's
    band, times 4 n8 fragments, 3 passes and 8 warps per 128-row block."""
    r = pk.band_ranges(Wt).cpu().numpy()
    nt = Wt.shape[0]
    steps = 0
    for i in range(nt):
        rr = r[0 if r.shape[0] == 1 else i]
        kb, ke = rr[:, 0].min(), rr[:, 1].max()
        if kb > ke:
            continue
        base = kb // 32 * 32
        for lo, hi in rr:
            steps += sum(1 for ka in range(base, ke + 1, 8) if ka <= hi and ka + 7 >= lo)
    return steps * 4 * 3 * 8 * math.ceil(M / 128)


def biquad_main(args, card: str) -> None:
    """--biquad: the exact biquad's variants at its two launch shapes."""
    names = args.variants or list(BIQUAD_VARIANTS)
    src = kernels.CSRC / "biquad_exact.cu"
    sources = [src, kernels.CSRC / "exact_async.cuh"]
    dirs = {name: make_variant(f"biquad_{name}", src.name, BIQUAD_VARIANTS[name], sources)
            for name in names}
    for path in args.biquad_parent:
        name = path.resolve().parent.name
        dirs[name] = make_variant(f"biquad_{name}", src.name, [], sources, path)
    libs = build_all(dirs, BIQUAD_ENTRIES)
    for name, (_, report) in libs.items():
        print(f"{name}: {' | '.join(report)}")

    data = np.random.default_rng(0).integers(0, 256, (cs.BATCH, cs.FRAMES * 4), dtype=np.uint8)
    ops = cs.biquad_operands(data)
    plains = {key: bk.biquad_df1_plain(x, c, st, valid_len=vl)
              for key, (x, c, st, vl) in ops.items()}
    results = {name: [] for name in libs}
    for name in list(libs) + list(libs)[::-1]:
        kernels.library = lambda name=name: libs[name][0]
        row = {}
        for key, (x, c, st, vl) in ops.items():
            y, s_out = bk.biquad_df1_cuda(x, c, st, valid_len=vl)
            torch.cuda.synchronize()
            y_p, s_p = plains[key]
            row[f"{key}_bit_exact"] = float(cs.same_bits(y, y_p) and all(
                cs.same_bits(a, b) for a, b in zip(s_out, s_p)))
            ms, ms_wrapper, ms_one, _, bound_ms, _, _ = cs.biquad_timing(x, c, st, vl)
            row[f"{key}_ms"] = ms
            row[f"{key}_wrapper_ms"] = ms_wrapper
            row[f"{key}_one_lane_ns_per_step"] = ms_one / x.shape[-1] * 1e6
            row[f"{key}_bound_ms"] = bound_ms
        results[name].append(row)
        print(name, json.dumps(row))
    means = {name: {key: float(np.mean([r[key] for r in rows])) for key in rows[0]}
             for name, rows in results.items()}
    for name, m in means.items():
        print(f"{name}: main {m['main_ms']:.4f} ms ({m['main_one_lane_ns_per_step']:.2f} ns/step "
              f"alone), upsample {m['upsample_ms']:.4f} ms "
              f"({m['upsample_one_lane_ns_per_step']:.2f} ns/step alone), bit-exact "
              f"{m['main_bit_exact'] == 1.0 and m['upsample_bit_exact'] == 1.0} "
              f"(means of 2 turns)")
    print(json.dumps({"card": card, "device": torch.cuda.get_device_name(0), "variants": means}))


def sass_histogram(lib: Path, kernel: str) -> str:
    """The most frequent SASS opcodes of the functions of ``lib`` whose
    mangled name holds ``kernel`` (cuobjdump), as one text line."""
    cuobjdump = Path(kernels._nvcc()).parent / "cuobjdump"
    res = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True)
    counts, inside = {}, False
    for line in res.stdout.splitlines():
        if "Function :" in line:
            inside = kernel in line
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if inside and m:
            op = m.group(1)
            counts[op] = counts.get(op, 0) + 1
    top = sorted(counts.items(), key=lambda kv: -kv[1])[:24]
    return ", ".join(f"{op} {n}" for op, n in top) or f"no SASS ({res.stderr.strip()[:200]})"


def polyphase_exact_main(args, card: str) -> None:
    """--polyphase-exact: the exact polyphase kernel's variants, earlier
    sources and their probes at its two launch shapes."""
    names = list(EXACT_VARIANTS) if args.variants is None else args.variants
    src = kernels.CSRC / "polyphase_exact.cu"
    sources = [src, kernels.CSRC / "exact_async.cuh"]
    dirs = {name: make_variant(f"exact_{name}", src.name, EXACT_VARIANTS[name], sources)
            for name in names}
    for path in args.polyphase_exact_parent:
        parent = path.resolve().parent.name
        dirs[parent] = make_variant(f"exact_{parent}", src.name, [], sources, path)
        for probe in args.parent_probes:
            dirs[f"{parent}_{probe}"] = make_variant(f"exact_{parent}_{probe}", src.name,
                                                     PR4_PROBES[probe], sources, path)
    libs = build_all(dirs, ("eal_polyphase_exact",))
    for name, (_, report) in libs.items():
        print(f"{name}: {' | '.join(report)}")
        print(f"{name} SASS: {sass_histogram(dirs[name] / 'lib.so', 'polyphase_exact')}")

    data = np.random.default_rng(0).integers(0, 256, (cs.BATCH, cs.FRAMES * 4), dtype=np.uint8)
    ops = cs.polyphase_operands(data)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = cs.max_clock_mhz()
    checks = {}          # (shape, compute_second, rows) -> (operands, plain output)
    for key, (xext, fb, grid, half, second) in ops.items():
        for sec, rows in ((second, None), (False, None), (second, 13)):
            xe = xext[:rows].contiguous()
            checks[(key, sec, xe.shape[0])] = ((xe, fb, grid, half, sec), pk.polyphase_exact_plain(
                xe, fb, *grid, half=half, compute_second=sec))
    work = {key: cs.polyphase_work(xext, fb, grid) for key, (xext, fb, grid, _, _) in ops.items()}
    for key, (nbytes, n_ops) in work.items():
        print(f"{key}: {nbytes} B, {n_ops} FP32 ops: bound {nbytes / cs.PEAK_BYTES * 1e3:.4f} ms "
              f"(bytes), FMA-free issue floor {n_ops / (sms * 128 * mhz * 1e6) * 1e3:.4f} ms (an "
              f"estimate: {sms} SMs x 128 lanes at {mhz:.0f} MHz)")
    results = {name: [] for name in libs}
    for name in list(libs) + list(libs)[::-1]:
        lib = libs[name][0]
        row = {}
        for key, (xext, fb, grid, half, second) in ops.items():
            exact = True
            for (k, _, _), (operands, want) in checks.items():
                if k == key:
                    got = cs.polyphase_launcher(*operands, lib=lib)()
                    torch.cuda.synchronize()
                    exact = exact and cs.same_bits(got, want)
            row[f"{key}_bit_exact"] = float(exact)
            row[f"{key}_ms"] = cs.cuda_time(cs.polyphase_launcher(xext, fb, grid, half, second,
                                                                  lib=lib), iters=20)
        results[name].append(row)
        print(name, json.dumps(row))
    means = {name: {key: float(np.mean([r[key] for r in rows])) for key in rows[0]}
             for name, rows in results.items()}
    for name, m in means.items():
        print(f"{name}: main {m['main_ms']:.4f} ms, upsample {m['upsample_ms']:.4f} ms, "
              f"bit-exact {m['main_bit_exact'] == 1.0 and m['upsample_bit_exact'] == 1.0} "
              f"(means of 2 turns, 20 direct launches each)")
    print(json.dumps({"card": card, "device": torch.cuda.get_device_name(0), "variants": means}))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--biquad", action="store_true",
                    help="probe the exact biquad kernel instead of the banded main loop")
    ap.add_argument("--biquad-parent", type=Path, nargs="+", default=[],
                    help="with --biquad: earlier biquad_exact.cu files, each timed as a "
                         "variant named by its directory")
    ap.add_argument("--polyphase-exact", action="store_true",
                    help="probe the exact polyphase kernel instead of the banded main loop")
    ap.add_argument("--polyphase-exact-parent", type=Path, nargs="+", default=[],
                    help="with --polyphase-exact: earlier polyphase_exact.cu files, each timed "
                         "as a variant named by its directory")
    ap.add_argument("--parent-probes", nargs="+", default=[], choices=sorted(PR4_PROBES),
                    help="with --polyphase-exact-parent: these probes of each parent too")
    ap.add_argument("--variants", nargs="*", default=None,
                    choices=sorted(set(VARIANTS) | set(BIQUAD_VARIANTS) | set(EXACT_VARIANTS)))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("kernel_variants: needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
                            capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {card}, max SM clock {clocks}")
    if args.biquad:
        biquad_main(args, card)
        return
    if args.polyphase_exact:
        polyphase_exact_main(args, card)
        return
    names = args.variants or list(VARIANTS)
    sources = list(kernels.CSRC.glob("*.cu")) + list(kernels.CSRC.glob("*.cuh"))
    libs = build_all({name: make_variant(name, "banded_tile.cuh", VARIANTS[name], sources)
                      for name in names})
    for name, (_, report) in libs.items():
        print(f"{name}: {' | '.join(report)}")

    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, (cs.BATCH, cs.FRAMES * 4), dtype=np.uint8)
    down = cs.make_resampler(44100.0, 16000.0, cs.BATCH, "cuda")
    xf, x2, Wt, starts, out_max, factor = cs.chunk_operands(down, torch.as_tensor(data, device="cuda"))
    Wf = Wt * factor
    up = cs.make_resampler(16000.0, 44100.0, 256, "cuda")
    out_up = math.ceil(cs.FRAMES * float(up.sample_ratio)) + 8
    nt2 = -(-out_up // 128)
    L2 = -(-(up._post_Hlen + out_up + up._post_K) // 128) * 128
    xe = torch.randn(512, L2, device="cuda") * 0.3
    W2 = up._post_W2[None].expand(nt2, up._post_K, 128)
    st2 = torch.arange(nt2, dtype=torch.int32, device="cuda") * 128
    p_main = polyphase_banded(xf, Wt, starts, T=out_max)
    s_plain, _ = pk.polyphase_fused16_plain(x2, Wf, starts)
    p_post = polyphase_banded(xe, W2, st2, T=out_up)

    # the random main shape of tests/test_torch_kernels.py::test_banded_kernel_matches_plain
    g = np.random.default_rng(4096)
    rx = torch.from_numpy(g.standard_normal((4096, 8576)).astype(np.float32)).cuda()
    rW = np.zeros((24, 768, 128), np.float32)
    for i in range(24):
        for j in range(128):
            o = g.integers(0, 768 - 318)
            rW[i, o:o + 318, j] = g.standard_normal(318).astype(np.float32)
    rW = torch.from_numpy(rW).cuda()
    rs = torch.from_numpy(np.minimum(np.arange(24) * 359, 8576 - 768).astype(np.int32)).cuda()
    rT = 24 * 128 - 11
    r_plain = polyphase_banded(rx, rW, rs, T=rT)
    r_exact = polyphase_banded(rx.double(), rW.double(), rs, T=rT)
    tol = ATOL + RTOL * r_plain.abs()
    print(f"mma.sync per launch at the main shape: {mma_count(Wt, xf.shape[0])}; "
          f"random main shape, plain vs exact: {float(((r_plain.double() - r_exact).abs() / tol).max()):.4f} of the tolerance")

    results = {name: [] for name in libs}
    for name in list(libs) + list(libs)[::-1]:
        kernels.library = lambda name=name: libs[name][0]
        k = pk.polyphase_banded_cuda(xf, Wt, starts, T=out_max)
        s16, _ = pk.polyphase_fused16_cuda(x2, Wf, starts)
        k2 = pk.polyphase_banded_cuda(xe, W2, st2, T=out_up)
        rk = pk.polyphase_banded_cuda(rx, rW, rs, T=rT)
        torch.cuda.synchronize()
        row = {
            "banded_ms": cs.cuda_time(lambda: pk.polyphase_banded_cuda(xf, Wt, starts, T=out_max), 20),
            "fused16_ms": cs.cuda_time(lambda: pk.polyphase_fused16_cuda(x2, Wf, starts), 20),
            "post_ms": cs.cuda_time(lambda: pk.polyphase_banded_cuda(xe, W2, st2, T=out_up), 20),
            "err_main": float((k - p_main).abs().max()),
            "err_fused_lsb": int((s16.int() - s_plain.int()).abs().max()),
            "err_post": float((k2 - p_post).abs().max()),
            "random_vs_plain_tol": float(((rk - r_plain).abs() / tol).max()),
            "random_vs_exact_tol": float(((rk.double() - r_exact).abs() / tol).max()),
        }
        results[name].append(row)
        print(name, json.dumps(row))
    means = {name: {key: float(np.mean([r[key] for r in rows])) for key in rows[0]}
             for name, rows in results.items()}
    for name, m in means.items():
        print(f"{name}: banded {m['banded_ms']:.4f} ms, fused16 {m['fused16_ms']:.4f} ms, "
              f"post-filter {m['post_ms']:.4f} ms (means of 2 turns)")
    print(json.dumps({"card": card, "device": torch.cuda.get_device_name(0), "variants": means}))


if __name__ == "__main__":
    main()
