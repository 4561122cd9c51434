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

``--dotprod``: the exact dot kernel (``dotprod_exact.cu`` with
``exact_async.cuh``, built alone):

  as_is       the sources unchanged;
  nst2, nst4, nst6
              a ring of 2, 4 or 6 stages instead of 3 (3 blocks, 1 block and
              1 block an SM instead of 2);
  rows16      row groups of 16 rows (half the CHAIN warp idle, smaller
              stages, more resident blocks an SM) instead of 32;
  u4, u16     CHAIN batches of 4 or 16 chunks (16 or 64 columns) instead
              of 8;
  unroll4     CHAIN's batch loop unrolled 4 times;
  prefetch    LOAD prefetches the two tensor maps before its first copy;
  c256        tiles of 256 columns (one block an SM);
  no_chain    CHAIN adds nothing (a speed probe: the copies and hand-offs
              alone; not exact);
  no_copies   LOAD copies nothing on the tensor path (a speed probe: the
              chains on stale stages; not exact);
  <dir>       with ``--dotprod-parent DIR/dotprod_exact.cu ...``: each such
              file as dotprod_exact.cu, named by its directory (an earlier
              design, e.g. ``git show
              551999b:esp_audio_libs_tpu_torch/csrc/dotprod_exact.cu``); with
              ``--parent-probes`` also that file's probes ``no_chain`` (warp
              0 adds nothing) and ``no_copies`` (every load reads nothing),
              edits of that first design, named ``<dir>_<probe>``.

It times one launch (CUDA events, mean of 20 direct launches through
``eal_dotprod_exact`` after 2 warm-ups, queued behind a sleeping kernel so
that the host's enqueue does not pace them: ``chip_smoke.cuda_time_queued``;
in turns) at both ``chip_smoke.DOT_SHAPES``: [4096, 8192] on one operand set
(268 MB, past L2), [65536, 64] over ``chip_smoke.DOT_ROTATION`` operand sets
in turn (one set, 33.8 MB, fits in the 50 MB L2; four do not), on one set,
and rotated without the queue (what the host's enqueue allows); and at
[65536, 0] (no column: the launch, the persistent blocks and their +0
stores alone). It checks
the exact variants bit for bit against ``dotprod_exact_plain`` at both
shapes and on ``chip_smoke.dot_ragged_cases``, and prints each library's
ptxas report and the kernel's SASS opcode counts.

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

``--flac``: the FLAC frame kernel (``flac_frame.cu`` with ``exact_async.cuh``,
built alone):

  as_is       the sources unchanged;
  nst8        a ring of 8 stages instead of 4;
  s128        tiles of 128 steps (96 at W = 12) instead of 64 (48);
  one_tap     each step adds only c[W-1] and c[0]'s products (a speed
              probe: the multiply-adds off the chain dropped; not exact);
  no_load     LOAD reads no memory (a speed probe, not exact);
  no_pack     PACK writes nothing (a speed probe, not exact);
  <dir>       with ``--flac-parent DIR/flac_frame.cu ...``: each such file as
              flac_frame.cu, named by its directory; with ``--parent-probes``
              also that file's probes, edits of the design before the
              transposed one (``git show
              7302bf5:esp_audio_libs_tpu_torch/csrc/flac_frame.cu``):
              ``one_tap`` (the dot cut to its newest term), ``no_pack``,
              ``no_load`` (the helpers pack / load nothing; not exact) and
              ``transposed`` (the transposed-form recurrence in that kernel,
              exact), named ``<dir>_<probe>``.

It times one launch (CUDA events, mean of 20 direct launches through
``eal_flac_frame`` after 2 warm-ups, in turns) at the main path's launches
(``chip_smoke.flac_shapes``: one dispatch of 512 frames x 2 x 4096, the
4096-frame bucket, one lane alone, and order-12 and order-32 dispatches)
and two more (the dispatch's first block alone, and the dispatch on the
int16 plane its escapes stand for), checks all but the lone lane byte for
byte against ``flac_frame_plain``, prints each library's ptxas report and
the SASS opcode counts of ``flac_frame_kernel<8, false, int8_t>`` (its full
listing goes to ``build/variants/flac_<variant>/sass.txt``), and samples
the SM clock (nvidia-smi) while dispatch launches run.

``--mp3``: the MP3 granule kernel (``mp3_granules.cu``, built alone):

  as_is       the sources unchanged;
  mb2, mb4    registers capped for 2 or 4 blocks a SM instead of 3;
  no_prefetch each granule's spectra loaded when it starts, not a granule
              ahead (exact);
  no_dequant, no_reduce, no_butterfly, no_imdct, no_fdct, no_pqmf
              speed probes: that stage cut out (not exact; no_reduce: the
              dequantizer's warp reductions);
  no_b12      a speed probe: the granule's first two barriers dropped;
  <dir>       with ``--mp3-parent DIR/mp3_granules.cu ...``: each such file as
              mp3_granules.cu, named by its directory; with ``--parent-probes``
              also that file's probes, edits of the first design (``git show
              ebe6481:esp_audio_libs_tpu_torch/csrc/mp3_granules.cu``), each a
              speed probe that cuts out one stage or its barriers (not exact):
              ``no_granules`` (the granule loop: what staging the constants
              and the state costs), ``no_dequant`` (the dequantizer call),
              ``no_expand`` (the per-sample parameter expansion),
              ``no_stereo``, ``no_butterfly``, ``no_imdct``, ``no_fdct``,
              ``no_fifo`` (the 18 FIFO steps), ``fifo_one_step`` (one of
              them) and ``fifo_no_sync`` (their 36 barriers), named
              ``<dir>_<probe>``.

It times one launch (CUDA events, mean of 20 direct launches through
``eal_mp3_granules`` after 2 warm-ups, in turns) on phase 11's operands
(``chip_smoke.mp3_run_operands``: tonal MPEG-1 44.1 kHz stereo streams, 8
frames) at B = 256 and 2048 x G = 16, checks each variant byte for byte
(PCM, state, UB flag) against ``mp3_granules_plain`` there and on small
mixed-frame runs of the four batch formats (two runs in a row, B = 5),
prints each library's ptxas report, the SASS opcode counts of the kernel
(its listing goes to ``build/variants/mp3_<variant>/sass.txt``) and the
multiplies in its PQMF tap loops (``IMAD.WIDE`` or longer sequences), and
samples the SM clock while B = 2048 launches run.

``--mp3f32``: the mirror tier's MP3 kernel (``mp3_granules_f32.cu``, built
alone with ``mp3_common.cuh``):

  as_is       the sources unchanged;
  mb2, mb4    registers capped for 2 or 4 blocks a SM instead of 3;
  pqmf_u1, pqmf_u8
              the PQMF's tap loop unrolled 1 or 8 times instead of 2;
  side_late   the next granule's side row read when it is stored, not a
              stage ahead;
  no_dequant, no_imdct, no_fdct, no_pqmf
              speed probes: that stage cut out (not within the tolerance);
  <dir>       with ``--mp3f32-parent DIR/mp3_granules_f32.cu ...``: each such
              file as mp3_granules_f32.cu, named by its directory; with
              ``--parent-probes`` also that file's probes, edits of the first
              design (``git show
              a43feee:esp_audio_libs_tpu_torch/csrc/mp3_granules_f32.cu``):
              ``mb3`` (registers for 3 blocks a SM instead of 2), and the speed
              probes ``no_dequant``, ``no_imdct``, ``no_fdct``, ``no_pqmf`` and
              ``no_hist_copy`` (the 15 carried FIFO steps not moved to the
              front of the history, nor the barrier before it), named
              ``<dir>_<probe>``.

It times one launch (CUDA events, mean of 20 direct launches through
``eal_mp3_granules_f32`` after 2 warm-ups, in turns) on phase 11's operands
at B = 256 and 2048 x G = 16, holds each variant to
``mp3_granules_f32_plain`` within 1 LSB of PCM and ``MP3F_STATE_RTOL`` of
the f32 state's scale (the integer state equal) there and on mixed-frame
runs of the four batch formats (two runs in a row, B = 5), prints each
library's ptxas report and the kernel's SASS opcode counts (listing under
``build/variants/mp3f32_<variant>/sass.txt``), and samples the SM clock
while B = 2048 launches run.

``--mxu-pre``: the MXU tier's first step kernel (``mp3_mxu_step.cu``, built
alone; ``eal_mp3_mxu_pre``):

  as_is       the sources unchanged;
  no_fifo     the FIFO block not copied into the GEMM row (a speed probe);
  no_px       the overlap product over one input instead of nine (a speed
              probe);
  <dir>       with ``--mxu-pre-parent DIR/mp3_mxu_step.cu ...``: each such file
              as mp3_mxu_step.cu, named by its directory; with
              ``--parent-probes`` also that file's probes ``no_fifo`` and
              ``no_px``, edits of the first design (``git show
              a43feee:esp_audio_libs_tpu_torch/csrc/mp3_mxu_step.cu``), named
              ``<dir>_<probe>``.

It times one launch (CUDA events, mean of 20 direct launches after 2
warm-ups, and the same queued behind a sleeping kernel, in turns) on
granule 0 of phase 11b's tonal run from the state the run leaves, at B =
256 and 2048, and holds each variant at every granule step of the checks of
``--mp3f32`` (``mp3mxu.mxu_run`` with the rest of each step plain) to
``mxu_pre_plain`` within ``MP3F_STATE_RTOL`` of the scale, the integer state
equal, the run continuing from the kernel's results.

``--mxu-post``: the MXU tier's second step kernel (``mp3_mxu_step.cu``,
built alone; ``eal_mp3_mxu_post``):

  as_is       the sources unchanged;
  parts1      one block a stream (its first layout), two FIFO groups and
              at most one PCM quad a thread;
  t160x4      four blocks of 160 threads a stream;
  pcm_high    the PCM quads on the stream's last threads (which have the
              fewest FIFO groups) instead of its first;
  streaming   evict-first loads of acc and newv (``__ldcs``) and streaming
              PCM stores (``__stcs``);
  keep_plain  keep's groups read by plain loads instead of the read-only
              path;
  no_pcm      no PCM: the FIFO merge alone (a speed probe);
  no_fifo     no FIFO merge: the quantization alone (a speed probe);
  <dir>       with ``--mxu-post-parent DIR/mp3_mxu_step.cu ...``: each such
              file as mp3_mxu_step.cu, named by its directory; with
              ``--parent-probes`` also that file's probes ``no_pcm`` and
              ``no_fifo``, edits of the first design (``git show
              0bdb5de:esp_audio_libs_tpu_torch/csrc/mp3_mxu_step.cu``),
              named ``<dir>_<probe>``.

It times one launch (CUDA events, mean of 40 direct launches after 2
warm-ups, unqueued and queued behind a sleeping kernel, in turns) on the
accumulators and written slots of granule 0 of phase 11b's tonal run (the
plain step from zero state, the probed mask of its phase) at B = 256 and
2048 stereo and B = 256 mono, each on one operand set (hot: the GEMMs have
just written it, L2 holds it at B = 256) and rotated over enough copies
(at least four, 100 MB together) that L2 cannot serve them, beside the
bytes bound (``chip_smoke.mxu_post_bytes``), and a run of
``mp3mxu.mxu_steps`` (the tonal run's 16 granule steps: the package's pre
kernel, the two GEMMs and the variant's post; mean of 5 after 2, the state
carried on) at B = 256 and 2048. It holds each exact variant to
``mxu_post_plain`` bit for bit on ``chip_smoke.mxu_post_cases`` and at
every granule step of the checks of ``--mp3f32`` (``mp3mxu.mxu_run`` with
the rest of each step plain, the run continuing from the kernel's results).

``--quantize16``: the quantize-and-pack kernel (``pcm_quantize16.cu``,
built alone):

  as_is       the sources unchanged (1024 threads, 4 frames in flight each);
  u2, u8      2 or 8 frames in flight a thread instead of 4;
  t256, t512  blocks of 256 (the first design) or 512 threads instead of
              1024; ``t256_u8``, ``t512_u8``: with 8 frames in flight;
  streaming   evict-first loads (``__ldcs``) and streaming stores
              (``__stcs``); ``ldcs``, ``stcs``: one of the two.

It times one launch (CUDA events, mean of 40 direct launches after 2
warm-ups, queued behind a sleeping kernel, in turns) at both cells' chunks,
[2048, 2, 2981] and [2048, 2, 22587], on chip_smoke.py phase 9b's samples,
beside the bytes bound (``chip_smoke.quantize16_bytes``), and holds every
variant to ``quantize_pack16_plain`` byte for byte there and on
``chip_smoke.quantize16_cases``.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 tools/kernel_variants.py [--variants as_is one_pass ...]
    python3 tools/kernel_variants.py --biquad [--biquad-parent build/parent/biquad_exact.cu]
    python3 tools/kernel_variants.py --dotprod \
        [--dotprod-parent build/pr11/dotprod_exact.cu --parent-probes no_chain no_copies]
    python3 tools/kernel_variants.py --polyphase-exact \
        [--polyphase-exact-parent build/pr4/polyphase_exact.cu --parent-probes no_dot]
    python3 tools/kernel_variants.py --flac \
        [--flac-parent build/pr7/flac_frame.cu --parent-probes one_tap no_pack no_load]
    python3 tools/kernel_variants.py --mp3 \
        [--mp3-parent build/parent/mp3_granules.cu --parent-probes no_fifo no_fdct]
    python3 tools/kernel_variants.py --mp3f32 [--variants ...] \
        [--mp3f32-parent build/pr16/mp3_granules_f32.cu --parent-probes no_pqmf no_hist_copy]
    python3 tools/kernel_variants.py --mxu-pre \
        [--mxu-pre-parent build/pr16/mp3_mxu_step.cu --parent-probes no_fifo]
    python3 tools/kernel_variants.py --mxu-post [--variants ...] \
        [--mxu-post-parent build/parent/mp3_mxu_step.cu --parent-probes no_pcm no_fifo]
    python3 tools/kernel_variants.py --quantize16 [--variants as_is t256 ...]

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
import time
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

_DOT_NST = "constexpr int NST = 3;"
_DOT_ROWS = "constexpr int ROWS = 32;"
DOT_VARIANTS = {
    "as_is": [],
    "nst2": [(_DOT_NST, "constexpr int NST = 2;")],
    "nst4": [(_DOT_NST, "constexpr int NST = 4;")],
    "nst6": [(_DOT_NST, "constexpr int NST = 6;")],
    "rows16": [(_DOT_ROWS, "constexpr int ROWS = 16;")],
    "u4": [("constexpr int U = 8;", "constexpr int U = 4;")],
    "u16": [("constexpr int U = 8;", "constexpr int U = 16;")],
    "unroll4": [("  for (int batch = 0; batch < batches; ++batch) {",
                 "#pragma unroll 4\n  for (int batch = 0; batch < batches; ++batch) {")],
    "prefetch": [("  Slot at;\n  for (long long g = blockIdx.x; g < groups; g += gridDim.x) {\n"
                  "    for (int t = 0;",
                  "  Slot at;\n  asm volatile(\"prefetch.tensormap [%0];\" :: \"l\"(&d.map_a) : \"memory\");\n"
                  "  asm volatile(\"prefetch.tensormap [%0];\" :: \"l\"(&d.map_b) : \"memory\");\n"
                  "  for (long long g = blockIdx.x; g < groups; g += gridDim.x) {\n    for (int t = 0;")],
    "c256": [("constexpr int COLS = 128;", "constexpr int COLS = 256;")],
    "no_chain": [("      if (mine) {\n        const float* st = ring",
                  "      if (mine && d.n < 0) {\n        const float* st = ring")],
    "no_copies": [("const int boxes = min(BOXES, (d.n - c0 + 31) / 32);", "const int boxes = 0;")],
}
DOT_EXACT = tuple(name for name in DOT_VARIANTS if not name.startswith("no_"))
# probes of the first exact dot kernel (the parent of its redesign:
# `git show 551999b:esp_audio_libs_tpu_torch/csrc/dotprod_exact.cu`)
DOT_PARENT_PROBES = {
    "no_chain": [("for (int c = 0; c < cols; ++c) acc = add_ftz(acc, pr[c]);",
                  "for (int c = 0; c < 0; ++c) acc = add_ftz(acc, pr[c]);")],
    "no_copies": [("const bool valid = r < rows && c < n;", "const bool valid = false;")],
}

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


# probes of the earlier frame kernel (`git show 7302bf5:esp_audio_libs_tpu_torch/csrc/flac_frame.cu`)
FLAC_PARENT_PROBES = {
    "one_tap": [("for (int k = 0; k < W; ++k)\n          acc += static_cast<unsigned long long>",
                 "for (int k = W - 1; k < W; ++k)\n          acc += static_cast<unsigned long long>"),
                ("for (int k = 0; k < W; ++k)\n          acc += static_cast<uint32_t>",
                 "for (int k = W - 1; k < W; ++k)\n          acc += static_cast<uint32_t>")],
    "no_pack": [("for (int idx = h; idx < b.fpb * S; idx += HELP) {",
                 "for (int idx = h; idx < 0; idx += HELP) {")],
    "no_load": [("      load_tile<W, R>(tile, data, vec, h, b.lanes_b, b.lane0, b.nlanes, t0, T);\n",
                 "")],
}
# the transposed-form recurrence alone: that kernel with its win[] turned
# into the W running sums, its barriers and helpers as they were
_FLAC_OLD_DOT = """      int32_t pred;
      if constexpr (USE64) {
        unsigned long long acc = 0;
#pragma unroll
        for (int k = 0; k < W; ++k)
          acc += static_cast<unsigned long long>(static_cast<long long>(win[(u + k) % W]) * c[k]);
        pred = static_cast<int32_t>(static_cast<uint32_t>(static_cast<long long>(acc) >> sh));
      } else {
        uint32_t acc = 0;
#pragma unroll
        for (int k = 0; k < W; ++k)
          acc += static_cast<uint32_t>(win[(u + k) % W]) * static_cast<uint32_t>(c[k]);
        pred = static_cast<int32_t>(acc) >> sh;
      }
      int32_t y = static_cast<int32_t>(static_cast<uint32_t>(x) + static_cast<uint32_t>(pred));
      if (WARM && t0 + b + u < order) y = x;
      win[u] = y;
"""
_FLAC_TRANSPOSED = """      int32_t pred;
      if constexpr (USE64)
        pred = static_cast<int32_t>(static_cast<uint32_t>(static_cast<long long>(win[u]) >> sh));
      else
        pred = static_cast<int32_t>(win[u]) >> sh;
      int32_t y = static_cast<int32_t>(static_cast<uint32_t>(x) + static_cast<uint32_t>(pred));
      if (WARM && t0 + b + u < order) y = x;
#pragma unroll
      for (int j = 1; j < W; ++j) {
        if constexpr (USE64)
          win[(u + j) % W] += static_cast<unsigned long long>(static_cast<long long>(y) * c[W - j]);
        else
          win[(u + j) % W] += static_cast<uint32_t>(y) * static_cast<uint32_t>(c[W - j]);
      }
      if constexpr (USE64)
        win[u] = static_cast<unsigned long long>(static_cast<long long>(y) * c[0]);
      else
        win[u] = static_cast<uint32_t>(y) * static_cast<uint32_t>(c[0]);
"""
FLAC_PARENT_PROBES["transposed"] = [
    ("template <int W, bool USE64, bool WARM>\n__device__ __forceinline__ void restore_tile("
     "int32_t* row, int32_t (&win)[W],",
     "template <bool USE64>\nstruct Acc { using T = uint32_t; };\ntemplate <>\n"
     "struct Acc<true> { using T = unsigned long long; };\n\n"
     "template <int W, bool USE64, bool WARM>\n__device__ __forceinline__ void restore_tile("
     "int32_t* row, typename Acc<USE64>::T (&win)[W],"),
    (_FLAC_OLD_DOT, _FLAC_TRANSPOSED),
    ("int32_t c[W], win[W];", "int32_t c[W];\n  typename Acc<USE64>::T win[W];"),
]
FLAC_VARIANTS = {
    "as_is": [],
    "nst8": [("constexpr int NST = 4;", "constexpr int NST = 8;")],
    "s128": [("static constexpr int S = W == 12 ? 48 : 64;",
              "static constexpr int S = W == 12 ? 96 : 128;")],
    "one_tap": [("for (int j = 2; j < W; ++j)\n      acc[(u + j) % W] += static_cast<uint32_t>(y)",
                 "for (int j = 2; j < 2; ++j)\n      acc[(u + j) % W] += static_cast<uint32_t>(y)")],
    "no_load": [("if (r < g.lanes && t < a.T)\n      v[i] = __ldg(", "if (r < 0)\n      v[i] = __ldg("),
                ("v[i] = (r < g.lanes && t < a.T) ?", "v[i] = (r < 0) ?")],
    "no_pack": [("const int nf = min(g.fpb, a.F - g.f0);", "const int nf = 0;")],
}
FLAC_SASS_KERNEL = "flac_frame_kernelILi8ELb0EaE"   # flac_frame_kernel<8, false, int8_t>

# probes of the first granule kernel (`git show ebe6481:esp_audio_libs_tpu_torch/csrc/mp3_granules.cu`)
MP3_PARENT_PROBES = {
    "no_granules": [("  for (int g = 0; g < a.G; ++g) {", "  for (int g = 0; g < 0; ++g) {")],
    "no_dequant": [("      if (s.processed) dequant(hs, s.gain, cst, dq, mag);\n", "")],
    "no_expand": [("      const Sample s = expand(cb, cst, ch, i);",
                   "      const Sample s{0, 0, 0, i, true, true, false};")],
    "no_stereo": [("      if (nch == 2) {\n        const int* sfb_l",
                   "      if (nch == 3) {\n        const int* sfb_l")],
    "no_butterfly": [("      if (bnd <= nbfly[ch]) {", "      if (bnd < 0) {")],
    "no_imdct": [("    if (tid < nch * 32) {\n", "    if (tid < 0) {\n")],
    "no_fdct": [("    if (tid < 18 * nch) {\n", "    if (tid < 0) {\n")],
    "no_fifo": [("for (int s = 0; s < 18; ++s) {", "for (int s = 0; s < 0; ++s) {")],
    "fifo_one_step": [("for (int s = 0; s < 18; ++s) {", "for (int s = 0; s < 1; ++s) {")],
    "fifo_no_sync": [("      __syncthreads();\n      if (tid < 32 * nch) {", "      if (tid < 32 * nch) {"),
                     ("      __syncthreads();\n      v = (v - odd) & 7;", "      v = (v - odd) & 7;")],
}
MP3_VARIANTS = {
    "as_is": [],
    "mb2": [("constexpr int MIN_BLOCKS = 3;", "constexpr int MIN_BLOCKS = 2;")],
    "mb4": [("constexpr int MIN_BLOCKS = 3;", "constexpr int MIN_BLOCKS = 4;")],
    "no_prefetch": [("    if (g + 1 < G) {               // the next granule's spectra and side row",
                     "    if (g + 1 < G && false) {"),
                    ("    int src[2][2] = {};",
                     "    if (g > 0) {\n#pragma unroll\n      for (int ch = 0; ch < 2; ++ch) {\n"
                     "        if (ch >= nch) break;\n"
                     "        const int16_t* h = a.huff + (((size_t)g * B + b) * nch + ch) * NS;\n"
                     "        hx[ch] = (h[ia] & 0xFFFF) | "
                     "static_cast<int>(static_cast<uint32_t>(h[ib]) << 16);\n      }\n    }\n"
                     "    if (g + 1 < G && tid < SW) side_next = a.side[((size_t)(g + 1) * B + b) * SW + tid];\n"
                     "    int src[2][2] = {};")],
    "no_dequant": [("          dequant(hs, gain, tb, d, mag);\n", "          mag = gain & hs;\n")],
    "no_reduce": [("      warp_or(&red[R_GBMASK + ch], gbm);\n",
                   "      if (gbm == 12345) red[0] = cbl + cbs0 + cbs1 + cbs2;\n"),
                  ("      warp_max(&red[R_CBL + ch], cbl);\n", ""),
                  ("      warp_max(&red[R_CBS + 3 * ch], cbs0);\n", ""),
                  ("      warp_max(&red[R_CBS + 3 * ch + 1], cbs1);\n", ""),
                  ("      warp_max(&red[R_CBS + 3 * ch + 2], cbs2);\n", ""),
                  ("      warp_or(&red[R_ANYOVER + ch], S.over[ch * 288 + tid] != 0);\n", "")],
    "no_butterfly": [("if (bnd != 0 && bnd <= blocks_of(sd, nch, ch, a.cutoff).nbfly) {", "if (bnd < 0) {")],
    "no_b12": [("    __syncthreads();   // B1:", "    // B1:"), ("    __syncthreads();   // B2:", "    // B2:")],
    "no_imdct": [("    } else {                        // whole warps", "    } else if (tid < 0) {")],
    "no_fdct": [("      if ((tid & ~31) < 8 * nu) {", "      if (tid < 0) {")],
    "no_pqmf": [("item < 18 * nch * 16; item += nt", "item < 0; item += nt")],
}
MP3_SASS_KERNEL = "mp3_granules_kernel"

# the mirror tier's kernel (csrc/mp3_granules_f32.cu)
MP3F32_VARIANTS = {
    "as_is": [],
    "mb2": [("constexpr int MIN_BLOCKS = 3;", "constexpr int MIN_BLOCKS = 2;")],
    "mb4": [("constexpr int MIN_BLOCKS = 3;", "constexpr int MIN_BLOCKS = 4;")],
    "side_late": [("      if (tid < SW) side_next = a.side[((size_t)(g + 1) * B + b) * SW + tid];\n", ""),
                  ("S.sd[cur ^ 1][tid] = side_next;",
                   "S.sd[cur ^ 1][tid] = a.side[((size_t)(g + 1) * B + b) * SW + tid];")],
    "pqmf_u1": [("#pragma unroll 2\n    for (int k = 0; k < 8; ++k) {\n      const float4 c",
                 "#pragma unroll 1\n    for (int k = 0; k < 8; ++k) {\n      const float4 c")],
    "pqmf_u8": [("#pragma unroll 2\n    for (int k = 0; k < 8; ++k) {\n      const float4 c",
                 "#pragma unroll\n    for (int k = 0; k < 8; ++k) {\n      const float4 c")],
    "no_dequant": [("          dequant_f(hs, gain, d, mag);\n",
                    "          mag = static_cast<float>(gain & hs);\n          d = mag;\n")],
    "no_imdct": [("    } else {                        // whole warps", "    } else if (tid < 0) {")],
    "no_fdct": [("      if ((tid & ~31) < 8 * nu) {", "      if (tid < 0) {")],
    "no_pqmf": [("item < 18 * nch * 16; item += nt", "item < 0; item += nt")],
}
# probes of the first mirror-tier kernel (`git show a43feee:esp_audio_libs_tpu_torch/csrc/mp3_granules_f32.cu`)
MP3F32_PARENT_PROBES = {
    "mb3": [("constexpr int MIN_BLOCKS = 2;", "constexpr int MIN_BLOCKS = 3;")],
    "no_dequant": [("          dequant_f(hs, gain, d, mag);\n",
                    "          mag = static_cast<float>(gain & hs);\n          d = mag;\n")],
    "no_imdct": [("    if (tid < 32 * nch) {\n", "    if (tid < 0) {\n")],
    "no_fdct": [("    if (tid < 18 * nch) {\n", "    if (tid < 0) {\n")],
    "no_pqmf": [("item < 18 * nch * 16; item += THREADS", "item < 0; item += THREADS")],
    "no_hist_copy": [("      __syncthreads();\n      for (int k = tid; k < CARRY * HSTEP; k += THREADS) "
                      "S.hist[k] = S.hist[18 * HSTEP + k];\n", "")],
}
MP3F32_SASS_KERNEL = "mp3_granules_f32_kernel"
# the MXU tier's first step kernel (csrc/mp3_mxu_step.cu, eal_mp3_mxu_pre)
MXU_PRE_VARIANTS = {
    "as_is": [],
    "no_fifo": [("for (int e = tid; e < N_V / 4; e += PRE_THREADS)",
                 "for (int e = tid; e < 0; e += PRE_THREADS)")],
    "no_px": [("for (int i = 0; i < 9; ++i) ypo = fmaf(", "for (int i = 0; i < 1; ++i) ypo = fmaf(")],
}
# probes of the first step kernel (`git show a43feee:esp_audio_libs_tpu_torch/csrc/mp3_mxu_step.cu`)
MXU_PRE_PARENT_PROBES = {
    "no_fifo": [("  for (int r = 0; r < 34; ++r) vc[32 * r] = vb[64 * r];",
                 "  for (int r = 0; r < 0; ++r) vc[32 * r] = vb[64 * r];")],
    "no_px": [("for (int i = 0; i < 9; ++i) t += xp[i] * px[72 * i + j];",
               "for (int i = 0; i < 1; ++i) t += xp[i] * px[72 * i + j];")],
}
MXU_PRE_SASS_KERNEL = "mp3_mxu_pre_kernel"
# the MXU tier's second step kernel (csrc/mp3_mxu_step.cu, eal_mp3_mxu_post)
def _post_shape(threads, parts):
    return [("constexpr int POST_THREADS = 288;", f"constexpr int POST_THREADS = {threads};"),
            ("constexpr int POST_PARTS = 2;", f"constexpr int POST_PARTS = {parts};")]


_POST_STREAMING = [   # evict-first loads of acc and newv, streaming PCM stores
    ("x[ch] = acc4[ch * (N_OUT / 4) + k];", "x[ch] = __ldcs(acc4 + ch * (N_OUT / 4) + k);"),
    ("nv[r] = nv4[((j / 8) % NCH) * (N_V / 4) + 8 * (j / (8 * NCH)) + j % 8];",
     "nv[r] = __ldcs(nv4 + ((j / 8) % NCH) * (N_V / 4) + 8 * (j / (8 * NCH)) + j % 8);"),
    ("reinterpret_cast<uint4*>(out)[k] = w;", "__stcs(reinterpret_cast<uint4*>(out) + k, w);"),
    ("reinterpret_cast<uint2*>(out)[k] = w;", "__stcs(reinterpret_cast<uint2*>(out) + k, w);"),
]
MXU_POST_VARIANTS = {
    "as_is": [],
    "parts1": _post_shape(288, 1),
    "t160x4": _post_shape(160, 4),
    "pcm_high": [("  const int k = u;\n", "  const int k = POST_SPAN - 1 - u;\n")],
    "streaming": _POST_STREAMING,
    "keep_plain": [("kp[r] = __ldg(keep4 + 8 * row + c4);", "kp[r] = keep4[8 * row + c4];")],
    "no_pcm": [("const bool quad = k < N_OUT / 4;", "const bool quad = false;")],
    "no_fifo": [("    if (j < GROUPS) {", "    if (j < 0) {")],
}
MXU_POST_EXACT = ("as_is", "parts1", "t160x4", "pcm_high", "streaming", "keep_plain")
# probes of the first design (`git show 0bdb5de:esp_audio_libs_tpu_torch/csrc/mp3_mxu_step.cu`)
MXU_POST_PARENT_PROBES = {
    "no_pcm": [("for (int e = threadIdx.x; e < N_OUT; e += POST_THREADS) {",
                "for (int e = threadIdx.x; e < 0; e += POST_THREADS) {")],
    "no_fifo": [("for (int e = threadIdx.x; e < N_V; e += POST_THREADS)\n",
                 "for (int e = threadIdx.x; e < 0; e += POST_THREADS)\n")],
}
MXU_POST_SASS_KERNEL = "mp3_mxu_post_kernel"

_Q_THREADS, _Q_UNROLL = "constexpr int THREADS = 1024;", "constexpr int UNROLL = 4;"


def _q(threads=None, unroll=None):
    """Edits of pcm_quantize16.cu's block shape: threads a block and frames
    in flight a thread."""
    return ([(_Q_THREADS, f"constexpr int THREADS = {threads};")] if threads else []) + \
        ([(_Q_UNROLL, f"constexpr int UNROLL = {unroll};")] if unroll else [])


_Q_LDCS = [("l[u] = t < T ? __ldg(left + t) : 0.0f;", "l[u] = t < T ? __ldcs(left + t) : 0.0f;"),
           ("r[u] = t < T ? __ldg(right + t) : 0.0f;", "r[u] = t < T ? __ldcs(right + t) : 0.0f;")]
_Q_STCS = [("row[t] = word;", "__stcs(row + t, word);")]
QUANT16_VARIANTS = {
    "as_is": [],
    "u2": _q(unroll=2),
    "u8": _q(unroll=8),
    "t256": _q(threads=256),
    "t256_u8": _q(threads=256, unroll=8),
    "t512": _q(threads=512),
    "t512_u8": _q(threads=512, unroll=8),
    "streaming": _Q_LDCS + _Q_STCS,
    "ldcs": _Q_LDCS,
    "stcs": _Q_STCS,
}
QUANT16_SASS_KERNEL = "quantize_pack16_kernel"

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
        report = [ln.strip() for ln in out.splitlines()
                  if "registers" in ln or "spill" in ln or "Function properties" in ln]
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


def dotprod_main(args, card: str) -> None:
    """--dotprod: the exact dot's variants, earlier sources and their probes
    at both DOT_SHAPES, [65536, 64] rotated past L2."""
    from esp_audio_libs_tpu_torch.ops import dsp_kernels as dk
    names = list(DOT_VARIANTS) if args.variants is None else args.variants
    src = kernels.CSRC / "dotprod_exact.cu"
    sources = [src, kernels.CSRC / "exact_async.cuh"]
    dirs = {name: make_variant(f"dot_{name}", src.name, DOT_VARIANTS[name], sources)
            for name in names}
    exact = {name for name in names if name in DOT_EXACT}
    for path in args.dotprod_parent:
        parent = path.resolve().parent.name
        dirs[parent] = make_variant(f"dot_{parent}", src.name, [], sources, path)
        exact.add(parent)
        for probe in args.parent_probes:
            dirs[f"{parent}_{probe}"] = make_variant(f"dot_{parent}_{probe}", src.name,
                                                     DOT_PARENT_PROBES[probe], sources, path)
    libs = build_all(dirs, ("eal_dotprod_exact",))
    for name, (_, report) in libs.items():
        print(f"{name}: {' | '.join(report)}")
        print(f"{name} SASS: {sass_histogram(dirs[name] / 'lib.so', 'dotprod_exact')}")

    g = torch.Generator(device="cuda").manual_seed(1400)
    main, small = ((torch.randn(shape, generator=g, device="cuda"),
                    torch.randn(shape, generator=g, device="cuda")) for shape in cs.DOT_SHAPES)
    rotation = [small] + [tuple(torch.randn(cs.DOT_SHAPES[1], generator=g, device="cuda")
                                for _ in range(2)) for _ in range(cs.DOT_ROTATION - 1)]
    empty = tuple(torch.empty((cs.DOT_SHAPES[1][0], 0), device="cuda") for _ in range(2))
    checks = [("main", *main), ("small", *small)] + cs.dot_ragged_cases()
    wants = [dk.dotprod_exact_plain(a, b) for _, a, b in checks]
    for (R, n) in cs.DOT_SHAPES:
        nbytes, bound_ms, by = cs.dot_work(R, n)
        print(f"[{R}, {n}]: {nbytes} B, bound {bound_ms:.4f} ms ({by} at 3.35 TB/s)")
    results = {name: [] for name in libs}
    for name in list(libs) + list(libs)[::-1]:
        lib = libs[name][0]
        row = {}
        if name in exact:
            same = True
            for (label, a, b), want in zip(checks, wants):
                out = torch.empty(want.shape, dtype=torch.float32, device="cuda")
                ra, lda = dk._rows(a, out.numel(), a.shape[-1])
                rb, ldb = dk._rows(b, out.numel(), b.shape[-1])
                if lib.eal_dotprod_exact(ra.data_ptr(), lda, rb.data_ptr(), ldb, out.data_ptr(),
                                         out.numel(), a.shape[-1],
                                         torch.cuda.current_stream().cuda_stream) != 0:
                    raise RuntimeError(f"{name}: eal_dotprod_exact refused {label}")
                torch.cuda.synchronize()
                if not cs.same_bits(out, want):
                    print(f"{name}: differs from the plain version: {label}")
                    same = False
            row["bit_exact"] = float(same)
        row["main_ms"] = cs.cuda_time_queued(cs.dot_launcher(*main, lib=lib))
        row["small_rotated_ms"] = cs.cuda_time_queued(cs.dot_rotated_launcher(rotation, lib=lib))
        row["small_one_set_ms"] = cs.cuda_time_queued(cs.dot_launcher(*small, lib=lib))
        row["small_unqueued_ms"] = cs.cuda_time(cs.dot_rotated_launcher(rotation, lib=lib), 20)
        row["empty_ms"] = cs.cuda_time_queued(cs.dot_launcher(*empty, lib=lib))
        results[name].append(row)
        print(name, json.dumps(row))
    means = {name: {key: float(np.mean([r[key] for r in rows])) for key in rows[0]}
             for name, rows in results.items()}
    bounds = [cs.dot_work(R, n)[1] for R, n in cs.DOT_SHAPES]
    for name, m in means.items():
        print(f"{name}: [4096, 8192] {m['main_ms']:.4f} ms ({bounds[0] / m['main_ms']:.1%} of "
              f"the bound), [65536, 64] rotated over {cs.DOT_ROTATION} sets "
              f"{m['small_rotated_ms']:.4f} ms ({bounds[1] / m['small_rotated_ms']:.1%}), one "
              f"set {m['small_one_set_ms']:.4f} ms, rotated unqueued "
              f"{m['small_unqueued_ms']:.4f} ms, [65536, 0] {m['empty_ms']:.4f} ms, bit-exact "
              f"{m['bit_exact'] == 1.0 if 'bit_exact' in m else 'not checked (a probe)'} "
              f"(means of 2 turns, 20 queued direct launches each)")
    print(f"SM clock while the first variant's [4096, 8192] launches run: "
          f"{sm_clock(cs.dot_launcher(*main, lib=next(iter(libs.values()))[0]))}")
    print(json.dumps({"card": card, "device": torch.cuda.get_device_name(0), "variants": means}))


def sass_listing(lib: Path, kernel: str) -> str:
    """The SASS (cuobjdump -sass) of the functions of ``lib`` whose mangled
    name holds ``kernel``, or cuobjdump's error when it gave none."""
    cuobjdump = Path(kernels._nvcc()).parent / "cuobjdump"
    res = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True)
    keep, inside = [], False
    for line in res.stdout.splitlines():
        if "Function :" in line:
            inside = kernel in line
        if inside:
            keep.append(line)
    return "\n".join(keep) + "\n" if keep else f"no SASS ({res.stderr.strip()[:200]})"


def sass_histogram(lib: Path, kernel: str) -> str:
    """The most frequent SASS opcodes of the functions of ``lib`` whose
    mangled name holds ``kernel`` (cuobjdump), as one text line."""
    listing = sass_listing(lib, kernel)
    counts = {}
    for line in listing.splitlines():
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m:
            counts[m.group(1)] = counts.get(m.group(1), 0) + 1
    top = sorted(counts.items(), key=lambda kv: -kv[1])[:24]
    return ", ".join(f"{op} {n}" for op, n in top) or listing


def loop_opcodes(listing: str, marker: str, n_marker: int) -> tuple:
    """The opcodes of the innermost loops of a SASS ``listing`` (a backward
    branch and the instructions from its target on) that hold ``marker``
    exactly ``n_marker`` times: (number of such loops, their opcode counts)."""
    ins = re.findall(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);",
                     listing)
    ins = [(int(a, 16), op, rest) for a, op, rest in ins]
    at = {a: i for i, (a, _, _) in enumerate(ins)}
    loops = []
    for i, (a, op, rest) in enumerate(ins):
        t = re.search(r"0x([0-9a-f]+)", rest) if op == "BRA" else None
        if t and int(t.group(1), 16) < a and int(t.group(1), 16) in at:
            loops.append((at[int(t.group(1), 16)], i))
    inner = [(s, e) for s, e in loops
             if not any(s <= s2 and e2 <= e and (s2, e2) != (s, e) for s2, e2 in loops)]
    counts, n = {}, 0
    for s, e in inner:
        body = [op for _, op, _ in ins[s:e + 1]]
        if body.count(marker) == n_marker:
            n += 1
            for op in body:
                counts[op] = counts.get(op, 0) + 1
    return n, counts


def pqmf_opcodes(lib: Path) -> str:
    """The multiplies of the granule kernel's PQMF tap loops (two taps a
    body, whose four coefficients a tap are two ``LDS.128``): whether the
    products are ``IMAD.WIDE`` (32 x 32 + 64 -> 64 bits) or longer 64-bit
    sequences, as one text line."""
    n, counts = loop_opcodes(sass_listing(lib, MP3_SASS_KERNEL), "LDS.128", 2)
    if not n:
        return "no PQMF tap loop found"
    mul = {op: c for op, c in sorted(counts.items())
           if op.startswith(("IMAD.WIDE", "IMAD.HI", "IMUL", "IMAD.X", "IADD3.X"))}
    return (f"{n} tap loops, {sum(counts.values())} instructions: "
            + ", ".join(f"{op} {c}" for op, c in mul.items()))


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


def flac_main(args, card: str) -> None:
    """--flac: the frame kernel's variants, earlier sources and their probes
    at the main path's launches (chip_smoke.flac_shapes)."""
    names = list(FLAC_VARIANTS) if args.variants is None else args.variants
    src = kernels.CSRC / "flac_frame.cu"
    sources = [src, kernels.CSRC / "exact_async.cuh"]
    dirs = {name: make_variant(f"flac_{name}", src.name, FLAC_VARIANTS[name], sources)
            for name in names}
    for path in args.flac_parent:
        parent = path.resolve().parent.name
        dirs[parent] = make_variant(f"flac_{parent}", src.name, [], sources, path)
        for probe in args.parent_probes:
            dirs[f"{parent}_{probe}"] = make_variant(f"flac_{parent}_{probe}", src.name,
                                                     FLAC_PARENT_PROBES[probe], sources, path)
    libs = build_all(dirs, ("eal_flac_frame",))
    for name, (_, report) in libs.items():
        print(f"{name}: {' | '.join(report)}")
        print(f"{name} SASS of flac_frame_kernel<8, false, int8_t>: "
              f"{sass_histogram(dirs[name] / 'lib.so', FLAC_SASS_KERNEL)}")
        (dirs[name] / "sass.txt").write_text(sass_listing(dirs[name] / "lib.so", FLAC_SASS_KERNEL))

    sys.path.insert(0, str(REPO / "tools"))
    from esp_audio_libs_tpu_torch.ops import flac_kernels as fk
    shapes = cs.flac_shapes(cs.flac_stream(8))
    # beside the main path's: the dispatch's first block alone (16 frames,
    # 32 lanes, escapes), and the dispatch on the int16 plane the escape
    # tier stands for (no escapes)
    tensors, kw = shapes["dispatch"]
    shapes["one_block"] = ([a[:16].contiguous() for a in tensors], kw)
    lean = {k: v for k, v in kw.items() if not k.startswith("esc")}
    plane = tensors[0].to(torch.int32).reshape(-1)
    live = kw["esc_pos"] < plane.numel()
    plane[kw["esc_pos"][live].long()] = kw["esc_val"][live]
    shapes["dispatch_int16"] = ([plane.reshape(tensors[0].shape).to(torch.int16)] +
                                list(tensors[1:]), lean)
    checked = ("dispatch", "bucket", "dispatch_w12", "dispatch_w32", "one_block",
               "dispatch_int16")
    plains = {key: fk.flac_frame_plain(*shapes[key][0], **shapes[key][1]) for key in checked}
    for key, (tensors, kw) in shapes.items():
        nbytes, bound_ms, chain_ms, issue_ms = cs.flac_work(tensors, kw)
        F, C, T = tensors[0].shape
        print(f"{key}: F={F} C={C} T={T} W={kw['max_order']} use64={kw['use64']} "
              f"{tensors[0].dtype}{' + escapes' if 'esc_pos' in kw else ''}: {nbytes} B, bound "
              f"{bound_ms:.4f} ms (bytes); estimates: serial chain {chain_ms:.4f} ms, issue "
              f"{issue_ms:.4f} ms")
    results = {name: [] for name in libs}
    for name in list(libs) + list(libs)[::-1]:
        lib = libs[name][0]
        row = {}
        for key, (tensors, kw) in shapes.items():
            if key in plains:
                got = cs.flac_launcher(tensors, kw, lib=lib)()
                torch.cuda.synchronize()
                row[f"{key}_byte_exact"] = float(torch.equal(got, plains[key]))
            ms = cs.cuda_time(cs.flac_launcher(tensors, kw, lib=lib), iters=20)
            row[f"{key}_ms"] = ms
            row[f"{key}_ns_per_step"] = ms / tensors[0].shape[-1] * 1e6
        results[name].append(row)
        print(name, json.dumps(row))
    means = {name: {key: float(np.mean([r[key] for r in rows])) for key in rows[0]}
             for name, rows in results.items()}
    for name, m in means.items():
        exact = all(m[f"{key}_byte_exact"] == 1.0 for key in checked)
        print(f"{name}: dispatch {m['dispatch_ms']:.4f} ms, bucket {m['bucket_ms']:.4f} ms, one "
              f"lane {m['one_lane_ms']:.4f} ms ({m['one_lane_ns_per_step']:.2f} ns/step), W=12 "
              f"{m['dispatch_w12_ms']:.4f} ms, W=32 {m['dispatch_w32_ms']:.4f} ms, byte-exact "
              f"{exact} (means of 2 turns, 20 direct launches each)")
    launch = cs.flac_launcher(*shapes["dispatch"], lib=next(iter(libs.values()))[0])
    print(f"SM clock while the first variant's dispatch launches run: {sm_clock(launch)}")
    print(json.dumps({"card": card, "device": torch.cuda.get_device_name(0), "variants": means}))


def mp3_checks():
    """The operands and plain results every --mp3 variant is held to, byte
    for byte: phase 11's tonal run (B = 256, G = 16) and small mixed-frame
    runs of the four batch formats, two runs in a row (B = 5, G = 8)."""
    from esp_audio_libs_tpu_torch.models import mp3_pipeline
    from esp_audio_libs_tpu_torch.ops import mp3_kernels as mk
    mf = cs.tools_import("mp3frames")
    runs = []
    (fmt, vindex, huff, side), = cs.mp3_run_operands(
        cs.mp3_streams("tonal", cs.MP3_STREAMS, cs.MP3_FRAMES, 5000), cs.MP3_FRAMES)
    runs.append(("tonal", fmt, vindex, huff, side, cs.mp3_zero_state(huff.shape[1], "cuda")))
    for ci, cfg in enumerate(mf.BATCH_CFGS):
        streams = cs.mp3_streams("mixed", 5, 8, 100 * ci, cfg)
        (fmt, vindex, huff, side), = cs.mp3_run_operands([s[: len(s) // 2] for s in streams], 4)
        state = cs.mp3_zero_state(5, "cuda")
        runs.append((f"fmt{ci}_run0", fmt, vindex, huff, side, state))
        state = mk.mp3_granules_plain(huff, side, *state, vindex, ver=fmt[0], sr_idx=fmt[1],
                                      nch=fmt[2], cutoff=fmt[3])[1]
        vindex = mp3_pipeline._advance_vindex(vindex, huff.shape[0])
        (fmt, _, huff, side), = cs.mp3_run_operands([s[len(s) // 2:] for s in streams], 4)
        runs.append((f"fmt{ci}_run1", fmt, vindex, huff, side, state))
    wants = [mk.mp3_granules_plain(huff, side, *state, vindex, ver=fmt[0], sr_idx=fmt[1],
                                   nch=fmt[2], cutoff=fmt[3])
             for _, fmt, vindex, huff, side, state in runs]
    return runs, wants


def mp3_exact(lib, runs, wants) -> bool:
    """Whether ``lib``'s eal_mp3_granules gives the plain results on every
    run (one launch each, from copies of the state)."""
    ok = True
    for (_, fmt, vindex, huff, side, state), want in zip(runs, wants):
        launch = cs.mp3_launcher(huff, side, state, fmt, vindex, lib=lib)
        pcm = launch()
        torch.cuda.synchronize()
        _, _, _, st, _, undef = launch.keep
        got = (pcm.transpose(0, 1), *st, undef != 0)
        ok = ok and all(torch.equal(a, b) for a, b in zip(got, (want[0], *want[1], want[2])))
    return ok


def mp3_main(args, card: str) -> None:
    """--mp3: the granule kernel's variants, earlier sources and their probes
    at phase 11's timed shapes (B = 256 and 2048 x G = 16)."""
    names = list(MP3_VARIANTS) if args.variants is None else args.variants
    src = kernels.CSRC / "mp3_granules.cu"
    sources = [src, kernels.CSRC / "mp3_common.cuh"]
    dirs = {name: make_variant(f"mp3_{name}", src.name, MP3_VARIANTS[name], sources)
            for name in names}
    for path in args.mp3_parent:
        parent = path.resolve().parent.name
        dirs[parent] = make_variant(f"mp3_{parent}", src.name, [], sources, path)
        for probe in args.parent_probes:
            dirs[f"{parent}_{probe}"] = make_variant(f"mp3_{parent}_{probe}", src.name,
                                                     MP3_PARENT_PROBES[probe], sources, path)
    libs = build_all(dirs, ("eal_mp3_granules",))
    for name, (_, report) in libs.items():
        print(f"{name}: {' | '.join(report)}")
        print(f"{name} SASS: {sass_histogram(dirs[name] / 'lib.so', MP3_SASS_KERNEL)}")
        print(f"{name} PQMF: {pqmf_opcodes(dirs[name] / 'lib.so')}")
        (dirs[name] / "sass.txt").write_text(sass_listing(dirs[name] / "lib.so", MP3_SASS_KERNEL))

    runs, wants = mp3_checks()
    _, fmt, vindex, huff, side, _ = runs[0]
    shapes = {}
    for B in (cs.MP3_STREAMS, 8 * cs.MP3_STREAMS):
        h = huff.repeat(1, B // cs.MP3_STREAMS, 1, 1).contiguous()
        sd = side.repeat(1, B // cs.MP3_STREAMS, 1).contiguous()
        shapes[f"b{B}"] = (h, sd, cs.mp3_zero_state(B, "cuda"))
        nbytes, bound_ms, bound_by = cs.mp3_work(h, sd, fmt)[:3]
        print(f"b{B}: G={h.shape[0]} B={B} stereo: {nbytes} B; bound {bound_ms:.4f} ms ({bound_by})")
    results = {name: [] for name in libs}
    for name in list(libs) + list(libs)[::-1]:
        lib = libs[name][0]
        row = {"byte_exact": float(mp3_exact(lib, runs, wants))}
        for key, (h, sd, state) in shapes.items():
            row[f"{key}_ms"] = cs.cuda_time(cs.mp3_launcher(h, sd, state, fmt, vindex, lib=lib),
                                            iters=20)
        results[name].append(row)
        print(name, json.dumps(row))
    means = {name: {key: float(np.mean([r[key] for r in rows])) for key in rows[0]}
             for name, rows in results.items()}
    for name, m in means.items():
        print(f"{name}: B=256 {m['b256_ms']:.4f} ms, B=2048 {m['b2048_ms']:.4f} ms, byte-exact "
              f"{m['byte_exact'] == 1.0} (means of 2 turns, 20 direct launches each)")
    h, sd, state = shapes[f"b{8 * cs.MP3_STREAMS}"]
    launch = cs.mp3_launcher(h, sd, state, fmt, vindex, lib=next(iter(libs.values()))[0])
    print(f"SM clock while the first variant's B=2048 launches run: {sm_clock(launch)}")
    print(json.dumps({"card": card, "device": torch.cuda.get_device_name(0), "variants": means}))


def parent_dirs(paths, probes, table, prefix, target, sources) -> dict:
    """Variant directories of earlier sources: each file of ``paths`` as
    ``target``, named by its directory, and with each probe of ``probes``
    (edits from ``table``) named ``<dir>_<probe>``."""
    dirs = {}
    for path in paths:
        parent = path.resolve().parent.name
        dirs[parent] = make_variant(f"{prefix}_{parent}", target, [], sources, path)
        for probe in probes:
            dirs[f"{parent}_{probe}"] = make_variant(f"{prefix}_{parent}_{probe}", target,
                                                     table[probe], sources, path)
    return dirs


def report_libs(libs, dirs, sass_kernel) -> None:
    """Each library's ptxas report and its kernel's SASS opcode counts (the
    listing goes to ``<variant dir>/sass.txt``)."""
    for name, (_, report) in libs.items():
        print(f"{name}: {' | '.join(report)}")
        print(f"{name} SASS: {sass_histogram(dirs[name] / 'lib.so', sass_kernel)}")
        (dirs[name] / "sass.txt").write_text(sass_listing(dirs[name] / "lib.so", sass_kernel))


def timed_turns(libs, row_of) -> dict:
    """``row_of(lib)`` for every library, first to last and then last to
    first, printed as it comes; returns the means per library."""
    results = {name: [] for name in libs}
    for name in list(libs) + list(libs)[::-1]:
        row = row_of(libs[name][0])
        results[name].append(row)
        print(name, json.dumps(row))
    return {name: {key: float(np.mean([r[key] for r in rows])) for key in rows[0]}
            for name, rows in results.items()}


def mp3f32_zero_state(B):
    return (torch.zeros((B, 2, 288), device="cuda"), *cs.mp3_zero_state(B, "cuda")[1:4],
            torch.zeros((B, 2176), device="cuda"))


def mp3f32_launcher(huff, side, state, fmt, vindex, lib):
    """A function that launches ``lib``'s eal_mp3_granules_f32 on the
    operands, its buffers prepared once (the state updated in place launch
    after launch): the kernel alone, for timing."""
    from esp_audio_libs_tpu_torch.ops import mp3_kernels as mk
    ver, sr_idx, nch, cutoff = fmt
    G, B = huff.shape[:2]
    st = tuple(t.clone() for t in state)
    pcm = torch.empty((B, G, 576 * nch), dtype=torch.int16, device=huff.device)
    consts = mk.format_consts(ver, sr_idx, huff.device)
    args = (huff.data_ptr(), side.data_ptr(), consts.data_ptr(), *(t.data_ptr() for t in st),
            pcm.data_ptr(), G, B, nch, vindex, cutoff, torch.cuda.current_stream().cuda_stream)

    def launch():
        if lib.eal_mp3_granules_f32(*args) != 0:
            cs.fail("eal_mp3_granules_f32 refused its arguments")
        launch.keep = (huff, side, consts, st, pcm)
        return pcm
    return launch


def mp3f32_checks():
    """The runs every --mp3f32 variant is held to and their plain results:
    phase 11's tonal run (B = 256, G = 16), and mixed-frame runs of the four
    batch formats, two runs in a row (B = 5, the second from the first's
    state at another FIFO phase)."""
    from esp_audio_libs_tpu_torch.models import mp3_pipeline
    from esp_audio_libs_tpu_torch.ops import mp3_kernels as mk
    mf = cs.tools_import("mp3frames")
    (fmt, vindex, huff, side), = cs.mp3_run_operands(
        cs.mp3_streams("tonal", cs.MP3_STREAMS, cs.MP3_FRAMES, 5000), cs.MP3_FRAMES)
    runs = [("tonal", fmt, vindex, huff, side, mp3f32_zero_state(huff.shape[1]))]
    for ci, cfg in enumerate(mf.BATCH_CFGS):
        streams = cs.mp3_streams("mixed", 5, 8, 100 * ci, cfg)
        (fmt, vindex, huff, side), = cs.mp3_run_operands([s[: len(s) // 2] for s in streams], 4)
        state = mp3f32_zero_state(5)
        runs.append((f"fmt{ci}_run0", fmt, vindex, huff, side, state))
        state = mk.mp3_granules_f32_plain(huff, side, *state, vindex, ver=fmt[0], sr_idx=fmt[1],
                                          nch=fmt[2], cutoff=fmt[3])[1]
        vindex = mp3_pipeline._advance_vindex(vindex, huff.shape[0])
        (fmt, _, huff, side), = cs.mp3_run_operands([s[len(s) // 2:] for s in streams], 4)
        runs.append((f"fmt{ci}_run1", fmt, vindex, huff, side, state))
    wants = [mk.mp3_granules_f32_plain(huff, side, *state, vindex, ver=fmt[0], sr_idx=fmt[1],
                                       nch=fmt[2], cutoff=fmt[3])
             for _, fmt, vindex, huff, side, state in runs]
    return runs, wants


def mp3f32_errors(lib, runs, wants) -> tuple:
    """``lib``'s eal_mp3_granules_f32 on every run (one launch each, from
    copies of the state) against the plain results: (worst PCM difference
    in LSB, worst f32 state difference relative to its scale, whether the
    integer state is equal)."""
    lsb, rel, ints = 0, 0.0, True
    for (_, fmt, vindex, huff, side, state), want in zip(runs, wants):
        launch = mp3f32_launcher(huff, side, state, fmt, vindex, lib)
        pcm = launch()
        torch.cuda.synchronize()
        lsb = max(lsb, int((pcm.transpose(0, 1).int() - want[0].int()).abs().max()))
        for a, b in zip(launch.keep[3], want[1]):
            if a.dtype == torch.float32:
                rel = max(rel, float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30))
            else:
                ints = ints and torch.equal(a, b)
    return lsb, rel, ints


def mp3f32_main(args, card: str) -> None:
    """--mp3f32: the mirror tier's kernel, its variants, earlier sources and
    their probes at phase 11's timed shapes (B = 256 and 2048 x G = 16)."""
    names = list(MP3F32_VARIANTS) if args.variants is None else args.variants
    src = kernels.CSRC / "mp3_granules_f32.cu"
    sources = [src, kernels.CSRC / "mp3_common.cuh"]
    dirs = {name: make_variant(f"mp3f32_{name}", src.name, MP3F32_VARIANTS[name], sources)
            for name in names}
    dirs.update(parent_dirs(args.mp3f32_parent, args.parent_probes, MP3F32_PARENT_PROBES,
                            "mp3f32", src.name, sources))
    libs = build_all(dirs, ("eal_mp3_granules_f32",))
    report_libs(libs, dirs, MP3F32_SASS_KERNEL)

    runs, wants = mp3f32_checks()
    _, fmt, vindex, huff, side, _ = runs[0]
    shapes = {}
    for B in (cs.MP3_STREAMS, 8 * cs.MP3_STREAMS):
        h = huff.repeat(1, B // cs.MP3_STREAMS, 1, 1).contiguous()
        sd = side.repeat(1, B // cs.MP3_STREAMS, 1).contiguous()
        shapes[f"b{B}"] = (h, sd, mp3f32_zero_state(B))
        nbytes, bound_ms, bound_by = cs.mp3f32_work(h, sd)[:3]
        print(f"b{B}: G={h.shape[0]} B={B} stereo: {nbytes} B; bound {bound_ms:.4f} ms ({bound_by})")

    def row_of(lib):
        lsb, rel, ints = mp3f32_errors(lib, runs, wants)
        row = {"pcm_lsb": float(lsb), "state_rel": rel,
               "within": float(lsb <= 1 and rel <= cs.MP3F_STATE_RTOL and ints)}
        for key, (h, sd, state) in shapes.items():
            row[f"{key}_ms"] = cs.cuda_time(mp3f32_launcher(h, sd, state, fmt, vindex, lib),
                                            iters=20)
        return row
    means = timed_turns(libs, row_of)
    for name, m in means.items():
        print(f"{name}: B=256 {m['b256_ms']:.4f} ms, B=2048 {m['b2048_ms']:.4f} ms, within 1 LSB "
              f"and {cs.MP3F_STATE_RTOL} of the state's scale {m['within'] == 1.0} (worst "
              f"{m['pcm_lsb']:.0f} LSB, {m['state_rel']:.3g}; means of 2 turns, 20 direct "
              f"launches each)")
    h, sd, state = shapes[f"b{8 * cs.MP3_STREAMS}"]
    launch = mp3f32_launcher(h, sd, state, fmt, vindex, next(iter(libs.values()))[0])
    print(f"SM clock while the first variant's B=2048 launches run: {sm_clock(launch)}")
    print(json.dumps({"card": card, "device": torch.cuda.get_device_name(0), "variants": means}))


def mxu_pre_call(lib, yx, ip, over, pt, pws, npv, vbuf, px, *, nch):
    """``lib``'s eal_mp3_mxu_pre as ``mp3mxu.mp3_mxu_pre_cuda`` (uncounted)."""
    from esp_audio_libs_tpu_torch.ops import mp3_kernels as mk
    B = over.shape[0]
    ofvc = torch.empty((B * nch, mk.MXU_IN), dtype=torch.float32, device=yx.device)
    if lib.eal_mp3_mxu_pre(yx.data_ptr(), ip.data_ptr(), over.data_ptr(), pt.data_ptr(),
                           pws.data_ptr(), npv.data_ptr(), vbuf.data_ptr(), px.data_ptr(),
                           ofvc.data_ptr(), B, nch, torch.cuda.current_stream().cuda_stream) != 0:
        cs.fail("eal_mp3_mxu_pre refused its arguments")
    return ofvc


def mxu_plain_steps(pre_kernel=None, post_kernel=None):
    """Swap ``mp3mxu``'s step kernels for their plain versions (or for
    ``pre_kernel`` / ``post_kernel`` when given); returns a function that
    restores them."""
    from esp_audio_libs_tpu_torch.ops import mp3mxu
    real = mp3mxu.mp3_mxu_pre_cuda, mp3mxu.mp3_mxu_post_cuda

    def pre(yx, ip, over, pt, pws, npv, vbuf, px, *, nch):
        ofvc, *new = mp3mxu.mxu_pre_plain(yx, ip, over, pt, pws, npv, vbuf, px, nch=nch)
        for t, n in zip((over, pt, pws, npv), new):
            t.copy_(n)
        return ofvc

    def post(acc, newv, vbuf, keep, out, *, nch):
        pcm, nv = mp3mxu.mxu_post_plain(acc, newv, vbuf, keep, nch=nch)
        out.copy_(pcm)
        vbuf.copy_(nv)

    mp3mxu.mp3_mxu_pre_cuda, mp3mxu.mp3_mxu_post_cuda = pre_kernel or pre, post_kernel or post

    def restore():
        mp3mxu.mp3_mxu_pre_cuda, mp3mxu.mp3_mxu_post_cuda = real
    return restore


def mxu_pre_errors(lib, runs) -> tuple:
    """``lib``'s eal_mp3_mxu_pre at every granule step of each run (through
    ``mp3mxu.mxu_run``, the other parts plain) against ``mxu_pre_plain`` on
    the same inputs, the run continuing from the kernel's results: (worst
    absolute difference of its f32 outputs, worst f32 state difference
    relative to its scale, whether the integer state is equal)."""
    from esp_audio_libs_tpu_torch.ops import mp3mxu
    worst = [0.0, 0.0, True]

    def pre(yx, ip, over, pt, pws, npv, vbuf, px, *, nch):
        want = mp3mxu.mxu_pre_plain(yx, ip, over, pt, pws, npv, vbuf, px, nch=nch)
        got = mxu_pre_call(lib, yx, ip, over, pt, pws, npv, vbuf, px, nch=nch)
        torch.cuda.synchronize()
        for a, b in zip((got, over, pt, pws, npv), want):
            if a.dtype == torch.float32:
                err = float((a - b).abs().max())
                worst[0] = max(worst[0], err)
                worst[1] = max(worst[1], err / max(float(b.abs().max()), 1e-30))
            else:
                worst[2] = worst[2] and torch.equal(a, b)
        return got

    restore = mxu_plain_steps(pre)
    try:
        for _, fmt, vindex, huff, side, state in runs:
            mp3mxu.mxu_run(huff, side, *state, vindex, ver=fmt[0], sr_idx=fmt[1], nch=fmt[2],
                           cutoff=fmt[3])
    finally:
        restore()
    return tuple(worst)


def mxu_pre_main(args, card: str) -> None:
    """--mxu-pre: the MXU tier's first step kernel, its variants, earlier
    sources and their probes at phase 11b's timed shapes (B = 256 and 2048,
    granule 0 of the tonal run, from the state the run leaves)."""
    from esp_audio_libs_tpu_torch.ops import mp3mxu
    names = list(MXU_PRE_VARIANTS) if args.variants is None else args.variants
    src = kernels.CSRC / "mp3_mxu_step.cu"
    dirs = {name: make_variant(f"mxu_pre_{name}", src.name, MXU_PRE_VARIANTS[name], [src])
            for name in names}
    dirs.update(parent_dirs(args.mxu_pre_parent, args.parent_probes, MXU_PRE_PARENT_PROBES,
                            "mxu_pre", src.name, [src]))
    libs = build_all(dirs, ("eal_mp3_mxu_pre",))
    report_libs(libs, dirs, MXU_PRE_SASS_KERNEL)

    runs = mp3f32_checks()[0]
    _, fmt, vindex, huff, side, _ = runs[0]
    kw = dict(ver=fmt[0], sr_idx=fmt[1], nch=fmt[2], cutoff=fmt[3])
    ops = mp3mxu.device_operators(torch.device("cuda"))
    shapes = {}
    for B in (cs.MP3_STREAMS, 8 * cs.MP3_STREAMS):
        h = huff.repeat(1, B // cs.MP3_STREAMS, 1, 1).contiguous()
        sd = side.repeat(1, B // cs.MP3_STREAMS, 1).contiguous()
        with torch.no_grad():
            yx, ip = mp3mxu.mxu_prelude(h, sd, **kw)
            st = mp3f32_zero_state(B)
            pcm = torch.empty((B, h.shape[0], 576 * fmt[2]), dtype=torch.int16, device="cuda")
            restore = mxu_plain_steps()
            try:
                mp3mxu.mxu_steps(yx, ip, st, vindex, pcm, nch=fmt[2])
            finally:
                restore()
        pre_bytes = cs.mxu_step_bytes(ip[0], ops["keep"][vindex], B, fmt[2])[0]
        shapes[f"b{B}"] = (yx[0].contiguous(), ip[0].contiguous(), st)
        print(f"b{B}: B={B} stereo, granule 0 of the run from the state it leaves: {pre_bytes} "
              f"B; bound {pre_bytes / cs.PEAK_BYTES * 1e3:.4f} ms (bytes)")
        del yx, ip

    def row_of(lib):
        err, rel, ints = mxu_pre_errors(lib, runs)
        row = {"max_abs_err": err, "state_rel": rel,
               "within": float(rel <= cs.MP3F_STATE_RTOL and ints)}
        for key, (yx, ip, st) in shapes.items():
            st2 = tuple(t.clone() for t in st)
            row[f"{key}_ms"] = cs.cuda_time(
                lambda: mxu_pre_call(lib, yx, ip, *st2, ops["PX"], nch=fmt[2]), iters=20)
            row[f"{key}_queued_ms"] = cs.cuda_time_queued(
                lambda: mxu_pre_call(lib, yx, ip, *st2, ops["PX"], nch=fmt[2]), iters=20)
        return row
    means = timed_turns(libs, row_of)
    for name, m in means.items():
        print(f"{name}: B=256 {m['b256_ms']:.4f} ms (queued {m['b256_queued_ms']:.4f}), B=2048 "
              f"{m['b2048_ms']:.4f} ms (queued {m['b2048_queued_ms']:.4f}), within "
              f"{cs.MP3F_STATE_RTOL} of the state's scale {m['within'] == 1.0} (worst "
              f"{m['max_abs_err']:.3g}, {m['state_rel']:.3g}; means of 2 turns, 20 direct "
              f"launches each)")
    print(json.dumps({"card": card, "device": torch.cuda.get_device_name(0), "variants": means}))


def mxu_post_call(lib, acc, newv, vbuf, keep, out, *, nch):
    """``lib``'s eal_mp3_mxu_post as ``mp3mxu.mp3_mxu_post_cuda`` (uncounted)."""
    if lib.eal_mp3_mxu_post(acc.data_ptr(), newv.data_ptr(), vbuf.data_ptr(), keep.data_ptr(),
                            out.data_ptr(), out.stride(0), vbuf.shape[0], nch,
                            torch.cuda.current_stream().cuda_stream) != 0:
        cs.fail("eal_mp3_mxu_post refused its arguments")


def mxu_post_errors(lib, runs, cases) -> int:
    """How often ``lib``'s eal_mp3_mxu_post differs from ``mxu_post_plain``
    (PCM or vbuf bit for bit, or the PCM rows' padding): on ``cases``
    (``chip_smoke.mxu_post_cases``) and at every granule step of each run
    (``mp3mxu.mxu_run`` with the rest plain), the run continuing from the
    kernel's results."""
    from esp_audio_libs_tpu_torch.ops import mp3mxu
    bad = len(cs.mxu_post_mismatches(lambda *a, nch: mxu_post_call(lib, *a, nch=nch), cases))
    steps = [0]

    def post(acc, newv, vbuf, keep, out, *, nch):
        want_pcm, want_vbuf = mp3mxu.mxu_post_plain(acc, newv, vbuf, keep, nch=nch)
        mxu_post_call(lib, acc, newv, vbuf, keep, out, nch=nch)
        torch.cuda.synchronize()
        steps[0] += not (torch.equal(out, want_pcm) and cs.same_bits(vbuf, want_vbuf))

    restore = mxu_plain_steps(post_kernel=post)
    try:
        for _, fmt, vindex, huff, side, state in runs:
            mp3mxu.mxu_run(huff, side, *state, vindex, ver=fmt[0], sr_idx=fmt[1], nch=fmt[2],
                           cutoff=fmt[3])
    finally:
        restore()
    return bad + steps[0]


MXU_POST_L2_SPAN = 100e6   # bytes the rotated operand sets of --mxu-post cover together


def mxu_post_main(args, card: str) -> None:
    """--mxu-post: the MXU tier's second step kernel, its variants, earlier
    sources and their probes at B = 256 and 2048 stereo and B = 256 mono,
    hot and rotated past L2, unqueued and queued."""
    from esp_audio_libs_tpu_torch.ops import mp3mxu
    names = list(MXU_POST_VARIANTS) if args.variants is None else args.variants
    src = kernels.CSRC / "mp3_mxu_step.cu"
    dirs = {name: make_variant(f"mxu_post_{name}", src.name, MXU_POST_VARIANTS[name], [src])
            for name in names}
    exact = {name for name in names if name in MXU_POST_EXACT}
    parents = parent_dirs(args.mxu_post_parent, args.parent_probes, MXU_POST_PARENT_PROBES,
                          "mxu_post", src.name, [src])
    exact |= {path.resolve().parent.name for path in args.mxu_post_parent}
    dirs.update(parents)
    libs = build_all(dirs, ("eal_mp3_mxu_post",))
    report_libs(libs, dirs, MXU_POST_SASS_KERNEL)

    runs = mp3f32_checks()[0]
    _, fmt, vindex, huff, side, _ = runs[0]
    nch, G = fmt[2], huff.shape[0]
    kw = dict(ver=fmt[0], sr_idx=fmt[1], nch=nch, cutoff=fmt[3])
    ops = mp3mxu.device_operators(torch.device("cuda"))
    keep = ops["keep"][vindex]
    cases = cs.mxu_post_cases(list(ops["keep"]), "cuda")
    shapes, bounds, step_runs = {}, {}, {}
    for B in (cs.MP3_STREAMS, 8 * cs.MP3_STREAMS):
        h = huff.repeat(1, B // cs.MP3_STREAMS, 1, 1).contiguous()
        sd = side.repeat(1, B // cs.MP3_STREAMS, 1).contiguous()
        with torch.no_grad():
            yx, ip = mp3mxu.mxu_prelude(h, sd, **kw)
            st = mp3f32_zero_state(B)
            ofvc = mp3mxu.mxu_pre_plain(yx[0], ip[0], *st, ops["PX"], nch=nch)[0]
            acc, newv = ofvc @ ops["S"][vindex], ofvc[:, :576] @ ops["W"][vindex]
        step_runs[B] = (yx, ip, st, torch.empty((B, G, 576 * nch), dtype=torch.int16,
                                                device="cuda"))
        del ofvc
        for key, c, rows in ((f"b{B}", nch, B * nch), (f"b{B}m", 1, B)):
            if c == 1 and B != cs.MP3_STREAMS:
                continue

            def one_set(c=c, rows=rows):
                out = torch.empty((B, G, 576 * c), dtype=torch.int16, device="cuda")[:, 0]
                return (acc[:rows].clone(), newv[:rows].clone(), st[4].clone(), keep, out)
            first = one_set()
            nbytes = sum(t.numel() * t.element_size() for t in first[:3]) + B * 576 * c * 2
            n_sets = max(cs.DOT_ROTATION, math.ceil(MXU_POST_L2_SPAN / nbytes))
            shapes[key] = ([first], [first] + [one_set() for _ in range(n_sets - 1)], c)
            post_bytes = cs.mxu_post_bytes(keep, B, c)
            bounds[key] = post_bytes / cs.PEAK_BYTES * 1e3
            print(f"{key}: B={B} nch={c}, granule 0 of the tonal run: {post_bytes} B, bound "
                  f"{bounds[key]:.4f} ms (bytes); rotated over {n_sets} sets of {nbytes} B")
        del acc, newv

    def row_of(lib):
        name = next(n for n, v in libs.items() if v[0] is lib)
        row = {"mismatches": float(mxu_post_errors(lib, runs, cases)) if name in exact
               else float("nan")}
        for key, (hot, rotated, c) in shapes.items():
            for label, sets in (("hot", hot), ("rot", rotated)):
                launch = cs.mxu_post_launcher(sets, c, lib=lib)
                row[f"{key}_{label}_ms"] = cs.cuda_time(launch, iters=40)
                row[f"{key}_{label}_queued_ms"] = cs.cuda_time_queued(launch, iters=40)
        real = mp3mxu.mp3_mxu_post_cuda
        mp3mxu.mp3_mxu_post_cuda = lambda *a, nch: mxu_post_call(lib, *a, nch=nch)
        try:   # the step loop of a run: the package's pre kernel, the GEMMs, this post
            for B, (yx, ip, st, pcm) in step_runs.items():
                row[f"b{B}_steps_ms"] = cs.cuda_time(
                    lambda: mp3mxu.mxu_steps(yx, ip, st, vindex, pcm, nch=nch), iters=5)
        finally:
            mp3mxu.mp3_mxu_post_cuda = real
        return row
    means = timed_turns(libs, row_of)
    for name, m in means.items():
        print(f"{name}: " + "; ".join(
            f"{key} hot {m[f'{key}_hot_queued_ms']:.4f} ms queued ({bounds[key] / m[f'{key}_hot_queued_ms']:.1%}"
            f" of the bound), {m[f'{key}_hot_ms']:.4f} unqueued, rotated "
            f"{m[f'{key}_rot_queued_ms']:.4f} queued ({bounds[key] / m[f'{key}_rot_queued_ms']:.1%}),"
            f" {m[f'{key}_rot_ms']:.4f} unqueued" for key in shapes)
              + "; a run of mxu_steps (G = 16) " + ", ".join(
                  f"B={B} {m[f'b{B}_steps_ms']:.4f} ms" for B in step_runs)
              + (f"; bit for bit {m['mismatches'] == 0} ({m['mismatches']:.0f} mismatches)"
                 if name in exact else "; not exact (a probe)")
              + " (means of 2 turns, 40 direct launches each)")
    print(json.dumps({"card": card, "device": torch.cuda.get_device_name(0), "bounds": bounds,
                      "variants": means}))


def quantize16_main(args, card: str) -> None:
    """--quantize16: the quantize-and-pack kernel's variants at both cells'
    chunk shapes, byte for byte against the plain version."""
    from esp_audio_libs_tpu_torch.ops import quantization_kernels as qk
    names = list(QUANT16_VARIANTS) if args.variants is None else args.variants
    src = kernels.CSRC / "pcm_quantize16.cu"
    dirs = {name: make_variant(f"quantize16_{name}", src.name, QUANT16_VARIANTS[name], [src])
            for name in names}
    libs = build_all(dirs, ("eal_quantize_pack16",))
    report_libs(libs, dirs, QUANT16_SASS_KERNEL)
    gen = torch.Generator(device="cuda").manual_seed(22)
    shapes = {}
    for key, T in (("down", 2981), ("up", 22587)):
        x = torch.empty((cs.BATCH, 2, T), device="cuda").uniform_(-1.06, 1.06, generator=gen)
        shapes[key] = (x, T - 8, qk.quantize_pack16_plain(x, T - 8))

    def row_of(lib):
        def quantize(x, g, out, clips):
            B, _, T = x.shape
            rc = lib.eal_quantize_pack16(x.data_ptr(), x.stride(0), x.stride(1), out.data_ptr(),
                                         out.stride(0) // 4, clips.data_ptr(), B, T, min(g, T),
                                         torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"eal_quantize_pack16: cudaError {rc}")
        row = {"cases_exact": float(cs.quantize16_mismatches(
            quantize, cs.quantize16_cases("cuda")) == [])}
        for key, (x, g, (want, want_clips)) in shapes.items():
            T = x.shape[-1]
            out = torch.empty((cs.BATCH, T * 4), dtype=torch.uint8, device="cuda")
            clips = torch.empty(cs.BATCH, dtype=torch.int64, device="cuda")
            quantize(x, g, out, clips)
            row[f"{key}_exact"] = float(torch.equal(out, want) and torch.equal(clips, want_clips))
            ms = cs.cuda_time_queued(lambda: quantize(x, g, out, clips), iters=40)
            row[f"{key}_ms"] = ms
            row[f"{key}_share"] = cs.quantize16_bytes(cs.BATCH, T) / cs.PEAK_BYTES * 1e3 / ms
        return row

    means = timed_turns(libs, row_of)
    for name, m in means.items():
        print(f"{name}: down {m['down_ms']:.4f} ms ({m['down_share']:.1%} of the bound), up "
              f"{m['up_ms']:.4f} ms ({m['up_share']:.1%}), byte-exact "
              f"{min(m['cases_exact'], m['down_exact'], m['up_exact']) == 1.0} (means of 2 turns)")
    print(json.dumps({"card": card, "device": torch.cuda.get_device_name(0), "variants": means}))


def sm_clock(launch, seconds: float = 1.5) -> str:
    """The SM clock (nvidia-smi, sampled every 50 ms) while ``launch()``
    runs back to back for ``seconds``: median and range in MHz, to turn a
    step time into cycles."""
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits",
                            "-lms", "50"], stdout=subprocess.PIPE, text=True)
    try:
        t_end = time.perf_counter() + seconds
        while time.perf_counter() < t_end:
            for _ in range(100):
                launch()
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        out, _ = smi.communicate(timeout=30)
    mhz = sorted(float(v) for v in out.split() if v.strip().isdigit())
    if len(mhz) < 3:
        return "not measured (nvidia-smi gave no samples)"
    return f"median {mhz[len(mhz) // 2]:.0f} MHz ({mhz[1]:.0f}..{mhz[-2]:.0f}, {len(mhz)} samples)"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--biquad", action="store_true",
                    help="probe the exact biquad kernel instead of the banded main loop")
    ap.add_argument("--biquad-parent", type=Path, nargs="+", default=[],
                    help="with --biquad: earlier biquad_exact.cu files, each timed as a "
                         "variant named by its directory")
    ap.add_argument("--dotprod", action="store_true",
                    help="probe the exact dot kernel instead of the banded main loop")
    ap.add_argument("--dotprod-parent", type=Path, nargs="+", default=[],
                    help="with --dotprod: earlier dotprod_exact.cu files, each timed as a "
                         "variant named by its directory")
    ap.add_argument("--polyphase-exact", action="store_true",
                    help="probe the exact polyphase kernel instead of the banded main loop")
    ap.add_argument("--polyphase-exact-parent", type=Path, nargs="+", default=[],
                    help="with --polyphase-exact: earlier polyphase_exact.cu files, each timed "
                         "as a variant named by its directory")
    ap.add_argument("--flac", action="store_true",
                    help="probe the FLAC frame kernel instead of the banded main loop")
    ap.add_argument("--flac-parent", type=Path, nargs="+", default=[],
                    help="with --flac: earlier flac_frame.cu files, each timed as a variant "
                         "named by its directory")
    ap.add_argument("--mp3", action="store_true",
                    help="probe the MP3 granule kernel instead of the banded main loop")
    ap.add_argument("--mp3-parent", type=Path, nargs="+", default=[],
                    help="with --mp3: earlier mp3_granules.cu files, each timed as a variant "
                         "named by its directory")
    ap.add_argument("--mp3f32", action="store_true",
                    help="probe the mirror tier's MP3 kernel instead of the banded main loop")
    ap.add_argument("--mp3f32-parent", type=Path, nargs="+", default=[],
                    help="with --mp3f32: earlier mp3_granules_f32.cu files, each timed as a "
                         "variant named by its directory")
    ap.add_argument("--mxu-pre", action="store_true",
                    help="probe the MXU tier's first step kernel instead of the banded main loop")
    ap.add_argument("--mxu-pre-parent", type=Path, nargs="+", default=[],
                    help="with --mxu-pre: earlier mp3_mxu_step.cu files, each timed as a "
                         "variant named by its directory")
    ap.add_argument("--mxu-post", action="store_true",
                    help="probe the MXU tier's second step kernel instead of the banded main "
                         "loop")
    ap.add_argument("--mxu-post-parent", type=Path, nargs="+", default=[],
                    help="with --mxu-post: earlier mp3_mxu_step.cu files, each timed as a "
                         "variant named by its directory")
    ap.add_argument("--quantize16", action="store_true",
                    help="the quantize-and-pack kernel's variants at both cells' chunk shapes")
    ap.add_argument("--parent-probes", nargs="+", default=[],
                    choices=sorted(set(PR4_PROBES) | set(FLAC_PARENT_PROBES)
                                   | set(MP3_PARENT_PROBES) | set(DOT_PARENT_PROBES)
                                   | set(MP3F32_PARENT_PROBES) | set(MXU_PRE_PARENT_PROBES)
                                   | set(MXU_POST_PARENT_PROBES)),
                    help="with --polyphase-exact-parent, --flac-parent, --mp3-parent, "
                         "--dotprod-parent, --mp3f32-parent, --mxu-pre-parent or "
                         "--mxu-post-parent: these probes of each parent too")
    ap.add_argument("--variants", nargs="*", default=None,
                    choices=sorted(set(VARIANTS) | set(BIQUAD_VARIANTS) | set(EXACT_VARIANTS)
                                   | set(FLAC_VARIANTS) | set(MP3_VARIANTS)
                                   | set(DOT_VARIANTS) | set(MP3F32_VARIANTS)
                                   | set(MXU_PRE_VARIANTS) | set(MXU_POST_VARIANTS)
                                   | set(QUANT16_VARIANTS)))
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
    if args.dotprod:
        dotprod_main(args, card)
        return
    if args.polyphase_exact:
        polyphase_exact_main(args, card)
        return
    if args.flac:
        flac_main(args, card)
        return
    if args.mp3:
        mp3_main(args, card)
        return
    if args.mp3f32:
        mp3f32_main(args, card)
        return
    if args.mxu_pre:
        mxu_pre_main(args, card)
        return
    if args.mxu_post:
        mxu_post_main(args, card)
        return
    if args.quantize16:
        quantize16_main(args, card)
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
