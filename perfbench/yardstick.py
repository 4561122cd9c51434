"""The benchmark's yardstick: peaks, statistics, the work a kernel launch
needs, and the reduction of a profiler trace to device busy time, kernel
time by name and host-labelled idle gaps.

Peaks are one NVIDIA H100 SXM's published dense rates (NVIDIA H100 data
sheet) at its 700 W limit. ``PEAK_INT32`` is an assumed peak: 64 INT32
lanes per SM (NVIDIA Hopper architecture whitepaper, the SM diagram) x 132
SMs x 1980 MHz, the card's maximum SM clock.
"""

from __future__ import annotations

import bisect
import math
import re
from pathlib import Path

PEAK_BYTES = 3.35e12          # HBM3, bytes/s
PEAK_FP32 = 67e12             # FP32 outside the tensor cores, operations/s (an FMA counts 2)
PEAK_INT32 = 64 * 132 * 1980e6
SPAN_PREFIX = "perfbench."    # the benchmark's own spans in a trace


# ---------------------------------------------------------------- statistics
def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100) by linear interpolation between the
    order statistics (numpy's default method), over every value."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(units: float, start: float, end: float) -> float:
    """Units per second over a window: all the work over all the time."""
    if end <= start:
        raise ValueError("empty window")
    return units / (end - start)


# ------------------------------------------------------ work of one launch
def bound_s(nbytes: float, ops: float, peak_ops: float = PEAK_FP32) -> float:
    """Least seconds for the work: the larger of the bytes at the memory
    rate and the operations at ``peak_ops``."""
    return max(nbytes / PEAK_BYTES, ops / peak_ops)


def biquad_work(lanes: int, T: int) -> tuple[int, int]:
    """(bytes, FP32 operations) of one exact DF-I biquad launch over
    ``lanes`` rows of ``T`` samples: x read and y written once, the four
    state words in and out, five coefficients; 9 operations a sample (five
    products, four sums)."""
    return 2 * lanes * T * 4 + 8 * lanes * 4 + 5 * 4, 9 * lanes * T


def polyphase_exact_work(M: int, L: int, T: int, rows: int, taps: int,
                         n_single: int, n_lerp: int) -> tuple[int, int]:
    """(bytes, FP32 operations) of one exact polyphase launch: x [M, L], the
    filterbank [rows, taps], the five grid arrays [T] and the output [M, T]
    each moved once; per row 2 operations a tap for a one-row output and 4
    a tap plus the 4 of the lerp for a two-row output (a copy is free)."""
    nbytes = (M * L + rows * taps + 5 * T + M * T) * 4
    return nbytes, M * (n_single * 2 * taps + n_lerp * (4 * taps + 4))


# chip_smoke.py's operation counts of the exact MP3 granule kernel
MP3_DEQUANT_OPS = (12, 18, 40)   # per nonzero line by magnitude: < 16, < 64, >= 64
MP3_EXPAND_OPS = 10              # per line below the Huffman span: band, gain, reorder
MP3_STEREO_OPS = 4               # per line below both channels' span, and channel (mid/side)
MP3_BUTTERFLY_OPS = 8            # per alias butterfly
MP3_IMDCT_OPS = 260              # per computed IMDCT block
MP3_FDCT_OPS = 408               # per subband slot's 32-point DCT
MP3_PQMF_OPS = 8 * 2 * 2 + 6     # per output: 8 taps x 2 widening multiply-adds, round, clip
MP3_STATE_WORDS = 576 + 6 + 2176  # per stream: overlap, flags, the synthesis FIFO


def mp3_granules_work(stats, streams: int) -> tuple[int, int]:
    """(bytes, integer operations) of one exact MP3 granule launch over
    ``streams`` stereo streams, from ``stats`` int [streams, granules, 2, 4]
    (per granule and channel: lines of magnitude 1-15, 16-63, 64+, and the
    Huffman span): chip_smoke.mp3_work's counts, mid/side in every granule.
    Bytes: the int16 spectra, 16 side-info bytes a granule and channel, the
    carried state read and written, the int16 PCM, each once."""
    stats = stats.reshape(streams, -1, 2, 4)
    G = stats.shape[1]
    span = stats[..., 3].clip(0, 576)
    blocks = ((span + 7) // 18 + 1).clip(max=32)
    units = streams * G * 2
    ops = (int((stats[..., 0] * MP3_DEQUANT_OPS[0] + stats[..., 1] * MP3_DEQUANT_OPS[1]
                + stats[..., 2] * MP3_DEQUANT_OPS[2]).sum())
           + int(span.sum()) * MP3_EXPAND_OPS + int(span.max(-1).sum()) * 2 * MP3_STEREO_OPS
           + int((blocks - 1).sum()) * 8 * MP3_BUTTERFLY_OPS + int(blocks.sum()) * MP3_IMDCT_OPS
           + units * 18 * MP3_FDCT_OPS + units * 576 * MP3_PQMF_OPS)
    nbytes = units * 576 * 2 + units * 16 + 2 * streams * MP3_STATE_WORDS * 4 + units * 576 * 2
    return nbytes, ops


# ------------------------------------------------------------ kernel names
def hand_kernels(csrc: Path) -> set[str]:
    """The names of the program's hand-written CUDA kernels: every
    ``__global__`` function of ``csrc/*.cu``."""
    names = set()
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(")
    for src in sorted(csrc.glob("*.cu")):
        names.update(pat.findall(src.read_text()))
    return names


def is_hand(name: str, hand: set[str]) -> bool:
    """Whether a device event's (demangled) name is one of ``hand``."""
    return any(re.search(rf"\b{re.escape(h)}\b", name) for h in hand)


# ---------------------------------------------------------------- traces
class Trace:
    """A profiler trace of a window, reduced: the device events (kernels,
    copies, sets) and the host events, both in ns on one clock."""

    def __init__(self, device_events, host_events, start_ns: int, end_ns: int, calls: int):
        self.start_ns, self.end_ns, self.calls = start_ns, end_ns, calls
        self.device = sorted((s, e, n) for s, e, n in device_events
                             if e > start_ns and s < end_ns)
        self.host = sorted((s, e, n) for s, e, n in host_events)
        self._host_starts = [h[0] for h in self.host]

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def busy_intervals(self):
        merged = []
        for s, e, _ in self.device:
            s, e = max(s, self.start_ns), min(e, self.end_ns)
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def by_name(self) -> dict:
        """Device seconds and event counts by name: {name: [count, seconds]}."""
        out = {}
        for s, e, n in self.device:
            c = out.setdefault(n, [0, 0.0])
            c[0] += 1
            c[1] += (e - s) / 1e9
        return out

    def gaps(self):
        """The idle stretches of the window: (start_ns, end_ns)."""
        t, out = self.start_ns, []
        for s, e in self.busy_intervals():
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if self.end_ns > t:
            out.append((t, self.end_ns))
        return out

    def host_label(self, at_ns: int) -> str:
        """The innermost host event running at ``at_ns`` (the one that began
        last among those that span it), or "host idle"."""
        i = bisect.bisect_right(self._host_starts, at_ns)
        best = None
        for j in range(i - 1, max(-1, i - 4000), -1):
            s, e, n = self.host[j]
            if e >= at_ns:
                best = n
                break
        return best or "host idle"

    def idle_by_host(self, top: int = 10):
        """Idle seconds summed by what the host was doing at each gap's
        middle, the largest ``top``."""
        acc = {}
        for s, e in self.gaps():
            label = self.host_label((s + e) // 2)
            acc[label] = acc.get(label, 0.0) + (e - s) / 1e9
        return sorted(([k, v] for k, v in acc.items()), key=lambda kv: -kv[1])[:top]

    def device_ops(self, top: int = 10, width: int = 160):
        """Device seconds by operation name (cut to ``width`` characters),
        the largest ``top``."""
        ops = sorted(([n, c[1]] for n, c in self.by_name().items()), key=lambda kv: -kv[1])
        return [[n[:width], sec] for n, sec in ops[:top]]


def _ns(ev, what: str) -> int:
    fn = getattr(ev, f"{what}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(ev, f"{what}_us")() * 1000)


def trace_from_profiler(prof, start_ns: int, end_ns: int, calls: int) -> Trace:
    """Reduce a finished ``torch.profiler.profile`` to a :class:`Trace`:
    device events are those of CUDA device type (kernels, memcpy, memset),
    without the device copies of the host's annotations (spans)."""
    device, host = [], []
    for ev in prof.profiler.kineto_results.events():
        s = _ns(ev, "start")
        e = s + int(ev.duration_ns()) if hasattr(ev, "duration_ns") else _ns(ev, "end")
        if "CUDA" not in str(ev.device_type()):
            host.append((s, e, ev.name()))
        elif not (ev.is_user_annotation() or ev.name().startswith(SPAN_PREFIX)):
            device.append((s, e, ev.name()))
    return Trace(device, host, start_ns, end_ns, calls)


def roofline_share(trace: Trace, kernel_name: str, launches) -> float | None:
    """The kernel's share of its roofline, in %: the least time of the
    traced launches' work (``launches``: (bytes, operations, peak
    operations/s) each) over the device time of the kernel's events. None
    when the trace holds no such event or another number of them than
    launches were made."""
    events = [(s, e) for s, e, n in trace.device if re.search(rf"\b{kernel_name}\b", n)]
    if not events or len(events) != len(launches):
        return None
    least = sum(bound_s(b, o, p) for b, o, p in launches)
    return 100.0 * least / (sum(e - s for s, e in events) / 1e9)
