"""Wrappers of the hand-written CUDA kernels for the banded polyphase
contraction; the counterpart of esp_audio_libs_tpu/ops/polyphase_pallas.py.

For each kernel: the wrapper, its plain PyTorch version and a launch count.

* ``polyphase_banded_cuda`` (csrc/polyphase_banded.cu) replaces
  ``polyphase_banded_pallas``; its plain version is
  ops/polyphase.py::polyphase_banded.
* ``polyphase_fused16_cuda`` (csrc/polyphase_fused16.cu) replaces
  ``polyphase_fused16_pallas``; its plain version is
  :func:`polyphase_fused16_plain`.
* ``polyphase_banded_sharded`` and ``polyphase_fused16_sharded`` replace the
  ``shard_map`` forms ``polyphase_banded_pallas_sharded`` and
  ``polyphase_fused16_pallas_sharded`` over a stream mesh
  (parallel/mesh.py): one launch of the single-device kernel per shard, on
  the shard's block of rows, with the weight tiles and tile starts copied
  once to each distinct device of the mesh.
* ``polyphase_exact_cuda`` (csrc/polyphase_exact.cu) replaces the per-tap
  ``lax.scan`` of ``polyphase_apply(exact=True)``
  (esp_audio_libs_tpu/ops/polyphase.py:236-260), XLA there, not Pallas:
  ordered dots, the lerp and the mode select, each op rounded on its own
  with subnormals flushed (ops/scan.py). Its plain version is
  :func:`polyphase_exact_plain`.

Both banded kernels first launch csrc/band_ranges.cu on the same stream: for each
weight tile and group of ``GROUP`` columns, the first and last K-row holding
a nonzero weight (plain version: :func:`band_ranges`). The contraction then
skips the K-rows outside those ranges. Skipping products with an exactly
zero weight leaves every sum unchanged, except that a NaN or Inf in the
input at a zero-weight position no longer reaches the output (no PCM input
holds one).

A wrapper given CPU tensors runs the plain version. Given CUDA tensors it
launches the kernel on the current stream or raises; there is no fallback.
Any other device raises. ``<wrapper>.launches`` counts kernel launches only;
a sharded wrapper's count is the number of its per-shard launches (each is
also counted by the single-device wrapper that makes it).
"""

from __future__ import annotations

import torch

from ..parallel.mesh import Sharded, StreamMesh, shard_streams
from ..runtime import kernels
from .polyphase import polyphase_banded
from .scan import ftz

__all__ = ["GROUP", "band_ranges", "band_ranges_cuda", "polyphase_banded_cuda",
           "polyphase_banded_sharded", "polyphase_exact_cuda", "polyphase_exact_plain",
           "polyphase_fused16_cuda", "polyphase_fused16_plain", "polyphase_fused16_sharded",
           "reset_launch_counts"]

GROUP = 32   # columns of one band range in the plain version (csrc/banded_tile.cuh's GROUP)


def _route(*tensors: torch.Tensor) -> str:
    """'cpu' or 'cuda' for a set of tensors on one device; raises otherwise."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devs))}")
    kind = devs.pop().type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device type {kind!r}: expected cpu or cuda")
    return kind


def _check_weights(Wt: torch.Tensor) -> int:
    """Validate Wt f32 [nt, K, 128] with a dense [K, 128] block per tile (the
    tile stride may be 0: one shared block); return the tile stride."""
    if Wt.dtype != torch.float32 or Wt.dim() != 3 or Wt.shape[2] != 128:
        raise ValueError(f"Wt must be f32 [nt, K, 128], got {Wt.dtype} {tuple(Wt.shape)}")
    if Wt.stride(2) != 1 or Wt.stride(1) != 128:
        raise ValueError("each Wt tile must be a dense row-major [K, 128] block")
    return Wt.stride(0)


def _check_starts(starts: torch.Tensor, nt: int) -> None:
    if starts.dtype != torch.int32 or starts.shape != (nt,) or not starts.is_contiguous():
        raise ValueError(f"starts must be contiguous int32 [{nt}], got "
                         f"{starts.dtype} {tuple(starts.shape)}")


def _check_pitch(x: torch.Tensor, L: int) -> None:
    """The kernels copy slab rows in 16-byte chunks: the row pitch and the
    base address must be multiples of 16 bytes."""
    if (L * x.element_size()) % 16 or x.data_ptr() % 16:
        raise ValueError(f"row pitch {L} x {x.element_size()} bytes (or the base address) "
                         "is not a multiple of 16 bytes")


def _weight_tiles(Wt: torch.Tensor) -> int:
    """Number of distinct weight tiles: 1 when the tile stride is 0."""
    return 1 if Wt.stride(0) == 0 else Wt.shape[0]


def band_ranges(Wt: torch.Tensor) -> torch.Tensor:
    """Plain version of the band-range kernel: int32 ``[ntw, 128 // GROUP, 2]``,
    for each distinct weight tile (one when the tile stride is 0) and each
    group of ``GROUP`` columns, the first and last K-row holding a weight
    unequal to 0 (NaN counts, -0.0 does not); ``(K, -1)`` for an empty group."""
    ntw, K = _weight_tiles(Wt), Wt.shape[1]
    nz = (Wt[:ntw] != 0).reshape(ntw, K, 128 // GROUP, GROUP).any(-1)    # [ntw, K, groups]
    k = torch.arange(K, device=Wt.device)[None, :, None]
    first = torch.where(nz, k, K).amin(1)
    last = torch.where(nz, k, -1).amax(1)
    return torch.stack([first, last], -1).to(torch.int32)


def _band_parts(Wt: torch.Tensor) -> torch.Tensor:
    """Scratch for the band-range kernel's partials, sized by the library."""
    n = kernels.library().eal_band_parts_len(Wt.shape[1])
    return torch.empty((_weight_tiles(Wt), n), dtype=torch.int32, device=Wt.device)


def band_ranges_cuda(Wt: torch.Tensor) -> torch.Tensor:
    """The band-range kernel alone (the contraction wrappers launch it
    themselves), reduced over its partials; the same result as
    :func:`band_ranges`. For checking the kernel on the card."""
    if _route(Wt) == "cpu":
        return band_ranges(Wt)
    tile_stride = _check_weights(Wt)
    parts = _band_parts(Wt)
    with kernels.launch_on(Wt.device) as lib:
        rc = lib.eal_band_ranges(
            Wt.data_ptr(), parts.data_ptr(), parts.shape[0], Wt.shape[1], tile_stride,
            torch.cuda.current_stream(Wt.device).cuda_stream)
    _raise_on(rc, "band_ranges")
    parts = parts.view(parts.shape[0], -1, 128 // GROUP, 2)      # [ntw, pieces, groups, 2]
    return torch.stack([parts[..., 0].amin(1), parts[..., 1].amax(1)], -1)


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


def polyphase_banded_cuda(xext: torch.Tensor, Wt: torch.Tensor, starts: torch.Tensor,
                          *, T: int) -> torch.Tensor:
    """Banded contraction ``out[..., t] = sum_k x[..., starts[t//128]+k] *
    Wt[t//128, k, t%128]`` for ``t < T``.

    xext: f32 ``[..., L]``; Wt: f32 ``[nt, K, 128]``; starts: int32 ``[nt]``
    with ``start + K <= L``. Returns f32 ``[..., T]``. On the card, ``L * 4``
    must be a multiple of 16 bytes (``ValueError`` otherwise), and products
    whose weight is exactly zero are skipped (see the module docstring).
    """
    if _route(xext, Wt, starts) == "cpu":
        return polyphase_banded(xext, Wt, starts, T=T)
    nt, K, _ = Wt.shape
    tile_stride = _check_weights(Wt)
    _check_starts(starts, nt)
    if xext.dtype != torch.float32 or not xext.is_contiguous():
        raise ValueError(f"xext must be contiguous f32, got {xext.dtype}")
    if not 0 < T <= nt * 128:
        raise ValueError(f"T={T} outside (0, {nt * 128}]")
    *lead, L = xext.shape
    _check_pitch(xext, L)
    _check_pitch(Wt, 128)
    M = xext.numel() // L
    out = torch.empty((*lead, T), dtype=torch.float32, device=xext.device)
    parts = _band_parts(Wt)
    with kernels.launch_on(xext.device) as lib:
        rc = lib.eal_polyphase_banded(
            xext.data_ptr(), Wt.data_ptr(), starts.data_ptr(), out.data_ptr(), parts.data_ptr(),
            M, L, nt, K, tile_stride, T, torch.cuda.current_stream(xext.device).cuda_stream)
    _raise_on(rc, "polyphase_banded")
    polyphase_banded_cuda.launches += 1
    return out


polyphase_banded_cuda.launches = 0


def _quantize16(y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The fused kernel's epilogue in plain PyTorch: round-half-up with the
    product and the add separately rounded, x86 cast emulation (NaN or
    |y| >= 2^31 -> INT_MIN), clip to int16 with a clip mask."""
    y = torch.floor(torch.mul(y, 32768.0).add(0.5))
    bad = torch.isnan(y) | (y >= 2147483648.0) | (y < -2147483648.0)
    yc = torch.where(bad, -2147483648.0, y)
    clipped = (yc > 32767.0) | (yc < -32768.0)
    return yc.clamp(-32768.0, 32767.0).to(torch.int16), clipped.to(torch.int8)


def polyphase_fused16_plain(x2: torch.Tensor, Wt: torch.Tensor, starts: torch.Tensor):
    """Plain version of the fused kernel: the banded contraction of the raw
    int16 slabs in f32, then the 16-bit quantize epilogue."""
    nt = Wt.shape[0]
    y = polyphase_banded(x2.to(torch.float32), Wt, starts, T=nt * 128)
    return _quantize16(y)


def polyphase_fused16_cuda(x2: torch.Tensor, Wt: torch.Tensor, starts: torch.Tensor):
    """Fused resample + 16-bit quantize.

    Args:
      x2: RAW int16 samples ``[M, L]`` (history + chunk, gain NOT applied).
      Wt: f32 ``[nt, K, 128]`` weight tiles with the PCM gain factor folded in.
      starts: int32 ``[nt]`` tile starts.
    Returns: (samples int16 ``[M, nt*128]``, clip mask int8 ``[M, nt*128]``).
    Columns past the real output count carry values the caller ignores.
    On the card, ``L * 2`` must be a multiple of 16 bytes (``ValueError``
    otherwise), and products whose weight is exactly zero are skipped (see
    the module docstring).
    """
    if _route(x2, Wt, starts) == "cpu":
        return polyphase_fused16_plain(x2, Wt, starts)
    nt, K, _ = Wt.shape
    tile_stride = _check_weights(Wt)
    _check_starts(starts, nt)
    if x2.dtype != torch.int16 or x2.dim() != 2 or not x2.is_contiguous():
        raise ValueError(f"x2 must be contiguous int16 [M, L], got {x2.dtype} {tuple(x2.shape)}")
    M, L = x2.shape
    _check_pitch(x2, L)
    _check_pitch(Wt, 128)
    out = torch.empty((M, nt * 128), dtype=torch.int16, device=x2.device)
    clip = torch.empty((M, nt * 128), dtype=torch.int8, device=x2.device)
    parts = _band_parts(Wt)
    with kernels.launch_on(x2.device) as lib:
        rc = lib.eal_polyphase_fused16(
            x2.data_ptr(), Wt.data_ptr(), starts.data_ptr(), out.data_ptr(), clip.data_ptr(),
            parts.data_ptr(), M, L, nt, K, tile_stride,
            torch.cuda.current_stream(x2.device).cuda_stream)
    _raise_on(rc, "polyphase_fused16")
    polyphase_fused16_cuda.launches += 1
    return out, clip


polyphase_fused16_cuda.launches = 0


def _replicated(mesh: StreamMesh, Wt: torch.Tensor, starts: torch.Tensor) -> list:
    """Per shard, ``(Wt, starts)`` on the shard's device, copied once to each
    distinct device (a tile stride of 0 stays one shared block)."""
    copies = {}
    for dev in mesh.distinct():
        w = Wt[:1].to(dev).expand(Wt.shape) if Wt.stride(0) == 0 else Wt.to(dev)
        copies[dev] = (w, starts.to(dev))
    return [copies[dev] for dev in mesh.devices]


def polyphase_banded_sharded(xext, Wt: torch.Tensor, starts: torch.Tensor, *, T: int,
                             mesh: StreamMesh) -> Sharded:
    """The banded contraction over a stream mesh: the counterpart of
    ``polyphase_banded_pallas_sharded``
    (esp_audio_libs_tpu/ops/polyphase_pallas.py:201).

    ``xext`` ``[B, ..., L]`` (a tensor, or a :class:`Sharded` split along
    axis 0 over ``mesh``) must have its leading dim divisible by the mesh
    size (the serving classes' bucketing guarantees this). Each shard runs
    :func:`polyphase_banded_cuda` on its local ``[B/S, ..., L]`` block, one
    launch per shard, with ``Wt`` and ``starts`` replicated: no data moves
    between shards. Returns the ``[B, ..., T]`` output split along axis 0.
    """
    B = xext.shape[0]
    if B % mesh.size:
        raise ValueError(f"leading dim {B} must divide over the {mesh.size}-device mesh")
    xs = shard_streams(xext, mesh)
    before = polyphase_banded_cuda.launches
    parts = [polyphase_banded_cuda(x, w, st, T=T)
             for x, (w, st) in zip(xs.parts, _replicated(mesh, Wt, starts))]
    # the launches made through this wrapper: the inner wrapper counts each
    # at its launch
    polyphase_banded_sharded.launches += polyphase_banded_cuda.launches - before
    return Sharded(parts, 0, mesh)


polyphase_banded_sharded.launches = 0


def polyphase_fused16_sharded(x2, Wt: torch.Tensor, starts: torch.Tensor, *,
                              mesh: StreamMesh) -> tuple[Sharded, Sharded]:
    """The fused int16 kernel over a stream mesh: the counterpart of
    ``polyphase_fused16_pallas_sharded``
    (esp_audio_libs_tpu/ops/polyphase_pallas.py:319).

    Each shard runs :func:`polyphase_fused16_cuda` on its local ``[M/S, L]``
    int16 block with the gain-folded weight tiles and tile starts
    replicated, one launch per shard. Both outputs (int16 samples, int8 clip
    mask) come back split along axis 0. ``x2``'s leading dim must divide by
    the mesh size and leave a local block that is a multiple of 16 rows (the
    JAX kernel's int16 sublane minimum, which the resampler's tier gate
    checks before it picks this form, so that both packages pick the same
    tier); ``ValueError`` otherwise.
    """
    M = x2.shape[0]
    if M % mesh.size:
        raise ValueError(f"leading dim {M} must divide over the {mesh.size}-device mesh")
    if (M // mesh.size) % 16:
        raise ValueError(
            f"local block {M // mesh.size} below the fused kernel's 16-row "
            f"int16 sublane minimum (M={M}, mesh={mesh.size})")
    xs = shard_streams(x2, mesh)
    before = polyphase_fused16_cuda.launches
    outs = [polyphase_fused16_cuda(x, w, st)
            for x, (w, st) in zip(xs.parts, _replicated(mesh, Wt, starts))]
    polyphase_fused16_sharded.launches += polyphase_fused16_cuda.launches - before
    return Sharded([o[0] for o in outs], 0, mesh), Sharded([o[1] for o in outs], 0, mesh)


polyphase_fused16_sharded.launches = 0


def polyphase_exact_plain(xext, filters, win0x, idx1, idx2, weight, mode, *, half: int,
                          compute_second: bool = True):
    """Plain version of the exact polyphase kernel: the per-tap loop.

    For each output t: ``acc1 = sum_k x[win0x[t] + k] * filters[idx1[t], k]``
    accumulated from +0 in k order (``acc2`` likewise with ``idx2``), each
    product and sum rounded and flushed on its own; then mode 0 copies
    ``x[win0x[t] + half - 1]``, mode 1 gives acc1, any other mode
    ``acc2*w + acc1*(1 - w)`` with ``1 - w`` rounded first (acc1 without
    ``compute_second``). Window samples outside ``[0, L)`` read NaN, as
    ``jnp.take`` fills them past the end and before ``-L`` (it wraps an
    index in ``[-L, -1]``; no schedule starts a window before 0, and only
    padded mode-0 outputs past a chunk's generated count reach past the
    end, where a copy does not read them).

    xext: f32 ``[..., L]``; filters f32 ``[F+1, taps]``; win0x/idx1/idx2/mode
    integer ``[T]``; weight f32 ``[T]``. Returns f32 ``[..., T]``.
    """
    xext = xext.to(torch.float32)
    fb, w = ftz(filters.to(torch.float32)), ftz(weight.to(torch.float32))
    win = win0x.long()
    if win.numel():
        # windows outside [0, L) read NaN (as jnp.take fills them): pad
        lo = max(0, -int(win.min()))
        hi = max(0, int(win.max()) + fb.shape[1] - xext.shape[-1])
        if lo or hi:
            xext = torch.nn.functional.pad(xext, (lo, hi), value=float("nan"))
            win = win + lo
    xf = ftz(xext)
    f1 = fb[idx1.long()]                                             # [T, taps]
    f2 = fb[idx2.long()] if compute_second else None
    acc1 = torch.zeros(xext.shape[:-1] + win.shape, dtype=torch.float32, device=xext.device)
    acc2 = acc1.clone()
    for k in range(fb.shape[1]):
        xg = xf[..., win + k]
        acc1 = ftz(acc1 + ftz(xg * f1[:, k]))
        if compute_second:
            acc2 = ftz(acc2 + ftz(xg * f2[:, k]))
    lerp = ftz(ftz(acc2 * w) + ftz(acc1 * ftz(1.0 - w))) if compute_second else acc1
    direct = xext[..., win + (half - 1)]
    return torch.where(mode == 0, direct, torch.where(mode == 1, acc1, lerp))


def _check_grid(name: str, t: torch.Tensor, dtype, T: int) -> torch.Tensor:
    if t.dim() != 1 or t.shape[0] != T or t.dtype.is_floating_point != dtype.is_floating_point:
        raise ValueError(f"{name} must be [{T}] of {dtype}, got {t.dtype} {tuple(t.shape)}")
    return t.to(dtype).contiguous()


def polyphase_exact_cuda(xext, filters, win0x, idx1, idx2, weight, mode, *, half: int,
                         compute_second: bool = True):
    """The exact polyphase contraction. Arguments and result as
    :func:`polyphase_exact_plain`. On the card ``xext`` and ``filters`` must
    be f32 (made contiguous) and ``taps`` at most 4096."""
    if _route(xext, filters, win0x, idx1, idx2, weight, mode) == "cpu":
        return polyphase_exact_plain(xext, filters, win0x, idx1, idx2, weight, mode,
                                     half=half, compute_second=compute_second)
    if xext.dtype != torch.float32 or filters.dtype != torch.float32 or filters.dim() != 2:
        raise ValueError(f"xext must be f32 [..., L] and filters f32 [F+1, taps], got "
                         f"{xext.dtype} {tuple(xext.shape)}, {filters.dtype} {tuple(filters.shape)}")
    T = win0x.shape[0]
    grid = [_check_grid(n, g, torch.int32, T)
            for n, g in (("win0x", win0x), ("idx1", idx1), ("idx2", idx2), ("mode", mode))]
    w = _check_grid("weight", weight, torch.float32, T)
    *lead, L = xext.shape
    M = xext.numel() // L if L else 0
    out = torch.empty((*lead, T), dtype=torch.float32, device=xext.device)
    if M == 0 or T == 0:
        return out
    x = xext.contiguous()
    fb = filters.contiguous()
    with kernels.launch_on(xext.device) as lib:
        rc = lib.eal_polyphase_exact(
            x.data_ptr(), fb.data_ptr(), grid[0].data_ptr(), grid[1].data_ptr(), grid[2].data_ptr(),
            w.data_ptr(), grid[3].data_ptr(), out.data_ptr(), M, L, T, fb.shape[0], fb.shape[1],
            half, int(bool(compute_second)), torch.cuda.current_stream(xext.device).cuda_stream)
    _raise_on(rc, "polyphase_exact")
    polyphase_exact_cuda.launches += 1
    return out


polyphase_exact_cuda.launches = 0


def reset_launch_counts() -> None:
    polyphase_banded_cuda.launches = 0
    polyphase_fused16_cuda.launches = 0
    polyphase_banded_sharded.launches = 0
    polyphase_fused16_sharded.launches = 0
    polyphase_exact_cuda.launches = 0
