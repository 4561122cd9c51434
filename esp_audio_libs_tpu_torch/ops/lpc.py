"""FLAC LPC/fixed prediction restoration and stereo decorrelation in plain
PyTorch: the counterpart of esp_audio_libs_tpu/ops/lpc.py (reference:
src/decode/flac/flac_lpc.cpp:85-125, flac_decoder.cpp:669-731).

These are the plain versions of the hand-written frame kernel
(csrc/flac_frame.cu, wrapped by ops/flac_kernels.py). The recurrence
``buf[i+order] += (sum_j buf[i+j] * c[j]) >> shift`` is sequential in time,
so :func:`lpc_restore` loops over time with a window of the last
``max_order`` samples per lane, all lanes advancing together. That is one
short run of tensor ops per sample: right for the CPU and the tests, far
too many launches for the card, which runs the kernel.

Integer semantics follow the JAX package on XLA bit for bit:
- ``use64=False`` wraps the predictor dot in int32 before the shift, as the
  reference's 32-bit path does (corrupted but CRC-valid streams do overflow;
  corpus/independent/mut_flip_payload_bits_i32_overflow.flac);
- ``use64=True`` sums exact int64 products, shifts, then keeps the low 32 bits;
- an arithmetic shift by an amount outside ``[0, bits)`` fills with the
  sign, and a left shift by 32 or more gives 0 (XLA's shift semantics);
- every int32 add wraps.
Arithmetic runs in int64 and wraps to int32 explicitly, so no step relies on
signed overflow.
"""

from __future__ import annotations

import torch

MAX_ORDER = 32

__all__ = ["lpc_restore", "decorrelate", "wrap32", "MAX_ORDER"]


def wrap32(x: torch.Tensor) -> torch.Tensor:
    """The low 32 bits of an int64 tensor as a signed value (still int64)."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def lpc_restore(data: torch.Tensor, coeffs: torch.Tensor, order: torch.Tensor,
                shift: torch.Tensor, *, use64: bool = True,
                max_order: int = MAX_ORDER) -> torch.Tensor:
    """Restore LPC/fixed prediction for a batch of subframes.

    Args:
      data: int32 ``[..., T]``: warm-up samples in ``[0, order)``, then
        residuals (the reference's in-place layout).
      coeffs: int32 ``[..., 32]``: predictor coefficients oldest-first,
        zero-padded beyond ``order``.
      order: int32 ``[...]``: predictor order (0 passes the data through).
      shift: int32 ``[...]``: quantization shift (0 for fixed predictors).
      use64: accumulate the dot in int64; ``False`` wraps it in int32, valid
        where the front-end's overflow analysis cleared every subframe.
      max_order: the window width, at least ``max(order)``.

    Returns: int32 ``[..., T]`` restored samples.
    """
    if data.dtype != torch.int32:
        raise TypeError(f"data must be int32, got {data.dtype}")
    W = int(max_order)
    T = data.shape[-1]
    batch = data.shape[:-1]
    order_l = order.long()
    # c_al[k] pairs with window slot k, which holds the sample at lag W - k:
    # c[j] multiplies lag order - j, so c_al[k] = c[k - (W - order)]
    j = torch.arange(W, device=data.device) - (W - order_l[..., None])        # [..., W]
    valid = (j >= 0) & (j < order_l[..., None])
    c_al = torch.where(valid, torch.gather(coeffs.long().expand(*batch, coeffs.shape[-1]), -1,
                                           j.clamp(0, coeffs.shape[-1] - 1)), 0)
    bits = 64 if use64 else 32
    sh = shift.long()
    sh = torch.where((sh < 0) | (sh >= bits), bits - 1, sh)
    hist = torch.zeros((*batch, W + T), dtype=torch.int64, device=data.device)
    x = data.long()
    for i in range(T):
        dot = (hist[..., i:i + W] * c_al).sum(-1)          # wraps mod 2^64
        if not use64:
            dot = wrap32(dot)
        y = wrap32(x[..., i] + wrap32(dot >> sh))
        hist[..., W + i] = torch.where(order_l > i, x[..., i], y)
    return hist[..., W:].to(torch.int32)


def decorrelate(samples: torch.Tensor, channel_assignment: torch.Tensor) -> torch.Tensor:
    """Undo inter-channel decorrelation for stereo frames.

    samples: int32 ``[..., 2, T]`` (already wasted-bits-shifted).
    channel_assignment: int32 ``[...]``: 0..7 independent, 8 left/side,
    9 right/side, 10 mid/side (reference flac_decoder.cpp:691-706).
    """
    ca = channel_assignment.long()[..., None]
    ch0 = samples[..., 0, :].long()
    ch1 = samples[..., 1, :].long()
    ms_r = wrap32(ch0 - (ch1 >> 1))
    out0 = torch.where(ca == 8, ch0, torch.where(
        ca == 9, wrap32(ch0 + ch1), torch.where(ca == 10, wrap32(ms_r + ch1), ch0)))
    out1 = torch.where(ca == 8, wrap32(ch0 - ch1), torch.where(
        ca == 9, ch1, torch.where(ca == 10, ms_r, ch1)))
    return torch.stack([out0, out1], dim=-2).to(torch.int32)
