"""The PCM traffic generator: a pool of packed s16 buffers, one row per
stream, made on the device from the seed in a few large calls.

Each stream is a few tones over a noise floor at its own level, as decoded
music and speech fill a PCM front end: per stream and channel ``tones``
sinusoids with frequencies drawn log-uniform from ``tone_hz`` and levels
from ``tone_dbfs``, plus Gaussian noise at a level from ``noise_dbfs``. A
share ``hot_share`` of the streams is raised by ``hot_db`` so that the
output quantizer clips some samples. Buffer k of the pool continues each
stream where buffer k - 1 ends. The parameters come from the traffic file;
the same seed gives the same bytes on the same device.
"""

from __future__ import annotations

import math

import torch

STREAM_BLOCK = 256      # streams made at a time: bounds the float temporaries


def make_pool(traffic: dict, seed: int, device) -> list[torch.Tensor]:
    """``traffic["pool_buffers"]`` uint8 tensors ``[streams, frames *
    channels * 2]`` of interleaved little-endian s16, ``frames`` =
    ``chunk_frames * chunks_per_call``, on ``device``."""
    sig = traffic["signal"]
    B, ch = traffic["streams"], traffic["channels"]
    frames = traffic["chunk_frames"] * traffic["chunks_per_call"]
    fs = float(traffic["source_sample_rate"])
    n_tones = sig["tones"]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device,
                                           dtype=torch.float64)

    lo_hz, hi_hz = (math.log(f) for f in sig["tone_hz"])
    freq = torch.exp(uniform((B, ch, n_tones), lo_hz, hi_hz)) / fs      # cycles a frame
    amp = 10.0 ** (uniform((B, ch, n_tones), *sig["tone_dbfs"]) / 20.0)
    phase0 = uniform((B, ch, n_tones), 0.0, 1.0)
    noise = 10.0 ** (uniform((B, 1, 1), *sig["noise_dbfs"]) / 20.0)
    hot = torch.rand((B, 1, 1), generator=gen, device=device) < sig["hot_share"]
    gain = torch.where(hot, 10.0 ** (sig["hot_db"] / 20.0), 1.0).to(torch.float64)

    pool = []
    t = torch.arange(frames, device=device, dtype=torch.float64)
    for k in range(traffic["pool_buffers"]):
        buf = torch.empty((B, frames * ch * 2), dtype=torch.uint8, device=device)
        rows = buf.view(torch.int16).view(B, frames, ch)
        for b0 in range(0, B, STREAM_BLOCK):
            sl = slice(b0, min(B, b0 + STREAM_BLOCK))
            cyc = torch.remainder(freq[sl, :, :, None] * (t + k * frames) + phase0[sl, :, :, None],
                                  1.0)
            x = (amp[sl, :, :, None] * torch.sin(2 * math.pi * cyc)).sum(2)   # [b, ch, frames]
            x = x + noise[sl] * torch.randn(x.shape, generator=gen, device=device,
                                            dtype=torch.float64)
            x = torch.round(x * gain[sl] * 32768.0).clamp(-32768, 32767)
            rows[sl] = x.to(torch.int16).transpose(1, 2)
        pool.append(buf)
    return pool
