"""MP3 decoding of the port: native host front-end + device back-end, the
counterpart of esp_audio_libs_tpu/models/mp3.py.

Public semantics mirror the reference Helix API (reference:
include/mp3_decoder.h:386-394): ``MP3Decode``, frame info and sync search,
with the same error codes and bad-frame zero-fill.

The native front-end (native/src/mp3_frontend.cpp, the same
``libeal_host.so`` the JAX package loads) does everything bitstream-serial
and emits 576-coefficient tensors and parameters; this module builds the
per-sample parameter arrays that turn the reference's per-critical-band
loops into uniform passes, and the device runs a whole run of granules in
one launch of the hand-written kernel ``ops.mp3_kernels.mp3_granules_cuda``
(csrc/mp3_granules.cu) through ``models.mp3_pipeline``; on the CPU its plain
version runs. All of it is int32/int64 fixed point, byte-exact against the
JAX package.
"""

from __future__ import annotations

import ctypes as C
import functools

import numpy as np
import torch

from ..runtime.kernels import entry_device
from ..runtime.native import host_lib
from ..runtime.tables import mp3_tables
from ..utils.errors import MP3Error

__all__ = ["MP3Decoder", "expand_hp_device", "format_maps", "granule_params",
           "granule_params_compact_blob"]

MAX_NSAMP = 576
IMDCT_SCALE = 2

_i32p = C.POINTER(C.c_int32)
_u8p = C.POINTER(C.c_uint8)


def granule_params(params: np.ndarray, sf: np.ndarray, frame: np.ndarray, sfjs: np.ndarray,
                   nzb: np.ndarray) -> dict:
    """Build per-sample parameter arrays for one granule (all channels).

    Mirrors the control flow of the reference DequantChannel
    (src/decode/mp3_decoder.cpp:657-795): which critical band each sample
    belongs to, its gainI, the short-block reorder permutation, and the
    processed range implied by the early-exit-at-nonZeroBound logic — plus
    the output-order structure arrays used by the stereo stage.

    Args:
      params: int32 ``[C, 24]`` per-channel side info (front-end layout).
      sf:     int32 ``[C, 62]`` scalefactors (l[23] + s[13*3]).
      frame:  int32 ``[16]`` frame fields (front-end layout).
      sfjs:   int32 ``[8]`` slen[4] + nr[4].
      nzb:    int32 ``[C]`` input non-zero bounds.

    Returns: dict of numpy arrays keyed as ops.mp3dsp.dequantize_granule's
    ``hp`` expects (without the leading lane axis).
    """
    T = mp3_tables()
    ver, sr_idx, s_mode, mode_ext = int(frame[0]), int(frame[4]), int(frame[2]), int(frame[3])
    nch = int(frame[5])
    sfb_l = T["sfBandLong"][ver][sr_idx]
    sfb_s = T["sfBandShort"][ver][sr_idx]
    pre_tab = T["preTab"]

    Cn = nch
    gain = np.zeros((Cn, MAX_NSAMP), np.int32)
    band_in = np.full((Cn, MAX_NSAMP), -1, np.int32)
    win_in = np.zeros((Cn, MAX_NSAMP), np.int32)
    is_long_in = np.zeros((Cn, MAX_NSAMP), bool)
    processed = np.zeros((Cn, MAX_NSAMP), bool)
    invperm = np.tile(np.arange(MAX_NSAMP, dtype=np.int32), (Cn, 1))
    short_base = np.zeros(Cn, np.int32)
    cb_start_s = np.zeros(Cn, np.int32)
    has_short = np.zeros(Cn, bool)
    cb_type = np.zeros(Cn, np.int32)
    out_nzb_short = np.zeros(Cn, np.int32)

    for ch in range(Cn):
        p = params[ch]
        block_type, mixed = int(p[5]), int(p[6])
        sfact_mult = 2 * (int(p[16]) + 1)
        global_gain = int(p[2])
        if mode_ext >> 1:
            global_gain -= 2
        global_gain += IMDCT_SCALE

        if block_type == 2:
            if mixed:
                cb_end_l = 8 if ver == 0 else 6
                cbs = 3
            else:
                cb_end_l = 0
                cbs = 0
            cb_end_s = 13
        else:
            cb_end_l = 22
            cbs = 13
            cb_end_s = 13
        cb_start_s[ch] = cbs
        has_short[ch] = cbs < 12
        cb_type[ch] = 0 if block_type != 2 else (2 if mixed else 1)

        sfl = sf[ch, :23]
        sfs = sf[ch, 23:].reshape(13, 3)
        i = 0
        short_base[ch] = 0
        for cb in range(cb_end_l):
            n = int(sfb_l[cb + 1] - sfb_l[cb])
            g = 210 - global_gain + sfact_mult * (int(sfl[cb]) + (int(pre_tab[cb]) if p[15] else 0))
            gain[ch, i:i + n] = g
            band_in[ch, i:i + n] = cb
            is_long_in[ch, i:i + n] = True
            processed[ch, i:i + n] = True
            i += n
            if i >= nzb[ch]:
                break
        short_base[ch] = i

        if cbs < 12:
            for cb in range(cbs, cb_end_s):
                n = int(sfb_s[cb + 1] - sfb_s[cb])
                for w in range(3):
                    g = 210 - global_gain + 8 * int(p[10 + w]) + sfact_mult * int(sfs[cb, w])
                    gain[ch, i + n * w: i + n * (w + 1)] = g
                    band_in[ch, i + n * w: i + n * (w + 1)] = cb
                    win_in[ch, i + n * w: i + n * (w + 1)] = w
                    processed[ch, i + n * w: i + n * (w + 1)] = True
                # reorder: out[i + 3j + w] = in[i + n*w + j]
                for w in range(3):
                    j = np.arange(n)
                    invperm[ch, i + 3 * j + w] = i + n * w + j
                i += 3 * n
                if i >= nzb[ch]:
                    break
            out_nzb_short[ch] = i

    # ---- output-order structure arrays (for the stereo stage) ----
    idx = np.arange(MAX_NSAMP)
    band_out_l = np.full(MAX_NSAMP, -1, np.int32)
    for cb in range(22):
        band_out_l[sfb_l[cb]: sfb_l[cb + 1]] = cb
    band_out_s = np.full(MAX_NSAMP, -1, np.int32)
    win_out = np.zeros(MAX_NSAMP, np.int32)
    for cb in range(13):
        lo, hi = 3 * int(sfb_s[cb]), 3 * int(sfb_s[cb + 1])
        band_out_s[lo:hi] = cb
        win_out[lo:hi] = (idx[lo:hi] - lo) % 3

    # right-channel scalefactors per sample (for intensity)
    sf_r_l = np.zeros(MAX_NSAMP, np.int32)
    sf_r_s = np.zeros(MAX_NSAMP, np.int32)
    il_l = np.zeros(MAX_NSAMP, np.int32)
    il_s = np.zeros(MAX_NSAMP, np.int32)
    if Cn == 2:
        sfl1 = sf[1, :23]
        sfs1 = sf[1, 23:].reshape(13, 3)
        valid_l = band_out_l >= 0
        sf_r_l[valid_l] = sfl1[band_out_l[valid_l]]
        valid_s = band_out_s >= 0
        sf_r_s[valid_s] = sfs1[band_out_s[valid_s], win_out[valid_s]]
        # MPEG2 illegal-intensity-position per band (reference :1330-1334)
        il = np.zeros(23, np.int64)
        k = 0
        for r in range(4):
            tmp = (1 << int(sfjs[r])) - 1
            for _ in range(int(sfjs[4 + r])):
                if k < 23:
                    il[k] = tmp
                k += 1
        il_long = il.copy()
        il_long[21] = il_long[22] = 1     # (:1352)
        il_short = il.copy()
        il_short[12] = 1                  # (:1391)
        il_l[valid_l] = il_long[band_out_l[valid_l]]
        il_s[valid_s] = il_short[np.clip(band_out_s[valid_s], 0, 12)]

    return dict(
        gain=gain, band_in=band_in, win_in=win_in, is_long_in=is_long_in,
        processed=processed, invperm=invperm, short_base=short_base,
        cb_start_s=cb_start_s,
        has_short=has_short, cb_type=cb_type, out_nzb_short=out_nzb_short,
        band_out_l=band_out_l, band_out_s=band_out_s, win_out=win_out,
        sf_right_l=sf_r_l, sf_right_s=sf_r_s, il_out_l=il_l, il_out_s=il_s,
        sfb_l=sfb_l.astype(np.int32), sfb_s=sfb_s.astype(np.int32),
        mode_ext=np.int32(mode_ext), ver_is_mpeg1=np.bool_(ver == 0),
        intensity_scale=np.int32(frame[12]),
    )


# compact band-level blob: 2*22 + 2*39 + 2*6 + 23 + 39 + 23 + 13 + 3 words
# (layout: native/src/mp3_frontend.cpp eal_mp3_granule_params_compact)
_GPC_SIZE = 2 * 22 + 2 * 39 + 2 * 6 + 23 + 39 + 23 + 13 + 3


def granule_params_compact_blob(params, sf, frame, sfjs, nzb, nch) -> np.ndarray:
    """Raw compact parameter blob ``[B, _GPC_SIZE]`` (one native call;
    layout: native/src/mp3_frontend.cpp eal_mp3_granule_params_compact).
    Each call returns a new array (the JAX package reuses one buffer per B,
    which its callers must copy out before the next call)."""
    B = params.shape[0]
    p2 = np.zeros((B, 2, 24), np.int32)
    p2[:, :nch] = params[:, :nch]
    s2 = np.zeros((B, 2, 62), np.int32)
    s2[:, :nch] = sf[:, :nch]
    n2 = np.zeros((B, 2), np.int32)
    n2[:, :nch] = nzb[:, :nch]
    fr = np.ascontiguousarray(frame, np.int32)
    js = np.ascontiguousarray(sfjs, np.int32)
    out = np.empty((B, _GPC_SIZE), np.int32)
    host_lib().eal_mp3_granule_params_compact_batch(
        B, p2.ctypes.data_as(_i32p), s2.ctypes.data_as(_i32p),
        fr.ctypes.data_as(_i32p), js.ctypes.data_as(_i32p),
        n2.ctypes.data_as(_i32p), out.ctypes.data_as(_i32p))
    return out


@functools.lru_cache(None)
def format_maps(ver: int, sr_idx: int) -> dict:
    """Static per-format per-sample maps (numpy, cached). These never depend
    on stream data:

      long_band[576]   input-order long-section band per sample (sfb_l)
      off_band/off_win/inv_off [2, 576]   short-section band / window /
        reorder source, indexed by OFFSET from the (dynamic) short-section
        base, one row per cbs in (0, 3) — the only short-start bands
      band_out_l/band_out_s/win_out [576]  output-order structure
      sfb_l[23] sfb_s[14]
    """
    T = mp3_tables()
    sfb_l = T["sfBandLong"][ver][sr_idx].astype(np.int32)
    sfb_s = T["sfBandShort"][ver][sr_idx].astype(np.int32)
    N = MAX_NSAMP

    long_band = np.zeros(N, np.int32)
    for cb in range(22):
        long_band[sfb_l[cb]: sfb_l[cb + 1]] = cb

    off_band = np.zeros((2, N), np.int32)
    off_win = np.zeros((2, N), np.int32)
    inv_off = np.tile(np.arange(N, dtype=np.int32), (2, 1))
    for ci, cbs in enumerate((0, 3)):
        off = 0
        for cb in range(cbs, 13):
            n = int(sfb_s[cb + 1] - sfb_s[cb])
            for w in range(3):
                off_band[ci, off + n * w: off + n * (w + 1)] = cb
                off_win[ci, off + n * w: off + n * (w + 1)] = w
            j = np.arange(n)
            for w in range(3):
                inv_off[ci, off + 3 * j + w] = off + n * w + j
            off += 3 * n

    idx = np.arange(N)
    band_out_l = np.full(N, -1, np.int32)
    for cb in range(22):
        band_out_l[sfb_l[cb]: sfb_l[cb + 1]] = cb
    band_out_s = np.full(N, -1, np.int32)
    win_out = np.zeros(N, np.int32)
    for cb in range(13):
        lo, hi = 3 * int(sfb_s[cb]), 3 * int(sfb_s[cb + 1])
        band_out_s[lo:hi] = cb
        win_out[lo:hi] = (idx[lo:hi] - lo) % 3
    return dict(long_band=long_band, off_band=off_band, off_win=off_win,
                inv_off=inv_off, band_out_l=band_out_l, band_out_s=band_out_s,
                win_out=win_out, sfb_l=sfb_l, sfb_s=sfb_s)




_MAP_KEYS = ("long_band", "band_out_l", "band_out_s", "win_out", "sfb_l", "sfb_s")


def expand_hp_device(compact, maps, nch: int) -> dict:
    """Per-sample expansion of the compact blob on its device: gathers and
    masks against the static per-format maps. The integers equal the JAX
    ``expand_hp_device``'s, whose select trees and one-hot products stand
    in for gathers that were slow on the TPU.

    Args:
      compact: int32 ``[B, _GPC_SIZE]`` blobs (``granule_params_compact_blob``).
      maps: :func:`format_maps` of the format (numpy).
      nch: channels.
    Returns the ``hp`` dict ``ops.mp3dsp.dequantize_granule`` reads.
    """
    B = compact.shape[0]
    dev = compact.device
    N = MAX_NSAMP
    i32 = torch.int32
    m = {k: torch.as_tensor(np.asarray(maps[k]), dtype=i32, device=dev) for k in _MAP_KEYS}
    o = 0

    def take(*shape):
        nonlocal o
        n = int(np.prod(shape))
        v = compact[:, o:o + n].reshape(B, *shape)
        o += n
        return v

    gain_l = take(2, 22)[:, :nch]
    gain_s = take(2, 39)[:, :nch]
    pe_l = take(2)[:, :nch]
    short_base = take(2)[:, :nch]
    pe_s = take(2)[:, :nch]
    cb_start_s = take(2)[:, :nch]
    has_short = take(2)[:, :nch].to(torch.bool)
    cb_type = take(2)[:, :nch]
    sfl1, sfs1, il_long, il_short, scalars = take(23), take(39), take(23), take(13), take(3)

    idx = torch.arange(N, dtype=i32, device=dev)
    long_proc = idx < pe_l[..., None]                                   # [B, C, N]
    off = idx - short_base[..., None]
    so = off.clamp(0, N - 1)
    short_proc = (off >= 0) & (idx < pe_s[..., None]) & has_short[..., None]

    # short section: band = the last band whose start (relative to the
    # section's first band sfb_s[cbs], cbs = 0 or 3) is <= the offset
    sfb_s = m["sfb_s"]
    base_s = torch.where(cb_start_s == 3, sfb_s[3], sfb_s[0])          # [B, C]
    starts = 3 * (sfb_s[:13] - base_s[..., None])                       # [B, C, 13]
    sband = (so[..., None] >= starts[..., None, :]).sum(-1) - 1         # [B, C, N]
    s_sel = torch.gather(starts, -1, sband)
    n_sel = (sfb_s[1:] - sfb_s[:-1])[sband]
    q = so - s_sel
    swin = torch.div(q, n_sel, rounding_mode="floor")
    sinv = s_sel + n_sel * (q % 3) + torch.div(q, 3, rounding_mode="floor")
    g_short = torch.gather(gain_s, -1, sband * 3 + swin.clamp(0, 2).to(torch.int64))

    lband = m["long_band"]
    g_long = torch.gather(gain_l, -1, lband.to(torch.int64).expand(B, gain_l.shape[1], N))
    zero = torch.zeros_like(so)
    band_in = torch.where(long_proc, lband, torch.where(short_proc, sband.to(i32), zero - 1))
    gain = torch.where(long_proc, g_long, torch.where(short_proc, g_short, zero))
    win_in = torch.where(short_proc, swin, zero)
    processed = long_proc | short_proc
    invperm = torch.where(short_proc, short_base[..., None] + sinv, idx)

    # output-order right-channel parameters
    bo_l, bo_s, wo = m["band_out_l"], m["band_out_s"], m["win_out"]
    valid_l, valid_s = bo_l >= 0, bo_s >= 0
    il_idx_l = bo_l.clamp(0, 22).to(torch.int64)
    zero_n = torch.zeros((B, N), dtype=i32, device=dev)
    sf_right_l = torch.where(valid_l, sfl1[:, il_idx_l], zero_n)
    sf_right_s = torch.where(valid_s, sfs1[:, (bo_s * 3 + wo).clamp(0, 38).to(torch.int64)],
                             zero_n)
    il_out_l = torch.where(valid_l, il_long[:, il_idx_l], zero_n)
    il_out_s = torch.where(valid_s, il_short[:, bo_s.clamp(0, 12).to(torch.int64)], zero_n)

    def bc(a):
        return a[None].expand((B,) + tuple(a.shape))

    return dict(
        gain=gain, band_in=band_in, win_in=win_in, is_long_in=long_proc,
        processed=processed, invperm=invperm, short_base=short_base,
        cb_start_s=cb_start_s, has_short=has_short, cb_type=cb_type, out_nzb_short=pe_s,
        band_out_l=bc(bo_l), band_out_s=bc(bo_s), win_out=bc(wo),
        sf_right_l=sf_right_l, sf_right_s=sf_right_s, il_out_l=il_out_l, il_out_s=il_out_s,
        sfb_l=bc(m["sfb_l"]), sfb_s=bc(sfb_s), mode_ext=scalars[:, 0],
        ver_is_mpeg1=scalars[:, 1].to(torch.bool), intensity_scale=scalars[:, 2],
    )


def _frame_info(info: np.ndarray) -> dict:
    return {"bitrate": int(info[0]), "nChans": int(info[1]), "samprate": int(info[2]),
            "bitsPerSample": int(info[3]), "outputSamps": int(info[4]),
            "layer": int(info[5]), "version": int(info[6])}


class MP3Decoder:
    """Drop-in equivalent of the reference Helix public API, device-accelerated.

    See ``decode`` (== MP3Decode), ``get_last_frame_info``,
    ``get_next_frame_info``, ``find_sync_word``. The carried synthesis state
    (overlap, block types, FIFO) lives on the host between frames, as in
    the JAX package's ``MP3Decoder``; ``BatchedMP3Decoder`` keeps it on the
    device.

    Args:
      device: where the granule kernel runs: ``"cuda"`` (the default: the
        hand-written kernel) or ``"cpu"`` (its plain version). ``"cuda"``
        without a usable card raises; nothing falls back.
    """

    def __init__(self, device="cuda"):
        self.device = entry_device(device, "MP3Decoder")
        self._lib = host_lib()
        self._ctx = self._lib.eal_mp3_create()
        self._last_frame = None
        self.last_frame_reference_defined = True
        # carried synthesis state (per channel)
        self._over = np.zeros((2, 288), np.int32)
        self._prev_type = np.zeros(2, np.int32)
        self._prev_win_switch = np.zeros(2, np.int32)
        self._num_prev = np.zeros(2, np.int32)
        self._vbuf = np.zeros(2 * 1088, np.int32)
        self._vindex = 0

    def __del__(self):
        try:
            self._lib.eal_mp3_destroy(self._ctx)
        except Exception:
            pass

    def get_state(self) -> dict:
        """Serializable snapshot of all carried decode state, the JAX
        package's dict: the native front-end image (bit reservoir included)
        and the synthesis state (overlap, block types, FIFO). Restore with
        :meth:`set_state` into an ``MP3Decoder`` of either package; decoding
        then continues byte-identically to an uninterrupted run."""
        return {"native": self._native_snapshot(),
                "over": self._over.copy(),
                "prev_type": self._prev_type.copy(),
                "prev_win_switch": self._prev_win_switch.copy(),
                "num_prev": self._num_prev.copy(),
                "vbuf": self._vbuf.copy(),
                "vindex": self._vindex}

    def set_state(self, state: dict) -> None:
        """Load a :meth:`get_state` snapshot; a bad or truncated native
        image raises ``RuntimeError``."""
        self._native_restore(state["native"])
        self._over = np.array(state["over"], np.int32)
        self._prev_type = np.array(state["prev_type"], np.int32)
        self._prev_win_switch = np.array(state["prev_win_switch"], np.int32)
        self._num_prev = np.array(state["num_prev"], np.int32)
        self._vbuf = np.array(state["vbuf"], np.int32)
        self._vindex = int(state["vindex"])

    def _native_snapshot(self) -> bytes:
        """The native front-end's image (bit reservoir, headers): the state
        a host parse changes, saved to roll back a parse whose results turn
        out unusable (``BatchedMP3Decoder.decode_run`` with ``to_device``)."""
        n = self._lib.eal_mp3_state_size(self._ctx)
        buf = np.zeros(n, np.uint8)
        if self._lib.eal_mp3_state_save(self._ctx, buf.ctypes.data_as(_u8p), n) != 0:
            raise RuntimeError("MP3 state save failed")
        return buf.tobytes()

    def _native_restore(self, blob: bytes) -> None:
        data = np.frombuffer(blob, np.uint8)
        if self._lib.eal_mp3_state_load(self._ctx, data.ctypes.data_as(_u8p), data.size) != 0:
            raise RuntimeError("MP3 state load failed (bad/incompatible blob)")

    @staticmethod
    def find_sync_word(buf: bytes) -> int:
        b = np.frombuffer(buf, np.uint8)
        return host_lib().eal_mp3_find_sync_word(b.ctypes.data_as(_u8p), b.size)

    def parse_frame(self, buf: bytes, use_size: bool = False):
        """Run the serial front-end on one frame; returns the raw stage
        arrays (error, huff, params, sf, frame, sfjs, consumed, clear,
        error granule)."""
        b = np.frombuffer(buf, np.uint8) if isinstance(buf, (bytes, bytearray)) else buf
        huff = np.zeros(2 * 2 * MAX_NSAMP, np.int32)
        params = np.zeros(2 * 2 * 24, np.int32)
        sf = np.zeros(2 * 2 * 62, np.int32)
        frame = np.zeros(16, np.int32)
        sfjs = np.zeros(8, np.int32)
        consumed = C.c_int32(0)
        clear = C.c_int32(0)
        err_gr = C.c_int32(0)
        err = self._lib.eal_mp3_parse_frame(
            self._ctx, b.ctypes.data_as(_u8p), b.size, int(use_size),
            huff.ctypes.data_as(_i32p), params.ctypes.data_as(_i32p), sf.ctypes.data_as(_i32p),
            frame.ctypes.data_as(_i32p), sfjs.ctypes.data_as(_i32p),
            C.byref(consumed), C.byref(clear), C.byref(err_gr))
        self._last_frame = frame
        return (MP3Error(err), huff.reshape(2, 2, MAX_NSAMP), params.reshape(2, 2, 24),
                sf.reshape(2, 2, 62), frame, sfjs, consumed.value, bool(clear.value),
                err_gr.value)

    def get_last_frame_info(self) -> dict:
        """MP3GetLastFrameInfo equivalent (reference :8613-8634): all-zero
        fields before any successful Layer III header parse."""
        info = np.zeros(7, np.int32)
        self._lib.eal_mp3_last_frame_info(self._ctx, info.ctypes.data_as(_i32p))
        return _frame_info(info)

    def get_next_frame_info(self, buf: bytes):
        b = np.frombuffer(buf, np.uint8)
        info = np.zeros(7, np.int32)
        err = self._lib.eal_mp3_frame_info(self._ctx, b.ctypes.data_as(_u8p),
                                           info.ctypes.data_as(_i32p))
        return MP3Error(err), _frame_info(info)

    def _state(self):
        return (self._over, self._prev_type, self._prev_win_switch, self._num_prev,
                self._vbuf, self._vindex)

    def _set(self, state) -> None:
        (self._over, self._prev_type, self._prev_win_switch, self._num_prev,
         self._vbuf, self._vindex) = state

    def decode(self, buf: bytes, use_size: bool = False):
        """MP3Decode equivalent: one frame -> (error, int16 PCM, consumed bytes).

        On bad frames returns zeroed PCM like MP3ClearBadFrame
        (reference :8677-8685) when the frame size was known. Granules
        before a failing one still update the carried state, as the
        reference decodes granule by granule (:8807-8854).
        """
        from .mp3_pipeline import decode_granules

        err, huff, params, sf, frame, sfjs, consumed, clear, err_gr = \
            self.parse_frame(buf, use_size)
        ngr, nch, ngs = int(frame[6]), int(frame[5]), int(frame[7])
        self.last_frame_reference_defined = True
        if err != MP3Error.NONE:
            if err_gr > 0:
                _, state, rdef = decode_granules(huff, params, sf, frame, sfjs, self._state(),
                                                 n_granules=err_gr, device=self.device)
                self.last_frame_reference_defined = rdef
                self._set(state)
            pcm = np.zeros(ngr * ngs * nch, np.int16) if clear else None
            return err, pcm, consumed
        pcm, state, rdef = decode_granules(huff, params, sf, frame, sfjs, self._state(),
                                           device=self.device)
        self.last_frame_reference_defined = rdef
        self._set(state)
        return err, pcm, consumed
