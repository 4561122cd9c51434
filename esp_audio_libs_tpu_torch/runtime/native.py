"""ctypes loader for the native host library (libeal_host.so).

The same library the JAX package loads (esp_audio_libs_tpu/runtime/native.py),
built from ``native/`` by ``native/build_host.sh``: filter design with exact
glibc f32 libm semantics, the serial f32 phase-grid recurrence and the FLAC
bitstream front-end (sync, headers, CRC, Rice decoding into residual tables,
and the decoder-state save/load blob) come from one C++ source for both
packages. Bound here: the resampler's four entry points and the FLAC and MP3
front-ends (MP3: sync search, frame parse one stream or a fleet at a time,
frame info, the compact per-granule parameter blob and the decoder-state
blob). The library is built at first use if it is missing
(:func:`build_host_library`).
"""

from __future__ import annotations

import ctypes as C
import fcntl
import functools
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent.parent
LIB_PATH = REPO / "build" / "libeal_host.so"


# native/build_host.sh's compile line (its flags, its sources)
HOST_CXXFLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-ffp-contract=off", "-Wall", "-pthread"]


def _mp3_headers() -> None:
    """The MP3 front-end's generated headers in the repository's build/ (its
    source includes them from there), made as native/build_host.sh makes
    them from the committed copies in native/gen/ (the same generated
    artifacts as an extraction from the reference source)."""
    build, gen = REPO / "build", REPO / "native" / "gen"
    build.mkdir(parents=True, exist_ok=True)
    if not (build / "mp3_tables.h").exists():
        for name in ("mp3_tables.h", "mp3_tables.npz"):
            shutil.copy(gen / name, build / name)
    tool, huff = REPO / "tools" / "gen_huffman_tables.py", build / "mp3_huff.h"
    if not huff.exists() or tool.stat().st_mtime > huff.stat().st_mtime:
        if (build / "mp3_tables.npz").exists():
            subprocess.run([sys.executable, str(tool)], check=True, capture_output=True)
        else:
            for name in ("mp3_huff.h", "mp3_huff.npz"):
                shutil.copy(gen / name, build / name)


def build_host_library(lib_path: Path = LIB_PATH) -> Path:
    """Build the host library into ``lib_path`` unless it exists; returns
    the path. It runs native/build_host.sh's compile line itself (that
    script writes its output in place, so a concurrent loader could map a
    half-written file): under an exclusive ``flock`` on
    ``.libeal_host.lock`` beside the library, into a temporary file in the
    same directory, then ``os.replace`` onto ``lib_path``. A process that
    finds the file sees a complete library; concurrent first builds compile
    once."""
    if lib_path.exists():
        return lib_path
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    with open(lib_path.parent / ".libeal_host.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib_path.exists():
            return lib_path
        _mp3_headers()
        tmp = lib_path.parent / f".libeal_host.{os.getpid()}.so"
        try:
            sources = sorted(str(p) for p in (REPO / "native" / "src").glob("*.cpp"))
            subprocess.run(["g++", *HOST_CXXFLAGS, *sources, "-o", str(tmp)], check=True,
                           capture_output=True)
            os.replace(tmp, lib_path)
        finally:
            tmp.unlink(missing_ok=True)
    return lib_path


@functools.lru_cache(None)
def host_lib() -> C.CDLL:
    lib = C.CDLL(str(build_host_library()))
    f32p = C.POINTER(C.c_float)
    i32p = C.POINTER(C.c_int32)
    i8p = C.POINTER(C.c_int8)
    lib.eal_design_filterbank.restype = C.c_int
    lib.eal_design_filterbank.argtypes = [C.c_int, C.c_int, C.c_float, C.c_int, f32p]
    lib.eal_phase_grid.restype = None
    lib.eal_phase_grid.argtypes = [
        C.c_int, C.c_int, C.c_int, C.c_float,       # config
        C.c_int, C.c_int,                           # chunk
        f32p, i32p,                                 # state io
        i32p, i32p, i32p, f32p, i8p,                # schedule
        i32p, i32p,                                 # results
    ]
    lib.eal_required_samples.restype = C.c_uint
    lib.eal_required_samples.argtypes = [C.c_int, C.c_float, C.c_int, C.c_int, C.c_float]
    lib.eal_expected_output.restype = C.c_uint
    lib.eal_expected_output.argtypes = [C.c_int, C.c_float, C.c_int, C.c_int, C.c_float]

    # ---- FLAC front-end ----
    u8p = C.POINTER(C.c_uint8)
    i16p = C.POINTER(C.c_int16)
    lib.eal_flac_create.restype = C.c_void_p
    lib.eal_flac_destroy.argtypes = [C.c_void_p]
    lib.eal_flac_read_header.restype = C.c_int32
    lib.eal_flac_read_header.argtypes = [C.c_void_p, u8p, C.c_size_t]
    lib.eal_flac_set_max_metadata_size.argtypes = [C.c_void_p, C.c_int32, C.c_uint32]
    lib.eal_flac_set_crc_check.argtypes = [C.c_void_p, C.c_int32]
    for name, restype in [
        ("eal_flac_sample_rate", C.c_uint32), ("eal_flac_num_channels", C.c_uint32),
        ("eal_flac_sample_depth", C.c_uint32), ("eal_flac_min_block_size", C.c_uint32),
        ("eal_flac_max_block_size", C.c_uint32), ("eal_flac_num_samples", C.c_uint64),
        ("eal_flac_bytes_index", C.c_size_t), ("eal_flac_num_metadata", C.c_int32),
    ]:
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = [C.c_void_p]
    lib.eal_flac_md5.argtypes = [C.c_void_p, u8p]
    lib.eal_flac_metadata_info.restype = C.c_int32
    lib.eal_flac_metadata_info.argtypes = [C.c_void_p, C.c_int32, i32p, i32p]
    lib.eal_flac_metadata_data.restype = C.c_int32
    lib.eal_flac_metadata_data.argtypes = [C.c_void_p, C.c_int32, u8p]
    lib.eal_flac_parse_frame.restype = C.c_int32
    lib.eal_flac_parse_frame.argtypes = [
        C.c_void_p, u8p, C.c_size_t, i32p, C.c_size_t,
        i32p, i32p, i32p, i32p, i32p, i32p, i32p, i32p, i32p]
    lib.eal_flac_parse_stream.restype = C.c_int32
    lib.eal_flac_parse_stream.argtypes = [
        C.c_void_p, u8p, C.c_size_t, C.c_int32, C.c_int32,   # ctx, buf, len, max_frames, frame_cap
        i8p, i16p, i32p,                                     # data8/16/32
        i32p, i32p, i32p,                                    # slot8/16/32 cursors
        i32p, i32p,                                          # wide, slot
        i32p, i32p, i32p, i32p, i32p,                        # order, shift, wasted, use64, coeffs
        i32p, i32p, i32p, i32p, i32p,                        # bs, ca, depth, crc_ok, consumed
        i32p]                                                # last_rc (24 args total)

    # ---- MP3 front-end ----
    lib.eal_mp3_create.restype = C.c_void_p
    lib.eal_mp3_destroy.argtypes = [C.c_void_p]
    lib.eal_mp3_find_sync_word.restype = C.c_int
    lib.eal_mp3_find_sync_word.argtypes = [u8p, C.c_int]
    lib.eal_mp3_parse_frame.restype = C.c_int
    lib.eal_mp3_parse_frame.argtypes = [
        C.c_void_p, u8p, C.c_int, C.c_int,
        i32p, i32p, i32p, i32p, i32p, i32p, i32p, i32p]
    lib.eal_mp3_parse_frame_batch.restype = C.c_int
    lib.eal_mp3_parse_frame_batch.argtypes = [
        C.c_int, C.POINTER(C.c_void_p), C.POINTER(u8p), i32p, C.c_int,
        i32p, i32p, i32p, i32p, i32p, i32p, i32p, i32p, i32p]
    lib.eal_mp3_frame_info.restype = C.c_int
    lib.eal_mp3_frame_info.argtypes = [C.c_void_p, u8p, i32p]
    lib.eal_mp3_last_frame_info.restype = C.c_int
    lib.eal_mp3_last_frame_info.argtypes = [C.c_void_p, i32p]
    lib.eal_mp3_granule_params_compact_batch.restype = C.c_int
    lib.eal_mp3_granule_params_compact_batch.argtypes = [C.c_int, i32p, i32p, i32p, i32p,
                                                         i32p, i32p]
    for codec in ("flac", "mp3"):
        getattr(lib, f"eal_{codec}_state_size").restype = C.c_size_t
        getattr(lib, f"eal_{codec}_state_size").argtypes = [C.c_void_p]
        getattr(lib, f"eal_{codec}_state_save").restype = C.c_int
        getattr(lib, f"eal_{codec}_state_save").argtypes = [C.c_void_p, u8p, C.c_size_t]
        getattr(lib, f"eal_{codec}_state_load").restype = C.c_int
        getattr(lib, f"eal_{codec}_state_load").argtypes = [C.c_void_p, u8p, C.c_size_t]
    return lib


def design_filterbank_native(num_taps: int, num_filters: int, lowpass_ratio: float,
                             flags: int) -> np.ndarray:
    """Bit-exact ``[num_filters + 1, num_taps]`` f32 filterbank design."""
    out = np.zeros((num_filters + 1, num_taps), np.float32)
    rc = host_lib().eal_design_filterbank(
        num_taps, num_filters, np.float32(lowpass_ratio), flags,
        out.ctypes.data_as(C.POINTER(C.c_float)))
    if rc == 1:
        raise ValueError("must 4-1024 filter taps, and a multiple of 4!")
    if rc == 2:
        raise ValueError("must be 2-1024 filters!")
    return out
