"""First-use build and ctypes loader of the hand-written CUDA kernels.

``esp_audio_libs_tpu_torch/csrc/*.cu`` compile with nvcc, one process per
source, all started together, and link into one shared library with a plain
C interface, ``build/kernels/libeal_kernels.so``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -c \
         -Xcompiler -fPIC -o <obj> csrc/<source>.cu          # for each source
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \
         -o build/kernels/libeal_kernels.so <objs>

The build runs the first time a kernel is launched (never at import), and
again whenever a source is newer than the library. Each C entry point takes
``void*`` for every pointer and for the CUDA stream and returns
``cudaGetLastError()``. Launches go through :func:`launch_on`, which makes
the tensors' device current for PyTorch and for the library's own CUDA
runtime (csrc/launch_device.cu).
"""

from __future__ import annotations

import contextlib
import ctypes as C
import functools
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from .trace import span

REPO = Path(__file__).resolve().parent.parent.parent
CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = REPO / "build" / "kernels"
LIB_PATH = BUILD_DIR / "libeal_kernels.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]


def entry_device(device, what: str):
    """The ``torch.device`` of an entry point such as ``Resampler`` or
    ``FLACDecoder`` (named by ``what``): ``cuda`` runs the kernels and needs
    a card, ``cpu`` runs their plain versions, anything else raises. Nothing
    falls back."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"{what}(device={str(dev)!r}): CUDA is not available")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: expected cpu or cuda")
    return dev


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): "
                       "the CUDA kernels cannot be built")


def compile_library(src_dir: Path, lib_path: Path, ptxas_report: bool = False) -> str:
    """Compile every ``*.cu`` of ``src_dir`` (one nvcc each, all started
    together) and link them into ``lib_path``; returns nvcc's output. With
    ``ptxas_report`` it adds ``-Xptxas -v``: registers, shared memory and
    spills per kernel. The one build recipe of the kernels."""
    nvcc = _nvcc()
    sources = sorted(src_dir.glob("*.cu"))
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=lib_path.parent) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in sources]
        procs = [subprocess.Popen(
            [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-c", "-Xcompiler", "-fPIC",
             *(["-Xptxas", "-v"] if ptxas_report else []), "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for src, obj in zip(sources, objs)]
        reports = []
        for proc in procs:
            out, err = proc.communicate()
            reports.append(out + err)
        if any(proc.returncode for proc in procs):
            raise RuntimeError("nvcc failed:\n" + "\n".join(reports))
        lib = Path(tmp) / lib_path.name
        link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(lib), *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr}")
        os.replace(lib, lib_path)
    return "\n".join(reports)


def build(verbose: bool = False) -> Path:
    """Compile csrc/*.cu into LIB_PATH unless it is newer than every source.
    With ``verbose``, a build that runs prints ptxas's report."""
    if LIB_PATH.exists():
        built = LIB_PATH.stat().st_mtime
        if all(p.stat().st_mtime <= built for p in CSRC.glob("*.cu*")):
            return LIB_PATH
    report = compile_library(CSRC, LIB_PATH, ptxas_report=verbose)
    if verbose:
        print(report)
    return LIB_PATH


@functools.lru_cache(None)
def library() -> C.CDLL:
    """The kernel library, built on first use, with its C signatures bound."""
    return bind(C.CDLL(str(build())))


@contextlib.contextmanager
def launch_on(device: torch.device):
    """Yield the kernel library with ``device`` current for the launches made
    in the block: PyTorch's current device (``torch.cuda.device``) and the
    library's own (``eal_set_device``; nvcc links the CUDA runtime statically
    into the library, so it keeps a current device apart from PyTorch's, and
    its entry points set kernel attributes and read the SM count there).
    The ``eal.launch`` span covers the device switch and the block."""
    lib = library()
    with span("eal.launch"), torch.cuda.device(device):
        index = device.index if device.index is not None else torch.cuda.current_device()
        rc = lib.eal_set_device(index)
        if rc != 0:
            raise RuntimeError(f"eal_set_device({index}) failed: cudaError {rc}")
        yield lib


_P, _I, _LL = C.c_void_p, C.c_int, C.c_longlong
# restype and argtypes of every C entry point of csrc/*.cu
SIGNATURES = {
    "eal_set_device": (C.c_int, [_I]),
    "eal_band_parts_len": (C.c_longlong, [_I]),
    "eal_band_ranges": (C.c_int, [_P, _P, _I, _I, _LL, _P]),
    "eal_polyphase_banded": (C.c_int, [_P, _P, _P, _P, _P, _I, _I, _I, _I, _LL, _I, _P]),
    "eal_polyphase_fused16": (C.c_int, [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _LL, _P]),
    "eal_flac_frame": (C.c_int, [_P, _I, _P, _P, _I, _P, _P, _P, _P, _P, _P,
                                 _I, _I, _I, _I, _I, _I, _I, _I, _P]),
    "eal_biquad_df1": (C.c_int, [_P, _P, _P, _I, _P, _P, _LL, _I, _I, _I, _P]),
    "eal_iir2_sequential": (C.c_int, [_P, _P, _P, _P, _P, _LL, _I, _P]),
    "eal_polyphase_exact": (C.c_int, [_P, _P, _P, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _I,
                                      _I, _P]),
    "eal_mp3_consts_layout": (C.c_int, [_P]),
    "eal_mp3_granules": (C.c_int, [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                   _P]),
    "eal_dotprod_exact": (C.c_int, [_P, _LL, _P, _LL, _P, _LL, _I, _P]),
    "eal_mp3_granules_f32": (C.c_int, [_P] * 9 + [_I] * 5 + [_P]),
    "eal_mp3_mxu_pre": (C.c_int, [_P] * 9 + [_I, _I, _P]),
    "eal_mp3_mxu_post": (C.c_int, [_P] * 5 + [_LL, _I, _I, _P]),
    "eal_quantize_pack16": (C.c_int, [_P, _LL, _LL, _P, _LL, _P, _I, _I, _I, _P]),
    "eal_unpack16_extend": (C.c_int, [_P, _LL, _I, C.c_float, _P, _LL, _LL, _LL, _I, _P, _I, _I,
                                      _P]),
}


def bind(lib: C.CDLL, names=tuple(SIGNATURES)) -> C.CDLL:
    """Set the C signatures of the kernel entry points ``names`` (all by
    default) on a loaded library."""
    for name in names:
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = SIGNATURES[name]
    return lib
