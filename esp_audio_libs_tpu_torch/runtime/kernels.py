"""First-use build and ctypes loader of the hand-written CUDA kernels.

``esp_audio_libs_tpu_torch/csrc/*.cu`` compile with nvcc into one shared
library with a plain C interface, ``build/kernels/libeal_kernels.so``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/kernels/libeal_kernels.so csrc/*.cu

The build runs the first time a kernel is launched (never at import), and
again whenever a source is newer than the library. Each C entry point takes
``void*`` for every pointer and for the CUDA stream and returns
``cudaGetLastError()``.
"""

from __future__ import annotations

import ctypes as C
import functools
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent.parent
CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = REPO / "build" / "kernels"
LIB_PATH = BUILD_DIR / "libeal_kernels.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]


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


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def build(verbose: bool = False) -> Path:
    """Compile csrc/*.cu into LIB_PATH unless it is newer than every source.
    With ``verbose``, a build that runs adds ``-Xptxas -v`` and prints
    ptxas's report (registers, shared memory, spills per kernel)."""
    deps = _sources() + sorted(CSRC.glob("*.cuh"))
    if LIB_PATH.exists():
        built = LIB_PATH.stat().st_mtime
        if all(p.stat().st_mtime <= built for p in deps):
            return LIB_PATH
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, *map(str, _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, LIB_PATH)
    if verbose:
        print(proc.stderr)
    return LIB_PATH


@functools.lru_cache(None)
def library() -> C.CDLL:
    """The kernel library, built on first use, with its C signatures bound."""
    lib = C.CDLL(str(build()))
    p = C.c_void_p
    lib.eal_polyphase_banded.restype = C.c_int
    lib.eal_polyphase_banded.argtypes = [p, p, p, p, C.c_int, C.c_int, C.c_int, C.c_int,
                                         C.c_longlong, C.c_int, p]
    lib.eal_polyphase_fused16.restype = C.c_int
    lib.eal_polyphase_fused16.argtypes = [p, p, p, p, p, C.c_int, C.c_int, C.c_int, C.c_int,
                                          C.c_longlong, p]
    return lib
