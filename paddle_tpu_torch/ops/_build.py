"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source (``decode_attention.cu``,
``flash_attention.cu``) is compiled by one ``nvcc`` call into one shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds) and loaded with ``ctypes``.  The library goes into
``paddle_tpu_torch/_build/`` (listed in ``.gitignore``), named by a hash
over all sources and the flags, so an edited source rebuilds and an
unchanged tree is reused.  Nothing is built at import time: the first
CUDA call of a kernel wrapper builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent.parent
SOURCES = (_PKG / "csrc" / "decode_attention.cu",
           _PKG / "csrc" / "flash_attention.cu")
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of the library, as function -> argtypes
SIGNATURES = {
    "pt_flash_decode": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I,
                        _I, _P],
    "pt_paged_decode": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                        _F, _I, _I, _P],
    "pt_ragged_paged_decode": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                               _I, _I, _I, _F, _I, _I, _P],
    "pt_hb_flash_forward": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                            _I, _F, _I, _P],
    "pt_hb_flash_backward": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                             _I, _I, _I, _I, _I, _I, _I, _F, _I, _P],
}

_lib: Optional[ctypes.CDLL] = None


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                           "kernels are compiled from csrc/ at first use")
    return found


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    return BUILD_DIR / f"kernels-{h.hexdigest()[:16]}.so"


def build() -> float:
    """Compile the library unless it is already there; returns the wall
    seconds spent.  The compiler's output (``-Xptxas=-v``: registers,
    shared memory, spills) is kept beside the library as ``<name>.log``."""
    t0 = time.perf_counter()
    out = library_path()
    if out.exists():
        return time.perf_counter() - t0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                           *map(str, SOURCES)], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT)
    out.with_suffix(".log").write_bytes(proc.stdout)
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed for "
                           + ", ".join(s.name for s in SOURCES) + ":\n"
                           + proc.stdout.decode(errors="replace"))
    os.replace(tmp, out)
    return time.perf_counter() - t0


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C signatures of a loaded library."""
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.pt_error_string.argtypes = [ctypes.c_int]
    lib.pt_error_string.restype = ctypes.c_char_p
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        build()
        _lib = bind(ctypes.CDLL(str(library_path())))
    return _lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error (``cudaGetLastError``)."""
    if code != 0:
        msg = lib.pt_error_string(code).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
