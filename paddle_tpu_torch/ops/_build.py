"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source (``decode_attention.cu``, ``flash_attention.cu``,
``masked_flash_attention.cu``, ``grouped_matmul.cu``, ``wgmma_probe.cu``; the
middle three include ``flash_common.cuh``, and every one ``hopper.cuh``,
the TMA / bulk-copy / mbarrier / wgmma building blocks) is compiled by its own ``nvcc``
process, all started together, into an object file; one more ``nvcc``
links them into a shared library with a plain C interface (no PyTorch
headers, so a build takes seconds), loaded with ``ctypes``.  The library
goes into ``paddle_tpu_torch/_build/`` (listed in ``.gitignore``), named by
a hash over all sources, headers and flags, so an edited source rebuilds
and an unchanged tree is reused.
Nothing is built at import time: the first CUDA call of a kernel wrapper
builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
SOURCES = (CSRC / "decode_attention.cu", CSRC / "flash_attention.cu",
           CSRC / "masked_flash_attention.cu", CSRC / "grouped_matmul.cu",
           CSRC / "wgmma_probe.cu")
HEADERS = (CSRC / "flash_common.cuh", CSRC / "hopper.cuh")
BUILD_DIR = _PKG / "_build"
# compile flags of each source; headers resolve through -I csrc/, also for
# an edited copy of a source compiled from elsewhere
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v", f"-I{CSRC}")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of the library, as function -> argtypes
SIGNATURES = {
    "pt_flash_decode": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                        _I, _F, _I, _I, _P],
    # q, k, v, o, lens, slots (or null), tables, part_m, part_l, part_acc,
    # rows, h, kvh, page, d, max_pages, pp, chunk, scale, q dtype, kv dtype,
    # stream
    "pt_paged_decode": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                        _I, _I, _I, _I, _I, _F, _I, _I, _P],
    "pt_hb_flash_forward": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                            _I, _F, _I, _I, _P],
    "pt_hb_flash_backward": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                             _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _P],
    # kind, pointer array, int array, scale, dtype, stream
    "pt_masked_flash": [_I, _P, _P, _F, _I, _P],
    # x, w, scale, y, starts, lens, wids, part, R, K, N, S, E, block_rows,
    # dtype, w_int8, trans, route, rows_tile, splits, rows_inner, stream
    "pt_grouped_matmul": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                          _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "pt_grouped_outer": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # mode, a, b, c, stream
    "pt_wgmma_probe": [_I, _P, _P, _P, _P],
}
# the bf16 kernels that must issue wgmma (HGMMA in their SASS): B1, B2
# (dk/dv, dq), B5, B6 (dk/dv split and fused, dq), B7 (forward and dx; bf16
# x over an int8 bank), B8
WGMMA_KERNELS = ("hb_fwd_wgmma_kernel", "hb_dkv_wgmma_kernel",
                 "hb_dq_wgmma_kernel", "masked_fwd_wgmma_kernel",
                 "masked_dkv_wgmma_kernel", "masked_dq_wgmma_kernel",
                 "gmm_wgmma_kernel", "gmm_int8_wgmma_kernel",
                 "outer_wgmma_kernel")
# the shape of b that each mode of pt_wgmma_probe takes (csrc/wgmma_probe.cu)
PROBE_B_SHAPES = {0: (64, 64), 1: (64, 128), 2: (64, 256), 3: (64, 256),
                  4: (256, 64), 5: (64, 128), 6: (64, 64), 7: (16, 64),
                  8: (64, 64), 9: (128, 64)}
# modes whose a is an int8 tile [64, 128] (B7 int8's widened weight), the
# others' a is bf16 [64, 64]
PROBE_INT8_MODES = (7, 8, 9)

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
    for src in (*SOURCES, *HEADERS):
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    return BUILD_DIR / f"kernels-{h.hexdigest()[:16]}.so"


def build_library(sources, out: Path) -> None:
    """Compile ``sources`` with one ``nvcc`` process each, all running at
    once, and link the objects into the shared library ``out``.  The
    compilers' output (``-Xptxas=-v``: registers, shared memory, spills)
    goes to ``<out>.log``; a failure raises with it."""
    out = Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [out.with_name(f"{tag}.{Path(src).stem}.o") for src in sources]
    jobs = [subprocess.Popen([nvcc_path(), *NVCC_FLAGS, "-c", "-o", str(obj),
                              str(src)], stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT)
            for src, obj in zip(sources, objs)]
    logs, failed = [], []
    for src, job in zip(sources, jobs):
        log, _ = job.communicate()
        logs.append(f"== {Path(src).name}\n".encode() + log)
        if job.returncode != 0:
            failed.append(Path(src).name)
    if not failed:
        tmp = out.with_name(f"{tag}.tmp.so")
        link = subprocess.run([nvcc_path(), "-shared", "-o", str(tmp),
                               *map(str, objs)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
        logs.append(b"== link\n" + link.stdout)
        if link.returncode != 0:
            failed.append("link")
        else:
            os.replace(tmp, out)
    for obj in objs:
        obj.unlink(missing_ok=True)
    out.with_suffix(".log").write_bytes(b"".join(logs))
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + b"".join(logs).decode(errors="replace"))


def build() -> float:
    """Build the library unless it is already there; returns the wall
    seconds spent."""
    t0 = time.perf_counter()
    out = library_path()
    if not out.exists():
        build_library(SOURCES, out)
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


def cuda_tool(name: str) -> str:
    """A binary of the CUDA toolkit that holds nvcc (cuobjdump, cu++filt)."""
    return str(Path(nvcc_path()).with_name(name))


_PTXAS_ENTRY = re.compile(r"(?:Compiling entry function|Function properties "
                          r"for) '?([\w$]+)")
_PTXAS_SPILL = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads")
_PTXAS_USED = re.compile(r"Used (\d+) registers")
_PTXAS_SMEM = re.compile(r"(\d+) bytes smem")


def ptxas_report(log: str) -> dict:
    """Per kernel (mangled name) of an ``-Xptxas=-v`` build log: registers,
    stack frame, spill stores and loads, static shared memory in bytes
    (dynamic shared memory is set at launch and not in the log)."""
    out, cur = {}, None
    for line in log.splitlines():
        m = _PTXAS_ENTRY.search(line)
        if m:
            cur = out.setdefault(m.group(1), {"registers": 0, "stack": 0,
                                              "spill_stores": 0,
                                              "spill_loads": 0, "smem": 0})
            continue
        if cur is None:
            continue
        m = _PTXAS_SPILL.search(line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = _PTXAS_USED.search(line)
        if m:
            cur["registers"] = int(m.group(1))
            sm = _PTXAS_SMEM.search(line)
            cur["smem"] = int(sm.group(1)) if sm else 0
    return out


def demangle(names) -> dict:
    """{mangled: readable} through cu++filt, without the return type, the
    anonymous namespace and the argument list."""
    names = list(names)
    res = subprocess.run([cuda_tool("cu++filt")], input="\n".join(names),
                         capture_output=True, text=True, check=True)
    out = {}
    for n, d in zip(names, res.stdout.splitlines()):
        d = re.sub(r"^void |<unnamed>::|\(anonymous namespace\)::", "", d)
        depth = 0
        for i, ch in enumerate(d):      # cut at the argument list's "("
            depth += {"<": 1, ">": -1}.get(ch, 0)
            if ch == "(" and depth == 0:
                d = d[:i]
                break
        out[n] = d
    return out


def sass_functions(path: Path) -> dict:
    """{mangled kernel name: its SASS text} of a built library
    (``cuobjdump --dump-sass``)."""
    res = subprocess.run([cuda_tool("cuobjdump"), "--dump-sass", str(path)],
                         capture_output=True, text=True, check=True)
    out, name = {}, None
    for line in res.stdout.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
        elif name is not None:
            out[name].append(line)
    return {n: "\n".join(lines) for n, lines in out.items()}


def kernel_report(path: Optional[Path] = None) -> dict:
    """{readable kernel name: registers, stack, spills, static smem, hgmma}
    of the built library: ptxas's counts from its build log beside whether
    the kernel's SASS issues HGMMA (wgmma)."""
    path = library_path() if path is None else Path(path)
    counts = ptxas_report(path.with_suffix(".log").read_text(
        errors="replace"))
    sass = sass_functions(path)
    names = demangle(sorted(set(counts) | set(sass)))
    return {names[n]: dict(counts.get(n, {}),
                           hgmma="HGMMA" in sass.get(n, ""))
            for n in names}


def wgmma_probe(mode: int, a, b):
    """The one-tile layout probe of csrc/wgmma_probe.cu on CUDA tensors:
    modes 0-6 take a bf16 [64, 64] and b bf16 as ``PROBE_B_SHAPES[mode]``,
    c fp32 = a @ b^T (modes 0 and 4), a @ b (1, 3, 5), a^T @ b (2, 6);
    modes 7-9 (``PROBE_INT8_MODES``) take a int8 [64, 128] and b bf16 [NR,
    64], c fp32 [128, NR] = a^T @ b^T."""
    import torch
    int8 = mode in PROBE_INT8_MODES
    a_shape = (64, 128) if int8 else (64, 64)
    if mode not in PROBE_B_SHAPES or tuple(a.shape) != a_shape or \
            tuple(b.shape) != PROBE_B_SHAPES[mode]:
        raise ValueError(f"wgmma_probe mode {mode}: a {list(a_shape)}, b "
                         f"{list(PROBE_B_SHAPES.get(mode, ()))}")
    a, b = a.contiguous(), b.contiguous()
    shape = ((128, b.shape[0]) if int8 else
             (64, b.shape[0] if mode in (0, 4) else b.shape[1]))
    c = torch.empty(shape, dtype=torch.float32, device=a.device)
    lib = library()
    check(lib, lib.pt_wgmma_probe(mode, a.data_ptr(), b.data_ptr(),
                                  c.data_ptr(),
                                  torch.cuda.current_stream().cuda_stream),
          "wgmma_probe")
    return c
