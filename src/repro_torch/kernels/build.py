"""Build and load the CUDA kernels of `repro_torch/csrc`.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process (all
started together) for ``sm_90a``, then linked into one shared library with a
plain C interface, which `load_library` opens with `ctypes`. No PyTorch
header is compiled, so a build takes seconds.

The library goes to ``build/kernels/`` at the repository root (override:
``REPRO_TORCH_BUILD_DIR``), keyed by a hash of the sources and flags: an
unchanged source tree loads the library built before, a changed one builds
anew. Nothing is built on import; the first kernel launch builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
LIB_NAME = "libmatrixpic_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIB: ctypes.CDLL | None = None
#: what the last build in this process did: seconds, and ptxas' per-kernel
#: report (kept beside the library, so a cached build has it too)
BUILD_INFO: dict = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    return Path(env) if env else Path(__file__).resolve().parents[3] / "build" / "kernels"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA kernels cannot be built")


def _sources() -> list[Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_library() -> Path:
    """Compile the sources if the library for their hash is missing; returns
    its path. Raises with the compiler's output when a build fails."""
    out_dir = build_dir() / _digest()
    lib_path = out_dir / LIB_NAME
    log_path = out_dir / "nvcc.log"
    if lib_path.exists():
        BUILD_INFO.update(seconds=0.0, cached=True, log=log_path.read_text() if log_path.exists() else "")
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    units = [p for p in _sources() if p.suffix == ".cu"]
    procs = [
        (p, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(p), "-o", str(out_dir / f"{p.stem}.o")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
        for p in units
    ]
    logs = []
    failed = []
    for p, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {p.name}\n{out}")
        if proc.returncode != 0:
            failed.append(p.name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
    tmp = out_dir / f"{LIB_NAME}.tmp-{os.getpid()}"
    link = subprocess.run(
        [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a", "-o", str(tmp),
         *(str(out_dir / f"{p.stem}.o") for p in units)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"linking {LIB_NAME} failed:\n{link.stdout}")
    log_path.write_text("\n".join(logs))
    os.replace(tmp, lib_path)
    BUILD_INFO.update(seconds=time.perf_counter() - t0, cached=False, log="\n".join(logs))
    return lib_path


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use, with every entry
    point's argument types declared (pointers and the stream as c_void_p,
    so no 64-bit value is cut to an int)."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(str(build_library()))
    p, i, z = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
    lib.mpic_fused_deposit.argtypes = [p, p, p, i, i, i, i, i, i, z, i, p]
    lib.mpic_fused_deposit_reduced.argtypes = [p, p, p, i, i, i, i, i, i, i, z, i, p]
    lib.mpic_fused_gather.argtypes = [p, p, p, i, i, i, i, i, i, i, i, i, z, i, p]
    lib.mpic_bin_outer_product.argtypes = [p, p, p, i, i, i, i, i, i, i, z, i, i, i, p]
    lib.mpic_bin_gather.argtypes = [p, p, p, p, i, i, i, i, i, i, i, z, i, i, p]
    lib.mpic_segment_accumulate.argtypes = [p, p, p, i, i, i, i, i, p]
    lib.mpic_graph_if_begin.argtypes = [p, p, p]
    lib.mpic_graph_if_end.argtypes = [p]
    for fn in (lib.mpic_fused_deposit, lib.mpic_fused_deposit_reduced, lib.mpic_fused_gather,
               lib.mpic_bin_outer_product, lib.mpic_bin_gather, lib.mpic_segment_accumulate,
               lib.mpic_graph_if_begin, lib.mpic_graph_if_end):
        fn.restype = ctypes.c_int
    lib.mpic_error_string.argtypes = [i]
    lib.mpic_error_string.restype = ctypes.c_char_p
    _LIB = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (its `cudaGetLastError`)."""
    if rc != 0:
        msg = load_library().mpic_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
