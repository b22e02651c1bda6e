"""Build and load the port's CUDA kernels.

Each source `csrc/<name>.cu` exposes a plain C interface. At first use it is
compiled with `nvcc` for `sm_90a` into a shared library under
`build/torch_kernels/` of the checkout and loaded with ctypes. The library's
file name carries a digest of the source, the shared headers `csrc/*.cuh`
and the flags, so an edited source or header is rebuilt and a stale library
is never loaded. Nothing is built when the
module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Iterable

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"

# --fmad=false: the kernels do their float32 arithmetic operation for
# operation like the plain PyTorch versions beside them (no fused
# multiply-adds), so kernel and plain version agree bit for bit and
# threshold decisions (the 1/255 cutoff, the T < 1e-4 stop) never differ.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def kernel_names() -> list[str]:
    """Every kernel source of the package, by name."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path(name: str) -> Path:
    """The library of kernel `name`; its digest covers the source, every
    header under csrc/ (the sources include them) and the flags."""
    h = hashlib.sha1((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Iterable[str] | None = None) -> dict[str, dict]:
    """Compile the named kernels (default: all) that are not built yet.

    One `nvcc` per source, all started together. Returns, per name, the
    build seconds (0.0 when the library already existed) and the
    ptxas resource report. Raises with the compiler output on failure.
    """
    names = kernel_names() if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    out: dict[str, dict] = {}
    t0 = time.perf_counter()
    for name in names:
        lib = library_path(name)
        if lib.exists():
            out[name] = {"seconds": 0.0, "ptxas": ""}
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp, lib)
    failures = []
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, lib)
        ptxas = "\n".join(l for l in log.splitlines() if "ptxas" in l)
        out[name] = {"seconds": time.perf_counter() - t0, "ptxas": ptxas}
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _loaded[name] = lib
        return lib
