"""Build and load the port's CUDA kernels.

Each source `csrc/<name>.cu` exposes a plain C interface. At first use it is
compiled with `nvcc` for `sm_90a` into a shared library under
`build/torch_kernels/` of the checkout and loaded with ctypes. The library's
file name carries a digest of the source, the shared headers `csrc/*.cuh`
and the flags, so an edited source or header is rebuilt and a stale library
is never loaded. Nothing is built when the
module is imported. Building (`cuda_build/build`, with the count of
sources compiled) and loading (`cuda_build/load`) are set-up spans
(`utils/profiling.setup_report`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Iterable

from .utils.profiling import setup_span

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


def cuda_tool(tool: str = "nvcc") -> str:
    """A program of the CUDA toolkit (nvcc, cuobjdump): under CUDA_HOME,
    CUDA_PATH or /usr/local/cuda, else on PATH."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / tool
    if cand.exists():
        return str(cand)
    found = shutil.which(tool)
    if found is None:
        raise RuntimeError(f"{tool} not found: set CUDA_HOME or put it on PATH")
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

    One `nvcc` per source, all started together. Processes may build at
    once (each writes its own temporary files and renames them into
    place); `parallel.distributed.launch` builds before it starts the
    ranks, so they build nothing. Returns, per name, the
    build seconds (0.0 when the library already existed) and the
    compiler's output, which holds the ptxas resource report (kept beside
    the library, so a library built earlier still has it; see
    `ptxas_report`). Raises with the compiler output on failure.
    """
    names = kernel_names() if names is None else list(names)
    with setup_span("cuda_build/build", sources=len(names)) as span:
        out = _build(names)
        span["compiled"] = sum(v["seconds"] > 0 for v in out.values())
        return out


def _build(names: list) -> dict[str, dict]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    out: dict[str, dict] = {}
    t0 = time.perf_counter()
    for name in names:
        lib = library_path(name)
        if lib.exists():
            log = lib.with_suffix(".log")
            out[name] = {"seconds": 0.0, "log": log.read_text() if log.exists() else ""}
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [cuda_tool(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp, lib)
    failures = []
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        # The log, like the library, is written whole under a name of this
        # process and renamed into place: another process building the
        # same library at the same time reads one or the other, never a part.
        tmp_log = lib.with_suffix(f".{os.getpid()}.log.tmp")
        tmp_log.write_text(log)
        os.replace(tmp_log, lib.with_suffix(".log"))
        os.replace(tmp, lib)
        out[name] = {"seconds": time.perf_counter() - t0, "log": log}
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return out


_PTXAS_FIELDS = (("registers", r"Used (\d+) registers"), ("smem_bytes", r"(\d+) bytes smem"),
                 ("stack_bytes", r"(\d+) bytes stack frame"),
                 ("spill_stores", r"(\d+) bytes spill stores"),
                 ("spill_loads", r"(\d+) bytes spill loads"))


def ptxas_report(log: str) -> dict[str, dict]:
    """Per kernel of a build's `-Xptxas -v` output, by mangled name: its
    registers a thread, static shared memory, stack frame and spill bytes."""
    out: dict[str, dict] = {}
    cur = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'|Function properties for (\S+)", line)
        if m:
            cur = out.setdefault(m.group(1) or m.group(2), {})
            continue
        if cur is not None:
            for key, pat in _PTXAS_FIELDS:
                f = re.search(pat, line)
                if f:
                    cur[key] = int(f.group(1))
    return out


# An H100 SM: 65,536 registers (allocated 256 a warp at a time), 228 KB of
# shared memory (1 KB a block kept by the system), 2,048 threads, 32 blocks.
SM_REGS, SM_REG_UNIT, SM_SMEM, SM_SMEM_PER_BLOCK = 65536, 256, 233472, 1024
SM_THREADS, SM_BLOCKS = 2048, 32


def blocks_per_sm(report: dict, threads: int) -> int:
    """Blocks of `threads` threads an H100 SM holds at once, by a kernel's
    `ptxas_report` entry (registers a thread, static shared memory a block):
    the least of the register, shared-memory, thread and block limits."""
    warps = -(-threads // 32)
    regs_per_warp = -(-report["registers"] * 32 // SM_REG_UNIT) * SM_REG_UNIT
    return min(SM_REGS // regs_per_warp // warps,
               SM_SMEM // (report.get("smem_bytes", 0) + SM_SMEM_PER_BLOCK),
               SM_THREADS // threads, SM_BLOCKS)


SASS_OPCODES = ("FFMA", "FMUL", "FADD", "HMMA", "HGMMA", "BAR", "SHFL", "LDS")


def sass_opcodes(text: str) -> dict[str, dict]:
    """Per kernel of `cuobjdump -sass` output, by mangled name: how many
    instructions of each opcode in SASS_OPCODES its code holds (a static
    count, whatever the modifiers: HMMA.1688.F32.TF32 counts as HMMA)."""
    out: dict[str, dict] = {}
    cur = None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = out.setdefault(m.group(1), dict.fromkeys(SASS_OPCODES, 0))
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)", line)
        if cur is not None and m and m.group(1) in cur:
            cur[m.group(1)] += 1
    return out


MAX_BOUND_SHARE = 1.05   # a time this far below the bound means work was removed


def fold_failures(name: str, bound_share: float, sass: dict | None, opcode: str,
                  route_floor_share: float | None = None) -> list[str]:
    """Why the time of reduction kernel `name` cannot stand as its route's,
    if it cannot: a share of its bound above MAX_BOUND_SHARE (the compiler
    folded work the bound counts), or SASS (`sass_opcodes` of the kernel;
    None when there is none) without `opcode`, the instruction of its route
    (FFMA on the CUDA cores, SHFL for warp shuffles, HMMA for mma.sync and
    HGMMA for wgmma on the tensor cores). A tensor-core kernel is held to
    its route's own floor instead of the CUDA-core bound (it may rightly
    beat that one): with `route_floor_share`, that share is the one above
    MAX_BOUND_SHARE that fails. Empty when sound."""
    out = []
    share, of = ((bound_share, "its bound") if route_floor_share is None
                 else (route_floor_share, "its route floor"))
    if not share <= MAX_BOUND_SHARE:
        out.append(f"{name}: {share:.3f} of {of} (above {MAX_BOUND_SHARE})")
    if sass is None:
        out.append(f"{name}: no SASS")
    elif not sass.get(opcode):
        out.append(f"{name}: no {opcode} in its SASS")
    return out


def library_sass(name: str) -> str:
    """`cuobjdump -sass` of kernel `name`'s built library."""
    return subprocess.run([cuda_tool("cuobjdump"), "-sass", str(library_path(name))],
                          check=True, capture_output=True, text=True, timeout=300).stdout


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            with setup_span("cuda_build/load", library=name):
                lib = ctypes.CDLL(str(library_path(name)))
            _loaded[name] = lib
        return lib
