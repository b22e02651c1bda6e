"""The port's kernel build helpers that run without a card (the digest of a
library, the ptxas and SASS reports `chip_smoke.py` logs), and the shape of
the micro-reduce kernels' schedules in their source."""
from gaussianavatars_torch import cuda_build

PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_16kern_cEPKfPf' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_16kern_cEPKfPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 4608 bytes smem, 368 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_16kern_aEPKfPf' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_16kern_aEPKfPf
    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 40 registers, 4096 bytes smem, 368 bytes cmem[0]
"""

SASS = """\
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_16kern_aEPKfPf
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;        /* 0x00000a00ff017b82 */
        /*0010*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;  /* 0x0000000000007b1d */
        /*0020*/                   FFMA R4, R2, 3, R4 ;           /* 0x0000000302047823 */
        /*0030*/              @!P0 FMUL R5, R2, R3 ;              /* 0x0000000302058220 */
        /*0040*/                   FFMA R6, R2, 5, R6 ;           /* 0x0000000502067823 */
\t\tFunction : _ZN12_GLOBAL__N_16kern_cEPKfPf
        /*0000*/                   LDS.64 R2, [R0] ;              /* 0x0000000000027984 */
        /*0010*/                   HMMA.1688.F32.TF32 R8, R12, R16, R8 ;
        /*10a0*/                   SHFL.BFLY PT, R3, R2, 0x1, 0x1f ;
		Function : _ZN12_GLOBAL__N_16kern_dEPKfPf
        /*0000*/                   WARPGROUP.ARRIVE ;
        /*0010*/                   HGMMA.64x16x8.F32.TF32 R24, R8, gdesc[UR4], R24, gsb0 ;
        /*0020*/                   HGMMA.64x16x8.F32.TF32 R24, R12, gdesc[UR8], R24, gsb0 ;
        /*0030*/                   WARPGROUP.DEPBAR.LE gsb0, 0x1 ;
"""


def test_ptxas_report_reads_each_kernel():
    rep = cuda_build.ptxas_report(PTXAS_LOG)
    assert rep == {
        "_ZN12_GLOBAL__N_16kern_cEPKfPf": dict(stack_bytes=0, spill_stores=0, spill_loads=0,
                                                registers=128, smem_bytes=4608),
        "_ZN12_GLOBAL__N_16kern_aEPKfPf": dict(stack_bytes=8, spill_stores=4, spill_loads=12,
                                                registers=40, smem_bytes=4096),
    }
    assert cuda_build.ptxas_report("") == {}


def test_sass_opcodes_counts_per_kernel():
    rep = cuda_build.sass_opcodes(SASS)
    a, c = rep["_ZN12_GLOBAL__N_16kern_aEPKfPf"], rep["_ZN12_GLOBAL__N_16kern_cEPKfPf"]
    assert (a["FFMA"], a["FMUL"], a["BAR"], a["HMMA"], a["LDS"]) == (2, 1, 1, 0, 0)
    assert (c["HMMA"], c["SHFL"], c["LDS"], c["FFMA"]) == (1, 1, 1, 0)
    assert set(a) == set(cuda_build.SASS_OPCODES)


def test_sass_opcodes_counts_warpgroup_products_apart():
    """wgmma compiles to HGMMA, counted on its own: it is not HMMA."""
    d = cuda_build.sass_opcodes(SASS)["_ZN12_GLOBAL__N_16kern_dEPKfPf"]
    assert (d["HGMMA"], d["HMMA"], d["FFMA"]) == (2, 0, 0)
    assert cuda_build.sass_opcodes(SASS)["_ZN12_GLOBAL__N_16kern_cEPKfPf"]["HGMMA"] == 0


def test_fold_failures_passes_a_sound_report():
    sass = cuda_build.sass_opcodes(SASS)["_ZN12_GLOBAL__N_16kern_aEPKfPf"]
    assert cuda_build.fold_failures("micro_reduce_a", 0.67, sass, "FFMA") == []
    hmma = cuda_build.sass_opcodes(SASS)["_ZN12_GLOBAL__N_16kern_cEPKfPf"]
    assert cuda_build.fold_failures("micro_reduce_c", 1.05, hmma, "HMMA") == []


def test_fold_failures_rejects_a_folded_report():
    """A kernel whose sums were folded into one product runs above its bound
    and loses its route's instruction: each of the three signs fails it."""
    sass = cuda_build.sass_opcodes(SASS)["_ZN12_GLOBAL__N_16kern_cEPKfPf"]
    no_ffma = cuda_build.fold_failures("micro_reduce_a", 0.67, sass, "FFMA")
    assert len(no_ffma) == 1 and "no FFMA" in no_ffma[0]
    fast = cuda_build.fold_failures("micro_reduce_c", 1.3, sass, "HMMA")
    assert len(fast) == 1 and "1.300 of its bound" in fast[0]
    assert cuda_build.fold_failures("micro_reduce_b", float("nan"), None, "SHFL") == [
        "micro_reduce_b: nan of its bound (above 1.05)", "micro_reduce_b: no SASS"]


def test_fold_failures_holds_a_tensor_core_route_to_its_floor():
    """A tensor-core kernel may beat the CUDA-core operations bound: with
    its route's floor given, that share is the one held to 1.05, and its
    SASS must hold the route's opcode (HGMMA for wgmma)."""
    d = cuda_build.sass_opcodes(SASS)["_ZN12_GLOBAL__N_16kern_dEPKfPf"]
    assert cuda_build.fold_failures("micro_reduce_d", 1.2, d, "HGMMA",
                                    route_floor_share=0.8) == []
    assert cuda_build.fold_failures("micro_reduce_d", 1.2, d, "HGMMA",
                                    route_floor_share=1.0) == []
    above = cuda_build.fold_failures("micro_reduce_d", 1.2, d, "HGMMA", route_floor_share=1.3)
    assert above == ["micro_reduce_d: 1.300 of its route floor (above 1.05)"]
    # Without a route floor the operations bound is held, as for A and B.
    assert cuda_build.fold_failures("micro_reduce_d", 1.2, d, "HGMMA") == [
        "micro_reduce_d: 1.200 of its bound (above 1.05)"]
    # mma.sync's HMMA is not the warpgroup route's instruction.
    assert cuda_build.fold_failures("micro_reduce_d", 0.5, d, "HMMA",
                                    route_floor_share=0.5) == ["micro_reduce_d: no HMMA in its SASS"]


def test_library_path_covers_source_and_flags(monkeypatch):
    names = cuda_build.kernel_names()
    assert "micro_reduce" in names and "composite_pairs_fwd" in names
    path = cuda_build.library_path("micro_reduce")
    assert path.parent == cuda_build.BUILD_DIR and path.suffix == ".so"
    monkeypatch.setattr(cuda_build, "NVCC_FLAGS", cuda_build.NVCC_FLAGS + ("-DX=1",))
    assert cuda_build.library_path("micro_reduce") != path


def _body(src: str, head: str) -> str:
    """The braced body of the function whose declaration holds `head`."""
    start = src.index("{", src.index(head))
    depth = 0
    for j in range(start, len(src)):
        depth += {"{": 1, "}": -1}.get(src[j], 0)
        if depth == 0:
            return src[start:j + 1]
    raise AssertionError(f"{head}: unbalanced braces")


def _kernel_body(name: str) -> str:
    """The body of function `name` in csrc/micro_reduce.cu."""
    src = (cuda_build.CSRC_DIR / "micro_reduce.cu").read_text()
    return _body(src, f" {name}(const float*" if name.startswith("kern_") else f" {name}(")


def test_micro_reduce_a_has_no_block_barrier_or_tensor_core():
    """A keeps its sums in registers: the ones are staged before the chunk
    loop, and no block barrier or tensor-core instruction follows."""
    body = _kernel_body("kern_a")
    staged, loop = body.index("stage_ones(ones)"), body.index("for (int k = 0; k < N_CHUNKS")
    assert staged < loop
    assert "__syncthreads" not in body and "mma" not in body


def test_micro_reduce_c_splits_each_fragment_once_for_all_fields():
    """C builds and splits one A fragment a k-step, outside the field loops
    that issue the nine fields' 3xTF32 products on it."""
    body = _kernel_body("kern_c")
    kstep = body[body.index("for (int kk"):]
    frag, field = kstep.index("a_fragment("), kstep.index("for (int r = 0; r < NRED")
    assert frag < field and kstep.count("a_fragment(") == 1
    assert kstep.count("mma_tf32(small[r]") == 2 and kstep.count("mma_tf32(big[r]") == 1


def test_micro_reduce_d_issues_warpgroup_products_in_flight():
    """D is one warpgroup's wgmma.mma_async m64n16k8 TF32 products: each
    k-step's A fragment built and split once (hi by truncation, lo the
    remainder), in registers, before the fence of its batch; three products a k-step (3xTF32) on B through a
    shared-memory descriptor; each batch committed as a group, and the
    groups waited for only before a register set is rebuilt and before the
    accumulators are read. No mma.sync."""
    src = (cuda_build.CSRC_DIR / "micro_reduce.cu").read_text()
    assert "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32" in src
    assert "constexpr int D_THREADS = 128;" in src and "kern_d<<<nt, D_THREADS," in src
    body = _kernel_body("kern_d")
    assert "mma_tf32(" not in body and "slab_desc(" in body
    batch = _kernel_body("d_batch")
    assert batch.count("a_fragment<true>(") == 1   # split by truncation (`split_trunc`)
    order = [batch.index(t) for t in ("a_fragment<true>(", "wgmma_fence()", "wgmma_tf32(",
                                      "wgmma_commit()")]
    assert order == sorted(order)
    assert batch.count("wgmma_tf32(") == 3 and "wgmma_wait" not in batch
    loop = body[body.index("for (int kk"):]
    assert loop.count("d_batch(a[0]") == 1 and loop.count("d_batch(a[1]") == 1
    assert loop.count("wgmma_wait<1>()") == 2 and body.count("wgmma_wait<0>()") == 1
    assert body.index("wgmma_wait<0>()") < body.index("d[e] = small[e] + big[e]")


def test_micro_reduce_b_reduces_many_partials_a_shuffle():
    """B forms its plane once a slot and reduces 16 of its (field, row)
    partials with one transposing butterfly: no __syncwarp, no shared row
    buffer, one store a slot."""
    body = _kernel_body("kern_b")
    assert "__syncwarp" not in body and "rowsum" not in body
    assert body.index("f[rr][j] = v * one") < body.index("b_level<8, 4>(part")
    assert body.count("lane == 0") == 1


def _compositor_source(name: str) -> str:
    """csrc/<name>.cu with the header it includes, as the compiler sees them."""
    csrc = cuda_build.CSRC_DIR
    return (csrc / "composite_pairs_common.cuh").read_text() + (csrc / f"{name}.cu").read_text()


def test_bwd_kernel_sums_pixels_in_threads_without_atomics():
    """The backward compositor sums a pair over a thread's pixels, then a
    warp's by the transposing butterfly, then the warps' in order: no
    atomics, no per-field butterflies of the old schedule. The schedule's
    pieces are in the shared header, so the source is read with it."""
    src = _compositor_source("composite_pairs_bwd")
    assert "atomicAdd" not in src and "warp_partials(" not in src
    for step in ("transpose_level<4>(v, lane)", "transpose_level<2>(v, lane)",
                 "transpose_level<1>(v, lane)"):
        assert src.count(step) == 1
    assert "warp_fields(s, rb + j, lane)" in src
    assert "walk_group<kAmp, kGcVpu, kChunk>(" in src


def test_bwd_v2_kernel_walks_live_slots_through_the_shared_butterfly():
    """Row 4 (the v2 backward) walks only the live slots of each 512-pair
    chunk, reduces through the one transposing butterfly of the shared
    header (the schedule of composite_pairs_bwd.cu), and writes its own
    zeros: no atomics, no walk of a whole chunk, no per-field butterflies."""
    src = _compositor_source("composite_pairs_bwd_v2")
    body = src[src.index("composite_pairs_bwd_v2_kernel("):]
    assert "atomicAdd" not in src and "warp_partials(" not in src
    assert "g < kChunk" not in body and "i < kChunk" not in body
    assert "for (int g = lo; g < hi; g += kGroup" in body
    assert "walk_group<kAmp, false, kChunk>(" in body and "group_rows<kChunk>(" in body
    assert "write_zeros(" in body
    header = (cuda_build.CSRC_DIR / "composite_pairs_common.cuh").read_text()
    assert header.count("template <int kHalf>\n__device__ __forceinline__ void "
                        "transpose_level") == 1
    for name in ("composite_pairs_bwd.cu", "composite_pairs_bwd_v2.cu"):
        assert "transpose_level" not in (cuda_build.CSRC_DIR / name).read_text()


def _fwd_header_body(head: str) -> str:
    """The body of a function of the forward's walk in the shared header."""
    header = (cuda_build.CSRC_DIR / "composite_pairs_common.cuh").read_text()
    return _body(header, head)


def test_fwd_kernel_puts_several_pixels_in_a_thread():
    """Row 1 keeps 4 pixels a thread in blocks of 2 warps (a 32×32 tile over
    4 blocks, 16 blocks an SM asked of the compiler), reads each staged pair
    once a thread, forms its alpha at the thread's pixels before any of
    them blends it, and blends with selects: no branch on a pixel's stop
    inside the walk. The walk (`fwd_walk`) and its per-pair step
    (`fwd_step`) are the shared header's, so the source is read with it."""
    src = _compositor_source("composite_pairs_fwd")
    assert "constexpr int kFwdPix = 4;" in src and "constexpr int kFwdBlockWarps = 2;" in src
    assert "__launch_bounds__(kFwdBlockWarps * 32, 32 / kFwdBlockWarps)" in src
    assert "fwd_walk<kChunk, kChunk, false>(" in src
    walk = _fwd_header_body("void fwd_walk(")
    step = _fwd_header_body("bool fwd_step(")
    assert step.count("load_pair(") == 1 and "load_pair(" not in walk
    assert step.index("fwd_alpha(q,") < step.index("fwd_blend(a[i], q, !v.done[i],")
    # 4 consecutive pixels of one row a thread, one dy a pair, vector stores.
    assert "const int pix0 = warp * 32 * kFwdPix + kFwdPix * lane;" in walk
    assert step.count("const float dy = v.py - q.my;") == 1
    assert walk.count("*reinterpret_cast<float4*>(") == 4
    # Row 1's chunks (kSub == kChunk): one exit test a chunk.
    once = walk[walk.index("if constexpr (kSub >= kChunk) {"):walk.index("} else {")]
    assert "for (int j = lo; j < n && !all_done; ++j)" in once
    assert "fwd_step(&chunk[0][j], kChunk, base + j + sid0, v)" in once
    assert once.count("__syncthreads_count(") == 1
    header = (cuda_build.CSRC_DIR / "composite_pairs_common.cuh").read_text()
    blend = header[header.index("bool fwd_blend("):header.index("constexpr int kFwdPix")]
    assert "if (" not in blend and "keep ? test_t : T" in blend


def test_fwd_v2_kernel_walks_live_slots_through_the_shared_walk():
    """Row 3 (the v2 forward) instantiates row 1's walk from the shared
    header over v2's window: 512-pair chunks aligned to the window, the
    exit tested once per 64-pair group, and only the live slots of a chunk
    staged and walked (no staging loop over a whole chunk, no per-slot
    test of the window's head). Neither forward source holds a walk of its
    own: one copy of the per-pair arithmetic."""
    cu = (cuda_build.CSRC_DIR / "composite_pairs_fwd_v2.cu").read_text()
    assert "constexpr int kChunk = 512;" in cu and "constexpr int kSub = 64;" in cu
    assert "fwd_walk<kChunk, kSub, true>(" in cu
    assert "__launch_bounds__(kFwdBlockWarps * 32, 32 / kFwdBlockWarps)" in cu
    walk = _fwd_header_body("void fwd_walk(")
    assert "i < kChunk" not in walk and "sid >= head" not in walk
    assert "const int origin = kWindowChunks ? start - head : start;" in walk
    assert "const int lo = kWindowChunks ? max(first - base, 0) : 0;" in walk
    assert "for (int i = lo + tid; i < n; i += blockDim.x)" in walk
    groups = walk[walk.index("} else {"):]
    assert "for (int g = lo, g_end; walking && g < n; g = g_end)" in groups
    assert "g_end = min(n, (g / kSub + 1) * kSub);" in groups
    assert groups.index("for (int j = g; j < g_end && !all_done; ++j)") < groups.index(
        "__syncthreads_count(!all_done)")
    assert groups.count("__syncthreads_count(") == 1 and groups.count("fwd_step(") == 1
    assert walk.count("fwd_step(") == 2
    step = _fwd_header_body("bool fwd_step(")
    assert "v.stop[i] = sid;" in step
    for name in ("composite_pairs_fwd.cu", "composite_pairs_fwd_v2.cu"):
        text = (cuda_build.CSRC_DIR / name).read_text()
        body = _body(text, "_kernel(")
        assert "load_pair(" not in body and "fwd_blend(" not in body and "fwd_alpha(" not in body
        assert "fwd_launch(" in text


def test_blocks_per_sm_takes_the_tightest_limit():
    """Registers (256 a warp at a time), shared memory, threads: row 2's
    report on the H100 (108 registers, 27,680 B) holds 2 blocks of 256 threads."""
    assert cuda_build.blocks_per_sm({"registers": 108, "smem_bytes": 27680}, 256) == 2
    assert cuda_build.blocks_per_sm({"registers": 64, "smem_bytes": 9216}, 256) == 4
    assert cuda_build.blocks_per_sm({"registers": 32, "smem_bytes": 0}, 256) == 8
    assert cuda_build.blocks_per_sm({"registers": 32, "smem_bytes": 100000}, 256) == 2
    assert cuda_build.blocks_per_sm({"registers": 16}, 32) == 32


FAKE_NVCC = """#!/bin/sh
# Stands in for nvcc: a long log on stdout, then the output file, late.
out=""
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; shift; fi
  shift
done
i=0
while [ $i -lt 2000 ]; do echo "ptxas info    : line $i of the build log"; i=$((i+1)); done
sleep 1
echo "library" > "$out"
"""

BUILD_SCRIPT = """
import sys
from pathlib import Path
from gaussianavatars_torch import cuda_build
cuda_build.CSRC_DIR = Path(sys.argv[1])
cuda_build.BUILD_DIR = Path(sys.argv[2])
cuda_build.build(["k"])
"""


def test_two_processes_building_one_missing_library_leave_it_whole(tmp_path):
    """Two processes build the same library at once: one library and one
    whole log (2,000 lines) come out, and no temporary file is left."""
    import os
    import subprocess
    import sys

    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    nvcc = home / "bin" / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(0o755)
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// a kernel\n")
    env = {**os.environ, "CUDA_HOME": str(home)}
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_SCRIPT, str(csrc), str(build)], env=env)
             for _ in range(2)]
    assert [p.wait(timeout=120) for p in procs] == [0, 0]
    files = sorted(p.name for p in build.iterdir())
    assert len(files) == 2 and files[0].endswith(".log") and files[1].endswith(".so"), files
    log = (build / files[0]).read_text().splitlines()
    assert len(log) == 2000 and log[-1] == "ptxas info    : line 1999 of the build log"
    assert (build / files[1]).read_text() == "library\n"
