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


def test_library_path_covers_source_and_flags(monkeypatch):
    names = cuda_build.kernel_names()
    assert "micro_reduce" in names and "composite_pairs_fwd" in names
    path = cuda_build.library_path("micro_reduce")
    assert path.parent == cuda_build.BUILD_DIR and path.suffix == ".so"
    monkeypatch.setattr(cuda_build, "NVCC_FLAGS", cuda_build.NVCC_FLAGS + ("-DX=1",))
    assert cuda_build.library_path("micro_reduce") != path


def _kernel_body(name: str) -> str:
    """The body of `__global__` function `name` in csrc/micro_reduce.cu."""
    src = (cuda_build.CSRC_DIR / "micro_reduce.cu").read_text()
    start = src.index("{", src.index(f" {name}(const float*"))
    depth = 0
    for j in range(start, len(src)):
        depth += {"{": 1, "}": -1}.get(src[j], 0)
        if depth == 0:
            return src[start:j + 1]
    raise AssertionError(f"{name}: unbalanced braces")


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


def test_micro_reduce_b_reduces_many_partials_a_shuffle():
    """B forms its plane once a slot and reduces 16 of its (field, row)
    partials with one transposing butterfly: no __syncwarp, no shared row
    buffer, one store a slot."""
    body = _kernel_body("kern_b")
    assert "__syncwarp" not in body and "rowsum" not in body
    assert body.index("f[rr][j] = v * one") < body.index("b_level<8, 4>(part")
    assert body.count("lane == 0") == 1


def test_bwd_kernel_sums_pixels_in_threads_without_atomics():
    """The backward compositor sums a pair over a thread's pixels, then a
    warp's by the transposing butterfly, then the warps' in order: no
    atomics, no per-field butterflies of the old schedule."""
    src = (cuda_build.CSRC_DIR / "composite_pairs_bwd.cu").read_text()
    assert "atomicAdd" not in src and "warp_partials(" not in src
    for step in ("transpose_level<4>(v, lane)", "transpose_level<2>(v, lane)",
                 "transpose_level<1>(v, lane)"):
        assert src.count(step) == 1
    assert "warp_fields(s, rb + j, lane)" in src
