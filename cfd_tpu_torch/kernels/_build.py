"""Build and bind the hand-written CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own nvcc process, all started
together, and the objects are linked into one shared library with a plain C
interface, loaded with ctypes (no PyTorch headers, so the build takes
seconds, not minutes):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
         -Xptxas -v -Xcompiler -fPIC -c csrc/<name>.cu -o <name>.o   (each)
    nvcc -shared -o build/cfd_tpu_torch/libcfd_tpu_torch_<sha>.so *.o

``<sha>`` hashes the sources and the flags, so an edited source builds a
new library. The build runs at the first CUDA call (``library()``), never
at import. A missing nvcc or a failed build raises with the compiler's
output; nothing falls back to the plain PyTorch versions. The compiler's
report (``-Xptxas -v``: registers, shared memory and spills of every
kernel) is kept beside the library as ``<library>.log``.

``--fmad=false``: nvcc would otherwise contract ``a*b + c`` into one fused
multiply-add, while PyTorch's eager ops round every product. Without
contraction each kernel performs the same float32 operations in the same
order as its plain twin, so the card comparisons hold to a few ulps (and
most outputs bit for bit), and the V-cycle counts cannot drift apart. The
stencils are bound by memory traffic, so the lost FMAs cost no time that
matters here.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cfd_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# C entry points: argument types (pointers and the stream as c_void_p,
# ints as c_int, coefficients as c_float); every one returns cudaError_t.
SIGNATURES = {
    "cfd_quad_corrector": [_P] * 7 + [_I] * 4 + [_F] * 3 + [_P],
    # the cavity's carry; its last two ints are a sharded local block's
    # row_base and halo (0, 0 on a whole field), the pointer after them its
    # tile plan (kernels/plan.py CarryPlan)
    "cfd_quad_carry": [_P] * 9 + [_I] * 4 + [_F] * 10 + [_I, _I, _P, _P],
    # the carries' tile kernels readied: adaptive, block, shared memory;
    # blocks, blocks per SM, registers out
    "cfd_quad_carry_grid": [_I] * 3 + [_P] * 3,
    "cfd_quad_channel_carry_grid": [_I] * 3 + [_P] * 3,
    "cfd_step_carry_grid": [_I] * 3 + [_P] * 3,
    "cfd_rb_carry_grid": [_I] * 3 + [_P] * 3,
    # the cavity's, channel's and RB's finest-level pre and post: the last
    # three ints n_pairs and a block's row_base and halo, the pointer after
    # them the tile plan (kernels/plan.py level0_plan, masked=False); the
    # post's running max and count (acc) after res
    "cfd_quad_pre_smooth_restrict": [_P] * 8 + [_I] * 4 + [_F] * 3 + [_I] * 3 + [_P, _P],
    "cfd_quad_post_prolong_smooth": [_P] * 10 + [_I] * 4 + [_F] * 3 + [_I] * 3 + [_P, _P],
    # their tile kernels readied: post, block, shared memory; blocks,
    # blocks per SM, registers out
    "cfd_quad_level0_grid": [_I] * 3 + [_P] * 3,
    # the coarse smoother: storage, p, b, out, r, res, acc, the weights,
    # the level, n_pairs, the tile plan (kernels/plan.py pairs_plan)
    "cfd_rb_pairs": [_I] + [_P] * 10 + [_I] * 4 + [_F] * 3 + [_I, _P, _P],
    # its kernel readied: storage, shared memory; blocks, blocks per SM,
    # registers out
    "cfd_rb_pairs_grid": [_I] * 2 + [_P] * 3,
    "cfd_quad_channel_corrector": [_P] * 7 + [_I] * 4 + [_F] * 3 + [_P],
    # the channel's, the step's and RB's carries: the last two ints and the
    # plan as the cavity's
    "cfd_quad_channel_carry": [_P] * 11 + [_I] * 4 + [_F] * 10 + [_I, _I, _P, _P],
    # ... the last two pointers before the stream: rc32 and the launch plan
    # (kernels/whole_solve.py Plan)
    "cfd_whole_solve": ([_I] + [_P] * 13 + [_I] * 6 + [_F] * 4 + [_I] + [_P] * 3 + [_F]
                        + [_I] * 3 + [_F] * 3 + [_I, _P, _F] + [_I, _I, _P, _P] + [_P]),
    # masked, shared memory; blocks, blocks per SM, registers out
    "cfd_whole_solve_grid": [_I] * 2 + [_P] * 3,
    # the whole time step: flavor, io, cf, the carry's tile plan, then
    # cfd_whole_solve's arguments from `masked` on without p_in, b0 and max_b
    "cfd_whole_step": ([_I, _P, _P, _P, _I] + [_P] * 10 + [_I] * 6 + [_F] * 4 + [_I] + [_P] * 3
                       + [_F] + [_I] * 3 + [_F] * 3 + [_I, _P, _F] + [_I, _I, _P, _P] + [_P]),
    # the fused coarse tail: b, e, pinv, the levels, omega, pre, post, the
    # plan
    "cfd_mg_tail": [_P] * 3 + [_I] + [_P] * 3 + [_F] + [_I] * 2 + [_P, _P],
    "cfd_mg_tail_grid": [_I] + [_P] * 3,
    "cfd_whole_step_grid": [_I] * 2 + [_P] * 3,
    # the step's corrector: the two ints after the floats its block (kernels/
    # plan.py step_corrector_plan), as its traced-dt instance's
    "cfd_step_corrector": [_P] * 5 + [_I] * 6 + [_F] * 3 + [_I, _I, _P],
    # the step's carry, pre and post: the last two ints as the cavity's, the
    # pointer after them the tile plan (the pre's and post's: kernels/plan.py
    # level0_plan)
    "cfd_step_carry": [_P] * 9 + [_I] * 6 + [_F] * 10 + [_I, _I, _P, _P],
    "cfd_step_pre_smooth_restrict": [_P] * 4 + [_I] * 6 + [_F] * 5 + [_I] * 3 + [_P, _P],
    "cfd_step_post_prolong_smooth": [_P] * 6 + [_I] * 6 + [_F] * 5 + [_I] * 3 + [_P, _P],
    # the pre and post tile kernels readied: post, block, shared memory;
    # blocks, blocks per SM, registers out
    "cfd_step_level0_grid": [_I] * 3 + [_P] * 3,
    "cfd_rb_pairs_full": [_P] * 8 + [_I] * 4 + [_F] * 3 + [_I, _P, _P],
    "cfd_rb_corrector": [_P] * 5 + [_I] * 4 + [_F] * 2 + [_P],
    "cfd_rb_carry": [_P] * 13 + [_I] * 4 + [_F] * 13 + [_I, _I, _P, _P],
    # adaptive stepping: the traced-dt correctors, the traced-dt cavity
    # predictor+source (the running max's accumulator after max_b, the
    # pointer after the floats its tile plan, kernels/plan.py carry_plan;
    # its kernel readied: shared memory; blocks, blocks per SM, registers
    # out), the traced-dt + Courant carries (their last two ints and their
    # plan as the fixed carries')
    "cfd_quad_corrector_traced": [_P] * 8 + [_I] * 4 + [_F] * 3 + [_P],
    "cfd_quad_predictor_source": [_P] * 8 + [_I] * 4 + [_F] * 7 + [_P, _P],
    "cfd_quad_predictor_source_grid": [_I] + [_P] * 3,
    "cfd_quad_carry_adaptive": [_P] * 10 + [_I] * 4 + [_F] * 9 + [_I, _I, _P, _P],
    "cfd_quad_channel_corrector_traced": [_P] * 8 + [_I] * 4 + [_F] * 3 + [_P],
    "cfd_quad_channel_carry_adaptive": [_P] * 13 + [_I] * 4 + [_F] * 9 + [_I, _I, _P, _P],
    "cfd_step_corrector_traced": [_P] * 6 + [_I] * 6 + [_F] * 3 + [_I, _I, _P],
    "cfd_step_carry_adaptive": [_P] * 11 + [_I] * 6 + [_F] * 9 + [_I, _I, _P, _P],
    "cfd_rb_corrector_traced": [_P] * 6 + [_I] * 4 + [_F] * 2 + [_P],
    "cfd_rb_carry_adaptive": [_P] * 13 + [_I] * 4 + [_F] * 11 + [_I, _I, _P, _P],
    # the natural layout: the four stage kernels (the predictor + source
    # with the running max's accumulator after max_b and its tile plan,
    # kernels/plan.py natural_predictor_plan, after the floats; its kernel
    # readied as the cavity's; the channel's with the sum's count after the
    # partials and its plan, natural_predictor_plan(channel=True), after the
    # floats) and the step's exact masked finest-level pairs
    "cfd_predictor_source": [_P] * 7 + [_I] * 4 + [_F] * 8 + [_P, _P],
    "cfd_predictor_source_grid": [_I] + [_P] * 3,
    "cfd_corrector": [_P] * 7 + [_I] * 4 + [_F] * 3 + [_P],
    "cfd_channel_predictor_source": [_P] * 8 + [_I] * 4 + [_F] * 8 + [_P, _P],
    "cfd_channel_predictor_source_grid": [_I] + [_P] * 3,
    "cfd_channel_corrector": [_P] * 7 + [_I] * 4 + [_F] * 3 + [_P],
    # ... p, b, out, r, res, acc, the level, n_pairs, the tile plan
    # (kernels/plan.py step_pairs_plan); its kernel readied: shared memory;
    # blocks, blocks per SM, registers out
    "cfd_step_pairs": [_P] * 6 + [_I] * 6 + [_F] * 5 + [_I, _P, _P],
    "cfd_step_pairs_grid": [_I] + [_P] * 3,
    # the cavity carry with the first pre-smooth and restriction (one
    # cooperative launch; the pointer after n_pairs its plan,
    # kernels/plan.py FusedPrePlan) and its grid readied: shared memory;
    # blocks, blocks per SM, registers out; the non-carry channel stage
    # (the sum's count after the partials, its tile plan, kernels/plan.py
    # carry_plan("channel_predictor"), after the floats; its kernel readied
    # as the cavity's non-carry stage)
    "cfd_quad_fused_pre": [_P] * 12 + [_F] * 10 + [_P] * 4 + [_I] * 4 + [_F] * 3 + [_I, _P, _P],
    "cfd_quad_fused_pre_grid": [_I] + [_P] * 3,
    "cfd_quad_channel_predictor_source": [_P] * 8 + [_I] * 4 + [_F] * 8 + [_P, _P],
    "cfd_quad_channel_predictor_source_grid": [_I] + [_P] * 3,
}


def find_nvcc() -> str | None:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    return str(default) if default.exists() else None


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in _sources():
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libcfd_tpu_torch_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile the library unless this source hash is already built.
    Returns (path, seconds spent compiling)."""
    out = library_path()
    if out.exists():
        return out, 0.0
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                           "cfd_tpu_torch CUDA kernels cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as objdir:
        jobs = []
        for src in sorted(CSRC.glob("*.cu")):
            obj = Path(objdir) / f"{src.stem}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                    stderr=subprocess.PIPE, text=True)))
        log, failed = [], []
        for cmd, _, proc in jobs:
            stdout, stderr = proc.communicate()
            log.append(f"$ {' '.join(cmd)}\n{stdout}{stderr}")
            if proc.returncode != 0:
                failed.append(f"nvcc failed (exit {proc.returncode}):\n{log[-1]}")
        if failed:
            raise RuntimeError("\n".join(failed))
        link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", str(tmp),
                *(str(obj) for _, obj, _ in jobs)]
        proc = subprocess.run(link, capture_output=True, text=True)
        log.append(f"$ {' '.join(link)}\n{proc.stdout}{proc.stderr}")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n{log[-1]}")
    out.with_suffix(".log").write_text("\n".join(log))
    os.replace(tmp, out)
    return out, time.perf_counter() - t0


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.cfd_error_string.argtypes = [ctypes.c_int]
    lib.cfd_error_string.restype = ctypes.c_char_p
    return lib


class Kernel:
    """One C entry point of the library and its launch counter.

    ``launches`` is a plain int that grows by one each time the entry point
    launches its kernels on the card, and nowhere else (the CPU plain twin
    does not count)."""

    def __init__(self, name: str, symbol: str, source: str, replaces: str):
        self.name = name
        self.symbol = symbol
        self.source = source  # path in the repository
        self.replaces = replaces  # file:line of the TPU kernel
        self.launches = 0

    def __call__(self, like, *args) -> None:
        """Launch on the current stream of ``like``'s device; ``args`` are
        the C arguments before the stream."""
        lib = library()
        if like.device.type != "cuda":
            raise ValueError(f"{self.symbol} needs CUDA tensors, got {like.device}")
        err = getattr(lib, self.symbol)(*args, stream_of(like))
        if err != 0:
            raise RuntimeError(f"{self.symbol}: CUDA error {err} "
                               f"({lib.cfd_error_string(err).decode()})")
        self.launches += 1


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def route(*tensors) -> str:
    """'cpu' (plain twin) or 'cuda' (kernel) from the tensors' device; any
    other device, or a mix, raises."""
    kinds = {t.device.type for t in tensors}
    if len(kinds) != 1 or not kinds <= {"cpu", "cuda"}:
        raise ValueError(f"tensors must all lie on the CPU or all on one CUDA "
                         f"device, got {sorted(kinds)}")
    return kinds.pop()
