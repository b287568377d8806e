"""The whole-solve kernel (csrc/whole_solve.cu) on the card in its planned
schedule (kernels/plan.py): the finest level in shared-memory tiles, the
coarse levels from the plan's switch in one block, the levels above on the
grid. Each flavor is held bit-identical to its plain twin (error 0, equal
cycles and residual): separable V(2,1) and V(1,2), the pin-mean solve, the
bfloat16 hierarchy, the masked solve, masked with bf16 and with corr_opt,
on ragged shapes whose hierarchy runs wholly in the block and on the main
shapes whose upper levels run on the grid; the whole step's four flavors
and the fused tail once each.

Every test needs a CUDA card and skips without one. The file imports no
jax, so on a machine without JAX it runs on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_whole_solve_cuda.py

Limits: the kernels are built with --fmad=false and repeat their twins'
float32 operations in order, so p is bit-identical and the cycles and the
residual equal."""

import numpy as np
import pytest
import torch

from cfd_tpu_torch.cases import (
    make_backwards_step_case,
    make_cavity_case,
    make_channel_case,
    make_rayleigh_benard_case,
)
from cfd_tpu_torch.kernels import mg_tail as MT
from cfd_tpu_torch.seeded import seeded_fields, seeded_source


def _cavity(n):
    return make_cavity_case, dict(n_interior=n, poisson="multigrid", tolerance_factor=1e-6)


def _channel(nx, ny):
    return make_channel_case, dict(nx=nx, ny=ny, poisson="multigrid", tolerance_factor=1e-6,
                                   abs_tol=0.0)


def _step(nx, ny):
    return make_backwards_step_case, dict(nx=nx, ny=ny, poisson="multigrid",
                                          tolerance_factor=1e-6, abs_tol=0.0)


def _rb(nx, ny):
    return make_rayleigh_benard_case, dict(nx=nx, ny=ny, rayleigh=1e6)


BF16 = {"coarse_dtype": "bfloat16"}
CORR = {"corr_opt": True}
# id: (factory and kwargs, mg_overrides, whether every coarse level runs in
# the block)
SOLVES = {
    "separable-V21-cavity-64": (_cavity(64), {}, True),
    "separable-V21-cavity-128": (_cavity(128), {}, False),
    "separable-V21-cavity-256": (_cavity(256), {}, False),
    "separable-V21-cavity-2048": (_cavity(2048), {}, False),
    "separable-V12-channel-96x32": (_channel(96, 32), {}, True),
    "separable-V12-channel-200x72": (_channel(200, 72), {}, False),
    "separable-V12-channel-512x64": (_channel(512, 64), {}, False),
    "separable-V12-channel-1536x512": (_channel(1536, 512), {}, False),
    "pin-mean-rb-96x32": (_rb(96, 32), {}, True),
    "pin-mean-rb-256x128": (_rb(256, 128), {}, False),
    "pin-mean-rb-1536x512": (_rb(1536, 512), {}, False),
    "bf16-cavity-1024": (_cavity(1024), BF16, False),
    "bf16-channel-96x32": (_channel(96, 32), BF16, True),
    "bf16-channel-200x72": (_channel(200, 72), BF16, False),
    "bf16-pin-mean-rb-1536x512": (_rb(1536, 512), BF16, False),
    "masked-step-96x32": (_step(96, 32), {}, True),
    "masked-step-200x72": (_step(200, 72), {}, False),
    "masked-step-2048x256": (_step(2048, 256), {}, False),
    "masked-bf16-step-96x32": (_step(96, 32), BF16, True),
    "masked-bf16-step-512x64": (_step(512, 64), BF16, False),
    "masked-bf16-step-2048x256": (_step(2048, 256), BF16, False),
    "masked-corr_opt-step-96x32": (_step(96, 32), CORR, True),
    "masked-corr_opt-step-200x72": (_step(200, 72), CORR, False),
    "masked-corr_opt-step-256x128": (_step(256, 128), CORR, False),
    "masked-corr_opt-step-2048x256": (_step(2048, 256), CORR, False),
    "masked-corr_opt-bf16-step-2048x256": (_step(2048, 256), {**CORR, **BF16}, False),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _assert_twin(got, want):
    (pk, ck, rk), (pp, cp, rp) = got, want
    assert int(ck) == int(cp) and int(ck) >= 1
    assert float(rk) == float(rp)
    assert float((pk - pp).abs().max()) == 0.0
    assert torch.equal(pk, pp)


@pytest.mark.cuda
@pytest.mark.parametrize("which", list(SOLVES))
def test_whole_solve_matches_twin(cuda_device, which):
    (make, kw), ov, all_in_block = SOLVES[which]
    case = make(device=cuda_device, dtype=torch.float32,
                mg_overrides={"whole_solve": True, **ov}, **kw)
    solve = case.poisson_solve
    assert (solve.plan.block_from == 1) == all_in_block
    b = seeded_source(case, seed=len(which))
    record = solve._fine()[5]
    before = record.launches
    for warm in (torch.zeros_like(b), 0.01 * b):
        _assert_twin(solve.kernel(warm, b), solve.plain(warm, b))
    assert record.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("flow", ["cavity", "channel", "rb", "step"])
def test_whole_step_matches_twin(cuda_device, flow):
    make, kw = {"cavity": _cavity(512), "channel": _channel(1536, 512), "rb": _rb(256, 128),
                "step": _step(512, 64)}[flow]
    case = make(device=cuda_device, dtype=torch.float32, mg_overrides={"whole_step": True},
                **kw)
    ws = case.whole_step_kernel
    fields = seeded_fields(case, seed=15)
    got, want = ws.kernel(*fields), ws.plain(*fields)
    assert (int(got[-2]), float(got[-1])) == (int(want[-2]), float(want[-1]))
    for a, b in zip(got[:-2], want[:-2], strict=True):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("flow", ["channel", "step"])
def test_tail_matches_twin(cuda_device, flow):
    make, kw = {"channel": _channel(1536, 512), "step": _step(2048, 256)}[flow]
    case = make(device=cuda_device, dtype=torch.float32, mg_overrides={"tail_from": 1}, **kw)
    tail = case.poisson_solve.tail
    assert tail.plan.block_from > 1
    lv = tail.levels[0]
    rng = np.random.default_rng(20)
    active = MT.level_masks(lv, cuda_device)[1]
    b = torch.from_numpy(rng.standard_normal(lv.shape).astype(np.float32) * 1e2)
    b = torch.where(active, b.to(cuda_device), 0.0)
    assert torch.equal(tail.kernel(b), tail.plain(b))
