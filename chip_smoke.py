#!/usr/bin/env python3
"""Smoke check of the cfd_tpu_torch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Run from the root of a checkout. It imports torch and the port, never jax
or cfd_tpu. Phases (any failure raises and the exit code is non-zero):

1. Device and build: requires a CUDA device, prints the card's name and
   power limit (nvidia-smi), builds the kernels from csrc/ with nvcc and
   prints the build seconds.
2. Per-kernel check at the 2048^2 main-path shapes: each hand-written
   kernel against its plain PyTorch twin on the same seeded inputs on the
   card. Error = max |kernel - plain| / max |plain| per output; limits:
   1e-5 for float32 fields and scalars, 2^-7 for bfloat16-stored fields.
   Times are CUDA-event medians of 20 launches.
3. The slice: make_cavity_case(n_interior=2048, poisson="multigrid",
   dtype=float32, tolerance_factor=1e-6) on cuda through
   Simulation.run(n_steps=300, steps_per_call=100). Launch counters are
   zeroed just before; every kernel of the path must have launched.
   Prints steps/s and V-cycles/step over the last 100 steps.
4. Card against CPU: the slice at 256^2 for 20 steps with the kernels on
   the card and the plain twins on the CPU, with the f32 and with the bf16
   coarse hierarchy: per-step V-cycle counts equal, fields within 5e-5
   relative, avg_KE within 1e-6 relative.

The line before the last is a JSON object {"kernels": [...]}; the last
line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
N_MAIN = 2048
TOL_F32 = 1e-5
TOL_BF16 = 2.0 ** -7


def log(msg: str) -> None:
    print(msg, flush=True)


def import_port():
    sys.path.insert(0, str(ROOT))
    try:
        import cfd_tpu_torch
    except ImportError as e:
        raise SystemExit(f"chip_smoke: cfd_tpu_torch not found next to {__file__} "
                         f"({e}); run it from a checkout of the repository")
    if Path(cfd_tpu_torch.__file__).resolve().parent.parent != ROOT:
        raise SystemExit(f"chip_smoke: imported {cfd_tpu_torch.__file__}, not the "
                         f"checkout at {ROOT}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def rel_err(got, want, what: str, tol: float, errs: list) -> float:
    got = torch.as_tensor(got).float()
    want = torch.as_tensor(want).float()
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: non-finite kernel output")
    abs_err = float((got - want).abs().max())
    scale = float(want.abs().max())
    rel = abs_err / scale if scale > 0 else abs_err
    log(f"  {what:46s} max|err|={abs_err:.3e}  rel={rel:.3e}  (limit {tol:.1e})")
    if not rel <= tol:
        raise AssertionError(f"{what}: relative error {rel:.3e} > {tol:.1e}")
    errs.append(abs_err)
    return abs_err


def check_kernels(case, dev) -> dict:
    """Phase 2: every kernel against its plain twin at the case's shapes."""
    from cfd_tpu_torch.kernels.quad import to_quad
    from cfd_tpu_torch.kernels.rb_smoother import rb_pairs_for_level
    from cfd_tpu_torch.poisson.multigrid import _build_level, build_problems

    rng = np.random.default_rng(2048)
    g = case.grid
    shape = g.shape
    inner = np.zeros(shape, np.float32)
    inner[1:-1, 1:-1] = 1.0

    def field(scale=0.1, interior_only=False):
        a = (rng.standard_normal(shape) * scale).astype(np.float32)
        if interior_only:
            a *= inner
        return to_quad(torch.from_numpy(a).to(dev), shape)

    results = {}
    carry, corr = case.step_kernels
    solve = case.poisson_solve

    # 1. carry stage
    us, vs, p, p_prev = field(), field(), field(interior_only=True), field(interior_only=True)
    errs = []
    got, want = carry.kernel(us, vs, p, p_prev), carry.plain(us, vs, p, p_prev)
    for name, a, b in zip(("us'", "vs'", "b", "guess", "max|b|"), got, want):
        rel_err(a, b, f"quad_corr_predictor_source {name}", TOL_F32, errs)
    results["quad_corr_predictor_source"] = dict(
        err=max(errs), ms=median_ms(lambda: carry.kernel(us, vs, p, p_prev)),
        plain_ms=median_ms(lambda: carry.plain(us, vs, p, p_prev)))

    # 2. corrector
    errs = []
    got, want = corr.kernel(us, vs, p, p_prev), corr.plain(us, vs, p, p_prev)
    for name, a, b in zip(("u", "v", "guess"), got, want):
        rel_err(a, b, f"quad_corrector {name}", TOL_F32, errs)
    results["quad_corrector"] = dict(
        err=max(errs), ms=median_ms(lambda: corr.kernel(us, vs, p, p_prev)),
        plain_ms=median_ms(lambda: corr.plain(us, vs, p, p_prev)))

    # 3./4. finest-level V-cycle kernels (b on the interior, as the carry emits)
    b = field(scale=1e3, interior_only=True)
    pre, post = solve.pre0, solve.post0
    errs = []
    got, want = pre.kernel(p, b), pre.plain(p, b)
    for name, a, w in zip(("p", "rc"), got, want):
        rel_err(a, w, f"quad_pre_smooth_restrict {name}", TOL_F32, errs)
    results["quad_pre_smooth_restrict"] = dict(
        err=max(errs), ms=median_ms(lambda: pre.kernel(p, b)),
        plain_ms=median_ms(lambda: pre.plain(p, b)))
    Hc, Wc = pre.coarse_shape
    ec_np = np.zeros((Hc, Wc), np.float32)
    ec_np[1 : g.ny // 2 + 1, 1 : g.nx // 2 + 1] = rng.standard_normal(
        (g.ny // 2, g.nx // 2)).astype(np.float32) * 0.1
    ec = torch.from_numpy(ec_np).to(dev)
    errs = []
    got, want = post.kernel(p, b, ec), post.plain(p, b, ec)
    for name, a, w in zip(("p", "max|r|"), got, want):
        rel_err(a, w, f"quad_post_prolong_smooth {name}", TOL_F32, errs)
    results["quad_post_prolong_smooth"] = dict(
        err=max(errs), ms=median_ms(lambda: post.kernel(p, b, ec)),
        plain_ms=median_ms(lambda: post.plain(p, b, ec)))

    # 5. coarse smoother: every level shape the path smooths, f32 and bf16
    errs, timing = [], None
    probs = build_problems(solve_problem(case), solve.cfg)
    for k, prob in enumerate(probs[1:-1], start=1):
        for dt in (torch.float32, torch.bfloat16):
            lv = _build_level(prob, dt, dev)
            tol = TOL_F32 if dt == torch.float32 else TOL_BF16
            H8, W = lv.shape
            a = np.zeros((H8, W), np.float32)
            a[1 : prob.ny + 1, 1 : prob.nx + 1] = rng.standard_normal((prob.ny, prob.nx))
            bb = torch.from_numpy(a * 1e2).to(dev, dt)
            pp = torch.from_numpy(a * 0.1).to(dev, dt)
            for n_pairs, field_variant in ((solve.cfg.pre_sweeps, True),
                                           (solve.cfg.post_sweeps, False)):
                sm = rb_pairs_for_level(lv, solve.cfg.omega, n_pairs,
                                        with_residual_field=field_variant)
                got, want = sm.kernel(pp, bb), sm.plain(pp, bb)
                got = got if field_variant else (got,)
                want = want if field_variant else (want,)
                tag = f"rb_pairs L{k} {tuple(lv.shape)} {str(dt)[6:]} n={n_pairs}"
                for name, x, y in zip(("p", "r"), got, want):
                    rel_err(x, y, f"{tag} {name}", tol, errs)
                if k == 1 and dt == torch.bfloat16 and field_variant:
                    timing = dict(ms=median_ms(lambda: sm.kernel(pp, bb)),
                                  plain_ms=median_ms(lambda: sm.plain(pp, bb)))
    results["rb_pairs"] = dict(err=max(errs), **timing)
    return results


def solve_problem(case):
    from cfd_tpu_torch.poisson.multigrid import cavity_problem

    g = case.grid
    return cavity_problem(g.nx, g.ny, g.dx, g.dy)


def run_slice(case, n_steps: int, spc: int):
    from cfd_tpu_torch.solver import Simulation

    sim = Simulation(case, log=lambda m: log("  " + m))
    state = sim.run(n_steps=n_steps, steps_per_call=spc)
    torch.cuda.synchronize()
    return sim, sim._logical(state)


def card_vs_cpu(coarse: str) -> None:
    """Phase 4 for one coarse dtype: kernels on the card vs plain on the CPU."""
    from cfd_tpu_torch.cases import make_cavity_case
    from cfd_tpu_torch.solver import Simulation

    kw = dict(n_interior=256, poisson="multigrid", dtype=torch.float32,
              tolerance_factor=1e-6, print_interval=20,
              mg_overrides={"coarse_dtype": coarse})
    out = {}
    for where, dev in (("card", "cuda"), ("cpu", "cpu")):
        sim = Simulation(make_cavity_case(device=dev, **kw), log=lambda m: None)
        st = sim._logical(sim.run(n_steps=20))
        out[where] = (sim.step_iters, st, sim.history[-1]["avg_kinetic_energy"])
    (it_g, st_g, ke_g), (it_c, st_c, ke_c) = out["card"], out["cpu"]
    log(f"  coarse {coarse}: cycles/step card {it_g}")
    log(f"  coarse {coarse}: cycles/step cpu  {it_c}")
    if it_g != it_c:
        raise AssertionError(f"coarse {coarse}: card and CPU cycle counts differ")
    for name in ("u", "v", "p"):
        a = getattr(st_g, name).float().cpu()
        b = getattr(st_c, name).float()
        rel_err(a, b, f"256^2 {coarse} card vs cpu {name}", 5e-5, [])
    rel = abs(ke_g - ke_c) / abs(ke_c)
    log(f"  256^2 {coarse} avg_KE card {ke_g!r} cpu {ke_c!r} rel {rel:.3e} (limit 1e-6)")
    if not rel <= 1e-6:
        raise AssertionError(f"coarse {coarse}: avg_KE differs by {rel:.3e}")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this check "
                         "needs a CUDA GPU")
    import_port()
    from cfd_tpu_torch.cases import make_cavity_case
    from cfd_tpu_torch.kernels import KERNELS
    from cfd_tpu_torch.kernels import _build

    dev = torch.device("cuda")
    card = card_line()
    name = torch.cuda.get_device_name(0)
    log(f"phase 1: {name} | nvidia-smi: {card} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    path, build_s = _build.build()
    _build.library()
    log(f"  built {path.relative_to(ROOT)} in {build_s:.1f} s")

    log(f"phase 2: kernels vs plain twins at {N_MAIN}^2 shapes ({card})")
    case = make_cavity_case(n_interior=N_MAIN, poisson="multigrid", dtype=torch.float32,
                            tolerance_factor=1e-6, device=dev)
    mg = case.info["mg"]
    log(f"  solver config: V({mg.pre_sweeps},{mg.post_sweeps}) coarse_dtype="
        f"{mg.coarse_dtype} levels={len(case.poisson_solve.levels)}")
    checks = check_kernels(case, dev)
    for k, r in checks.items():
        log(f"  {k:28s} kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  ({card})")

    log(f"phase 3: the slice at {N_MAIN}^2, 300 steps in chunks of 100 ({card})")
    for kern in KERNELS:
        kern.launches = 0
    t0 = time.perf_counter()
    sim, st = run_slice(case, 300, 100)
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in KERNELS}
    log(f"  launches: {launches}")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    for fname in ("u", "v", "p"):
        if not bool(torch.isfinite(getattr(st, fname)).all()):
            raise AssertionError(f"non-finite {fname} after the 2048^2 run")
    ke = sim.history[-1]["avg_kinetic_energy"]
    if not ke > 0:
        raise AssertionError(f"avg_KE={ke} after the 2048^2 run")
    last = sim.step_iters[-100:]
    cycles = float(np.mean(last))
    t100 = sim.history[-1]["wall_seconds"] - sim.history[-2]["wall_seconds"]
    steps_s = 100 / t100
    updates = N_MAIN * N_MAIN * (5 + 16 / 3 * cycles) * steps_s
    log(f"  300 steps in {wall:.2f} s; last 100: {steps_s:.2f} steps/s, "
        f"{cycles:.2f} V-cycles/step, {updates:.4e} cell-updates/s, "
        f"avg_KE={ke:.6f} ({card})")

    log("phase 4: card vs CPU at 256^2, 20 steps")
    for coarse in ("float32", "bfloat16"):
        card_vs_cpu(coarse)

    kernels = []
    for k in KERNELS:
        r = checks[k.name]
        kernels.append(dict(name=k.name, route="cuda", source=k.source,
                            replaces=k.replaces, launches=launches[k.name],
                            max_abs_err=r["err"], ms=r["ms"], plain_ms=r["plain_ms"]))
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
