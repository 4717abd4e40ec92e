#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py [--out results.json] [--breakdown]

Drives the port's main path through the entry points a user would call and
holds every hand-written kernel against its plain PyTorch version:

  1. the card (name, power limit, torch / CUDA versions);
  2. builds both kernels from upright_tpu_torch/csrc/ (the Riccati kernel K1
     and the plant's contact kernel P1, one nvcc each, in parallel) and
     prints registers, local memory and shared memory of each instantiation
     (P1: float32 and float64, one warp and block-wide, two friction models);
  3. K1 against its plain version (float64): the main-path shapes in
     float32 and float64, the wide-input route (nu = 45) in both, and a batch
     built to take the jitter fallback and to fail it (same NaN pattern);
  4. the batched main path: demos/thing_demo.yaml, N = 20, batch 512, one
     warm-started AL-SQP iteration per solve, solves/s over 10 re-solves;
  5. the steady replan at batch 1: shift -> heal -> solve -> policy;
  6. kernel times (specialised and runtime-sized instances, both forms, batch
     1, float64, nu = 45, N = 200), each as one eager call of the wrapper and
     as the kernel's device time alone, beside its bound;
  7. the plant's contact kernel P1 (csrc/plant.cu) against its plain
     version over one control tick (10 outer steps x 40 substeps):
     thing_demo at batch 1 and 64 with the mass, mu and CoM spread per
     instance, a stacked arrangement (box_arch), seven objects on four warps
     (blue_cups, the block-wide route), the regularized friction model and a
     batch that trips the divergence latch: float64 against the
     plain version, float32 against the plain version run in float32 on the
     same inputs (the witness), and a control that the float32 limits reject;
  8. the closed loop: thing_demo at full width on the device loop
     (runtime/device_loop.py), a 12-iteration cold solve, then 150 ticks at
     100 Hz (1.5 s) through both kernels: costs finite, the bottle within
     0.03 m of its place; then 10 ticks of the host loop (ControllerManager +
     UprightSimulation) against the device loop from the same start;
  9. P1's times (thing_demo at batch 1 and 512, box_arch and blue_cups at
     batch 1) beside its bound and its plain version's,
     and the closed loop's host time per tick, replan and plant apart; then
     one JSON line describing each kernel (time, bound, launches), the card's
     name and power limit, and the final JSON line.

With ``--breakdown`` it also times the phases of one solve (linearization,
Riccati kernel, line search) between synchronisations and traces three solves
with torch.profiler, at batch 512 and batch 1: the numbers of PERF.md's
"where the time goes".

It needs a CUDA device and the repository around it: it exits non-zero and
prints no result without either.  Any failed check raises, so the exit code
is non-zero and the final line is never printed.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np

# Published peaks of the H100 SXM, used for the roofline bound of each kernel
H100_BYTES_PER_S = 3.35e12
H100_FP32_FLOPS = 67e12
H100_FP64_FLOPS = 34e12  # NVIDIA's data sheet, SXM part, outside the tensor cores

BATCH = 512
HORIZON = 20
TIMED_RESOLVES = 10
WARM_RESOLVES = 3
REPLAN_TICKS = 40
REPLAN_WARMUP = 5


def log(msg):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(f"chip_smoke check failed: {msg}")
    log(f"  ok: {msg}")


def riccati_work(Bt, N, nx, nu, invariant, elem_bytes=4):
    """(bytes, flops) the Riccati backward pass needs: each input read once,
    each output written once; the recursion's products, one factorisation
    and one substitution pair per stage.  The Qxu block of Q = H + Z^T P Z is
    never read by the recursion, so it is not counted."""
    nz = nx + nu
    per_stage_elems = nz * nz + nz + nx + nu * nx + nu
    if not invariant:
        per_stage_elems += nx * nz
    total_elems = Bt * (N * per_stage_elems + nx * nx + nx)
    if invariant:
        total_elems += nx * nz
    per_stage_flops = (
        2 * nx * nx * nz  # P Z
        + 2 * nx * (nz * nz - nx * nu)  # Z^T (P Z) without the Qxu block
        + 2 * nx * nx + 2 * nz * nx  # P d, Z^T (p + P d)
        + nu**3 // 3  # factorisation of Quu
        + 2 * nu * nu * (nx + 1)  # forward and back substitution of [Qux | Qu]
        + 2 * nx * nx * nu + 2 * nx * nu  # Qux^T K, Qux^T kff
    )
    return elem_bytes * total_elems, Bt * N * per_stage_flops


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also write the results as JSON here")
    ap.add_argument("--breakdown", action="store_true",
                    help="also time the phases of one solve and trace three solves")
    args = ap.parse_args()
    t_start = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script runs only "
              "on a GPU.", file=sys.stderr)
        return 2

    import upright_tpu_torch.config as cfg  # the package pins full-float32 products
    from upright_tpu_torch import _build
    from upright_tpu_torch.ocp.problem import build_problem
    from upright_tpu_torch.parallel.batch import (
        batch_solve_fn,
        batch_warm_starts,
        broadcast_params,
    )
    from upright_tpu_torch.runtime.device_loop import build_device_loop
    from upright_tpu_torch.sim import contact
    from upright_tpu_torch.sim.simulation import UprightSimulation
    from upright_tpu_torch.solver import al, riccati
    from upright_tpu_torch.solver.al import ALConfig, solve
    from upright_tpu_torch.solver.mpc import ControllerManager, MPCSettings
    from upright_tpu_torch.solver.ocp import SolverState
    from upright_tpu_torch.tools.plant_data import (
        F32_TOL,
        float32_witness,
        max_errors,
        objects_to,
        plant_for,
        tick_inputs,
    )
    from upright_tpu_torch.tools.stage_data import fallback_batch, random_batch, stage_data

    dev = torch.device("cuda")
    results = {}

    def cuda_median_ms(fn, reps, warmup=2):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def cuda_launch_ms(fn, reps, inner=20):
        """Device time of one launch: `inner` launches captured back to back
        in a CUDA graph, the replay timed, over `inner`.  (cuda_median_ms of
        one eager call on an idle card also counts the host's time from the
        first event to the launch: argument checks, allocation of K, kff.)"""
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(inner):
                fn()
        return cuda_median_ms(graph.replay, reps, warmup=1) / inner

    # -- 1. the card ------------------------------------------------------
    log("== 1. card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0 and smi.stdout.strip(), "nvidia-smi answered")
    card_line = smi.stdout.strip().splitlines()[0]
    log(card_line)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    check(torch.backends.cuda.matmul.allow_tf32 is False
          and torch.get_float32_matmul_precision() == "highest",
          "float32 products are full float32 (TF32 off)")

    # -- 2. build the kernels ------------------------------------------------
    log("== 2. build")
    t0 = time.perf_counter()
    # one nvcc per source, started together
    _build.build(["riccati", "plant"], extra_flags=("-Xptxas", "-v"), verbose=True)
    riccati._library()
    contact._library()
    build_s = time.perf_counter() - t0
    log(f"built csrc/riccati.cu and csrc/plant.cu in {build_s:.1f} s (set-up)")
    results["build_s"] = build_s
    thing_plant = plant_for("thing_demo")
    for name, a in contact.instance_attrs().items():
        dt_ = torch.float64 if name.startswith("float64") else torch.float32
        log(f"  plant instance {name}: {a['registers']} registers, {a['local_bytes']} bytes of "
            f"local memory per thread, shared memory {a['static_smem_bytes']} static + "
            f"{contact.smem_bytes(thing_plant.tables, thing_plant.object_substeps, dt_)} "
            "dynamic at thing_demo's 1 object, 16 slots and 40 substeps")
    results["plant_instances"] = contact.instance_attrs()
    check(all(a["local_bytes"] == 0 for a in results["plant_instances"].values()),
          "no plant instance has a stack frame or spills (local memory 0)")
    attrs = riccati.instance_attrs()
    smem_at = {
        "float32 nx=27 nu=13": [(27, 13, torch.float32, False)],
        "float32 nx=18 nu=10": [(18, 10, torch.float32, False)],
        "float32 runtime-sized": [(27, 13, torch.float32, True), (27, 45, torch.float32, True)],
        "float64 runtime-sized": [(27, 13, torch.float64, True), (27, 45, torch.float64, True)],
    }
    for name, a in attrs.items():
        dyn = ", ".join(f"{riccati.smem_bytes(nx_, nu_, dt, rt)} at {nx_}/{nu_}"
                        for nx_, nu_, dt, rt in smem_at[name])
        log(f"  instance {name}: {a['registers']} registers, {a['local_bytes']} bytes of local "
            f"memory per thread, shared memory {a['static_smem_bytes']} static + {dyn} dynamic")
    results["instances"] = attrs

    # -- 3. kernel vs plain version ------------------------------------------
    log("== 3. Riccati kernel vs its plain version (float64) on the card")
    reg = 1e-6
    # Tolerances.  float32 kernel: 1e-4 absolute on K and kff (both O(1) here).
    # The float32 recursion rounds differently from float64 over the N
    # dependent stages; on an H100 the largest difference over these cases is
    # 5e-6, so 1e-4 leaves a margin of 20 and is 50 times tighter than the 5e-3
    # the reference holds its own float32 kernel to on the random_batch data.
    # float64 kernel: 1e-10 relative to the largest entry; both sides are
    # float64 and differ in summation order only (1e-14 on an H100), so an
    # indexing fault at a tile edge cannot hide under it.
    KERNEL_ATOL = 1e-4
    KERNEL_RTOL_F64 = 1e-10
    cases = [
        ("form_a_8x6x5x3", random_batch(8, 6, 5, 3), False),
        ("form_a_512x20x27x13", stage_data(BATCH, HORIZON, 27, 13, seed=1), False),
        ("form_b_512x20x27x13", stage_data(BATCH, HORIZON, 27, 13, seed=2, invariant=True), True),
        ("form_b_1x20x27x13", stage_data(1, HORIZON, 27, 13, seed=3, invariant=True), True),
        # the wide-input route (relative jitter instead of the pivot clamp) at
        # the width of the frictional multi-object problems
        ("form_a_64x20x27x45", stage_data(64, HORIZON, 27, 45, seed=4), False),
        ("form_b_64x20x27x45", stage_data(64, HORIZON, 27, 45, seed=5, invariant=True), True),
        ("form_b_64x200x27x13", stage_data(64, 200, 27, 13, seed=6, invariant=True), True),
    ]
    kernel_inputs = {}
    max_abs_err = 0.0

    def compare(name, K, kff, K_ref, kff_ref, tol, relative):
        check(bool(torch.isfinite(K).all() and torch.isfinite(kff).all()), f"{name}: finite")
        scale = max(1.0, float(K_ref.abs().max())) if relative else 1.0
        err_K = float((K.double() - K_ref).abs().max()) / scale
        err_k = float((kff.double() - kff_ref).abs().max()) / scale
        log(f"  {name}: max|K - K_plain| = {err_K:.3e} (|K|max {float(K_ref.abs().max()):.3g}), "
            f"max|kff - kff_plain| = {err_k:.3e}")
        check(max(err_K, err_k) <= tol,
              f"{name}: within {tol} {'of the largest entry' if relative else 'absolute'}")
        results[f"kernel_err_{name}"] = max(err_K, err_k)
        return max(err_K, err_k)

    for name, arrays, invariant in cases:
        f32 = tuple(torch.as_tensor(a, dtype=torch.float32, device=dev) for a in arrays)
        f64 = tuple(t.double() for t in f32)
        K_ref, kff_ref = riccati.riccati_backward_plain(*f64, reg=reg)
        K, kff = riccati.riccati_backward(*f32, reg=reg)
        K64, kff64 = riccati.riccati_backward(*f64, reg=reg)
        torch.cuda.synchronize()
        check(K.dtype == torch.float32 and K64.dtype == torch.float64, f"{name}: output dtypes")
        max_abs_err = max(max_abs_err,
                          compare(name, K, kff, K_ref, kff_ref, KERNEL_ATOL, relative=False))
        compare(name + "_f64", K64, kff64, K_ref, kff_ref, KERNEL_RTOL_F64, relative=True)
        if f32[-1].shape[-1] == 27 and f32[1].shape[-1] == 13:
            # the runtime-sized float32 instance at a shape that has its own
            K_rt, kff_rt = riccati._riccati_backward_cuda(*f32, reg, runtime_sized=True)
            max_abs_err = max(max_abs_err, compare(name + "_runtime_sized", K_rt, kff_rt,
                                                   K_ref, kff_ref, KERNEL_ATOL, relative=False))
        kernel_inputs[name] = f32

    # the jitter fallback, per instance and per stage: where the first
    # factorisation fails the second is taken, where both fail K and kff are
    # NaN from that stage back; the pattern must be the plain version's
    fb = tuple(torch.as_tensor(a, dtype=torch.float64, device=dev) for a in fallback_batch())
    K_ref, kff_ref = riccati.riccati_backward_plain(*fb, reg=0.0)
    nan_ref = torch.isnan(K_ref).any(-1).any(-1)  # (Bt, N)
    expect = torch.zeros_like(nan_ref)
    expect[1, 0] = expect[3, 0] = expect[4, 0] = expect[4, 1] = True
    check(bool((nan_ref == expect).all()),
          "fallback batch, plain version: instance 4 is NaN from stage 1 back; instances 1 and 3 "
          "take the second factorisation at stage 1 and fail both at stage 0; the rest is finite")
    for dtype, tol, relative in ((torch.float64, KERNEL_RTOL_F64, True),
                                 (torch.float32, KERNEL_ATOL, True)):
        K, kff = riccati.riccati_backward(*(t.to(dtype) for t in fb), reg=0.0)
        torch.cuda.synchronize()
        same = bool((torch.isnan(K) == torch.isnan(K_ref)).all()
                    and (torch.isnan(kff) == torch.isnan(kff_ref)).all())
        check(same, f"fallback batch, {dtype}: NaN exactly where the plain version has NaN")
        ok = ~torch.isnan(K_ref)
        scale = float(K_ref[ok].abs().max())
        err = max(float((K.double() - K_ref)[ok].abs().max()),
                  float((kff.double() - kff_ref)[~torch.isnan(kff_ref)].abs().max())) / scale
        log(f"  fallback batch, {dtype}: max err / largest entry = {err:.3e} (|K|max {scale:.3g})")
        check(err <= tol, f"fallback batch, {dtype}: finite entries within {tol} of the largest")
        results[f"kernel_err_fallback_{str(dtype).split('.')[-1]}"] = err

    # the wrapper has no fallback: what the kernel does not take raises
    small = kernel_inputs["form_a_8x6x5x3"]
    for label, bad in (
        ("mixed float32 / float64", small[:4] + (small[4].double(),) + small[5:]),
        ("bfloat16", tuple(t.bfloat16() for t in small)),
    ):
        try:
            riccati.riccati_backward(*bad, reg=reg)
        except TypeError:
            log(f"  ok: {label} CUDA tensors raise (no quiet fallback to the plain version)")
        else:
            raise AssertionError(f"riccati_backward accepted {label} CUDA tensors")

    # -- 4. batched main path ----------------------------------------------
    log(f"== 4. batched solve: thing_demo, N = {HORIZON}, batch {BATCH}")
    path = cfg.resolve_package_path({"package": "configs", "path": "demos/thing_demo.yaml"})
    config = cfg.load_config(path)
    prob = build_problem(config)  # device="cuda", float32: the defaults
    ocp = prob.ocp
    check((ocp.N, ocp.nx, ocp.nu, ocp.n_eq, ocp.n_ineq, ocp.n_feq)
          == (HORIZON, 27, 13, 6, 80, 21), "thing_demo at full width: N=20 nx=27 nu=13")
    al_cfg = ALConfig(iterations=1, rho_eq=10.0, rho_ineq=10.0,
                      line_search_steps=(1.0, 0.5))
    batched_solve = batch_solve_fn(ocp, al_cfg)

    rng = np.random.default_rng(0)
    x0_np = prob.x0.cpu().numpy()[None, :] + 0.01 * rng.standard_normal((BATCH, ocp.nx))
    x0s = torch.as_tensor(x0_np, dtype=torch.float32, device=dev)
    params = broadcast_params(prob.stage_params(0.0), BATCH)
    cold = batch_warm_starts(ocp, x0s)

    # comparison only (before the counted run): the same cold solve with the
    # plain backward pass passed in explicitly
    sol_plain = solve(ocp, al_cfg, params, x0s, cold,
                      backward=riccati.riccati_backward_plain)
    torch.cuda.synchronize()

    riccati.launch_count = 0
    sol = batched_solve(params, x0s, cold)
    torch.cuda.synchronize()

    def rel_err(a, b):
        return float((a - b).abs().max() / max(1.0, float(b.abs().max())))

    # Tolerance: both solves are float32 end to end and differ only in the
    # backward pass's rounding.  Errors are taken relative to the largest
    # entry (K reaches O(100)).  K comes straight out of the backward pass:
    # 1e-3 (about 2e-5 on an H100).  X and U pass through a closed-loop
    # rollout with those gains, which amplifies the difference: 5e-3 (up to
    # 8e-4 on an H100, on the warm solve).
    K_RTOL, SOLVE_RTOL = 1e-3, 5e-3
    for field, a, b in (
        ("X", sol.state.X, sol_plain.state.X),
        ("U", sol.state.U, sol_plain.state.U),
        ("K", sol.K, sol_plain.K),
    ):
        e = rel_err(a, b)
        log(f"  cold solve, kernel vs plain backward: {field} max err / scale = {e:.3e}")
        tol = K_RTOL if field == "K" else SOLVE_RTOL
        check(e <= tol, f"cold solve {field} agrees within {tol}")
        results[f"cold_solve_err_{field}"] = e

    for _ in range(WARM_RESOLVES):
        sol = batched_solve(params, x0s, sol.state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_RESOLVES):
        prev_state = sol.state
        sol = batched_solve(params, x0s, sol.state)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches_batched = riccati.launch_count
    solves_per_s = BATCH * TIMED_RESOLVES / elapsed
    log(f"  {TIMED_RESOLVES} warm re-solves of batch {BATCH}: {elapsed * 1e3 / TIMED_RESOLVES:.2f} ms"
        f" per call, {solves_per_s:.1f} solves/s")
    results.update(solves_per_s=solves_per_s, batched_call_ms=elapsed * 1e3 / TIMED_RESOLVES)

    n_calls = 1 + WARM_RESOLVES + TIMED_RESOLVES
    check(launches_batched == n_calls * al_cfg.iterations,
          f"the Riccati kernel was launched once per SQP iteration per call ({launches_batched})")
    for name, t in (("X", sol.state.X), ("U", sol.state.U), ("lam", sol.state.lam),
                    ("mu", sol.state.mu), ("lam_f", sol.state.lam_f), ("K", sol.K),
                    ("cost", sol.cost)):
        check(bool(torch.isfinite(t).all()), f"{name} finite on the card")
    check(sol.state.X.shape == (BATCH, HORIZON + 1, 27) and sol.K.shape == (BATCH, HORIZON, 13, 27),
          "output shapes")
    # eq_viol: this problem keeps a residual the frictionless forces cannot
    # cancel at the pinned, perturbed stage 0, so the warm solves settle near
    # 0.1 (the float64 CPU solve too); 0.5 catches a diverging solve.
    EQ_VIOL_BOUND = 0.5
    eq_max = float(sol.eq_viol.max())
    log(f"  after the warm solves: eq_viol max {eq_max:.4f}, median {float(sol.eq_viol.median()):.4f},"
        f" ineq_viol max {float(sol.ineq_viol.max()):.2e}, defect max {float(sol.defect.max()):.2e}")
    check(eq_max < EQ_VIOL_BOUND, f"eq_viol after the warm solves under {EQ_VIOL_BOUND}")
    results["eq_viol_max"] = eq_max

    # comparison only: the last warm solve again with the plain backward.  K
    # comes straight out of the backward pass; X, U also depend on the line
    # search's accept/reject, which float32 merits near convergence can flip,
    # so they are compared on the instances whose decisions agree.
    sol_plain_w = solve(ocp, al_cfg, params, x0s, prev_state,
                        backward=riccati.riccati_backward_plain)
    torch.cuda.synchronize()
    e = rel_err(sol.K, sol_plain_w.K)
    log(f"  warm solve, kernel vs plain backward: K max err / scale = {e:.3e}")
    check(e <= K_RTOL, f"warm solve K agrees within {K_RTOL}")
    same = (sol.defect == 0) == (sol_plain_w.defect == 0)
    check(float(same.float().mean()) >= 0.99, "accept/reject agrees on >= 99% of instances")
    e = rel_err(sol.state.X[same], sol_plain_w.state.X[same])
    log(f"  warm solve X max err / scale = {e:.3e} on {int(same.sum())} instances")
    check(e <= SOLVE_RTOL, f"warm solve X agrees within {SOLVE_RTOL}")
    results["warm_solve_err_K"] = rel_err(sol.K, sol_plain_w.K)

    # -- 5. steady replan ----------------------------------------------------
    log("== 5. steady replan, one instance")
    params1 = broadcast_params(prob.stage_params(0.0), 1)
    state = SolverState(**{f: getattr(sol.state, f)[:1].clone()
                           for f in ("X", "U", "lam", "mu", "lam_f")})
    x_head = state.X[0, 0].cpu().numpy()
    obs_np = x_head[None, :] + 1e-3 * rng.standard_normal((REPLAN_TICKS, ocp.nx))
    obs = torch.as_tensor(obs_np, dtype=torch.float32, device=dev)
    nq = prob.dims.robot_q
    u_lb, u_ub = ocp.u_lb[:nq].cpu(), ocp.u_ub[:nq].cpu()

    riccati.launch_count = 0
    tick_ms = []
    for i in range(REPLAN_TICKS):
        x = obs[i : i + 1]
        t0 = time.perf_counter()
        warm = prob.heal_warm_start(prob.shift_warm_start(state, 0.0), x)
        s = solve(ocp, al_cfg, params1, x, warm)
        u = s.state.U[:, 0] + (s.K[:, 0] @ (x - s.state.X[:, 0]).unsqueeze(-1)).squeeze(-1)
        u_host = u.cpu()  # the command goes back to the host: synchronises
        tick_ms.append((time.perf_counter() - t0) * 1e3)
        state = s.state
        if not bool(torch.isfinite(u_host).all()):
            raise AssertionError(f"replan tick {i}: non-finite input")
        if not bool(((u_host[0, :nq] >= u_lb) & (u_host[0, :nq] <= u_ub)).all()):
            raise AssertionError(f"replan tick {i}: robot input outside its limits")
    launches_replan = riccati.launch_count
    replan_ms = statistics.median(tick_ms[REPLAN_WARMUP:])
    log(f"  {REPLAN_TICKS} ticks: median {replan_ms:.2f} ms per replan "
        f"(max {max(tick_ms[REPLAN_WARMUP:]):.2f}); inputs finite and inside the robot's limits")
    check(launches_replan == REPLAN_TICKS * al_cfg.iterations,
          f"the Riccati kernel was launched once per replan ({launches_replan})")
    results.update(replan_ms=replan_ms)

    # -- 6. kernel times at the main-path shapes -------------------------------
    log("== 6. kernel times (CUDA events, median of 50): one eager call of the wrapper, "
        "and per launch of 20 captured back to back in a CUDA graph")
    inp_b = kernel_inputs["form_b_512x20x27x13"]
    inp_a = kernel_inputs["form_a_512x20x27x13"]
    inp_1 = kernel_inputs["form_b_1x20x27x13"]

    # (label, inputs, runtime-sized instance?, shape for the bound, float64?)
    timed = [
        ("form_b_512x20x27x13", inp_b, False, (BATCH, HORIZON, 27, 13, True), False),
        ("form_a_512x20x27x13", inp_a, False, (BATCH, HORIZON, 27, 13, False), False),
        ("form_b_1x20x27x13", inp_1, False, (1, HORIZON, 27, 13, True), False),
        ("form_b_512x20x27x13_runtime_sized", inp_b, True, (BATCH, HORIZON, 27, 13, True), False),
        ("form_b_1x20x27x13_runtime_sized", inp_1, True, (1, HORIZON, 27, 13, True), False),
        ("form_b_512x20x27x13_f64", tuple(t.double() for t in inp_b), False,
         (BATCH, HORIZON, 27, 13, True), True),
        ("form_b_64x20x27x45", kernel_inputs["form_b_64x20x27x45"], False,
         (64, HORIZON, 27, 45, True), False),
        ("form_a_64x20x27x45", kernel_inputs["form_a_64x20x27x45"], False,
         (64, HORIZON, 27, 45, False), False),
        ("form_b_64x200x27x13", kernel_inputs["form_b_64x200x27x13"], False,
         (64, 200, 27, 13, True), False),
    ]
    # "ms" is one eager call of the wrapper between two events on an idle card,
    # as a caller that waits for each result sees it; "ms_per_launch" is the
    # kernel's device time alone
    kernel_times = {}
    for label, inp, runtime_sized, shape, is_f64 in timed:
        nbytes, flops = riccati_work(*shape, elem_bytes=8 if is_f64 else 4)
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        t_ops = flops / (H100_FP64_FLOPS if is_f64 else H100_FP32_FLOPS) * 1e3
        if runtime_sized:
            call = lambda: riccati._riccati_backward_cuda(*inp, reg, runtime_sized=True)  # noqa: E731
        else:
            call = lambda: riccati.riccati_backward(*inp, reg=reg)  # noqa: E731
        t, t_launch = cuda_median_ms(call, reps=50), cuda_launch_ms(call, reps=50)
        kernel_times[label] = {
            "ms": t, "ms_per_launch": t_launch, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops,
        }
        log(f"  {label}: {t:.4f} ms ({t_launch:.4f} per launch); bound {max(t_bytes, t_ops):.4f} ms "
            f"({nbytes / 1e6:.1f} MB -> {t_bytes:.4f} ms, {flops / 1e9:.3f} GFLOP -> {t_ops:.4f} ms)")
    results["kernel_times"] = kernel_times
    # the bound at ur10_demo's widths, which tools/riccati_times.py times
    for Bt in (BATCH, 1):
        nbytes, flops = riccati_work(Bt, HORIZON, 18, 10, True)
        t_bytes, t_ops = nbytes / H100_BYTES_PER_S * 1e3, flops / H100_FP32_FLOPS * 1e3
        log(f"  bound at {Bt}x{HORIZON}x18x10 (form b, float32): {max(t_bytes, t_ops):.6f} ms "
            f"({'bytes' if t_bytes >= t_ops else 'operations'}; {nbytes / 1e6:.2f} MB -> "
            f"{t_bytes:.6f} ms, {flops / 1e9:.4f} GFLOP -> {t_ops:.6f} ms)")
        results[f"riccati_bound_{Bt}x{HORIZON}x18x10"] = max(t_bytes, t_ops)
    plain_ms = cuda_median_ms(
        lambda: riccati.riccati_backward_plain(*inp_b, reg=reg), reps=3, warmup=1)
    inp_c = kernel_inputs["form_b_64x20x27x45"]
    plain_ms_wide = cuda_median_ms(
        lambda: riccati.riccati_backward_plain(*inp_c, reg=reg), reps=3, warmup=1)

    def riccati_library(A, B, d, grads, hess, gf, Hf):
        """The same recursion on torch.linalg's batched Cholesky (a yardstick
        only: unclamped pivots, and nothing in the port calls it)."""
        nx = d.shape[-1]
        Z = torch.cat([A, B], dim=-1)
        eye_u = torch.eye(B.shape[-1], dtype=d.dtype, device=d.device)
        P, p = Hf, gf
        for k in reversed(range(d.shape[1])):
            Pd_p = p + (P @ d[:, k].unsqueeze(-1)).squeeze(-1)
            Q = hess[:, k] + Z.T @ (P @ Z)
            q = grads[:, k] + Pd_p @ Z
            Qux = Q[:, nx:, :nx]
            L = torch.linalg.cholesky(Q[:, nx:, nx:] + reg * eye_u)
            sol_ = -torch.cholesky_solve(torch.cat([Qux, q[:, nx:, None]], dim=-1), L)
            K_k, kff_k = sol_[..., :nx], sol_[..., nx]
            P = Q[:, :nx, :nx] + Qux.transpose(-1, -2) @ K_k
            P = 0.5 * (P + P.transpose(-1, -2))
            p = q[:, :nx] + (Qux.transpose(-1, -2) @ kff_k.unsqueeze(-1)).squeeze(-1)
        return K_k, kff_k

    library_ms = cuda_median_ms(lambda: riccati_library(*inp_b), reps=5, warmup=1)

    # -- 7. the plant's contact kernel vs its plain version -----------------------
    log("== 7. plant kernel P1 vs its plain version on the card, one control tick")
    # Inputs: tools/plant_data.py, made on the CPU in float64 from numpy seeds:
    # the objects settled on a tray that starts to move, nudged, mass and mu
    # within +-20% and the CoM within +-5 mm per instance and object.
    # Tolerances.  float64 kernel against the float64 plain version: 1e-10
    # absolute on r, q, v, w and the anchors, and identical contact and latch
    # flags: both sides are float64 and differ in summation order, fused
    # multiply-adds and the 3 x 3 solve (Cramer's rule against LU), 1e-14 on
    # the emulated kernel.  float32 kernel against the witness, the plain
    # version in float32 on the same float32 inputs: tools/plant_data.py
    # F32_TOL, which the control (the witness with the inertia 10% off) must
    # exceed in every field.  The float32 results' distance from float64 is
    # printed beside, for the kernel and for the witness.
    PLANT_TOL_F64 = 1e-10
    PLANT_TOL_F32 = F32_TOL
    plant_cases = [
        ("thing_b1", ("thing_demo", None, None), 1, ()),
        ("thing_b64", ("thing_demo", None, None), 64, ()),
        ("stacked_b8", ("ur10_demo", "box_arch", None), 8, ()),
        ("cups_b2", ("ur10_demo", "blue_cups", None), 2, ()),
        ("regularized_b8", ("thing_demo", None, "regularized"), 8, ()),
        ("latch_b4", ("thing_demo", None, None), 4, (0, 2)),
    ]
    def fmt(err):
        return ", ".join(f"{k} {v:.2e}" for k, v in err.items())

    plant_err32, plant_err64 = 0.0, 0.0
    plant_inputs, plant_sims, plant_readings = {}, {}, []
    for label, (demo, arrangement, friction), B, diverge in plant_cases:
        sim_cpu = plant_for(demo, arrangement, friction)
        frames, objects, params = tick_inputs(sim_cpu, B, seed=B, diverge=diverge)
        tables64 = sim_cpu.tables.to(device=dev)
        tables32 = tables64.to(dtype=torch.float32)
        consts = sim_cpu.contact

        def on_card(dtype):
            return (frames.to(dev, dtype), objects_to(objects, dev, dtype),
                    {k: v.to(dev, dtype) for k, v in params.items()})

        ref = contact.advance_objects_plain(tables64, consts, *on_card(torch.float64))
        witness, control = float32_witness(tables64, consts, *on_card(torch.float64))
        out64 = contact.advance_objects(tables64, consts, *on_card(torch.float64))
        out32 = contact.advance_objects(tables32, consts, *on_card(torch.float32))
        torch.cuda.synchronize()
        err64, same64 = max_errors(out64, ref)
        err32, same32 = max_errors(out32, witness)
        err_ctl, _ = max_errors(control, witness)
        off64 = {"kernel": max_errors(out32, ref)[0], "witness": max_errors(witness, ref)[0]}
        log(f"  {label} ({demo}{'/' + arrangement if arrangement else ''}, "
            f"{sim_cpu.friction_model}, {sim_cpu.tables.n_slots} slots x batch {B}):\n"
            f"    float64 kernel vs plain: {fmt(err64)}\n"
            f"    float32 kernel vs witness: {fmt(err32)}; flags "
            f"{'identical' if same32 else 'differ'}\n"
            f"    control (inertia x1.1) vs witness: {fmt(err_ctl)}\n"
            f"    float32 vs float64 plain: kernel {fmt(off64['kernel'])}; "
            f"witness {fmt(off64['witness'])}")
        plant_readings.append((label, ref, out32, diverge, err64, same64, err32, err_ctl))
        plant_err64 = max(plant_err64, max(err64.values()))
        plant_err32 = max(plant_err32, max(err32.values()))
        results[f"plant_err_{label}"] = {"float64": err64, "float32_vs_witness": err32,
                                         "control_vs_witness": err_ctl,
                                         "float32_vs_float64": off64}
        plant_inputs[label] = (frames, objects, params)
        plant_sims[label] = sim_cpu
    # every reading is printed before the first check
    for label, ref, out32, diverge, err64, same64, err32, err_ctl in plant_readings:
        check(same64 and max(err64.values()) <= PLANT_TOL_F64,
              f"{label}: float64 within {PLANT_TOL_F64}, contact and latch flags identical")
        check(all(err32[k] <= tol for k, tol in PLANT_TOL_F32.items() if k in err32),
              f"{label}: float32 kernel within {PLANT_TOL_F32} of the witness")
        check(all(err_ctl[k] > tol for k, tol in PLANT_TOL_F32.items() if k in err_ctl),
              f"{label}: the control exceeds every float32 limit")
        check(bool(torch.isfinite(out32.r).all() and torch.isfinite(out32.v).all()),
              f"{label}: float32 state finite")
        if ref.anchor_valid is not None:
            check(bool(ref.anchor_valid.any()), f"{label}: objects in contact after the tick")
        latched = torch.nonzero(ref.diverged.any(-1)).flatten().tolist()
        check(latched == list(diverge) and bool((out32.diverged == ref.diverged).all()),
              f"{label}: latched instances {latched} (float32 and float64 alike)")

    # -- 8. the closed loop ----------------------------------------------------------
    LOOP_TICKS, HOST_TICKS, RATE = 150, 10, 100.0
    log(f"== 8. closed loop on the card: thing_demo, {RATE:.0f} Hz, {LOOP_TICKS} ticks")
    settings = MPCSettings.from_config(config["controller"])
    loop_cfg = settings.al_config()
    sim_l = UprightSimulation(config["simulation"])  # card, float32: the defaults
    check(sim_l.object_substeps == 40 and sim_l.tables.n_slots == 16
          and sim_l.friction_model == "stiction",
          "plant: stiction, 40 substeps per 1 ms step, 16 contact slots")
    init_carry, run = build_device_loop(prob, sim_l, al_cfg=loop_cfg, ctrl_rate=RATE)
    t0 = time.perf_counter()
    carry0 = init_carry()  # the 12-iteration cold solve
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0

    riccati.launch_count = 0
    contact.launch_count = 0
    t0 = time.perf_counter()
    carry, metrics = run(carry0, LOOP_TICKS)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    launches_loop_k1, launches_loop_p1 = riccati.launch_count, contact.launch_count
    check(launches_loop_k1 == LOOP_TICKS * loop_cfg.iterations,
          f"the Riccati kernel was launched once per tick ({launches_loop_k1})")
    check(launches_loop_p1 == LOOP_TICKS,
          f"the plant kernel was launched once per tick ({launches_loop_p1})")
    cost, eq_l, r_ew = metrics.cost.cpu(), metrics.eq_viol.cpu(), metrics.r_ew_w.cpu()
    check(bool(torch.isfinite(cost).all() and torch.isfinite(eq_l).all()
               and torch.isfinite(r_ew).all()), "costs, eq_viol and EE positions finite")
    disp = sim_l.object_displacements(carry.sim)[0]
    target_r = prob.target.poses[0, :3].cpu()
    ee_err = [float(torch.linalg.vector_norm(r_ew[i] - target_r)) for i in (0, -1)]
    log(f"  {LOOP_TICKS} ticks in {loop_s:.2f} s ({loop_s * 1e3 / LOOP_TICKS:.2f} ms per tick; "
        f"cold solve {cold_s:.2f} s); EE error to the first waypoint {ee_err[0]:.4f} -> "
        f"{ee_err[1]:.4f} m; final eq_viol {float(eq_l[-1]):.2e}; bottle displacement "
        f"{float(disp.max()):.2e} m")
    check(bool(np.isfinite(disp).all() and (disp < 0.03).all()),
          "the bottle stays within 0.03 m of its place on the tray")
    results.update(loop_ticks=LOOP_TICKS, loop_s=loop_s, cold_solve_s=cold_s,
                   loop_ee_err=ee_err, loop_eq_viol_final=float(eq_l[-1]),
                   loop_bottle_displacement=float(disp.max()))

    # the host loop (ControllerManager + UprightSimulation, as mpc_sim runs it)
    # against the device loop from the same cold solve.  Tolerances: the host
    # loop carries the acceleration belief and the command in float64 numpy and
    # hands the solver float32, the device loop stays float32 throughout; on
    # the CPU in float32 the two differ after 10 ticks by 7e-12 in q, 1e-7 in
    # the acceleration belief, 3e-6 in X (|X| 1.6) and 0 in the bottle's
    # position, and the tolerances leave a margin of 30 or more
    ctrl = ControllerManager(prob, settings)
    sim_h = UprightSimulation(config["simulation"])
    state_h = sim_h.initial_state()
    nq = sim_h.robot.nq
    a_h = np.zeros(nq)
    dt_ctrl = 1.0 / RATE
    ctrl.warmstart(0.0, np.concatenate([state_h.q[0].cpu().numpy(),
                                        state_h.v[0].cpu().numpy(), a_h]))
    carry_d, _ = run(init_carry(t0=dt_ctrl, solver_state=ctrl.state), HOST_TICKS)
    t = dt_ctrl
    for _ in range(HOST_TICKS):
        q_m, v_m = sim_h.measure(state_h)
        v_np = v_m[0].cpu().numpy()
        x = np.concatenate([q_m[0].cpu().numpy(), v_np, a_h])
        _xd, u = ctrl.step(t, x)
        v_cmd = v_np + dt_ctrl * a_h + 0.5 * dt_ctrl**2 * u[:nq]
        a_h = a_h + dt_ctrl * u[:nq]
        state_h = sim_h.step(state_h, torch.as_tensor(v_cmd), n_steps=10)
        t += dt_ctrl
    torch.cuda.synchronize()
    HOST_TOL = {"q": 1e-6, "a_state": 1e-4, "X": 1e-4, "bottle r": 1e-6}
    host_err = {
        "q": float((carry_d.sim.q - state_h.q).abs().max()),
        "a_state": float((carry_d.a_state[0].cpu().double() - torch.as_tensor(a_h)).abs().max()),
        "X": float((carry_d.solver.X - ctrl.state.X).abs().max()),
        "bottle r": float((carry_d.sim.objects.r - state_h.objects.r).abs().max()),
    }
    log("  host loop vs device loop after 10 ticks: "
        + ", ".join(f"{k} {v:.2e}" for k, v in host_err.items()))
    check(all(host_err[k] <= tol for k, tol in HOST_TOL.items()),
          f"host loop and device loop agree within {HOST_TOL}")
    results["host_vs_device_loop"] = host_err

    # -- 9. times: P1 and the closed loop's tick ---------------------------------
    log("== 9. plant kernel times (CUDA events, median) and the closed loop's host time per tick")
    tables32 = sim_l.tables

    def plant_in(label, repeat=1, n=None):
        frames, objects, params = plant_inputs[label]
        if n is not None:  # the first n instances
            frames, params = frames[:n], {k: v[:n] for k, v in params.items()}
            objects = objects.replace(**{k: getattr(objects, k)[:n] for k in (
                "r", "q", "v", "w", "anchors", "anchor_valid", "diverged")
                if getattr(objects, k) is not None})
        f32 = objects_to(objects, dev, torch.float32)
        if repeat > 1:
            f32 = f32.replace(**{k: getattr(f32, k).repeat((repeat,) + (1,) * (getattr(f32, k).ndim - 1))
                                 for k in ("r", "q", "v", "w", "anchors", "anchor_valid", "diverged")})
        return (frames.to(dev, torch.float32).repeat(repeat, 1, 1), f32,
                {k: v.to(dev, torch.float32).repeat((repeat,) + (1,) * (v.ndim - 1))
                 for k, v in params.items()})

    plant_times = {}
    cups, arch = plant_sims["cups_b2"], plant_sims["stacked_b8"]
    for name, inp, tables_, consts_ in (
        ("batch1", plant_in("thing_b1"), tables32, sim_l.contact),
        ("batch512", plant_in("thing_b64", 8), tables32, sim_l.contact),
        ("box_arch_batch1", plant_in("stacked_b8", n=1),
         arch.tables.to(device=dev, dtype=torch.float32), arch.contact),
        ("blue_cups_batch1", plant_in("cups_b2", n=1),
         cups.tables.to(device=dev, dtype=torch.float32), cups.contact),
    ):
        B = inp[0].shape[0]
        call = lambda: contact.advance_objects(tables_, consts_, *inp)  # noqa: E731
        nbytes, flops = contact.plant_work(tables_, consts_, B, inp[0].shape[1], 4)
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        t_ops = flops / H100_FP32_FLOPS * 1e3
        t, t_launch = cuda_median_ms(call, reps=20), cuda_launch_ms(call, reps=10, inner=5)
        plant_times[name] = {"ms": t, "ms_per_launch": t_launch, "bound_ms": max(t_bytes, t_ops),
                             "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                             "bytes": nbytes, "flops": flops}
        log(f"  P1 {name}: {t:.4f} ms ({t_launch:.4f} per launch); bound {max(t_bytes, t_ops):.6f} ms "
            f"({nbytes / 1e3:.1f} kB -> {t_bytes:.6f} ms, {flops / 1e6:.2f} MFLOP -> {t_ops:.6f} ms)")
    inp1 = plant_in("thing_b1")
    plant_plain_ms = cuda_median_ms(
        lambda: contact.advance_objects_plain(tables32, sim_l.contact, *inp1), reps=1, warmup=0)
    log(f"  P1 plain version, one tick at batch 1: {plant_plain_ms:.1f} ms")

    # host time per tick of the closed loop (between synchronisations, median
    # of 20): one tick of the device loop, and the plant's step alone
    def host_ms(fn, reps=20):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    tick_ms = host_ms(lambda: run(carry, 1))
    plant_step_ms = host_ms(lambda: sim_l.step(carry.sim, carry.sim.v, n_steps=10))
    log(f"  closed loop, host ms per tick: {tick_ms:.2f} = replan {tick_ms - plant_step_ms:.2f} "
        f"+ plant {plant_step_ms:.2f} (of which P1 {plant_times['batch1']['ms']:.3f})")
    results.update(plant_times=plant_times, plant_plain_ms=plant_plain_ms, loop_tick_ms=tick_ms,
                   loop_plant_ms=plant_step_ms, loop_replan_ms=tick_ms - plant_step_ms)

    # -- optional: where one solve's time goes ---------------------------------
    def phase_breakdown(label, p, x0, st):
        """Host time of each phase of one SQP iteration between
        synchronisations (median of 5), then a profiler trace of 3 solves."""

        def timed(fn, reps=5):
            out = fn()
            times = []
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            return out, statistics.median(times)

        ps, pf = p["stage"], p["final"]
        X = torch.cat([x0.unsqueeze(1), st.X[:, 1:]], dim=1)
        x, u = X[:, :-1], st.U
        p00 = {k: v[0, 0] for k, v in ps.items()}
        alphas = torch.as_tensor(al_cfg.line_search_steps, dtype=X.dtype, device=dev)
        rows = {}

        def lin():
            A = torch.func.jacfwd(ocp.dynamics, argnums=0)(X[0, 0], u[0, 0], p00)
            Bm = torch.func.jacfwd(ocp.dynamics, argnums=1)(X[0, 0], u[0, 0], p00)
            return A, Bm, ocp.dynamics(x, u, ps) - X[:, 1:]

        (A, Bm, d), rows["dynamics linearization + defects"] = timed(lin)
        (grads, hess), rows["stage derivatives"] = timed(
            lambda: al._stage_derivatives(ocp, al_cfg, x, u, ps, st.lam, st.mu))
        (gf, Hf), rows["final derivatives"] = timed(
            lambda: al._final_derivatives(ocp, al_cfg, X[:, -1], pf, st.lam_f))
        args_k = tuple(t.contiguous() for t in (A, Bm, d, grads, hess, gf, Hf))
        (K, kff), rows["riccati kernel (launch + wait)"] = timed(
            lambda: riccati.riccati_backward(*args_k, reg=al_cfg.reg))
        _, rows["rollouts + merits of the candidates"] = timed(
            lambda: al._rollout_merit(ocp, al_cfg, X, u, K, kff, alphas, x0, ps, pf,
                                      st.lam, st.mu, st.lam_f))
        _, rows["merit of the incoming trajectory"] = timed(
            lambda: al._merit_terms(ocp, al_cfg, X, u, ps, pf, st.lam, st.mu, st.lam_f))
        _, whole = timed(lambda: solve(ocp, al_cfg, p, x0, st))
        rows["select + dual update + diagnostics (remainder)"] = whole - sum(rows.values())
        log(f"  [{label}] one solve: {whole:.2f} ms")
        for name, ms_ in rows.items():
            log(f"    {name}: {ms_:.2f} ms ({100 * ms_ / whole:.1f}%)")

        from torch.profiler import ProfilerActivity, profile

        n_prof = 3
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n_prof):
                solve(ocp, al_cfg, p, x0, st)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        dev_us, n_kernels = 0.0, 0
        for evt in prof.key_averages():
            if "cuda" in str(getattr(evt, "device_type", "")).lower():
                dev_us += getattr(evt, "self_device_time_total",
                                  getattr(evt, "self_cuda_time_total", 0.0))
                n_kernels += evt.count
        out = {"solve_ms": whole, "phases_ms": rows, "traced_wall_ms_per_solve": wall_ms / n_prof}
        if dev_us > 0:
            busy = dev_us / 1e3 / wall_ms
            log(f"    traced: {wall_ms / n_prof:.2f} ms per solve with the profiler on, device busy "
                f"{dev_us / 1e3 / n_prof:.2f} ms per solve ({100 * busy:.1f}% busy, "
                f"{100 * (1 - busy):.1f}% idle), {n_kernels / n_prof:.0f} device kernels per solve")
            out.update(device_busy_ms_per_solve=dev_us / 1e3 / n_prof, device_busy_share=busy,
                       device_kernels_per_solve=n_kernels / n_prof)
        else:
            log("    traced: the profiler showed no device time; busy share not measured")
        return out

    if args.breakdown:
        log("== 10. breakdown of one solve (optional)")
        results["breakdown_batch512"] = phase_breakdown(
            f"batch {BATCH}", params, x0s, prev_state)
        results["breakdown_batch1"] = phase_breakdown(
            "batch 1", params1, obs[-1:].clone(), state)

    def t_ms(label, key="ms"):
        return round(kernel_times[label][key], 6)

    main = kernel_times["form_b_512x20x27x13"]
    log(f"  plain version: {plain_ms:.2f} ms ({plain_ms_wide:.2f} ms at 64x20x27x45); "
        f"torch.linalg loop: {library_ms:.2f} ms")
    kernels = {
        "kernels": [
            {
                "name": "riccati_backward",
                "route": "cuda",
                "source": "upright_tpu_torch/csrc/riccati.cu",
                "replaces": "upright_tpu/solver/pallas_riccati.py:186",
                "launches": launches_batched + launches_replan,
                "max_abs_err": max_abs_err,
                "ms": t_ms("form_b_512x20x27x13"),
                "plain_ms": plain_ms,
                "bound_ms": main["bound_ms"],
                "bound_by": main["bound_by"],
                "library_ms": library_ms,
                "shape": "form (b), batch 512, N 20, nx 27, nu 13, float32",
                "ms_form_a": t_ms("form_a_512x20x27x13"),
                "ms_batch1": t_ms("form_b_1x20x27x13"),
                "ms_runtime_sized": t_ms("form_b_512x20x27x13_runtime_sized"),
                "ms_runtime_sized_batch1": t_ms("form_b_1x20x27x13_runtime_sized"),
                "ms_float64": t_ms("form_b_512x20x27x13_f64"),
                "ms_wide_64x20x27x45": t_ms("form_b_64x20x27x45"),
                "ms_long_64x200x27x13": t_ms("form_b_64x200x27x13"),
                "plain_ms_wide_64x20x27x45": plain_ms_wide,
                # the kernel's device time alone, for each of the ms keys above
                "ms_per_launch": {name: t_ms(label, "ms_per_launch") for name, label in (
                    ("batch512", "form_b_512x20x27x13"), ("form_a", "form_a_512x20x27x13"),
                    ("batch1", "form_b_1x20x27x13"),
                    ("runtime_sized", "form_b_512x20x27x13_runtime_sized"),
                    ("runtime_sized_batch1", "form_b_1x20x27x13_runtime_sized"),
                    ("float64", "form_b_512x20x27x13_f64"),
                    ("wide_64x20x27x45", "form_b_64x20x27x45"),
                    ("long_64x200x27x13", "form_b_64x200x27x13"))},
                "launches_batched_path": launches_batched,
                "launches_replan_path": launches_replan,
                "launches_closed_loop": launches_loop_k1,
                "launches_per_solve": al_cfg.iterations,
            },
            {
                "name": "plant_substeps",
                "route": "cuda",
                "source": "upright_tpu_torch/csrc/plant.cu",
                "replaces": "upright_tpu/sim/simulation.py:324-644 (no Pallas kernel)",
                "launches": launches_loop_p1,
                "max_abs_err": plant_err32,
                "ms": round(plant_times["batch1"]["ms"], 6),
                "plain_ms": plant_plain_ms,
                "bound_ms": plant_times["batch1"]["bound_ms"],
                "bound_by": plant_times["batch1"]["bound_by"],
                "library_ms": None,
                "shape": "thing_demo, one control tick: batch 1, 10 outer steps x 40 substeps, "
                         "16 contact slots, float32",
                "ms_batch512": round(plant_times["batch512"]["ms"], 6),
                "bound_ms_batch512": plant_times["batch512"]["bound_ms"],
                "ms_box_arch_batch1": round(plant_times["box_arch_batch1"]["ms"], 6),
                "ms_blue_cups_batch1": round(plant_times["blue_cups_batch1"]["ms"], 6),
                "ms_per_launch": {k: round(v["ms_per_launch"], 6) for k, v in plant_times.items()},
                "max_abs_err_float64": plant_err64,
                "launches_per_tick": launches_loop_p1 / LOOP_TICKS,
            },
        ]
    }
    results.update(kernels=kernels["kernels"], card=card_line,
                   total_s=time.perf_counter() - t_start)
    if args.out:
        import os

        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)

    log(f"solves_per_s={solves_per_s:.1f} replan_ms={replan_ms:.3f} "
        f"loop_tick_ms={tick_ms:.2f} total_s={time.perf_counter() - t_start:.1f}")
    print(json.dumps(kernels), flush=True)
    print(card_line, flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
