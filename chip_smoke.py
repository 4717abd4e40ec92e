#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py [--out results.json] [--breakdown]

Drives the port's main path through the entry points a user would call and
holds every hand-written kernel against its plain PyTorch version:

  1. the card (name, power limit, torch / CUDA versions);
  2. builds the Riccati kernel from upright_tpu_torch/csrc/ with nvcc;
  3. the kernel against its plain version (float64) at four shape/form cases;
  4. the batched main path: demos/thing_demo.yaml, N = 20, batch 512, one
     warm-started AL-SQP iteration per solve, solves/s over 10 re-solves;
  5. the steady replan at batch 1: shift -> heal -> solve -> policy;
  6. one JSON line describing each kernel (time, bound, launches), then the
     card's name and power limit, then the final JSON line.

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


# ---------------------------------------------------------------------------
# inputs for the kernel comparison (numpy, from a seed)
# ---------------------------------------------------------------------------


def random_batch(Bt, N, nx, nu, seed=0):
    """Random SPD stage data, the conditioning the reference's kernel tests
    use at small shapes (A = I + 0.2 G, unit-scale B)."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((Bt, N, nx, nx)) * 0.2 + np.eye(nx)
    B = rng.standard_normal((Bt, N, nx, nu))
    d = rng.standard_normal((Bt, N, nx)) * 0.05
    grads = rng.standard_normal((Bt, N, nx + nu))
    M = rng.standard_normal((Bt, N, nx + nu, nx + nu))
    hess = 0.1 * np.einsum("bkij,bklj->bkil", M, M) + np.eye(nx + nu)
    gf = rng.standard_normal((Bt, nx))
    Mf = rng.standard_normal((Bt, nx, nx))
    Hf = 0.1 * np.einsum("bij,blj->bil", Mf, Mf) + np.eye(nx)
    return A, B, d, grads, hess, gf, Hf


def mpc_shape_batch(Bt, N, nx, nu, seed=0, invariant=False):
    """Stage data at the main-path widths (A = I + 0.1 G, B = 0.1 G,
    H = M M^T + 3 I); ``invariant`` gives one (A, B) pair for the batch."""
    rng = np.random.default_rng(seed)
    nz = nx + nu
    lead = () if invariant else (Bt, N)
    A = (rng.standard_normal(lead + (nx, nx)) * 0.1 + np.eye(nx)).astype(np.float32)
    B = (rng.standard_normal(lead + (nx, nu)) * 0.1).astype(np.float32)
    d = (rng.standard_normal((Bt, N, nx)) * 0.01).astype(np.float32)
    g = rng.standard_normal((Bt, N, nz)).astype(np.float32)
    Hh = (rng.standard_normal((Bt, N, nz, nz)) * 0.1).astype(np.float32)
    H = Hh @ np.swapaxes(Hh, -1, -2) + 3 * np.eye(nz, dtype=np.float32)
    gf = rng.standard_normal((Bt, nx)).astype(np.float32)
    Hf_ = (rng.standard_normal((Bt, nx, nx)) * 0.1).astype(np.float32)
    Hf = Hf_ @ np.swapaxes(Hf_, -1, -2) + np.eye(nx, dtype=np.float32)
    return A, B, d, g, H, gf, Hf


def riccati_work(Bt, N, nx, nu, invariant):
    """(bytes, flops) the Riccati backward pass needs: each input read once,
    each output written once; the recursion's products, one factorisation
    and one substitution pair per stage."""
    nz = nx + nu
    per_stage_bytes = 4 * (nz * nz + nz + nx + nu * nx + nu)
    if not invariant:
        per_stage_bytes += 4 * nx * nz
    total_bytes = Bt * (N * per_stage_bytes + 4 * (nx * nx + nx))
    if invariant:
        total_bytes += 4 * nx * nz
    per_stage_flops = (
        2 * nx * nx * nz  # P Z
        + 2 * nz * nz * nx  # Z^T (P Z)
        + 2 * nx * nx + 2 * nz * nx  # P d, Z^T (p + P d)
        + nu**3 // 3  # Cholesky of Quu
        + 2 * nu * nu * (nx + 1)  # forward and back substitution of [Qux | Qu]
        + 2 * nx * nx * nu + 2 * nx * nu  # Qux^T K, Qux^T kff
    )
    return total_bytes, Bt * N * per_stage_flops


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
    from upright_tpu_torch.solver import al, riccati
    from upright_tpu_torch.solver.al import ALConfig, solve
    from upright_tpu_torch.solver.ocp import SolverState

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

    # -- 2. build the kernel ------------------------------------------------
    log("== 2. build")
    t0 = time.perf_counter()
    _build.load_library("riccati", extra_flags=("-Xptxas", "-v"), verbose=True)
    riccati._library()
    build_s = time.perf_counter() - t0
    log(f"built csrc/riccati.cu in {build_s:.1f} s (set-up)")
    results["build_s"] = build_s

    # -- 3. kernel vs plain version ------------------------------------------
    log("== 3. Riccati kernel vs its plain version (float64) on the card")
    reg = 1e-6
    # Tolerance: 1e-4 absolute on K and kff (both O(1) here).  The float32
    # recursion rounds differently from float64 over the N dependent stages;
    # on an H100 the largest difference over the four cases is 5e-6, so 1e-4
    # leaves a margin of 20 and is 50 times tighter than the 5e-3 the
    # reference holds its own float32 kernel to on the random_batch data.
    KERNEL_ATOL = 1e-4
    cases = [
        ("form_a_8x6x5x3", random_batch(8, 6, 5, 3), False),
        ("form_a_512x20x27x13", mpc_shape_batch(BATCH, HORIZON, 27, 13, seed=1), False),
        ("form_b_512x20x27x13", mpc_shape_batch(BATCH, HORIZON, 27, 13, seed=2, invariant=True), True),
        ("form_b_1x20x27x13", mpc_shape_batch(1, HORIZON, 27, 13, seed=3, invariant=True), True),
    ]
    kernel_inputs = {}
    max_abs_err = 0.0
    for name, arrays, invariant in cases:
        f32 = tuple(torch.as_tensor(a, dtype=torch.float32, device=dev) for a in arrays)
        f64 = tuple(t.double() for t in f32)
        K, kff = riccati.riccati_backward(*f32, reg=reg)
        torch.cuda.synchronize()
        K_ref, kff_ref = riccati.riccati_backward_plain(*f64, reg=reg)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(K).all() and torch.isfinite(kff).all()), f"{name}: finite")
        err_K = float((K.double() - K_ref).abs().max())
        err_k = float((kff.double() - kff_ref).abs().max())
        log(f"  {name}: max|K - K_plain| = {err_K:.3e} (|K|max {float(K_ref.abs().max()):.3g}), "
            f"max|kff - kff_plain| = {err_k:.3e}")
        check(max(err_K, err_k) <= KERNEL_ATOL, f"{name}: within {KERNEL_ATOL} absolute")
        max_abs_err = max(max_abs_err, err_K, err_k)
        kernel_inputs[name] = f32
        results[f"kernel_err_{name}"] = max(err_K, err_k)

    # the wrapper has no fallback: what the kernel does not take raises
    bad = tuple(t.double() for t in kernel_inputs["form_a_8x6x5x3"])
    try:
        riccati.riccati_backward(*bad, reg=reg)
    except TypeError:
        log("  ok: float64 CUDA tensors raise (no quiet fallback to the plain version)")
    else:
        raise AssertionError("riccati_backward accepted float64 CUDA tensors")

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
    log("== 6. kernel times (CUDA events, median)")
    inp_b = kernel_inputs["form_b_512x20x27x13"]
    inp_a = kernel_inputs["form_a_512x20x27x13"]
    inp_1 = kernel_inputs["form_b_1x20x27x13"]
    ms = cuda_median_ms(lambda: riccati.riccati_backward(*inp_b, reg=reg), reps=50)
    ms_a = cuda_median_ms(lambda: riccati.riccati_backward(*inp_a, reg=reg), reps=50)
    ms_1 = cuda_median_ms(lambda: riccati.riccati_backward(*inp_1, reg=reg), reps=50)
    plain_ms = cuda_median_ms(
        lambda: riccati.riccati_backward_plain(*inp_b, reg=reg), reps=3, warmup=1)

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
        log("== 7. breakdown of one solve (optional)")
        results["breakdown_batch512"] = phase_breakdown(
            f"batch {BATCH}", params, x0s, prev_state)
        results["breakdown_batch1"] = phase_breakdown(
            "batch 1", params1, obs[-1:].clone(), state)

    nbytes, flops = riccati_work(BATCH, HORIZON, 27, 13, invariant=True)
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S * 1e3, flops / H100_FP32_FLOPS * 1e3
    bound_ms = max(t_bytes, t_ops)
    log(f"  riccati_backward form (b) 512x20x27x13: {ms:.4f} ms; form (a): {ms_a:.4f} ms; "
        f"form (b) batch 1: {ms_1:.4f} ms")
    log(f"  plain version: {plain_ms:.2f} ms; torch.linalg loop: {library_ms:.2f} ms")
    log(f"  bound: {nbytes / 1e6:.1f} MB -> {t_bytes:.4f} ms, {flops / 1e9:.2f} GFLOP fp32 -> "
        f"{t_ops:.4f} ms")
    kernels = {
        "kernels": [
            {
                "name": "riccati_backward",
                "route": "cuda",
                "source": "upright_tpu_torch/csrc/riccati.cu",
                "replaces": "upright_tpu/solver/pallas_riccati.py:186",
                "launches": launches_batched + launches_replan,
                "max_abs_err": max_abs_err,
                "ms": ms,
                "plain_ms": plain_ms,
                "bound_ms": bound_ms,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": library_ms,
                "shape": "form (b), batch 512, N 20, nx 27, nu 13, float32",
                "ms_form_a": ms_a,
                "ms_batch1": ms_1,
                "launches_batched_path": launches_batched,
                "launches_replan_path": launches_replan,
                "launches_per_solve": al_cfg.iterations,
            }
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
        f"total_s={time.perf_counter() - t_start:.1f}")
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
