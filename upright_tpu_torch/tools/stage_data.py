"""Inputs for the Riccati backward pass: made with numpy from a seed, or
captured from a solve of a shipped configuration.

The one place the kernel's tests, ``chip_smoke.py`` and the timing tools take
their stage data from, so that a number measured by one can be reproduced by
another.  The generators return float64 numpy; callers cast.
"""

from __future__ import annotations

import numpy as np


def stage_data(Bt, N, nx, nu, seed=0, invariant=False):
    """Stage data at the conditioning of an MPC solve (A = I + 0.1 G,
    B = 0.1 G, H = M M^T + 3 I).  Returns (A, B, d, grads, hess, gf, Hf);
    ``invariant`` gives one unbatched (A, B) pair for the whole batch."""
    rng = np.random.default_rng(seed)
    nz = nx + nu
    lead = () if invariant else (Bt, N)
    A = rng.standard_normal(lead + (nx, nx)) * 0.1 + np.eye(nx)
    B = rng.standard_normal(lead + (nx, nu)) * 0.1
    d = rng.standard_normal((Bt, N, nx)) * 0.01
    g = rng.standard_normal((Bt, N, nz))
    Hh = rng.standard_normal((Bt, N, nz, nz)) * 0.1
    H = Hh @ np.swapaxes(Hh, -1, -2) + 3 * np.eye(nz)
    gf = rng.standard_normal((Bt, nx))
    Hf_ = rng.standard_normal((Bt, nx, nx)) * 0.1
    Hf = Hf_ @ np.swapaxes(Hf_, -1, -2) + np.eye(nx)
    return A, B, d, g, H, gf, Hf


def random_batch(Bt, N, nx, nu, seed=0):
    """Random SPD stage data with unit-scale B (A = I + 0.2 G), the
    conditioning the reference's kernel tests use at small shapes."""
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


def fallback_batch(Bt=6, N=3, nx=6, nu=26, seed=7):
    """A wide-input batch (per-stage dynamics, to be solved with reg = 0) in
    which, at stage 1, B = 0 and luu = diag(1, ..., 1, last): last = -1e-5 in
    instances 1 and 3 fails the first jitter (1e-7 relative) and passes the
    second (1e-3); last = -1 in instance 4 fails both.  Instances 0, 2 and 5
    are ordinary."""
    A, B, d, g, H, gf, Hf = stage_data(Bt, N, nx, nu, seed=seed)
    nz = nx + nu
    for b, last in ((1, -1e-5), (3, -1e-5), (4, -1.0)):
        Hs = np.zeros((nz, nz))
        Hs[:nx, :nx] = 2 * np.eye(nx)
        Hs[nx:, nx:] = np.diag([1.0] * (nu - 1) + [last])
        Hs[nx:, :nx] = 0.1 * np.arange(nu * nx).reshape(nu, nx) / (nu * nx)
        Hs[:nx, nx:] = Hs[nx:, :nx].T
        B[b, 1] = 0.0
        H[b, 1] = Hs
    return A, B, d, g, H, gf, Hf


def capture_stage_data(problem, state, x0=None, config=None):
    """The stage data (A, B, d, grads, hess, gf, Hf) that the solver hands the
    Riccati backward pass in the last iteration of ``config`` (one iteration
    unless given) from the warm start ``state``, as it passes them.  The
    backward pass is the plain version, so that capturing launches no
    kernel.  ``x0``: (B, nx), ``problem.x0`` unless given; the solve runs on
    its device and dtype, with ``problem``'s stage parameters at t = 0.
    """
    from upright_tpu_torch.parallel.batch import broadcast_params
    from upright_tpu_torch.solver.al import ALConfig, solve
    from upright_tpu_torch.solver.riccati import riccati_backward_plain

    x0 = problem.x0[None] if x0 is None else x0
    captured = []

    def capture(*args, **kw):
        captured[:] = [a.clone() for a in args]
        return riccati_backward_plain(*args, **kw)

    solve(problem.ocp, ALConfig(iterations=1) if config is None else config,
          broadcast_params(problem.stage_params(0.0), x0.shape[0]), x0, state,
          device=x0.device, dtype=x0.dtype, backward=capture)
    return tuple(captured)


def solver_stage_data(config_path, batch, N=None, iterations=2, seed=0, device="cuda",
                      dtype=None):
    """The stage data the solver hands the Riccati backward pass, from a cold
    solve of a shipped configuration.

    Builds ``configs/<config_path>`` on ``device`` (float32 unless ``dtype``
    says otherwise; N from the config unless given), perturbs x0 by 0.01 from
    numpy ``seed`` for each of ``batch`` instances and runs ``iterations``
    AL-SQP iterations from the cold start (``capture_stage_data``).  Returns
    the (A, B, d, grads, hess, gf, Hf) of the last iteration.
    """
    import torch

    import upright_tpu_torch.config as cfg
    from upright_tpu_torch.ocp.problem import build_problem
    from upright_tpu_torch.parallel.batch import batch_warm_starts
    from upright_tpu_torch.solver.al import ALConfig

    dtype = torch.float32 if dtype is None else dtype
    path = cfg.resolve_package_path({"package": "configs", "path": config_path})
    prob = build_problem(cfg.load_config(path), N=N, device=device, dtype=dtype)
    rng = np.random.default_rng(seed)
    x0 = prob.x0.cpu().numpy()[None, :] + 0.01 * rng.standard_normal((batch, prob.ocp.nx))
    x0 = torch.as_tensor(x0, dtype=dtype, device=prob.ocp.device)
    return capture_stage_data(
        prob, batch_warm_starts(prob.ocp, x0, device=device, dtype=dtype), x0=x0,
        config=ALConfig(iterations=iterations, rho_eq=10.0, rho_ineq=10.0))


# The ral25 study's robust plan of ``chip_smoke.py`` phase 16: the box height
# (m) and the one waypoint
RAL25_HEIGHT, RAL25_WAYPOINT = 0.20, (-2.0, 1.0, 0.0)


def ral25_plan_config():
    """The config of ``scripts/ral25_study.py`` ``build_study_config`` at
    RAL25_HEIGHT with the one RAL25_WAYPOINT, and the CoM box that
    ``plan_robust`` takes (``com_half_extents``)."""
    from upright_tpu_torch.scripts.ral25_study import COM_XY, build_study_config

    config = build_study_config(RAL25_HEIGHT)
    config["controller"]["waypoints"] = [
        {"time": 0, "position": list(RAL25_WAYPOINT), "orientation": [0, 0, 0, 1]}]
    return config, [[COM_XY, COM_XY, RAL25_HEIGHT / 2]]


# SQP iterations of the ral25 plan before its stage data is captured: on the
# CPU in float32, 5, 20 and 60 give the same data (the plan's line search
# stalls), and there the emulated K1 and the plain version differ by more
# than 2x in float32 (PERF.md, K1-e)
RAL25_ITERATIONS = 5


def ral25_stage_data():
    """The stage data the solver hands the backward pass on the ral25 robust
    plan (``ral25_plan_config``, 10 s: 1x100x27x41, stage-invariant A and
    B), after RAL25_ITERATIONS SQP iterations and one more that captures it.
    Made on the CPU in float32, which makes it deterministic on one machine.
    """
    import torch

    from upright_tpu_torch.robust.planning import plan_robust

    config, box = ral25_plan_config()
    prob, sol, _ = plan_robust(config, com_half_extents=box, duration=10.0,
                               iterations=RAL25_ITERATIONS, device="cpu", dtype=torch.float32)
    return capture_stage_data(prob, sol.state)
