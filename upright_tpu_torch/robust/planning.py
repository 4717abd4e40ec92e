"""Offline robust planning and batched tracking sweeps.

Counterpart of ``upright_tpu/robust/planning.py``, a redesign of the
reference's robust experiment pipeline
(upright_robust/scripts/planning_sim_loop.py):

  1. PLAN once, offline, with a horizon covering the whole motion and the
     balance model replicated over CoM-box vertex scenarios: one OCP that
     must balance every scenario (reference :513-534, :132-134).
  2. TRACK the fixed plan with P-control on position
     (v_cmd = Kp (qd - q) + vd, reference :157-176).
  3. SWEEP true inertial parameters: the reference runs 135 PyBullet runs
     one after another (:613-655), the JAX package vmaps one rollout; here
     the whole sweep is one loop over control ticks for the batch of
     parameter sets, one launch of the plant kernel a tick for all of them.
  4. VERIFY post-hoc with the closed-form worst-case analysis
     (``robust/verification.py``) and, optionally, the density-realizable
     set (``robust/realizable.py``).
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

import upright_tpu_torch.config as cfg_mod
from upright_tpu_torch.ocp.problem import build_problem
from upright_tpu_torch.parallel.batch import broadcast_params
from upright_tpu_torch.robust import modelling as rm
from upright_tpu_torch.robust import verification as rv
from upright_tpu_torch.robust.realizable import RealizableSet, verify_plan_realizable
from upright_tpu_torch.robust.scenarios import stack_vertex_scenarios_in_model
from upright_tpu_torch.robust.synthesis import (
    com_offset_grid,
    max_min_eig_inertia,
    parse_robust_bounds,
)
from upright_tpu_torch.sim.simulation import UprightSimulation
from upright_tpu_torch.solver.al import ALConfig, solve
from upright_tpu_torch.solver.ocp import zeros_warm_start


@dataclasses.dataclass
class OfflinePlan:
    dt: float
    ts: np.ndarray  # (N+1,)
    X: np.ndarray  # (N+1, nx)
    U: np.ndarray  # (N, nu)

    def interpolate(self, t):
        """Desired state at time t (clamped past the horizon end)."""
        tau = np.clip(t / self.dt, 0.0, len(self.U) - 1e-9)
        k = int(np.floor(tau))
        a = tau - k
        return (1 - a) * self.X[k] + a * self.X[k + 1]

    def dense(self, rate):
        """Per-tick desired states at the given control rate."""
        n = int(np.floor(self.ts[-1] * rate))
        return np.stack([self.interpolate(i / rate) for i in range(n)])


def plan_robust(config, com_half_extents=None, duration=None, iterations=60,
                rho=10.0, use_parallel_scan=False, device="cuda", dtype=torch.float32):
    """Solve the offline robust plan (one instance, from a cold start).

    com_half_extents: per-object CoM uncertainty boxes; when given, the
    balance model is expanded 8x (vertex scenarios, reference :513-534).
    duration: plan horizon in seconds (defaults to mpc.time_horizon).
    use_parallel_scan: the log-depth backward pass (``solver/pscan.py``)
    in place of the Riccati kernel.
    Returns (problem, batch-1 Solution, OfflinePlan).
    """
    ctrl = config["controller"]
    dt = float(ctrl.get("sqp", {}).get("dt", 0.1))
    if duration is None:
        duration = float(ctrl.get("mpc", {}).get("time_horizon", 2.0))
    N = int(round(duration / dt))

    prob = build_problem(config, N=N, device=device, dtype=dtype)
    balance_params = None
    if com_half_extents is not None and prob.balance_model.num_objects:
        robust_model = stack_vertex_scenarios_in_model(prob.balance_model, com_half_extents)
        # rebuilt around the expanded model: 8x objects, 8x contacts
        prob = build_problem(config, N=N, device=device, dtype=dtype,
                             _balance_model=robust_model)
        balance_params = robust_model.params

    al_cfg = ALConfig(
        iterations=iterations, rho_eq=rho, rho_ineq=rho,
        backward="pscan" if use_parallel_scan else "scan",
    )
    params = broadcast_params(prob.stage_params(0.0, balance_params=balance_params), 1)
    x0 = prob.x0[None]
    state = zeros_warm_start(prob.ocp, x0, device=device, dtype=dtype)
    sol = solve(prob.ocp, al_cfg, params, x0, state, device=device, dtype=dtype)

    X = sol.state.X[0].cpu().numpy()
    U = sol.state.U[0].cpu().numpy()
    return prob, sol, OfflinePlan(dt=dt, ts=np.arange(N + 1) * dt, X=X, U=U)


def tracking_sweep(sim, plan: OfflinePlan, param_batch, kp=10.0, ctrl_rate=125.0,
                   duration=None):
    """Track the plan under a batch of true inertial parameters: one loop
    over control ticks for the whole batch, each tick the robot's steps and
    one launch of the plant kernel.

    param_batch: dict like ``sim.default_params(batch=B)`` (leading batch
    axis on every tensor).  Returns the final object displacements
    (B, n_obj) in the tray frame, numpy; inf for an object whose integrator
    diverged (the plant's latch), so ``n_diverged`` counts it.
    """
    nq = sim.robot.nq
    duration = duration or float(plan.ts[-1])
    n_ticks = int(np.floor(duration * ctrl_rate))
    n_sub = max(1, int(round(1.0 / ctrl_rate / sim.timestep)))
    xd_ticks = torch.as_tensor(plan.dense(ctrl_rate)[:n_ticks], dtype=sim.dtype,
                               device=sim.device)
    state = sim.initial_state(param_batch["mass"].shape[0])
    for xd in xd_ticks:
        v_cmd = kp * (xd[:nq] - state.q) + xd[nq : 2 * nq]
        state = sim._step_impl(state, v_cmd, n_sub, param_batch)
    return sim.object_displacements(state)


def make_param_sweep(sim, com_offsets=None, mass_scales=None, inertia_scales=None,
                     inertias=None):
    """Cartesian parameter sweep, the reference's 15 CoM x 3 inertia grid
    (:548-655), as a batched parameter dict for ``tracking_sweep``.

    inertias: optional per-CoM-offset (3, 3) inertia overrides (e.g. the
    worst-case synthesis output), scaled by inertia_scales like the nominal.
    """
    base = sim.default_params()
    com_offsets = np.asarray(com_offsets if com_offsets is not None else [[0.0, 0, 0]])
    mass_scales = np.asarray(mass_scales if mass_scales is not None else [1.0])
    inertia_scales = np.asarray(inertia_scales if inertia_scales is not None else [1.0])

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=float), dtype=sim.dtype, device=sim.device)

    entries = []
    for ci, co in enumerate(com_offsets):
        if inertias is not None:
            I_base = t(inertias[ci]).expand_as(base["inertia"])
        else:
            I_base = base["inertia"]
        for ms in mass_scales:
            for is_ in inertia_scales:
                entries.append({
                    "mass": base["mass"] * float(ms),
                    "inertia": I_base * float(is_),
                    "mu": base["mu"],
                    "com_offset": t(co).expand_as(base["com_offset"]),
                })
    return {k: torch.stack([e[k] for e in entries]) for k in entries[0]}


def verify_offline_plan(prob, plan, com_half_extents, inertia_scales=(1.0,),
                        realizable=False, max_states=50):
    """Post-hoc worst-case CWC verification of one offline plan (the
    reference's process_sim_runs.py:87-270): for each planned state, maximize
    each contact-wrench-cone face violation over the inertial ambiguity set
    (CoM box x inertia scales, exact vertex form), and optionally over the
    density-realizable set (the barrier runs on the problem's device, in
    float64).  The planned states' EE motion is taken in float64 on the host.

    Returns {"worst_case_cwc_violation", "violation_steps", "n_states",
    ["worst_case_cwc_violation_realizable"]}.  Positive violation = some
    feasible parameters break balance at that planned state.

    SINGLE-OBJECT only, as the reference: a multi-object arrangement raises.
    """
    conf_parse = dict(prob.config["controller"])
    _model, names, objects, contacts = cfg_mod.parse_control_objects(
        conf_parse, device="cpu", dtype=torch.float64
    )
    if len(names) > 1:
        raise ValueError(
            "verify_offline_plan certifies a SINGLE uncertain object "
            f"(got {len(names)}: {names}); per-object ambiguity sets for "
            "multi-object arrangements are not implemented"
        )
    rcps = [rm.RobustContactPoint(c) for c in contacts]
    A = rm.compute_cwc_face_form(rm.compute_object_name_index(names), rcps)
    obj = objects[names[0]]
    pset = rv.ParameterSet.from_com_box(
        obj.mass, obj.com, obj.inertia, np.asarray(com_half_extents[0]),
        inertia_scales=tuple(inertia_scales),
    )
    stride = max(1, len(plan.X) // max_states)
    xs = torch.tensor(np.asarray(plan.X[::stride], dtype=float)[:, : prob.dims.robot_x])
    ee = prob.robot.ee_state(xs)
    states = [
        tuple(getattr(ee, f)[i].numpy() for f in ("C_we", "w_ew_w", "alpha_ew_w", "a_ew_w"))
        for i in range(xs.shape[0])
    ]
    # host-side float64 from the config, whatever the problem's dtype
    g = cfg_mod.parse_array(prob.config.get("gravity", [0, 0, -9.81]))
    viol = rv.verify_plan(A, states, g, pset)
    out = {
        "worst_case_cwc_violation": float(viol.max()),
        "violation_steps": int((viol > 0.0).sum()),
        "n_states": int(len(states)),
    }
    if realizable:
        com_half = np.asarray(com_half_extents[0], dtype=float)
        box = obj.box
        half = np.abs(box.vertices - box.position).max(axis=0)
        rset = RealizableSet(
            lower=box.position - half,
            upper=box.position + half,
            com_lower=np.asarray(obj.com) - com_half - 1e-4,
            com_upper=np.asarray(obj.com) + com_half + 1e-4,
            mass=obj.mass,
        )
        Ys = [rv.inertial_regressor(*s, g) for s in states]
        viol_r = verify_plan_realizable(A, Ys, rset, device=prob.ocp.device)
        out["worst_case_cwc_violation_realizable"] = float(viol_r.max())
    return out


def protocol_sweep(config, com_half_extents, inertia_scales=(1.0, 0.5, 0.1),
                   device="cuda", dtype=torch.float32):
    """The tracking sweep's set-up of ``ral25_protocol``: the 15 CoM offsets
    of the CoM box, the per-offset worst-case inertias
    (``synthesis.max_min_eig_inertia``) and the plant.

    The plant's substep count is sized for the nominal inertia, but the
    0.1-scaled worst-case inertias have a much stiffer rotational contact
    mode (omega ~ 1/sqrt(I)), so the count is raised by sqrt(I_nom / I_min)
    for the sweep.  Returns (config, sim, com_offsets, worst_inertias), the
    config carrying the raised count when it was raised.
    """
    sim = UprightSimulation(config["simulation"], device=device, dtype=dtype)
    if sim.n_obj < 1:
        raise ValueError("the protocol needs at least one balanced object")
    spec0 = sim.specs[0]
    # the object's bounding-box half extents for the vertex-mass synthesis
    obj_half = np.abs(np.asarray(spec0.vertices_local)).max(axis=0)
    com_offsets = com_offset_grid(np.asarray(com_half_extents[0]))
    worst_inertias = [
        np.diag(max_min_eig_inertia(obj_half, co, mass=spec0.mass)) for co in com_offsets
    ]
    I_min_nom = min(float(np.diag(np.asarray(sp.inertia_local)).min()) for sp in sim.specs)
    I_min_sweep = min(float(s * np.diag(I).min()) for I in worst_inertias for s in inertia_scales)
    if I_min_sweep < I_min_nom:
        factor = float(np.sqrt(I_min_nom / max(I_min_sweep, 1e-12)))
        config = copy.deepcopy(config)
        config["simulation"]["object_substeps"] = int(np.ceil(sim.object_substeps * factor))
        sim = UprightSimulation(config["simulation"], device=device, dtype=dtype)
    return config, sim, com_offsets, worst_inertias


def ral25_protocol(config, com_half_extents=None, waypoints=None,
                   inertia_scales=(1.0, 0.5, 0.1), iterations=60,
                   duration=None, kp=10.0, approx_bounds=False,
                   use_parallel_scan=False, failure_threshold=0.5,
                   com_variant="robust", verify=False,
                   verify_realizable=False, device="cuda", dtype=torch.float32):
    """The reference robust experiment, end to end (planning_sim_loop.py
    :548-655 + process_sim_runs.py): for each waypoint, solve ONE offline
    plan, then track it under the 15-CoM x len(inertia_scales) grid of true
    inertial parameters with per-CoM worst-case inertias; each waypoint's
    sweep is one batched tracking loop.

    com_variant selects the planner's CoM model (reference --com flag,
    planning_sim_loop.py:426-431):
      "robust"  - 8 CoM-vertex scenarios in one OCP,
      "center" / "top" / "bottom" - nominal single-CoM planning with the
      CoM pinned at the centroid / +z / -z extreme of the uncertainty box.

    com_half_extents: CoM-box half extents per object; defaults to the
    config's ``bounds`` schema.  Returns a dict with per-waypoint failure
    counts and displacements.
    """
    ctrl_conf = config["controller"]
    if com_half_extents is None:
        com_half_extents = parse_robust_bounds(ctrl_conf, approx=approx_bounds)
        if com_half_extents is None:
            raise ValueError(
                "no CoM bounds: pass com_half_extents or add a bounds block "
                "to the object config"
            )
    if waypoints is None:
        waypoints = [
            np.asarray(wp.get("position", [0, 0, 0]), dtype=float)
            for wp in ctrl_conf.get("waypoints", [{}])
        ]
    if com_variant not in ("robust", "center", "top", "bottom"):
        raise ValueError(f"unknown com_variant {com_variant!r}")

    config, sim, com_offsets, worst_inertias = protocol_sweep(
        config, com_half_extents, inertia_scales, device=device, dtype=dtype
    )
    plan_extents = com_half_extents if com_variant == "robust" else None

    results = []
    for wp in waypoints:
        wp_config = copy.deepcopy(config)
        wp_config["controller"]["waypoints"] = [
            {"time": 0, "position": list(np.asarray(wp)), "orientation": [0, 0, 0, 1]}
        ]
        # pristine copy for verification: the ambiguity set is centered at
        # the NOMINAL CoM even when the planner pins it to a box extreme
        verify_config = copy.deepcopy(wp_config)
        if com_variant in ("top", "bottom"):
            # nominal planning with the CoM pinned at a box extreme
            # (reference planning_sim_loop.py:495-501)
            sign = 1.0 if com_variant == "top" else -1.0
            arr = wp_config["controller"]["arrangements"][
                wp_config["controller"]["balancing"]["arrangement"]
            ]
            for i, obj in enumerate(arr["objects"]):
                dz = sign * float(np.asarray(com_half_extents[i])[2])
                wp_config["controller"]["objects"][obj["type"]]["com_offset"] = [0.0, 0.0, dz]
        prob, sol, plan = plan_robust(
            wp_config, com_half_extents=plan_extents, duration=duration,
            iterations=iterations, use_parallel_scan=use_parallel_scan,
            device=device, dtype=dtype,
        )
        sweep = make_param_sweep(
            sim, com_offsets=com_offsets, inertia_scales=list(inertia_scales),
            inertias=worst_inertias,
        )
        disp = tracking_sweep(sim, plan, sweep, kp=kp)
        worst = disp.max(axis=1)
        finite = worst[np.isfinite(worst)]
        entry = {
            "waypoint": [float(v) for v in np.asarray(wp, dtype=float)],
            "runs": int(disp.shape[0]),
            "failures": rv.count_failures(disp, failure_threshold),
            "n_diverged": int((~np.isfinite(worst)).sum()),
            "max_displacement_m": float(finite.max()) if finite.size else float("nan"),
            "plan_eq_violation": float(sol.eq_viol),
        }
        if verify:
            # certification of the PLAN over the full ambiguity set against
            # the nominal problem's CWC, whatever the planner's CoM model
            nominal_prob = build_problem(
                verify_config, N=int(round(plan.ts[-1] / plan.dt)), device=device, dtype=dtype
            )
            entry["verification"] = verify_offline_plan(
                nominal_prob, plan, com_half_extents,
                inertia_scales=inertia_scales, realizable=verify_realizable,
            )
        results.append(entry)
    return {
        "protocol": "ral25",
        "com_variant": com_variant,
        "runs": sum(r["runs"] for r in results),
        "failures": sum(r["failures"] for r in results),
        "waypoints": results,
    }
