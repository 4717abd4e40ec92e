"""Assembly of the upright OCP: config -> OCP functions + parameter dicts.

Counterpart of ``upright_tpu/ocp/problem.py`` for the features the demo
problems ``demos/thing_demo.yaml`` and ``demos/ur10_demo.yaml`` use:
triple-integrator dynamics, quadratic + EE-pose Gauss-Newton stage cost,
frictionless balance (Newton-Euler equality rows on mass-scaled force
variables), state/input box rows and the stationary terminal equality.  A
config that switches on anything else raises ``NotImplementedError`` naming
the config key.

Per-solve data (stage times, targets, inertial parameters) live in a
parameter dict so one problem serves every solve and batches over instances.
The port is batch-first: stage functions take leading batch dimensions, and
``shift_warm_start`` / ``heal_warm_start`` act on states with a leading
instance axis.

State / input layout:
    x = [q (nq), v (nq), a (nq)]
    u = [jerk (nq), forces (nc)]
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

import upright_tpu_torch.config as cfg_mod
from upright_tpu_torch import resolve_device
from upright_tpu_torch.core import balance as bal
from upright_tpu_torch.core.balance import BalanceModel
from upright_tpu_torch.core.math import orientation_error, rot_to_quat
from upright_tpu_torch.kinematics.robot import RobotModel, build_robot_model
from upright_tpu_torch.ocp.reference import TargetTrajectory
from upright_tpu_torch.solver.ocp import OCP, IneqBoxRows, SolverState


@dataclasses.dataclass
class UprightDims:
    """Problem dimensions."""

    robot_q: int
    robot_x: int
    robot_u: int
    num_objects: int = 0
    num_contacts: int = 0
    nf: int = 1  # force dim per contact: 1 frictionless
    num_obstacles: int = 0  # dynamic obstacles (not ported yet: always 0)

    @property
    def f(self):
        return self.nf * self.num_contacts

    @property
    def x(self):
        return self.robot_x + 9 * self.num_obstacles

    @property
    def u(self):
        return self.robot_u + self.f


@dataclasses.dataclass
class UprightProblem:
    """Everything needed to run the MPC: the OCP + the functions that make its params."""

    ocp: OCP
    dims: UprightDims
    robot: RobotModel
    balance_model: BalanceModel
    dt: float
    x0: torch.Tensor
    xd: torch.Tensor  # desired joint-space state for the quadratic cost
    target: TargetTrajectory
    gravity: torch.Tensor
    config: dict
    # (name, row count) of each inequality block, in stacking order
    ineq_groups: list = dataclasses.field(default_factory=list)
    # position-jump size (rad, joint-space 2-norm) above which the warm
    # start's state trajectory is re-rolled from the measured x0 instead of
    # kept; config key controller.mpc.heal_jump_threshold
    heal_jump_threshold: float = 0.2
    # per-force-variable scale (dims.f,): physical newtons = force_scale *
    # the solver's dimensionless force variables (see build_problem)
    force_scale: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0)
    )

    def shift_warm_start(self, state: SolverState, shift):
        """Time-shift the warm start by ``shift`` nodes (fractional OK).

        ``shift`` is a number or a (B,) tensor, ``(t - t_last)/dt``.  Rows
        are gathered and linearly interpolated; multipliers interpolate the
        same way, tail entries clamp to the last stage (X rows to index N,
        U/lam/mu rows to N-1); ``lam_f`` is not shifted.
        """
        B = state.X.shape[0]
        s = torch.as_tensor(shift, dtype=state.X.dtype, device=state.X.device)
        s = torch.clamp(s, min=0.0).expand(B)
        n = torch.floor(s)
        frac = (s - n).view(B, 1, 1)
        n = n.to(torch.long).view(B, 1)

        def shift_rows(A, last):
            k = torch.arange(A.shape[1], device=A.device).view(1, -1)
            a = torch.clamp(k + n, 0, last).unsqueeze(-1).expand_as(A)
            b = torch.clamp(k + n + 1, 0, last).unsqueeze(-1).expand_as(A)
            return (1.0 - frac) * torch.gather(A, 1, a) + frac * torch.gather(A, 1, b)

        N = state.U.shape[1]
        return state.replace(
            X=shift_rows(state.X, N),
            U=shift_rows(state.U, N - 1),
            lam=shift_rows(state.lam, N - 1),
            mu=shift_rows(state.mu, N - 1),
        )

    def heal_warm_start(self, state: SolverState, x0):
        """Repair stale components of the warm start for the new x0 (B, nx).

        The robot part keeps the stored (near-optimal) trajectory for normal
        tracking, but after a LARGE state jump (e.g. post-brake re-engage)
        the stored plan is unreachable from x0 and its stage-0 defect stalls
        the line search; in that case the state trajectory is re-rolled from
        x0 through the stored inputs.  The switch is gated, per instance, on
        the norm of the POSITION jump only: per-replan drift during fast
        nominal motion lives in the velocity/acceleration states.
        """
        x0 = torch.as_tensor(x0, dtype=state.X.dtype, device=state.X.device)
        xs = [x0]
        for k in range(state.U.shape[1]):
            # stage params do not affect the robot dynamics
            xs.append(self.ocp.dynamics(xs[-1], state.U[:, k], None))
        X_roll = torch.stack(xs, dim=1)

        nq = self.dims.robot_q
        jump = torch.linalg.vector_norm(x0[:, :nq] - state.X[:, 0, :nq], dim=-1)
        use_roll = (jump > self.heal_jump_threshold).view(-1, 1, 1)
        return state.replace(X=torch.where(use_roll, X_roll, state.X))

    def stage_params(self, t0, target: Optional[TargetTrajectory] = None,
                     balance_params=None):
        """Per-solve parameter dict for one instance (no batch axis; lift it
        with ``parallel.batch.broadcast_params``).

        t0: current time (stage k is at t0 + k*dt).
        target: overrides the stored target trajectory.
        balance_params: (n_obj, 10) overrides object inertial parameters.
        """
        target = self.target if target is None else target
        bp = self.balance_model.params if balance_params is None else balance_params
        N = self.ocp.N
        dev, dt_ = self.ocp.device, self.ocp.dtype
        ts = t0 + self.dt * torch.arange(N, device=dev, dtype=dt_)
        n_wp = target.times.shape[0]
        stage = {
            "t": ts,
            "target_times": target.times.expand(N, n_wp),
            "target_poses": target.poses.expand(N, n_wp, 8),
            "obj_params": bp.expand((N,) + tuple(bp.shape)),
        }
        final = {
            "t": torch.as_tensor(t0 + self.dt * N, device=dev, dtype=dt_),
            "target_times": target.times,
            "target_poses": target.poses,
            "obj_params": bp,
        }
        return {"stage": stage, "final": final}


def _triple_integrator_step(dt):
    """Exact discretization of the jerk-input triple integrator."""

    def step(q, v, a, j):
        q1 = q + dt * v + 0.5 * dt**2 * a + dt**3 / 6.0 * j
        v1 = v + dt * a + 0.5 * dt**2 * j
        a1 = a + dt * j
        return q1, v1, a1

    return step


def _reject_unported(ctrl, robot_conf, balancing, sqp_conf):
    """Raise for every config switch whose code the port does not carry yet."""

    def enabled(key, flag="enabled"):
        return bool(ctrl.get(key, {}).get(flag, False))

    unported = []
    if balancing.get("enabled", False) and not balancing.get("frictionless", True):
        unported.append("controller.balancing.frictionless=false (frictional cones)")
    if enabled("obstacles"):
        unported.append("controller.obstacles.enabled (collision rows, dynamic obstacles)")
    if enabled("projectile_path_constraint"):
        unported.append("controller.projectile_path_constraint.enabled")
    if enabled("projectile_plane_constraint"):
        unported.append("controller.projectile_plane_constraint.enabled")
    if enabled("inertial_alignment", "cost_enabled"):
        unported.append("controller.inertial_alignment.cost_enabled")
    if enabled("inertial_alignment", "constraint_enabled"):
        unported.append("controller.inertial_alignment.constraint_enabled")
    if enabled("end_effector_box_constraint"):
        unported.append("controller.end_effector_box_constraint.enabled")
    if robot_conf.get("base_type", "omnidirectional").lower() == "nonholonomic":
        unported.append("controller.robot.base_type=nonholonomic (rolling rows)")
    if sqp_conf.get("jac_mode", "auto") not in ("auto", "fwd"):
        unported.append("controller.sqp.jac_mode=rev")
    if sqp_conf.get("jac_col_blocks", "auto") is True:
        unported.append("controller.sqp.jac_col_blocks=true")
    if unported:
        raise NotImplementedError(
            "not yet ported to upright_tpu_torch: " + "; ".join(unported)
        )


def build_problem(config: dict, N: Optional[int] = None, device="cuda",
                  dtype=torch.float32) -> UprightProblem:
    """Build the OCP from a merged config dict (see configs/), with every
    constant on ``device`` as ``dtype``."""
    device = resolve_device(device)
    ctrl = config["controller"]
    robot_conf = ctrl["robot"]
    balancing = ctrl.get("balancing", {"enabled": False})
    sqp_conf = ctrl.get("sqp", {})
    _reject_unported(ctrl, robot_conf, balancing, sqp_conf)

    def tens(a):
        return torch.as_tensor(np.asarray(a, dtype=float), dtype=dtype, device=device)

    robot = build_robot_model(robot_conf)
    nq = robot.nq

    # -- balancing model ------------------------------------------------
    if balancing.get("enabled", False):
        model, names, objects, contacts = cfg_mod.parse_control_objects(
            dict(ctrl), device=device, dtype=dtype
        )
        nc = model.num_contacts
        n_obj = model.num_objects
    else:
        model = BalanceModel.empty(device=device, dtype=dtype)
        nc, n_obj = 0, 0
    nf = 1

    dims = UprightDims(
        robot_q=nq, robot_x=3 * nq, robot_u=nq,
        num_objects=n_obj, num_contacts=nc, nf=nf,
    )

    # -- horizon / transcription ---------------------------------------
    dt = float(sqp_conf.get("dt", 0.1))
    horizon = float(ctrl.get("mpc", {}).get("time_horizon", 2.0))
    if N is None:
        N = int(round(horizon / dt))

    robot_step = _triple_integrator_step(dt)

    def dynamics(x, u, p):
        q, v, a = x[..., :nq], x[..., nq : 2 * nq], x[..., 2 * nq : 3 * nq]
        j = u[..., :nq]
        return torch.cat(robot_step(q, v, a, j), dim=-1)

    # -- weights ---------------------------------------------------------
    W_input_np = cfg_mod.parse_diag_matrix_dict(ctrl["weights"]["input"])
    W_state_robot = tens(cfg_mod.parse_diag_matrix_dict(ctrl["weights"]["state"]))
    W_ee = tens(cfg_mod.parse_diag_matrix_dict(ctrl["weights"]["end_effector"]))
    force_weight = float(balancing.get("force_weight", 1e-3))

    # desired joint state: the initial state (velocity/acceleration weights
    # pull toward rest; q block is zero-weighted in the shipped configs)
    x0_robot_np = cfg_mod.parse_array(robot_conf["x0"])
    x0_robot = tens(x0_robot_np)
    xd_robot = x0_robot

    gravity = tens(cfg_mod.parse_array(config.get("gravity", [0, 0, -9.81])))

    # -- contact-force variable scaling (conditioning) --------------------
    # The NE residuals are mass-normalized, so their Jacobian w.r.t.
    # PHYSICAL forces is ~1/m.  Solve in MASS-SCALED force variables:
    #     f_physical = fscale_c * u_f,   fscale_c = m_ref(c),
    # with m_ref the lightest dynamic object the contact touches, so the
    # mass-normalized eq rows see force Jacobians of m_ref/m ~ 1 for every
    # object mass.
    if dims.f > 0:
        masses_np = model.params[:, 0].cpu().numpy().astype(float)
        incident = ((model.S1 + model.S2) > 0.5).cpu().numpy()
        m_ref = np.where(incident, masses_np[:, None], np.inf).min(axis=0)
        m_fill = float(masses_np.mean()) if masses_np.size else 1.0
        m_ref = np.where(np.isfinite(m_ref), m_ref, m_fill)
        force_scale = np.repeat(m_ref, nf)  # (dims.f,)
    else:
        force_scale = np.zeros(0)
    fscale = tens(force_scale)

    # input weight over [jerk, forces]; force_weight acts on the
    # DIMENSIONLESS force variables
    W_u_np = np.zeros((dims.u, dims.u))
    W_u_np[:nq, :nq] = W_input_np
    if dims.f > 0:
        W_u_np[nq:, nq:] = force_weight * np.eye(dims.f)
    W_u = tens(W_u_np)

    # -- limits ----------------------------------------------------------
    limits = ctrl.get("limits", {})
    x_lb_robot = cfg_mod.parse_array(limits["state"]["lower"]) if "state" in limits else None
    x_ub_robot = cfg_mod.parse_array(limits["state"]["upper"]) if "state" in limits else None
    u_lb_robot = cfg_mod.parse_array(limits["input"]["lower"]) if "input" in limits else None
    u_ub_robot = cfg_mod.parse_array(limits["input"]["upper"]) if "input" in limits else None

    FORCE_BOUND = 1e2  # newtons
    if dims.f > 0:
        # bounds live on the scaled variables: [0, FORCE_BOUND physical]
        f_lb = np.zeros(dims.f)
        f_ub = FORCE_BOUND / force_scale
    else:
        f_lb = np.zeros(0)
        f_ub = np.zeros(0)

    u_lb = tens(np.concatenate([u_lb_robot, f_lb])) if u_lb_robot is not None else None
    u_ub = tens(np.concatenate([u_ub_robot, f_ub])) if u_ub_robot is not None else None
    x_lb = tens(x_lb_robot) if x_lb_robot is not None else None
    x_ub = tens(x_ub_robot) if x_ub_robot is not None else None

    # -- EE helpers ------------------------------------------------------
    def ee_state_of(x):
        return robot.ee_state(x[..., : dims.robot_x])

    def interp_target(p):
        tgt = TargetTrajectory(times=p["target_times"], poses=p["target_poses"])
        return tgt.interpolate(p["t"])

    # -- stage cost ------------------------------------------------------
    def stage_quad(x, u, p):
        dx = x[..., : dims.robot_x] - xd_robot
        return 0.5 * ((dx @ W_state_robot) * dx).sum(-1) + 0.5 * ((u @ W_u) * u).sum(-1)

    H_quad = torch.block_diag(W_state_robot, W_u)

    def stage_quad_derivs(x, u, p):
        """Analytic gradient/Hessian of stage_quad (the Hessian is the
        constant weight block diagonal, returned without batch axes)."""
        dx = x[..., : dims.robot_x] - xd_robot
        grad = torch.cat([dx @ W_state_robot.T, u @ W_u.T], dim=-1)
        return grad, H_quad

    # EE-error clamp (controller.ee_error_clamp, meters; 0 = off): bounds
    # the tracking pull when the target is unreachable.  Clamping the error
    # magnitude keeps the gradient direction with a bounded norm.
    ee_clamp = float(ctrl.get("ee_error_clamp", 0.0))

    def _clamped(e_pos):
        if ee_clamp <= 0.0:
            # early return at build-time knowledge: the norm below has no
            # derivative at zero error
            return e_pos
        nrm = torch.linalg.vector_norm(e_pos, dim=-1, keepdim=True)
        scale = torch.clamp(ee_clamp / torch.clamp(nrm, min=1e-9), max=1.0)
        return e_pos * scale

    def stage_residuals(x, u, p):
        """Nonlinear GN residuals: EE pose error.  Returns (r (..., 6), W)."""
        rd, qd, _s = interp_target(p)
        ee = ee_state_of(x)
        q_act = rot_to_quat(ee.C_we)
        e = torch.cat(
            [_clamped(ee.r_ew_w - rd), orientation_error(q_act, qd)], dim=-1
        )
        return e, W_ee

    def stage_cost(x, u, p):
        r, W = stage_residuals(x, u, p)
        return stage_quad(x, u, p) + 0.5 * ((r @ W) * r).sum(-1)

    # -- equality constraints: object dynamics ---------------------------
    def eq(x, u, p):
        if n_obj == 0:
            return x.new_zeros(x.shape[:-1] + (0,))
        forces_flat = u[..., nq:] * fscale  # scaled variables -> physical newtons
        scen = model.replace(params=p["obj_params"])
        forces = bal.expand_frictionless_forces(scen, forces_flat)
        ee = ee_state_of(x)
        return bal.object_dynamics_constraints(scen, forces, ee, gravity)

    n_eq = 6 * n_obj

    # -- inequality constraints -----------------------------------------
    # Row order: [x_lo | x_hi | u_lo | u_hi]; so far every row is a
    # box row (frictionless cones are the f >= 0 input bounds), so the
    # smooth part is empty.
    def ineq(x, u, p):
        rows = []
        if x_lb is not None:
            xr = x[..., : dims.robot_x]
            rows.append(xr - x_lb)
            rows.append(x_ub - xr)
        if u_lb is not None:
            rows.append(u - u_lb)
            rows.append(u_ub - u)
        if not rows:
            return x.new_zeros(x.shape[:-1] + (0,))
        return torch.cat(rows, dim=-1)

    def ineq_smooth(x, u, p):
        return x.new_zeros(x.shape[:-1] + (0,))

    ineq_groups = []
    if x_lb is not None:
        ineq_groups.append(("state_limits", 2 * dims.robot_x))
    if u_lb is not None:
        ineq_groups.append(("input_limits", 2 * dims.u))
    n_ineq = sum(n for _, n in ineq_groups)

    box_rows = IneqBoxRows(
        n_pre=0,
        nx_box=dims.robot_x if x_lb is not None else 0,
        nu_box=dims.u if u_lb is not None else 0,
    )

    # -- terminal constraints -------------------------------------------
    def final_eq(x, p):
        # EE at the desired position, zero velocity/acceleration; the
        # position rows share the ee_error_clamp
        rd, _qd, _s = interp_target(p)
        r_ee = ee_state_of(x).r_ew_w
        v = x[..., nq : 2 * nq]
        a = x[..., 2 * nq : 3 * nq]
        return torch.cat([_clamped(r_ee - rd), v, a], dim=-1)

    n_feq = 3 + 2 * nq

    ocp = OCP(
        N=N, nx=dims.x, nu=dims.u, n_eq=n_eq, n_ineq=n_ineq, n_feq=n_feq,
        dynamics=dynamics, stage_cost=stage_cost, eq=eq, ineq=ineq,
        final_eq=final_eq,
        stage_residuals=stage_residuals, stage_quad=stage_quad,
        stage_quad_derivs=stage_quad_derivs,
        ineq_smooth=ineq_smooth, ineq_box=box_rows,
        u_lb=u_lb, u_ub=u_ub,
        # The discrete dynamics are exactly linear (triple integrator), so
        # the solver may linearize once and hand the Riccati kernel one
        # stage-invariant (A, B) pair (sqp.linear_dynamics).
        linear_dynamics=bool(sqp_conf.get("linear_dynamics", False)),
        device=device, dtype=dtype,
    )

    # -- initial state + target -----------------------------------------
    # target waypoints relative to the initial EE pose; computed in float64
    # on the host side of the chain so both dtypes see the same target
    q0_64 = torch.as_tensor(x0_robot_np[:nq], dtype=torch.float64)
    R0, r0 = robot.ee_pose(q0_64)
    q0 = rot_to_quat(R0)
    waypoints = ctrl.get("waypoints", [{"time": 0.0}])
    target = TargetTrajectory.from_waypoints(
        waypoints, r0.numpy(), q0.numpy(), device=device, dtype=dtype
    )

    return UprightProblem(
        ocp=ocp, dims=dims, robot=robot, balance_model=model, dt=dt,
        x0=x0_robot, xd=xd_robot, target=target, gravity=gravity, config=config,
        ineq_groups=ineq_groups,
        heal_jump_threshold=float(
            ctrl.get("mpc", {}).get("heal_jump_threshold", 0.2)
        ),
        force_scale=force_scale,
    )
