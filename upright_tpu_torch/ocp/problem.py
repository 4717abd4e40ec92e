"""Assembly of the upright OCP: config -> OCP functions + parameter dicts.

Counterpart of ``upright_tpu/ocp/problem.py``: the whole problem (dynamics,
costs, balance constraints with frictionless or frictional contacts, limits,
EE box, inertial alignment, collision avoidance, projectile avoidance, the
rolling rows of a nonholonomic base) is assembled into stage functions at
build time.

Per-solve data (stage times, targets, inertial parameters) live in a
parameter dict so one problem serves every solve and batches over instances;
dynamic-obstacle states live in x.  The port is batch-first: stage functions
take leading batch dimensions, and ``shift_warm_start`` / ``heal_warm_start``
act on states with a leading instance axis.

State / input layout:
    x = [q (nq), v (nq), a (nq), obs_1 (9), ..., obs_o (9)]
    u = [jerk (nq), forces (nf * nc)]
Dynamic-obstacle states are 9-vectors [r, v, a] with constant-acceleration
dynamics.
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
from upright_tpu_torch.core.math import dC_dtt, matvec, orientation_error, rot_to_quat
from upright_tpu_torch.core.polyhedron import plane_span
from upright_tpu_torch.kinematics.robot import RobotModel, build_robot_model
from upright_tpu_torch.ocp.reference import TargetTrajectory
from upright_tpu_torch.solver.ocp import OCP, IneqBoxRows, SolverState
from upright_tpu_torch.tracing import span


@dataclasses.dataclass
class UprightDims:
    """Problem dimensions."""

    robot_q: int
    robot_x: int
    robot_u: int
    num_objects: int = 0
    num_contacts: int = 0
    nf: int = 1  # force dim per contact: 1 frictionless, 3 frictional
    num_obstacles: int = 0  # dynamic obstacles, 9 states each

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
class CollisionSphere:
    """A collision sphere attached to a named chain frame.  ``_CollisionRows``
    keeps the config's spheres as stacked tensors; this names one."""

    link: str
    offset: np.ndarray
    radius: float


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

    def _at(self, x, u, t, target):
        """(x, u, stage-0 params) as tensors of the problem, for one (x, u, t)."""
        x = torch.as_tensor(x, dtype=self.ocp.dtype, device=self.ocp.device)
        u = torch.as_tensor(u, dtype=self.ocp.dtype, device=self.ocp.device)
        params = self.stage_params(t, target)
        return x, u, {k: v[0] for k, v in params["stage"].items()}

    def evaluate_constraints(self, x, u, t=0.0, target=None):
        """All constraint groups at one (x, u, t), split by named group (the
        per-named-constraint values the closed loop logs)."""
        x, u, p0 = self._at(x, u, t, target)
        r, _W = self.ocp.stage_residuals(x, u, p0)
        h = self.ocp.ineq(x, u, p0)
        out = {
            "equality": self.ocp.eq(x, u, p0),
            "inequality": h,
            "ee_pose_error": r[:6],
        }
        off = 0
        for name, n_rows in self.ineq_groups:
            out[name] = h[off : off + n_rows]
            off += n_rows
        return out

    def diagnostics(self, x, u, t=0.0, target=None):
        """Scalar diagnostics tracked per step: the angle between the tray
        normal and the total acceleration, the norm of the rotation matrix's
        second derivative, the stage cost, and the contact forces in newtons."""
        x, u, p0 = self._at(x, u, t, target)
        ee = self.robot.ee_state(x[: self.dims.robot_x])
        total_acc = ee.a_ew_w - self.gravity
        n_w = ee.C_we[:, 2]  # C_we @ e_z
        cosang = (n_w * total_acc).sum(-1) / torch.clamp(
            torch.linalg.vector_norm(total_acc), min=1e-9
        )
        orn_err = torch.arccos(torch.clamp(cosang, -1.0, 1.0))
        ddC = dC_dtt(ee.C_we, ee.w_ew_w, ee.alpha_ew_w)
        return {
            "orn_err": orn_err,
            "ddC_we_norm": torch.linalg.matrix_norm(ddC),
            "cost": self.ocp.stage_cost(x, u, p0),
            "contact_forces": u[self.dims.robot_u :]
            * torch.as_tensor(self.force_scale, dtype=u.dtype, device=u.device),
        }

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

        Dynamic-obstacle tails evolve autonomously, so they are always
        re-propagated from the measured obstacle state.  The robot part keeps
        the stored (near-optimal) trajectory for normal tracking, but after a
        LARGE state jump (e.g. post-brake re-engage) the stored plan is
        unreachable from x0 and its stage-0 defect stalls the line search; in
        that case the state trajectory is re-rolled from x0 through the
        stored inputs.  The switch is gated, per instance, on
        the norm of the POSITION jump only: per-replan drift during fast
        nominal motion lives in the velocity/acceleration states.
        """
        x0 = torch.as_tensor(x0, dtype=state.X.dtype, device=state.X.device)
        xs = [x0]
        for k in range(state.U.shape[1]):
            # stage params do not affect the robot/obstacle dynamics
            xs.append(self.ocp.dynamics(xs[-1], state.U[:, k], None))
        X_roll = torch.stack(xs, dim=1)

        X_keep = state.X
        if self.dims.num_obstacles:
            rx = self.dims.robot_x
            X_keep = torch.cat([X_keep[..., :rx], X_roll[..., rx:]], dim=-1)

        nq = self.dims.robot_q
        jump = torch.linalg.vector_norm(x0[:, :nq] - state.X[:, 0, :nq], dim=-1)
        use_roll = (jump > self.heal_jump_threshold).view(-1, 1, 1)
        return state.replace(X=torch.where(use_roll, X_roll, X_keep))

    def stage_params(self, t0, target: Optional[TargetTrajectory] = None,
                     balance_params=None):
        """Per-solve parameter dict, with the target's leading batch axes.

        For one target (times (n_wp,)) the dict has no batch axis; lift it
        with ``parallel.batch.broadcast_params``.  For a stack of B targets
        (``reference.stack_targets``, times (B, n_wp)) every leaf carries the
        leading B that ``solve`` takes, as expanded views of one expression.

        t0: current time (stage k is at t0 + k*dt), shared by the batch.
        target: overrides the stored target trajectory.
        balance_params: (n_obj, 10) overrides object inertial parameters.
        """
        target = self.target if target is None else target
        bp = self.balance_model.params if balance_params is None else balance_params
        N = self.ocp.N
        dev, dt_ = self.ocp.device, self.ocp.dtype
        lead = tuple(target.times.shape[:-1])
        n_wp = target.times.shape[-1]
        ts = t0 + self.dt * torch.arange(N, device=dev, dtype=dt_)
        stage = {
            "t": ts.expand(lead + (N,)),
            "target_times": target.times.unsqueeze(-2).expand(lead + (N, n_wp)),
            "target_poses": target.poses.unsqueeze(-3).expand(lead + (N, n_wp, 8)),
            "obj_params": bp.expand(lead + (N,) + tuple(bp.shape)),
        }
        final = {
            "t": torch.as_tensor(t0 + self.dt * N, device=dev, dtype=dt_).expand(lead),
            "target_times": target.times,
            "target_poses": target.poses,
            "obj_params": bp.expand(lead + tuple(bp.shape)),
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


def _obstacle_step(dt):
    """Constant-acceleration 9-state points, exact; s (..., n_obs, 9)."""

    def step(s):
        r, v, a = s[..., 0:3], s[..., 3:6], s[..., 6:9]
        return torch.cat([r + dt * v + 0.5 * dt**2 * a, v + dt * a, a], dim=-1)

    return step


def _use_jac_col_blocks(sqp_conf: dict, device: torch.device) -> bool:
    """Resolve sqp.jac_col_blocks ("auto" | true | false, default "auto").

    "auto" splits the stage Jacobian's x-columns into the [q | v | a |
    obstacles] blocks on the CPU, as the reference does there (the v- and
    a-columns skip the rotation-chain JVPs), and keeps one wide jacfwd on the
    card: on an H100 the eager solve is bound by its launches, and the four
    block sweeps took 2.2-2.8x the wide one (``chip_smoke.py --breakdown``,
    PERF.md section 5).
    """
    choice = sqp_conf.get("jac_col_blocks", "auto")
    if isinstance(choice, bool):
        return choice
    if choice != "auto":
        raise ValueError(f"sqp.jac_col_blocks must be 'auto' or bool, got {choice!r}")
    return device.type == "cpu"


def build_problem(config: dict, N: Optional[int] = None, device="cuda",
                  dtype=torch.float32, _balance_model: Optional[BalanceModel] = None
                  ) -> UprightProblem:
    """Build the OCP from a merged config dict (see configs/), with every
    constant on ``device`` as ``dtype``.

    ``_balance_model`` (internal: robust planning's scenario-stacked model,
    ``robust.planning.plan_robust``) takes the place of the model parsed
    from the config; the reference patches its parser module for this, which
    a planner thread building problems concurrently must not see.
    """
    device = resolve_device(device)
    ctrl = config["controller"]
    robot_conf = ctrl["robot"]
    robot = build_robot_model(robot_conf)
    nq = robot.nq

    def tens(a):
        return torch.as_tensor(np.asarray(a, dtype=float), dtype=dtype, device=device)

    # -- balancing model ------------------------------------------------
    balancing = ctrl.get("balancing", {"enabled": False})
    if balancing.get("enabled", False):
        model, names, objects, contacts = cfg_mod.parse_control_objects(
            dict(ctrl), device=device, dtype=dtype
        )
        if _balance_model is not None:
            model = _balance_model
        frictionless = bool(balancing.get("frictionless", True))
        nf = 1 if frictionless else 3
        nc = model.num_contacts
        n_obj = model.num_objects
    else:
        model = BalanceModel.empty(device=device, dtype=dtype)
        frictionless, nf, nc, n_obj = True, 1, 0, 0

    obstacles_conf = ctrl.get("obstacles", {"enabled": False})
    dyn_obs = obstacles_conf.get("dynamic", []) if obstacles_conf.get("enabled") else []
    num_obstacles = len(dyn_obs)

    dims = UprightDims(
        robot_q=nq, robot_x=3 * nq, robot_u=nq,
        num_objects=n_obj, num_contacts=nc, nf=nf,
        num_obstacles=num_obstacles,
    )
    rx = dims.robot_x

    # -- horizon / transcription ---------------------------------------
    sqp_conf = ctrl.get("sqp", {})
    dt = float(sqp_conf.get("dt", 0.1))
    horizon = float(ctrl.get("mpc", {}).get("time_horizon", 2.0))
    if N is None:
        N = int(round(horizon / dt))

    robot_step = _triple_integrator_step(dt)
    obs_step = _obstacle_step(dt)
    # Nonholonomic (unicycle) bases keep the exact linear triple-integrator
    # dynamics; the rolling constraint (zero lateral base velocity) enters as
    # an equality constraint.
    nonholonomic = robot_conf.get("base_type", "omnidirectional").lower() == "nonholonomic"

    def dynamics(x, u, p):
        q, v, a = x[..., :nq], x[..., nq : 2 * nq], x[..., 2 * nq : rx]
        j = u[..., :nq]
        parts = list(robot_step(q, v, a, j))
        if num_obstacles:
            obs = x[..., rx:].unflatten(-1, (num_obstacles, 9))
            parts.append(obs_step(obs).flatten(-2))
        return torch.cat(parts, dim=-1)

    # -- weights ---------------------------------------------------------
    W_input_np = cfg_mod.parse_diag_matrix_dict(ctrl["weights"]["input"])
    W_state_robot = tens(cfg_mod.parse_diag_matrix_dict(ctrl["weights"]["state"]))
    W_ee_np = cfg_mod.parse_diag_matrix_dict(ctrl["weights"]["end_effector"])
    force_weight = float(balancing.get("force_weight", 1e-3))

    # desired joint state: the initial state (velocity/acceleration weights
    # pull toward rest; q block is zero-weighted in the shipped configs)
    x0_robot_np = cfg_mod.parse_array(robot_conf["x0"])
    x0_robot = tens(x0_robot_np)
    xd_robot = x0_robot

    gravity_np = np.asarray(cfg_mod.parse_array(config.get("gravity", [0, 0, -9.81])), dtype=float)
    gravity = tens(gravity_np)

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
        # bounds live on the scaled variables: +-FORCE_BOUND physical
        # (frictionless normal forces: [0, FORCE_BOUND])
        f_bound = FORCE_BOUND / force_scale
        f_lb = np.zeros(dims.f) if frictionless else -f_bound
        f_ub = f_bound.copy()
    else:
        f_lb = np.zeros(0)
        f_ub = np.zeros(0)

    u_lb = tens(np.concatenate([u_lb_robot, f_lb])) if u_lb_robot is not None else None
    u_ub = tens(np.concatenate([u_ub_robot, f_ub])) if u_ub_robot is not None else None
    x_lb = tens(x_lb_robot) if x_lb_robot is not None else None
    x_ub = tens(x_ub_robot) if x_ub_robot is not None else None

    # -- EE helpers ------------------------------------------------------
    def ee_state_of(x):
        return robot.ee_state(x[..., :rx])

    def interp_target(p):
        tgt = TargetTrajectory(times=p["target_times"], poses=p["target_poses"])
        return tgt.interpolate(p["t"])

    # -- stage cost ------------------------------------------------------
    n_obs_x = dims.x - rx

    def stage_quad(x, u, p):
        dx = x[..., :rx] - xd_robot
        return 0.5 * ((dx @ W_state_robot) * dx).sum(-1) + 0.5 * ((u @ W_u) * u).sum(-1)

    H_quad = torch.block_diag(
        W_state_robot, torch.zeros((n_obs_x, n_obs_x), dtype=dtype, device=device), W_u
    )

    def stage_quad_derivs(x, u, p):
        """Analytic gradient/Hessian of stage_quad (the Hessian is the
        constant weight block diagonal, returned without batch axes;
        obstacle-state columns are zero)."""
        dx = x[..., :rx] - xd_robot
        grad = torch.cat(
            [dx @ W_state_robot.T, x.new_zeros(x.shape[:-1] + (n_obs_x,)), u @ W_u.T], dim=-1
        )
        return grad, H_quad

    # -- inertial alignment ------------------------------------------------
    # alignment-vector modes: the default is the total EE-frame acceleration;
    # use_angular_acceleration adds the term ddC_we @ com of an object CoM
    # offset; align_with_fixed_vector (the "upward" mode) tracks the original
    # normal direction instead.
    ia_conf = ctrl.get("inertial_alignment", {})
    ia_cost_enabled = bool(ia_conf.get("cost_enabled", False))
    ia_con_enabled = bool(ia_conf.get("constraint_enabled", False))
    ia_weight = float(ia_conf.get("cost_weight", 1.0))
    ia_alpha = float(ia_conf.get("alpha", 0.0))
    ia_fixed_vector = bool(ia_conf.get("align_with_fixed_vector", False))
    ia_use_angular = bool(ia_conf.get("use_angular_acceleration", False))
    ia_normal_np = np.asarray(ia_conf.get("contact_plane_normal", [0, 0, 1]), dtype=float)
    ia_normal = tens(ia_normal_np)
    ia_com = tens(ia_conf.get("com", [0.0, 0.0, 0.0]))
    ia_span = tens(plane_span(ia_normal_np)) if (ia_cost_enabled or ia_con_enabled) else None
    g_norm = float(np.linalg.norm(gravity_np))

    def _alignment_vector(ee):
        """EE-frame vector whose tangential components the alignment cost and
        constraint act on, (..., 3)."""
        C_ew = ee.C_we.transpose(-1, -2)
        if ia_fixed_vector:
            return matvec(C_ew, ia_normal)
        a_total = ee.a_ew_w - gravity
        if ia_use_angular:
            a_total = a_total + matvec(dC_dtt(ee.C_we, ee.w_ew_w, ee.alpha_ew_w), ia_com)
        return matvec(C_ew, a_total)

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

    W_res_np = W_ee_np
    if ia_cost_enabled:
        W_res_np = np.zeros((8, 8))
        W_res_np[:6, :6] = W_ee_np
        W_res_np[6:, 6:] = ia_weight * np.eye(2)
    W_res = tens(W_res_np)

    def stage_residuals(x, u, p):
        """Nonlinear GN residuals: EE pose error (+ inertial alignment).
        Returns (r (..., 6 or 8), W)."""
        rd, qd, _s = interp_target(p)
        ee = ee_state_of(x)
        q_act = rot_to_quat(ee.C_we)
        parts = [_clamped(ee.r_ew_w - rd), orientation_error(q_act, qd)]
        if ia_cost_enabled:
            # alignment residual S @ <alignment vector>, normalized by |g| in
            # the acceleration modes; in fixed-vector mode the GN residual
            # S C_we^T n has the minimizer and curvature of the linear cost
            e_align = matvec(ia_span, _alignment_vector(ee))
            if not ia_fixed_vector:
                e_align = e_align / g_norm
            parts.append(e_align)
        return torch.cat(parts, dim=-1), W_res

    def stage_cost(x, u, p):
        r, W = stage_residuals(x, u, p)
        return stage_quad(x, u, p) + 0.5 * ((r @ W) * r).sum(-1)

    # -- equality constraints: rolling rows + object dynamics -------------
    def _rolling_rows(x):
        # zero lateral velocity and acceleration of the unicycle base:
        # [-sin(yaw), cos(yaw)] . (vx, vy) = 0 (and the same for ax, ay);
        # entries stay (..., 1)-shaped (see core/math.py _mat1)
        yaw = x[..., 2:3]
        s_, c_ = torch.sin(yaw), torch.cos(yaw)
        v_lat = -s_ * x[..., nq : nq + 1] + c_ * x[..., nq + 1 : nq + 2]
        a_lat = -s_ * x[..., 2 * nq : 2 * nq + 1] + c_ * x[..., 2 * nq + 1 : 2 * nq + 2]
        return torch.cat([v_lat, a_lat], dim=-1)

    def eq(x, u, p):
        rows = []
        if nonholonomic:
            rows.append(_rolling_rows(x))
        if n_obj > 0:
            ee = ee_state_of(x)
            with span("ocp.balance", x.device):
                forces_flat = u[..., nq:] * fscale  # scaled variables -> physical newtons
                scen = model.replace(params=p["obj_params"])
                if frictionless:
                    forces = bal.expand_frictionless_forces(scen, forces_flat)
                else:
                    forces = forces_flat.unflatten(-1, (nc, 3))
                rows.append(bal.object_dynamics_constraints(scen, forces, ee, gravity))
        if not rows:
            return x.new_zeros(x.shape[:-1] + (0,))
        return torch.cat(rows, dim=-1)

    n_eq = 6 * n_obj + (2 if nonholonomic else 0)

    # -- inequality constraints -----------------------------------------
    ee_box_conf = ctrl.get("end_effector_box_constraint", {"enabled": False})
    ee_box_enabled = bool(ee_box_conf.get("enabled", False))
    if ee_box_enabled:
        xyz_lower = tens(ee_box_conf["xyz_lower"])
        xyz_upper = tens(ee_box_conf["xyz_upper"])

    collision = None
    if obstacles_conf.get("enabled", False):
        collision = _CollisionRows(
            ctrl, robot, num_obstacles, float(obstacles_conf.get("minimum_distance", 0.1)),
            device, dtype,
        )

    # projectile-path avoidance: keep named links at least distance_i from
    # the predicted ballistic path of the thrown obstacle (the first dynamic
    # obstacle), gated by the target's s flag
    proj_conf = ctrl.get("projectile_path_constraint", {"enabled": False})
    proj_enabled = bool(proj_conf.get("enabled", False)) and num_obstacles > 0
    proj_links = list(proj_conf.get("collision_links", []))
    proj_distances = np.asarray(proj_conf.get("distances", []), dtype=float)
    proj_scale = float(proj_conf.get("scale", 1.0))
    proj_enabled = proj_enabled and bool(proj_links)
    if proj_enabled:
        names_all = robot.chain.joint_names
        proj_idx = torch.as_tensor([names_all.index(link) for link in proj_links], device=device)
        proj_dist = tens(proj_distances)  # (n_links,)
        proj_w = tens(proj_scale / proj_distances)

    # projectile PLANE variant: keep the EE on the far side of a plane
    # through the projectile, s * (n.(r_ew - r_obs) - w) >= 0
    plane_conf = ctrl.get("projectile_plane_constraint", {"enabled": False})
    plane_enabled = bool(plane_conf.get("enabled", False)) and num_obstacles > 0
    plane_w = float(plane_conf.get("distance", 0.3))
    plane_n_np = np.asarray(plane_conf.get("normal", [0.0, 1.0, 0.0]), dtype=float)
    plane_n = tens(plane_n_np / np.linalg.norm(plane_n_np))

    def _projectile_plane_rows(x, p):
        _rd, _qd, s = interp_target(p)
        r_obs = x[..., rx : rx + 3]
        r_ee = ee_state_of(x).r_ew_w
        d = ((r_ee - r_obs) * plane_n).sum(-1, keepdim=True)
        return s.unsqueeze(-1) * (d - plane_w)

    def _projectile_rows(x, p):
        _rd, _qd, s = interp_target(p)
        s = s.unsqueeze(-1)  # (..., 1)
        x_obs = x[..., rx : rx + 9].unsqueeze(-2)  # (..., 1, 9)
        r_obs, v_obs, a_obs = x_obs[..., 0:3], x_obs[..., 3:6], x_obs[..., 6:9]
        r_link = robot.link_positions(x[..., :nq]).index_select(-2, proj_idx)
        dt_c = _projectile_closest_time(r_link, r_obs, v_obs, a_obs)  # (..., n_links, 1)
        s_l = s.unsqueeze(-1)
        dt_c = torch.where(s_l > 0.5, torch.clamp(dt_c, min=0.0), torch.zeros_like(dt_c))
        r_closest = r_obs + dt_c * v_obs + 0.5 * dt_c**2 * a_obs
        delta = r_link - r_closest
        return proj_w * s * (torch.linalg.vector_norm(delta, dim=-1) - proj_dist)

    # Inequality stack, split so the solver can treat the box-limit block
    # analytically (solver/ocp.py IneqBoxRows): row order is
    # [cones | x_lo | x_hi | u_lo | u_hi | ee_box | alignment | collisions
    #  | projectile | projectile plane].  The box rows have constant
    # +/-identity Jacobians.
    def _ineq_pre(x, u, p):
        # friction cones (frictional mode; frictionless cones are the
        # f >= 0 input bounds), evaluated on the SCALED force variables: the
        # cone rows are positively homogeneous, so this is the physical cone
        # divided by fscale_c, the same feasible set with O(1) rows for every
        # object mass
        if nc > 0 and not frictionless:
            with span("ocp.balance", x.device):
                scen = model.replace(params=p["obj_params"])
                return bal.contact_force_constraints_linearized(
                    scen, u[..., nq:].unflatten(-1, (nc, 3))
                )
        return None

    def _ineq_box(x, u):
        rows = []
        if x_lb is not None:
            xr = x[..., :rx]
            rows.append(xr - x_lb)
            rows.append(x_ub - xr)
        if u_lb is not None:
            rows.append(u - u_lb)
            rows.append(u_ub - u)
        return rows

    def _ineq_post(x, u, p):
        rows = []
        # EE position box around the desired position
        if ee_box_enabled:
            rd, _qd, _s = interp_target(p)
            r_ee = ee_state_of(x).r_ew_w
            rows.append(r_ee - (rd + xyz_lower))
            rows.append((rd + xyz_upper) - r_ee)
        # inertial alignment cone
        if ia_con_enabled:
            a = _alignment_vector(ee_state_of(x))
            a_n = (ia_normal * a).sum(-1, keepdim=True)
            a_t = matvec(ia_span, a)
            t0, t1 = a_t[..., 0:1], a_t[..., 1:2]
            an = ia_alpha * a_n
            rows.append(torch.cat(
                [a_n, an - t0 - t1, an - t0 + t1, an + t0 - t1, an + t0 + t1], dim=-1))
        # collision avoidance: sphere-sphere and sphere-ground distances
        if collision is not None and collision.n_rows:
            rows.append(collision(x))
        # projectile path avoidance
        if proj_enabled:
            rows.append(_projectile_rows(x, p))
        if plane_enabled:
            rows.append(_projectile_plane_rows(x, p))
        return rows

    def _stack(x, rows):
        if not rows:
            return x.new_zeros(x.shape[:-1] + (0,))
        return torch.cat(rows, dim=-1)

    def ineq(x, u, p):
        pre = _ineq_pre(x, u, p)
        return _stack(x, ([pre] if pre is not None else []) + _ineq_box(x, u)
                      + _ineq_post(x, u, p))

    def ineq_smooth(x, u, p):
        pre = _ineq_pre(x, u, p)
        return _stack(x, ([pre] if pre is not None else []) + _ineq_post(x, u, p))

    # named inequality blocks, in stacking order (for diagnostics/logging)
    ineq_groups = []
    if nc > 0 and not frictionless:
        ineq_groups.append(("contact_force_constraints", 5 * nc))
    if x_lb is not None:
        ineq_groups.append(("state_limits", 2 * rx))
    if u_lb is not None:
        ineq_groups.append(("input_limits", 2 * dims.u))
    if ee_box_enabled:
        ineq_groups.append(("ee_box_constraints", 6))
    if ia_con_enabled:
        ineq_groups.append(("alignment_constraints", 5))
    if collision is not None and collision.n_rows:
        ineq_groups.append(("collision_pair_distances", collision.n_rows))
    if proj_enabled:
        ineq_groups.append(("projectile_distances", len(proj_links)))
    if plane_enabled:
        ineq_groups.append(("projectile_plane", 1))
    n_ineq = sum(n for _, n in ineq_groups)

    box_rows = IneqBoxRows(
        n_pre=5 * nc if (nc > 0 and not frictionless) else 0,
        nx_box=rx if x_lb is not None else 0,
        nu_box=dims.u if u_lb is not None else 0,
    )

    # -- terminal constraints -------------------------------------------
    def final_eq(x, p):
        # EE at the desired position, zero velocity/acceleration; the
        # position rows share the ee_error_clamp
        rd, _qd, _s = interp_target(p)
        r_ee = ee_state_of(x).r_ew_w
        v = x[..., nq : 2 * nq]
        a = x[..., 2 * nq : rx]
        return torch.cat([_clamped(r_ee - rd), v, a], dim=-1)

    n_feq = 3 + 2 * nq

    # Stacked-Jacobian differentiation mode (sqp.jac_mode: auto|fwd|rev);
    # "auto" is fwd, as in the reference
    jac_mode = sqp_conf.get("jac_mode", "auto")
    if jac_mode == "auto":
        jac_mode = "fwd"
    if jac_mode not in ("fwd", "rev"):
        raise ValueError(f"sqp.jac_mode must be auto|fwd|rev, got {jac_mode!r}")

    ocp = OCP(
        N=N, nx=dims.x, nu=dims.u, n_eq=n_eq, n_ineq=n_ineq, n_feq=n_feq,
        dynamics=dynamics, stage_cost=stage_cost, eq=eq, ineq=ineq,
        final_eq=final_eq,
        stage_residuals=stage_residuals, stage_quad=stage_quad,
        stage_quad_derivs=stage_quad_derivs,
        ineq_smooth=ineq_smooth, ineq_box=box_rows,
        u_lb=u_lb, u_ub=u_ub,
        # The discrete dynamics are exactly linear (triple integrator +
        # constant-acceleration obstacles), so the solver may linearize once
        # and hand the Riccati kernel one stage-invariant (A, B) pair
        # (sqp.linear_dynamics).
        linear_dynamics=bool(sqp_conf.get("linear_dynamics", False)),
        # x = [q, v, a, obstacle states]: per-block Jacobian columns, so the
        # v/a/obstacle columns skip the rotation-chain JVPs
        x_jac_blocks=(
            (nq, nq, nq) + ((9 * num_obstacles,) if num_obstacles else ())
            if _use_jac_col_blocks(sqp_conf, device)
            else None
        ),
        jac_mode=jac_mode,
        device=device, dtype=dtype,
    )

    # -- initial state + target -----------------------------------------
    obs_states = []
    for d in dyn_obs:
        modes = d.get("modes", [])
        m0 = modes[0] if modes else {}
        obs_states.append(np.concatenate([
            np.asarray(m0.get(key, [0, 0, 0]), dtype=float)
            for key in ("position", "velocity", "acceleration")
        ]))
    x0 = tens(np.concatenate([x0_robot_np] + obs_states)) if obs_states else x0_robot
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
        x0=x0, xd=xd_robot, target=target, gravity=gravity, config=config,
        ineq_groups=ineq_groups,
        heal_jump_threshold=float(
            ctrl.get("mpc", {}).get("heal_jump_threshold", 0.2)
        ),
        force_scale=force_scale,
    )


class _CollisionRows:
    """Robot collision spheres x (static spheres | dynamic obstacles | ground).

    Each robot sphere is attached to a named chain frame with a local offset.
    Rows are sphere-major, and per sphere: the static obstacles, the dynamic
    obstacles, then the ground half-space z >= 0 where it applies, each row
    ``distance - (radius_a + radius_b + minimum_distance)``.  Every row is
    computed at once: one chain sweep, one gather of the sphere centres, one
    distance expression over all (sphere, obstacle) pairs, one gather of the
    rows that exist.
    """

    def __init__(self, ctrl, robot, num_obstacles, min_dist, device, dtype):
        obs_conf = ctrl.get("obstacles", {})
        spheres = obs_conf.get("collision_spheres", [])
        static = obs_conf.get("static_obstacles", [])
        dyn = obs_conf.get("dynamic", [])
        ground_conf = obs_conf.get("ground", {})
        ground = bool(ground_conf.get("enabled", False))
        ground_links = set(ground_conf.get("links", []))

        def tens(a):
            return torch.as_tensor(np.asarray(a, dtype=float), dtype=dtype, device=device)

        names_all = robot.chain.joint_names
        self.chain = robot.chain
        self.nq = robot.nq
        self.rx = 3 * robot.nq
        self.num_obstacles = num_obstacles
        # the distinct frames the spheres hang on, and each sphere's frame
        links = []
        for s in spheres:
            if s["link"] not in links:
                links.append(s["link"])
        self.frame_idx = [names_all.index(link) for link in links]
        self.sphere_frame = torch.as_tensor(
            [links.index(s["link"]) for s in spheres], device=device)
        self.offsets = tens([s.get("offset", [0, 0, 0]) for s in spheres]).reshape(-1, 3)
        rad_a = np.asarray([float(s["radius"]) for s in spheres])
        self.static_pos = tens([o["position"] for o in static]).reshape(-1, 3)
        rad_static = np.asarray([float(o["radius"]) for o in static])
        rad_dyn = np.asarray([float(d.get("radius", 0.1)) for d in dyn[:num_obstacles]])
        rad_b = np.concatenate([rad_static, rad_dyn])
        # (n_spheres, n_static + n_dyn + 1) margins; the last column: ground
        margin = np.concatenate([
            rad_a[:, None] + rad_b[None, :] + min_dist, (rad_a + min_dist)[:, None]], axis=1)
        self.margin = tens(margin)
        # which entries of the (sphere, column) grid are rows, in row order
        n_cols = margin.shape[1]
        keep = []
        for i, s in enumerate(spheres):
            keep.extend(i * n_cols + j for j in range(n_cols - 1))
            if ground and (not ground_links or s["link"] in ground_links):
                keep.append(i * n_cols + n_cols - 1)
        self.keep = torch.as_tensor(keep, dtype=torch.long, device=device)
        self.n_rows = len(keep)

    def __call__(self, x):
        q = x[..., : self.nq]
        lead = q.shape[:-1]
        R, p = self.chain.frame_poses(q, self.frame_idx)
        R = R.index_select(-3, self.sphere_frame)  # (..., n_spheres, 3, 3)
        centres = p.index_select(-2, self.sphere_frame) + matvec(R, self.offsets)
        others = self.static_pos.expand(lead + tuple(self.static_pos.shape))
        if self.num_obstacles:
            dyn = x[..., self.rx :].unflatten(-1, (self.num_obstacles, 9))[..., 0:3]
            others = torch.cat([others, dyn], dim=-2)
        dist = torch.linalg.vector_norm(centres.unsqueeze(-2) - others.unsqueeze(-3), dim=-1)
        grid = torch.cat([dist, centres[..., 2:3]], dim=-1) - self.margin
        return grid.flatten(-2).index_select(-1, self.keep)


def _projectile_closest_time(r, r0, v0, g, iters=10):
    """Time at which a ballistic trajectory r0 + v0 t + g t^2/2 is closest to
    point r: Newton iterations on the cubic stationarity condition from
    t = 0, a fixed iteration count.  Vectors (..., 3); returns (..., 1)."""

    def dot(a, b):
        return (a * b).sum(-1, keepdim=True)

    dr = r - r0
    a = dot(g, g)
    b = 3.0 * dot(v0, g)
    c = 2.0 * (dot(v0, v0) - dot(dr, g))
    d = -2.0 * dot(dr, v0)
    t = torch.zeros_like(d)
    for _ in range(iters):
        f = a * t**3 + b * t**2 + c * t + d
        df = 3 * a * t**2 + 2 * b * t + c
        t = t - f / torch.where(torch.abs(df) > 1e-9, df, torch.full_like(df, 1e-9))
    return t
