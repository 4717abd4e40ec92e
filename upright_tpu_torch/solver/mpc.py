"""MPC manager: warm-started re-solving + policy evaluation.

Counterpart of ``upright_tpu/solver/mpc.py``.  The solver state (trajectories
+ AL multipliers) persists across re-solves: a warm-started 1-iteration SQP at
the replan rate, after one high-iteration cold solve.  Policy evaluation
interpolates the plan and applies the time-varying LQR feedback gains.

The reference jits two closures; here they are eager calls of the port's
``solve`` on one instance (batch 1): shift, then heal, then solve for a
replan, and the ``warmstart_iterations`` cold solve for ``warmstart``.  On the
card each solve launches the Riccati kernel once per SQP iteration.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from upright_tpu_torch.ocp.problem import UprightProblem, build_problem
from upright_tpu_torch.ocp.reference import TargetTrajectory
from upright_tpu_torch.parallel.batch import broadcast_params
from upright_tpu_torch.solver.al import ALConfig, solve
from upright_tpu_torch.solver.ocp import SolverState, zeros_warm_start
from upright_tpu_torch.solver.trajectory import StateInputTrajectory, TrajectoryInterpolator


@dataclasses.dataclass
class MPCSettings:
    """Runtime MPC settings (the controller config's mpc/sqp/solver blocks)."""

    replan_interval: float = 0.01  # min time between re-solves (100 Hz cap)
    iterations: int = 1  # SQP iterations per replan
    warmstart_iterations: int = 12  # iterations for the initial solve
    rho_eq: float = 10.0
    rho_ineq: float = 10.0
    # dual safeguarding of the cold solve (see ALConfig)
    dual_update_every: int = 1
    dual_step: float = 1.0
    lam_max: float = 1e3  # equality-multiplier bound (windup safeguard)
    # zero stale duals when the warm start's violation exceeds this
    dual_reset_violation: float = 10.0
    use_feedback_policy: bool = True
    line_search_steps: tuple = (1.0, 0.5, 0.25, 0.1, 0.03, 0.01, 0.003, 0.001)

    @staticmethod
    def from_config(ctrl_conf):
        sqp = ctrl_conf.get("sqp", {})
        tracking = ctrl_conf.get("tracking", {})
        solver = ctrl_conf.get("solver", {})
        return MPCSettings(
            replan_interval=float(tracking.get("min_policy_update_time", 0.01)),
            iterations=int(sqp.get("sqp_iteration", 1)),
            warmstart_iterations=int(solver.get("warmstart_iterations", 12)),
            rho_eq=float(solver.get("rho_eq", 10.0)),
            rho_ineq=float(solver.get("rho_ineq", 10.0)),
            dual_update_every=int(solver.get("dual_update_every", 1)),
            dual_step=float(solver.get("dual_step", 1.0)),
            lam_max=float(solver.get("lam_max", 1e3)),
            dual_reset_violation=float(solver.get("dual_reset_violation", 10.0)),
            use_feedback_policy=bool(sqp.get("use_feedback_policy", True)),
        )

    def al_config(self) -> ALConfig:
        """The replan-path ALConfig these settings denote: the one source of
        the solver settings of every closed loop (ControllerManager, and the
        device loop as its callers build it)."""
        return ALConfig(
            iterations=self.iterations,
            rho_eq=self.rho_eq,
            rho_ineq=self.rho_ineq,
            lam_max=self.lam_max,
            dual_reset_violation=self.dual_reset_violation,
            line_search_steps=tuple(self.line_search_steps),
        )


def _sync(device):
    """Wait for the work queued on the calling thread's current stream: the
    default stream, or a planner thread's own (runtime/tracker.py), whose
    solves then never wait for the plant's launches."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


class ControllerManager:
    """Owns the problem and the solver state; ``warmstart()``,
    ``step(t, x) -> (xd, u)``, ``plan(...)``.  The device and dtype are the
    problem's."""

    def __init__(self, problem: UprightProblem, settings: Optional[MPCSettings] = None):
        self.problem = problem
        self.settings = settings or MPCSettings.from_config(problem.config["controller"])
        self.device, self.dtype = problem.ocp.device, problem.ocp.dtype

        self._cfg = self.settings.al_config()
        # the initial (cold) solve additionally applies the configured dual
        # safeguarding; the warm-started replan keeps the plain one-step update
        self._warm_cfg = dataclasses.replace(
            self._cfg,
            iterations=self.settings.warmstart_iterations,
            dual_update_every=self.settings.dual_update_every,
            dual_step=self.settings.dual_step,
        )

        self.state: Optional[SolverState] = None
        self.solution = None
        self.last_plan_time = -np.inf
        self.target = problem.target
        self.replanning_durations = []  # seconds per solve, between synchronisations

        # operating points: a saved plan used as the initial solver guess
        self._operating_traj: Optional[StateInputTrajectory] = None
        op_conf = problem.config["controller"].get("operating_points", {})
        if op_conf.get("enabled", False):
            self._operating_traj = StateInputTrajectory.load(op_conf["path"])

    @classmethod
    def from_config(cls, config, settings: Optional[MPCSettings] = None, device="cuda",
                    dtype=torch.float32):
        return cls(build_problem(config, device=device, dtype=dtype), settings)

    # -- lifecycle -------------------------------------------------------

    def reset(self, target: Optional[TargetTrajectory] = None):
        if target is not None:
            self.target = target
        self.state = None
        self.solution = None
        self.last_plan_time = -np.inf

    def set_operating_points(self, traj: StateInputTrajectory):
        """Use a saved plan as the initial solver guess."""
        self._operating_traj = traj

    def _x(self, x):
        """One state as a (1, nx) tensor of the problem."""
        return torch.as_tensor(x, dtype=self.dtype, device=self.device).reshape(1, -1)

    def _params(self, t):
        return broadcast_params(self.problem.stage_params(t, self.target), 1)

    def _solve(self, cfg, params, x, state):
        _sync(self.device)
        t_start = time.perf_counter()
        sol = solve(self.problem.ocp, cfg, params, x, state, device=self.device, dtype=self.dtype)
        _sync(self.device)
        self.replanning_durations.append(time.perf_counter() - t_start)
        return sol

    def _initial_guess(self, t, x):
        """Cold-start state (x a (1, nx) tensor), seeded from the
        operating-point trajectory when one is configured."""
        state = zeros_warm_start(self.problem.ocp, x, device=self.device, dtype=self.dtype)
        traj = self._operating_traj
        if traj is None:
            return state
        N, dt = self.problem.ocp.N, self.problem.dt
        interp = TrajectoryInterpolator(traj, self.problem.dims.robot_q)
        samples = [interp.interpolate(t + k * dt) for k in range(N + 1)]
        X = np.stack([s[0] for s in samples])
        U = np.stack([s[1] for s in samples[:-1]])
        nx, nu = self.problem.ocp.nx, self.problem.ocp.nu
        if X.shape[1] != nx or U.shape[1] != nu:
            raise ValueError(
                f"operating-point trajectory dims {X.shape[1]}/{U.shape[1]} "
                f"do not match problem dims {nx}/{nu}"
            )
        X = torch.as_tensor(X, dtype=self.dtype, device=self.device)[None]
        X = torch.cat([x.unsqueeze(1), X[:, 1:]], dim=1)
        return state.replace(X=X, U=torch.as_tensor(U, dtype=self.dtype, device=self.device)[None])

    def warmstart(self, t=0.0, x=None):
        """Initial high-iteration solve."""
        x = self._x(self.problem.x0 if x is None else x)
        sol = self._solve(self._warm_cfg, self._params(t), x, self._initial_guess(t, x))
        self.state = sol.state
        self.solution = sol
        self.last_plan_time = t
        return sol

    # -- control loop ----------------------------------------------------

    def step(self, t, x):
        """Advance the MPC (replan if due) and evaluate the policy at (t, x).

        Returns (xd, u) as numpy: desired state and input, with the LQR
        feedback applied if enabled."""
        if self.state is None:
            self.warmstart(t, x)
        elif t >= self.last_plan_time + self.settings.replan_interval:
            self.replan(t, x)
        return self.evaluate_policy(t, x)

    def replan(self, t, x):
        """One warm-started replan at (t, x): shift, heal, solve."""
        # round to whole nodes: inputs are piecewise-constant per shooting
        # interval, so a converged warm start stays exactly feasible under
        # sub-interval replanning (shift 0), while a full-node advance rolls
        # the trajectory so the 1-iteration SQP starts aligned
        shift = round((t - self.last_plan_time) / self.problem.dt)
        x_t = self._x(x)
        warm = self.problem.heal_warm_start(self.problem.shift_warm_start(self.state, shift), x_t)
        sol = self._solve(self._cfg, self._params(t), x_t, warm)
        self.state = sol.state
        self.solution = sol
        self.last_plan_time = t
        return sol

    def evaluate_policy(self, t, x):
        """Interpolate the plan at time t; optionally add LQR feedback."""
        sol = self.solution
        tau = (t - self.last_plan_time) / self.problem.dt
        k = int(np.clip(np.floor(float(tau)), 0, self.problem.ocp.N - 1))
        alpha = float(np.clip(float(tau) - k, 0.0, 1.0))

        X, U = sol.state.X[0], sol.state.U[0]
        xd = (1 - alpha) * X[k] + alpha * X[k + 1]
        u = U[k]
        if self.settings.use_feedback_policy:
            u = u + sol.K[0, k] @ (self._x(x)[0] - X[k])
        return xd.cpu().numpy(), u.cpu().numpy()

    def plan(self, timestep, duration, t0=0.0, x0=None) -> StateInputTrajectory:
        """Construct a plan by rolling the MPC forward, feeding the planned
        state back as the observation (each step observes the previous
        planned x, so the policy is pure feedforward)."""
        x = np.asarray(self.problem.x0.cpu().numpy() if x0 is None else x0, dtype=float)
        if self.state is None:
            self.warmstart(t0, x)
        nq = self.problem.dims.robot_q
        rx = self.problem.dims.robot_x
        ts, xs, us = [], [], []
        t = float(t0)
        h = float(timestep)
        while t <= t0 + duration + 1e-9:
            _xd, u = self.step(t, x)
            ts.append(t)
            xs.append(x)
            us.append(np.asarray(u))
            # advance the observation by exact integration of the triple
            # integrator under the returned jerk, and of each obstacle's
            # constant acceleration
            q, v, a = x[:nq], x[nq : 2 * nq], x[2 * nq : rx]
            j = np.asarray(u, dtype=float)[:nq]
            parts = [
                q + h * v + 0.5 * h**2 * a + h**3 / 6.0 * j,
                v + h * a + 0.5 * h**2 * j,
                a + h * j,
            ]
            for i in range(self.problem.dims.num_obstacles):
                ro, vo, ao = (x[rx + 9 * i + k : rx + 9 * i + k + 3] for k in (0, 3, 6))
                parts += [ro + h * vo + 0.5 * h**2 * ao, vo + h * ao, ao]
            x = np.concatenate(parts)
            t += h
        return StateInputTrajectory(ts=np.asarray(ts), xs=np.asarray(xs), us=np.asarray(us))
