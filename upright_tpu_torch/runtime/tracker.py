"""Planner/tracker runtime: asynchronous MPC with a high-rate tracking loop.

Counterpart of ``upright_tpu/runtime/tracker.py``.  Replaces the reference's
two-process ROS runtime (mpc_node planner + 125 Hz mrt_node tracker,
upright_ros_interface/src/{mpc,mrt}_node.cpp).  Instead of ROS topics, the
planner and tracker share a lock-swapped policy buffer; the solve runs in a
background thread.  On the card that thread queues its launches on a stream
of its own, so the plant's launches on the default stream never wait behind a
replan, and it waits for that stream alone before it publishes.  Rate
decoupling matches the reference: the tracker evaluates the last policy at
its own rate while replans land when ready (min_policy_update_time cap,
mrt_node.cpp:350-363).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional

import numpy as np
import torch

from upright_tpu_torch.runtime.estimator import robot_kf
from upright_tpu_torch.runtime.safety import SafetyMonitor


@dataclasses.dataclass
class Policy:
    """An MPC solution snapshot the tracker can evaluate lock-free."""

    t0: float
    dt: float
    X: np.ndarray  # (N+1, nx)
    U: np.ndarray  # (N, nu)
    K: np.ndarray  # (N, nu, nx)

    def evaluate(self, t, x, use_feedback=True):
        tau = (t - self.t0) / self.dt
        k = int(np.clip(np.floor(tau), 0, self.U.shape[0] - 1))
        alpha = float(np.clip(tau - k, 0.0, 1.0))
        xd = (1 - alpha) * self.X[k] + alpha * self.X[k + 1]
        u = self.U[k].copy()
        if use_feedback:
            u = u + self.K[k] @ (np.asarray(x) - self.X[k])
        return xd, u


class TrackingController:
    """The 125 Hz inner loop (mrt_node semantics), stepped explicitly so it
    can run against the simulated plant, wall-clock hardware, or tests.

    Each tick: KF predict/correct on [q, v, a] -> policy evaluation ->
    state feedback u_cmd = K(xd - x) + u -> jerk double-integration into the
    velocity command -> safety gate (mrt_node.cpp:206-366).
    """

    def __init__(self, nq, rate, safety: Optional[SafetyMonitor] = None,
                 kp=0.0, kv=0.0, ka=0.0, use_kf=True,
                 estimation_conf: Optional[dict] = None, x0=None):
        self.nq = nq
        self.dt = 1.0 / rate
        self.safety = safety
        self.kp, self.kv, self.ka = kp, kv, ka
        self.use_kf = use_kf
        est = estimation_conf or {}
        self.kf = robot_kf(
            nq,
            self.dt,
            init_variance=float(est.get("robot_init_variance", 0.1)),
            process_variance=float(est.get("robot_process_variance", 10.0)),
            measurement_variance=float(est.get("robot_measurement_variance", 1e-3)),
            x0=x0,
        )
        self._last_u = np.zeros(nq)
        self.braked = False
        self.brake_reason = ""

    def tick(self, t, q_meas, v_meas, policy: Policy):
        """One tracking step; returns (v_cmd, x_est, u_cmd).

        A safety violation latches `braked` and commands zero velocity."""
        if self.braked:
            return np.zeros(self.nq), self.kf.x, np.zeros(self.nq)

        if self.use_kf:
            self.kf.predict(self._last_u)
            self.kf.correct(np.concatenate([q_meas, v_meas]))
            x = self.kf.x.copy()
        else:
            x = np.concatenate([q_meas, v_meas, self.kf.x[2 * self.nq :]])

        xd, u = policy.evaluate(t, x)
        u_cmd = u[: self.nq].copy()

        # optional extra PD feedback (zero when the LQR policy is used,
        # config/controller.yaml:36-42)
        if self.kp or self.kv or self.ka:
            nq = self.nq
            u_cmd = u_cmd + (
                self.kp * (xd[:nq] - x[:nq])
                + self.kv * (xd[nq : 2 * nq] - x[nq : 2 * nq])
                + self.ka * (xd[2 * nq : 3 * nq] - x[2 * nq : 3 * nq])
            )

        if self.safety is not None:
            ok, reason = self.safety.check(x, u_cmd)
            if not ok:
                self.braked = True
                self.brake_reason = reason
                return np.zeros(self.nq), x, np.zeros(self.nq)

        # double-integrate jerk into a velocity command (mrt_node.cpp:337-348)
        nq = self.nq
        v = x[nq : 2 * nq]
        a = x[2 * nq : 3 * nq]
        v_cmd = v + self.dt * a + 0.5 * self.dt**2 * u_cmd

        self._last_u = u_cmd
        return v_cmd, x, u_cmd


class AsyncPlanner:
    """Background replanning thread: pulls the latest observation, solves,
    and publishes a Policy of host arrays (the mpc_node role,
    mpc_node.cpp:16-50).  The solves run on the manager's device."""

    def __init__(self, controller_manager, min_update_time=0.01):
        self.ctrl = controller_manager
        self.min_update_time = min_update_time
        self._obs = None
        self._policy: Optional[Policy] = None
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.error: Optional[Exception] = None
        dev = controller_manager.device
        self._stream = torch.cuda.Stream(device=dev) if dev.type == "cuda" else None

    # -- observation in / policy out ------------------------------------

    def set_observation(self, t, x):
        with self._lock:
            self._obs = (float(t), np.asarray(x, dtype=float).copy())

    def get_policy(self) -> Optional[Policy]:
        with self._lock:
            return self._policy

    # -- planner loop ----------------------------------------------------

    def _publish(self, t):
        sol = self.ctrl.solution
        policy = Policy(
            t0=t,
            dt=self.ctrl.problem.dt,
            X=sol.state.X[0].cpu().numpy(),
            U=sol.state.U[0].cpu().numpy(),
            K=sol.K[0].cpu().numpy(),
        )
        with self._lock:
            self._policy = policy

    def solve_once(self):
        """Synchronous single replan (also used by tests)."""
        with self._lock:
            obs = self._obs
        if obs is None:
            return False
        t, x = obs
        # the manager waits for the calling thread's current stream: this
        # planner's own on the card
        with torch.cuda.stream(self._stream):  # a no-op for None (the CPU)
            if self.ctrl.state is None:
                self.ctrl.warmstart(t, x)
            else:
                self.ctrl.replan(t, x)
            self._publish(t)
        return True

    def _run(self):
        last = -np.inf
        while not self._stop.is_set():
            now = time.perf_counter()
            if now - last < self.min_update_time:
                time.sleep(self.min_update_time / 10)
                continue
            try:
                solved = self.solve_once()
            except Exception as exc:  # surface planner faults to the caller
                self.error = exc
                break
            if solved:
                last = time.perf_counter()
            else:
                time.sleep(1e-3)

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            # a solve may be in flight; wait generously so the interpreter
            # never tears down a thread inside the runtime
            self._thread.join(timeout=60.0)
