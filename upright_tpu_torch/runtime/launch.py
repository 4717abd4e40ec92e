"""Multi-process orchestration: the planner as a separate OS process.

Counterpart of ``upright_tpu/runtime/launch.py``.  The reference splits its
runtime across ROS nodes started by launch files
(upright_ros_interface/launch/mpc_mrt_simulation.launch: mpc_node +
mrt_node + simulation, joined by ROS topics).  Here the same split is a
real OS-process boundary without ROS: the planner node owns the card and
runs MPC solves in its own process; the plant/executor process sends
observations and receives policies over a multiprocessing Pipe (the
latest-message-wins semantics of a queue_size=1 ROS topic).

Protocol (parent -> child):    ("obs", t, x) | ("stop",)
         (child -> parent):    ("ready", warmup_seconds) once, then
                               ("policy", t0, dt, X, U, K) after every solve.

The child is started with the "spawn" method (CUDA cannot be used in a
forked child) and touches the card only after it has started: it builds its
``ControllerManager`` on ``device`` (the card in float32 by default, the CPU
in float64 when asked).
"""

from __future__ import annotations

import multiprocessing as mp
import time
from typing import Optional

import numpy as np

from upright_tpu_torch import resolve_device
from upright_tpu_torch.runtime.tracker import Policy


def _planner_main(config_path, conn, min_update_time, device):
    import torch

    import upright_tpu_torch.config as cfg
    from upright_tpu_torch.runtime.tracker import AsyncPlanner
    from upright_tpu_torch.solver.mpc import ControllerManager

    config = cfg.load_config(config_path)
    dtype = torch.float64 if device == "cpu" else torch.float32
    ctrl = ControllerManager.from_config(config, device=device, dtype=dtype)
    planner = AsyncPlanner(ctrl, min_update_time=min_update_time)

    def drain():
        """Apply all pending messages; return False once 'stop' arrives."""
        while conn.poll():
            msg = conn.recv()
            if msg[0] == "stop":
                return False
            if msg[0] == "obs":
                planner.set_observation(msg[1], msg[2])
        return True

    # wait for the first observation, then run both solve paths once
    while conn.poll(0.05) is False:
        pass
    if not drain():
        return
    t0 = time.perf_counter()
    planner.solve_once()  # warm-start path
    planner.solve_once()  # 1-iteration replan path
    conn.send(("ready", time.perf_counter() - t0))
    pol = planner.get_policy()
    conn.send(("policy", pol.t0, pol.dt, pol.X, pol.U, pol.K))

    last = -np.inf
    running = True
    while running:
        running = drain()
        if not running:
            break
        now = time.perf_counter()
        if now - last < min_update_time:
            time.sleep(min_update_time / 10)
            continue
        if planner.solve_once():
            last = time.perf_counter()
            pol = planner.get_policy()
            conn.send(("policy", pol.t0, pol.dt, pol.X, pol.U, pol.K))
        else:
            time.sleep(1e-3)


class PlannerNode:
    """Parent-side handle on the planner process (the mpc_node role).
    ``device`` is where the child solves: the card unless "cpu" is asked."""

    def __init__(self, config_path, min_update_time=0.01, device="cuda"):
        device = str(resolve_device(device))  # raises here, without a card
        ctx = mp.get_context("spawn")
        self._conn, child_conn = ctx.Pipe()
        self._proc = ctx.Process(
            target=_planner_main,
            args=(str(config_path), child_conn, min_update_time, device),
            daemon=True,
        )
        self._proc.start()
        child_conn.close()
        self._policy = None
        self.compile_seconds: Optional[float] = None  # the child's first two solves

    def set_observation(self, t, x):
        self._conn.send(("obs", float(t), np.asarray(x, dtype=float)))

    def wait_ready(self, timeout=600.0):
        """Block until the child has run both solve paths (sends 'ready')."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if not self._proc.is_alive():
                raise RuntimeError("planner process died during startup")
            if self._conn.poll(0.1):
                msg = self._conn.recv()
                if msg[0] == "ready":
                    self.compile_seconds = msg[1]
                    return
                self._store_policy(msg)
        raise TimeoutError("planner did not become ready in time")

    def _store_policy(self, msg):
        if msg[0] == "policy":
            _, t0, dt, X, U, K = msg
            self._policy = Policy(t0=t0, dt=dt, X=X, U=U, K=K)

    def get_policy(self):
        """Latest policy received so far (drains the pipe)."""
        while self._conn.poll():
            self._store_policy(self._conn.recv())
        return self._policy

    def stop(self, timeout=10.0):
        try:
            self._conn.send(("stop",))
        except (BrokenPipeError, OSError):
            pass
        self._proc.join(timeout)
        if self._proc.is_alive():
            self._proc.terminate()
            self._proc.join(timeout)

    @property
    def alive(self):
        return self._proc.is_alive()
