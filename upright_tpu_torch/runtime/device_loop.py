"""Steady-state MPC loop kept on the card: replan + policy + plant per tick.

Counterpart of ``upright_tpu/runtime/device_loop.py``.  The reference runs the
loop as one ``lax.scan``, and ``vmap``s it over a batch of targets; here
``run`` is a Python loop over ticks whose every tensor stays on the device,
and a batch of B closed loops, each with its own target, is the leading axis
of every tensor.  Each tick, for all B instances at once:

  observe (the plant's joint state) -> shift/heal the warm start ->
  1-iteration SQP replan (the Riccati kernel) -> LQR policy at tau = 0 ->
  jerk double integration -> plant step (the contact kernel)

so a tick launches each kernel once per SQP iteration whatever B is.  A tick
runs in two spans (``tracing.py``): ``loop.replan`` (observe, shift and heal,
the solve) and ``loop.plant`` (the policy to the EE pose after the plant
step).  The host reads nothing back inside ``run``: the metrics it returns
are device tensors, stacked over the ticks, for the caller to read once.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from upright_tpu_torch.ocp.problem import UprightProblem
from upright_tpu_torch.ocp.reference import TargetTrajectory
from upright_tpu_torch.parallel.batch import broadcast_params
from upright_tpu_torch.sim.simulation import SimState, UprightSimulation
from upright_tpu_torch.solver.al import ALConfig, solve
from upright_tpu_torch.solver.ocp import SolverState, zeros_warm_start
from upright_tpu_torch.tracing import span


@dataclasses.dataclass
class LoopCarry:
    """Device-resident closed-loop state of B instances (B = 1 for one)."""

    t: torch.Tensor  # () time, shared by the batch
    sim: SimState
    solver: SolverState
    a_state: torch.Tensor  # (B, nq) the controller's triple-integrator acceleration belief


@dataclasses.dataclass
class LoopMetrics:
    """Per-replan diagnostics, stacked over the ticks of one ``run``: (n,)
    and (n, 3) for one target, (n, B) and (n, B, 3) for a stack of B."""

    eq_viol: torch.Tensor
    cost: torch.Tensor
    r_ew_w: torch.Tensor  # EE position after the plant step


def _is_stack(target: TargetTrajectory) -> bool:
    return target.times.ndim == 2


def build_device_loop(problem: UprightProblem, sim: UprightSimulation,
                      al_cfg: Optional[ALConfig] = None, ctrl_rate: float = 100.0,
                      use_feedback_policy: bool = True):
    """Build (init_carry, run) for the closed loop on the problem's device.

    ``run(carry, n_replans, target=None)`` executes n_replans control cycles
    at ``ctrl_rate`` and returns (carry, LoopMetrics).  Every tick replans (the
    100 Hz replan cadence).  ``target`` is one ``TargetTrajectory`` (the
    problem's by default) or a stack of B of them
    (``ocp.reference.stack_targets``): then ``init_carry(target=...)`` makes
    the carry of B loops, each with its own target, and ``run`` takes the same
    stack.  The plant must have been built on the problem's device with its
    dtype.

    Restriction: dynamic-obstacle problems need host-fed estimates; this loop
    covers the num_obstacles == 0 workloads.
    """
    ocp = problem.ocp
    dev = ocp.device
    if sim.device.type != dev.type or sim.dtype != ocp.dtype:
        raise ValueError(f"the plant lives on {sim.device} as {sim.dtype} and the problem on "
                         f"{dev} as {ocp.dtype}: build both on one device with one dtype")
    if problem.dims.num_obstacles:
        raise ValueError(
            "device loop supports obstacle-free problems; dynamic obstacles need host-fed estimates"
        )
    cfg = al_cfg or ALConfig(iterations=1)
    dt_ctrl = 1.0 / ctrl_rate
    n_sub = max(1, int(round(dt_ctrl / sim.timestep)))
    nq = problem.dims.robot_q
    # same whole-node rounding as ControllerManager.step
    shift = float(round(dt_ctrl / problem.dt))

    def params_at(t, target):
        """Stage parameters with the leading batch axis: a stack's own, or
        B = 1 for one target."""
        params = problem.stage_params(t, target)
        return params if _is_stack(target) else broadcast_params(params, 1)

    def tick(carry: LoopCarry, target):
        with span("loop.replan", dev):
            x = torch.cat([carry.sim.q, carry.sim.v, carry.a_state], dim=-1)
            warm = problem.heal_warm_start(problem.shift_warm_start(carry.solver, shift), x)
            sol = solve(ocp, cfg, params_at(carry.t, target), x, warm, device=dev,
                        dtype=ocp.dtype)

        with span("loop.plant", dev):
            # policy at tau = 0 (immediately after the replan): k = 0, alpha = 0
            u = sol.state.U[:, 0]
            if use_feedback_policy:
                u = u + (sol.K[:, 0] @ (x - sol.state.X[:, 0]).unsqueeze(-1)).squeeze(-1)
            j = u[:, :nq]

            v_cmd = carry.sim.v + dt_ctrl * carry.a_state + 0.5 * dt_ctrl**2 * j
            a_next = carry.a_state + dt_ctrl * j
            sim_next = sim.step(carry.sim, v_cmd, n_steps=n_sub)

            _, r_ew = sim.robot.ee_pose(sim_next.q)
            next_carry = LoopCarry(t=carry.t + dt_ctrl, sim=sim_next, solver=sol.state,
                                   a_state=a_next)
        return next_carry, (sol.eq_viol, sol.cost, r_ew)

    def run(carry: LoopCarry, n_replans: int, target=None):
        """target: optional TargetTrajectory override, one or a stack of B."""
        target = problem.target if target is None else target
        rows = []
        for _ in range(n_replans):
            carry, row = tick(carry, target)
            rows.append(row if _is_stack(target) else tuple(col[0] for col in row))
        eq_viol, cost, r_ew = (torch.stack(col) for col in zip(*rows))
        return carry, LoopMetrics(eq_viol=eq_viol, cost=cost, r_ew_w=r_ew)

    def init_carry(t0=0.0, sim_state: Optional[SimState] = None,
                   solver_state: Optional[SolverState] = None, target=None) -> LoopCarry:
        """Carry from a warm-started solver state; without one, a cold solve
        of 12 iterations from rest at the plant's joint state, of all the
        stack's instances at once."""
        tgt = problem.target if target is None else target
        B = tgt.times.shape[0] if _is_stack(tgt) else 1
        if sim_state is None:
            sim_state = sim.initial_state(batch=B)
        a0 = torch.zeros((B, nq), dtype=ocp.dtype, device=dev)
        if solver_state is None:
            x0 = torch.cat([sim_state.q, sim_state.v, a0], dim=-1)
            warm_cfg = dataclasses.replace(cfg, iterations=12)
            solver_state = solve(
                ocp, warm_cfg, params_at(t0, tgt), x0,
                zeros_warm_start(ocp, x0, device=dev, dtype=ocp.dtype), device=dev,
                dtype=ocp.dtype,
            ).state
        return LoopCarry(
            t=torch.as_tensor(float(t0), dtype=ocp.dtype, device=dev),
            sim=sim_state, solver=solver_state, a_state=a0,
        )

    return init_carry, run
