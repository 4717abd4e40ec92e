"""The benchmark's one traffic generator.

A traffic file (``traffic/<name>.json``) names its ``kind`` and its
parameters; this module turns it, a configuration and a seed into the work
of a cell, drives the program (``upright_tpu_torch``) through its normal
entry, and keeps, for a sample of instances drawn from the seed, what went
into each timed unit and what came out, for ``check.py`` to judge.

Kinds:

``solve``  a batch of independent MPC instances, each at x0 = the
           configuration's x0 + ``x0_noise_std`` N(0, 1); set-up runs a
           ``cold_iterations`` cold solve from there and ``warm_calls`` warm
           calls; one unit is one call of ``parallel.batch.batch_solve_fn``'s
           solve with the traffic's ``al`` settings, fed the previous call's
           state (a closed loop of one caller) and each instance's x0 moved
           by a fresh ``x0_step_std`` N(0, 1), as a replan's measured state
           moves (drawn on the card from the seed).  Work of a unit: B
           instance-solves.
``loop``   B closed loops through ``runtime.device_loop.build_device_loop``,
           each with its own target (the configuration's waypoints offset by
           U(-``target_offset``, ``target_offset``) m per axis), the
           controller settings of the configuration, replanning at
           ``ctrl_rate`` Hz, the configuration's plant; set-up runs the
           loop's cold solve (12 iterations from rest, as ``init_carry``
           does) and ``warm_ticks`` ticks; one unit is
           ``run(carry, 1, target)``.  Work of a unit: B instance-ticks.

Both read nothing back inside a unit.  The program is imported inside
``setup``, never when this module is imported.  Inside a unit, the
program's call runs in the profiler span ``bench.program`` and, once
``start_window`` has been called, between two CUDA events on the card; what
the harness itself does there (the next input, the sampled rows for the
check) lies outside both.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
from torch.profiler import record_function

from benchmark.trace import PROGRAM_SPAN

COLD_ITERATIONS = 12  # the device loop's cold solve (build_device_loop's init_carry)

def _rows(tree, idx):
    """The rows ``idx`` of every tensor of a dataclass / dict tree."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree.index_select(0, idx) if tree.ndim else tree.clone()
    if isinstance(tree, dict):
        return {k: _rows(v, idx) for k, v in tree.items()}
    return {f.name: _rows(getattr(tree, f.name), idx) for f in dataclasses.fields(tree)}


class _Traffic:
    kind = None

    def __init__(self, cell, seed, device="cuda", samples=None):
        self.traffic = cell.traffic
        self.conf = cell.config["config"]
        self.B = cell.batch
        self.seed = int(seed)
        self.device = torch.device(device)
        self.dtype = {"float32": torch.float32, "float64": torch.float64}[cell.config["dtype"]]
        n_s = int(self.traffic["samples_per_unit"] if samples is None else samples)
        self.n_samples = min(n_s, self.B)
        rng = np.random.default_rng([self.seed, 1])
        # instances judged after unit k: a fresh draw per unit, from the seed
        self._idx_np = np.stack([rng.choice(self.B, self.n_samples, replace=False)
                                 for _ in range(64)])
        n_cold = min(int(self.traffic["cold_samples_per_iteration"]), self.B)
        rng = np.random.default_rng([self.seed, 2])
        self._cold_idx_np = np.stack([rng.choice(self.B, n_cold, replace=False)
                                      for _ in range(64)])
        self.records = []  # (unit index, instances, input rows, output rows)
        self.units = 0
        self.nonfinite = None
        self.marks = None  # (start, end) CUDA events of each program call in the window

    def start_window(self):
        self.marks = []

    def _call(self, fn, *args):
        """``fn(*args)``, the program's call, and the host seconds it took to
        return (before any synchronisation)."""
        timed = self.marks is not None and self.device.type == "cuda"
        if timed:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        with record_function(PROGRAM_SPAN):
            t0 = time.perf_counter()
            out = fn(*args)
            dispatch = time.perf_counter() - t0
        if timed:
            end.record()
            self.marks.append((start, end))
        return out, dispatch

    def cold_solve(self, first, rest, params, x0, state, n):
        """Set-up's cold solve, one SQP iteration a call: ``first(params, x0,
        state)`` for the first iteration, ``rest`` for the others (the same
        arithmetic as one call of ``n`` iterations, whose multiplier watchdog
        looks only before the first), with the sampled rows of every
        iteration kept for the check."""
        self.cold_records = []
        sol = None
        table = torch.as_tensor(self._cold_idx_np, device=self.device)
        for it in range(n):
            idx = table[it % table.shape[0]]
            before = _rows(state, idx)
            before["x0"] = x0.index_select(0, idx)
            sol = (first if it == 0 else rest)(params, x0, state)
            after = {"state": _rows(sol.state, idx), "K": sol.K.index_select(0, idx)}
            self.cold_records.append((it, idx, before, after))
            state = sol.state
        return sol

    def sample_idx(self, k):
        if not hasattr(self, "_idx"):
            self._idx = torch.as_tensor(self._idx_np, device=self.device)
        return self._idx[k % self._idx.shape[0]]


class SolveTraffic(_Traffic):
    kind = "solve"

    def setup(self):
        from upright_tpu_torch.ocp.problem import build_problem
        from upright_tpu_torch.parallel.batch import (
            batch_solve_fn,
            batch_warm_starts,
            broadcast_params,
        )
        from upright_tpu_torch.solver.al import ALConfig

        tr = self.traffic
        self.prob = build_problem(self.conf, device=self.device, dtype=self.dtype)
        ocp = self.prob.ocp
        al = dict(tr["al"])
        al["line_search_steps"] = tuple(al["line_search_steps"])
        self.al_cfg = ALConfig(**al)
        rng = np.random.default_rng([self.seed, 0])
        x0 = self.prob.x0.cpu().double().numpy()[None, :] + tr["x0_noise_std"] * rng.standard_normal(
            (self.B, ocp.nx))
        self.x0_host = x0.astype(np.float32)  # the inputs both sides take
        self.x0s = torch.as_tensor(self.x0_host, dtype=self.dtype, device=self.device)
        self.params = broadcast_params(self.prob.stage_params(0.0), self.B)
        self.solve = batch_solve_fn(ocp, self.al_cfg, device=self.device, dtype=self.dtype)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(self.seed)
        self.x0_step = float(tr["x0_step_std"])
        self.sol = self.cold_solve(self.solve, self.solve, self.params, self.x0s,
                                   batch_warm_starts(ocp, self.x0s, self.device, self.dtype),
                                   int(tr["cold_iterations"]))
        for _ in range(int(tr["warm_calls"])):
            self.sol = self.solve(self.params, self._x0(), self.sol.state)
        self.nonfinite = torch.zeros((), dtype=torch.long, device=self.device)

    def _x0(self):
        z = torch.randn(self.x0s.shape, generator=self.gen, device=self.device, dtype=self.dtype)
        return self.x0s + self.x0_step * z

    def unit(self):
        """One timed call: returns the host seconds of the call into the
        solve (the dispatch), before any synchronisation."""
        idx = self.sample_idx(self.units)
        x0 = self._x0()
        before = _rows(self.sol.state, idx)
        before["x0"] = x0.index_select(0, idx)
        self.sol, dispatch = self._call(self.solve, self.params, x0, self.sol.state)
        s = self.sol
        after = {"state": _rows(s.state, idx), "K": s.K.index_select(0, idx),
                 "cost": s.cost.index_select(0, idx), "eq_viol": s.eq_viol.index_select(0, idx)}
        self.records.append((self.units, idx, before, after))
        self.nonfinite += (~torch.isfinite(s.cost)).sum()
        self.units += 1
        return dispatch

    def iterations_per_unit(self):
        return self.al_cfg.iterations

    def release(self):
        """Drop the program's batch state (before the reference runs)."""
        self.sol = self.params = self.x0s = None


class LoopTraffic(_Traffic):
    kind = "loop"

    def setup(self):
        from upright_tpu_torch.ocp.problem import build_problem
        from upright_tpu_torch.ocp.reference import TargetTrajectory
        from upright_tpu_torch.runtime.device_loop import build_device_loop
        from upright_tpu_torch.sim.simulation import UprightSimulation
        from upright_tpu_torch.solver.al import solve
        from upright_tpu_torch.solver.mpc import MPCSettings
        from upright_tpu_torch.solver.ocp import zeros_warm_start

        tr = self.traffic
        self.prob = build_problem(self.conf, device=self.device, dtype=self.dtype)
        self.sim = UprightSimulation(self.conf["simulation"], device=self.device, dtype=self.dtype)
        settings = MPCSettings.from_config(self.conf["controller"])
        self.al_cfg = settings.al_config()
        init_carry, self.run = build_device_loop(
            self.prob, self.sim, al_cfg=self.al_cfg, ctrl_rate=float(tr["ctrl_rate"]),
            use_feedback_policy=settings.use_feedback_policy)
        rng = np.random.default_rng([self.seed, 0])
        off = float(tr["target_offset"])
        self.offsets = rng.uniform(-off, off, (self.B, 3)).astype(np.float32)
        base = self.prob.target
        n_wp = base.times.shape[-1]
        poses = base.poses.unsqueeze(0).repeat(self.B, 1, 1)
        poses[:, :, :3] += torch.as_tensor(self.offsets, dtype=self.dtype,
                                           device=self.device).unsqueeze(1)
        self.target = TargetTrajectory(times=base.times.expand(self.B, n_wp).contiguous(),
                                       poses=poses)
        # the loop's 12-iteration cold solve from rest (init_carry's), run
        # one iteration a call so that the check can follow it
        ocp = self.prob.ocp
        sim0 = self.sim.initial_state(batch=self.B)
        x0 = torch.cat([sim0.q, sim0.v, torch.zeros_like(sim0.q)], dim=-1)
        one = dataclasses.replace(self.al_cfg, iterations=1)
        plain = dataclasses.replace(one, dual_reset_violation=None)

        def solver(cfg):
            return lambda p, x, s: solve(ocp, cfg, p, x, s, device=self.device, dtype=self.dtype)

        sol = self.cold_solve(solver(one), solver(plain), self.prob.stage_params(0.0, self.target),
                              x0, zeros_warm_start(ocp, x0, device=self.device, dtype=self.dtype),
                              COLD_ITERATIONS)
        self.carry = init_carry(t0=0.0, sim_state=sim0, solver_state=sol.state,
                                target=self.target)
        for _ in range(int(tr["warm_ticks"])):
            self.carry, _ = self.run(self.carry, 1, target=self.target)
        self.nonfinite = torch.zeros((), dtype=torch.long, device=self.device)

    def _carry_rows(self, idx):
        c = self.carry
        return {"t": c.t.clone(), "sim": _rows(c.sim, idx), "solver": _rows(c.solver, idx),
                "a_state": c.a_state.index_select(0, idx)}

    def unit(self):
        idx = self.sample_idx(self.units)
        before = self._carry_rows(idx)
        (self.carry, m), dispatch = self._call(self.run, self.carry, 1, self.target)
        after = self._carry_rows(idx)
        after.update(eq_viol=m.eq_viol[0].index_select(0, idx),
                     cost=m.cost[0].index_select(0, idx), r_ew=m.r_ew_w[0].index_select(0, idx))
        self.records.append((self.units, idx, before, after))
        self.nonfinite += (~torch.isfinite(m.r_ew_w[0]).all(-1)).sum()
        self.units += 1
        return dispatch

    def iterations_per_unit(self):
        return self.al_cfg.iterations

    def release(self):
        self.carry = self.target = None


KINDS = {"solve": SolveTraffic, "loop": LoopTraffic}


def make(cell, seed, device="cuda", samples=None):
    kind = cell.traffic["kind"]
    if kind not in KINDS:
        raise KeyError(f"traffic kind {kind!r} is not one of {sorted(KINDS)}")
    return KINDS[kind](cell, seed, device=device, samples=samples)
