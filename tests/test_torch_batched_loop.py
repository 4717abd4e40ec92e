"""The port's device loop batched over targets (``runtime/device_loop.py``
with a stack of targets, ``ocp/reference.py`` ``stack_targets``), on
ur10_demo (N = 5 stages) in float64 on the CPU.

B = 3 closed loops, each with its own waypoint (the demo's, offset by up to
0.2 m, numpy seed 0), run as one batch:

- they equal three batch-1 runs, to 1e-10 (the same arithmetic per
  instance; only the batch's summation orders may differ);
- they equal the JAX package's device loop ``jax.vmap``-ed over the same
  three targets (as scripts/ral23_sweep.py runs a group), from the same warm
  start: joints 1e-8, planned states 1e-7 (tests/test_torch_device_loop.py);
- the warm start's heal gate acts per instance inside the batched tick.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import upright_tpu.config as jcfg
from upright_tpu.ocp.problem import build_problem as jbuild
from upright_tpu.ocp.reference import TargetTrajectory as JTarget
from upright_tpu.runtime.device_loop import build_device_loop as jbuild_loop
from upright_tpu.sim.simulation import UprightSimulation as JSim
from upright_tpu.solver.ocp import SolverState as JState
from upright_tpu_torch.convert import solver_state_to_numpy
from upright_tpu_torch.ocp.problem import build_problem as tbuild
from upright_tpu_torch.ocp.reference import TargetTrajectory, stack_targets
from upright_tpu_torch.runtime.device_loop import build_device_loop
from upright_tpu_torch.sim.simulation import UprightSimulation

CPU64 = dict(device="cpu", dtype=torch.float64)
N = 5
B = 3
TICKS = 5
RATE = 100.0
SAME = dict(rtol=0, atol=1e-10)


@pytest.fixture(scope="module")
def config():
    return jcfg.load_config(
        jcfg.resolve_package_path({"package": "configs", "path": "demos/ur10_demo.yaml"})
    )


@pytest.fixture(scope="module")
def loop(config):
    prob = tbuild(config, N=N, **CPU64)
    sim = UprightSimulation(config["simulation"], **CPU64)
    init_carry, run = build_device_loop(prob, sim, ctrl_rate=RATE)
    offsets = np.random.default_rng(0).uniform(-0.2, 0.2, (B, 3))
    targets = []
    for off in offsets:
        poses = prob.target.poses.clone()
        poses[:, :3] += torch.as_tensor(off)
        targets.append(TargetTrajectory(times=prob.target.times, poses=poses))
    return prob, sim, init_carry, run, targets


@pytest.fixture(scope="module")
def batched_run(loop):
    _, _, init_carry, run, targets = loop
    stack = stack_targets(targets)
    carry0 = init_carry(t0=1.0 / RATE, target=stack)
    carry, metrics = run(carry0, TICKS, target=stack)
    return carry0, carry, metrics


def test_stack_targets_and_batched_stage_params(loop):
    prob, _, _, _, targets = loop
    stack = stack_targets(targets)
    assert stack.times.shape == (B, 1) and stack.poses.shape == (B, 1, 8)
    params = prob.stage_params(0.3, stack)
    for b, target in enumerate(targets):
        one = prob.stage_params(0.3, target)
        for part in ("stage", "final"):
            for k, v in one[part].items():
                assert params[part][k].shape == (B,) + tuple(v.shape), (part, k)
                torch.testing.assert_close(params[part][k][b], v, rtol=0, atol=0)
    with pytest.raises(ValueError, match="waypoint counts"):
        stack_targets([targets[0], TargetTrajectory(times=torch.zeros(2, **CPU64),
                                                    poses=torch.zeros(2, 8, **CPU64))])


def test_batch_equals_single_runs(loop, batched_run):
    """Each instance of the batch, from its own batched cold solve, equals
    the batch-1 loop on its target, tick for tick."""
    _, _, init_carry, run, targets = loop
    carry0, carry, metrics = batched_run
    assert metrics.eq_viol.shape == (TICKS, B) and metrics.cost.shape == (TICKS, B)
    assert metrics.r_ew_w.shape == (TICKS, B, 3)
    for b, target in enumerate(targets):
        c0 = init_carry(t0=1.0 / RATE, target=target)
        np.testing.assert_allclose(carry0.solver.X[b].numpy(), c0.solver.X[0].numpy(), **SAME)
        c, m = run(c0, TICKS, target=target)
        assert m.cost.shape == (TICKS,) and m.r_ew_w.shape == (TICKS, 3)
        np.testing.assert_allclose(carry.sim.q[b].numpy(), c.sim.q[0].numpy(), **SAME)
        np.testing.assert_allclose(carry.a_state[b].numpy(), c.a_state[0].numpy(), **SAME)
        np.testing.assert_allclose(carry.solver.X[b].numpy(), c.solver.X[0].numpy(), **SAME)
        np.testing.assert_allclose(carry.sim.objects.r[b].numpy(), c.sim.objects.r[0].numpy(),
                                   **SAME)
        np.testing.assert_allclose(metrics.r_ew_w[:, b].numpy(), m.r_ew_w.numpy(), **SAME)
        np.testing.assert_allclose(metrics.cost[:, b].numpy(), m.cost.numpy(), rtol=1e-10,
                                   atol=1e-10)
    # the three targets lead the three loops apart
    assert float((carry.sim.q[0] - carry.sim.q[1]).abs().max()) > 1e-4


def test_batch_matches_reference_vmapped_loop(config, loop, batched_run):
    """The JAX device loop, jax.vmap-ed over the same three targets from the
    port's batched cold solve, over the same ticks."""
    _, _, _, _, targets = loop
    carry0, carry, metrics = batched_run
    jinit, jrun = jbuild_loop(jbuild(config, N=N), JSim(config["simulation"]), ctrl_rate=RATE)
    jtargets = JTarget(times=jnp.stack([jnp.asarray(t.times.numpy()) for t in targets]),
                       poses=jnp.stack([jnp.asarray(t.poses.numpy()) for t in targets]))
    warm = solver_state_to_numpy(carry0.solver)
    jstates = JState(**{k: jnp.asarray(v) for k, v in warm.items()})
    jcarry0 = jax.vmap(lambda s, t: jinit(t0=1.0 / RATE, solver_state=s, target=t))(
        jstates, jtargets)
    jcarry, jmetrics = jax.jit(jax.vmap(lambda c, t: jrun(c, TICKS, target=t)))(jcarry0, jtargets)

    np.testing.assert_allclose(carry.sim.q.numpy(), np.asarray(jcarry.sim.q), rtol=0, atol=1e-8)
    np.testing.assert_allclose(carry.a_state.numpy(), np.asarray(jcarry.a_state), rtol=0,
                               atol=1e-7)
    np.testing.assert_allclose(carry.solver.X.numpy(), np.asarray(jcarry.solver.X), rtol=0,
                               atol=1e-7)
    np.testing.assert_allclose(carry.sim.objects.r.numpy(), np.asarray(jcarry.sim.objects.r),
                               rtol=0, atol=1e-8)
    # the reference stacks (B, ticks, ...), the port (ticks, B, ...)
    np.testing.assert_allclose(metrics.r_ew_w.numpy(),
                               np.swapaxes(np.asarray(jmetrics.r_ew_w), 0, 1), rtol=0, atol=1e-8)
    np.testing.assert_allclose(metrics.cost.numpy(), np.asarray(jmetrics.cost).T, rtol=1e-7,
                               atol=1e-9)


def instance(obj, b):
    """Instance b of a batch-first state (tensors, nested dataclasses) as a
    batch of 1; a carry's shared 0-dim time stays as it is."""
    if obj is None or (isinstance(obj, torch.Tensor) and obj.ndim == 0):
        return obj
    if isinstance(obj, torch.Tensor):
        return obj[b : b + 1]
    return dataclasses.replace(obj, **{f.name: instance(getattr(obj, f.name), b)
                                       for f in dataclasses.fields(obj)})


def test_heal_gate_acts_per_instance_in_the_batched_tick(loop, batched_run):
    """One instance's joints jump 0.5 rad (above the 0.2 heal threshold),
    the other two's 0.05 and 0.1 (below): the batched heal equals each
    instance healed alone (re-rolled only the second), and so does one
    batched tick from those joints against three batch-1 ticks."""
    prob, _, _, run, targets = loop
    _, carry, _ = batched_run
    nq = prob.dims.robot_q
    jumps = torch.tensor([0.05, 0.5, 0.1], dtype=torch.float64)
    dq = jumps[:, None] * torch.ones(nq, dtype=torch.float64) / nq**0.5
    x0 = carry.solver.X[:, 0].clone()
    x0[:, :nq] += dq
    healed = prob.heal_warm_start(carry.solver, x0)
    for b in range(B):
        alone = prob.heal_warm_start(instance(carry.solver, b), x0[b : b + 1])
        np.testing.assert_allclose(healed.X[b].numpy(), alone.X[0].numpy(), rtol=0, atol=1e-12)
        rerolled = bool(jumps[b] > prob.heal_jump_threshold)
        assert torch.equal(alone.X[0], carry.solver.X[b]) != rerolled
        head = x0[b] if rerolled else carry.solver.X[b, 0]
        np.testing.assert_allclose(alone.X[0, 0].numpy(), head.numpy(), rtol=0, atol=1e-12)

    bumped = dataclasses.replace(carry, sim=carry.sim.replace(q=carry.sim.q + dq))
    after, _ = run(bumped, 1, target=stack_targets(targets))
    for b, target in enumerate(targets):
        single, _ = run(instance(bumped, b), 1, target=target)
        np.testing.assert_allclose(after.solver.X[b].numpy(), single.solver.X[0].numpy(), **SAME)
        np.testing.assert_allclose(after.sim.q[b].numpy(), single.sim.q[0].numpy(), **SAME)
