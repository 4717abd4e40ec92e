"""The port's closed loop kept on the device (``upright_tpu_torch/runtime/
device_loop.py``) against the port's host loop and against the JAX package's
``build_device_loop``, on ur10_demo (N = 5 stages) in float64 on the CPU.

The device loop replans, applies the policy, integrates the jerk and steps the
plant (the contact substeps through ``advance_objects``, the plain version on
CPU tensors) every tick.  Tolerances as the JAX package holds its own device
loop to its host loop (tests/test_device_loop.py): robot joints 1e-8, the
acceleration belief and the planned states 1e-7; against the JAX loop the
same, and the bottle's state 1e-8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import upright_tpu.config as jcfg
from upright_tpu.ocp.problem import build_problem as jbuild
from upright_tpu.runtime.device_loop import build_device_loop as jbuild_loop
from upright_tpu.sim.simulation import UprightSimulation as JSim
from upright_tpu.solver.ocp import SolverState as JState
from upright_tpu_torch.convert import solver_state_to_numpy
from upright_tpu_torch.ocp.problem import build_problem as tbuild
from upright_tpu_torch.runtime.device_loop import build_device_loop
from upright_tpu_torch.sim.simulation import UprightSimulation
from upright_tpu_torch.solver.mpc import ControllerManager

CPU64 = dict(device="cpu", dtype=torch.float64)
N = 5
TICKS = 5
RATE = 100.0


@pytest.fixture(scope="module")
def config():
    return jcfg.load_config(
        jcfg.resolve_package_path({"package": "configs", "path": "demos/ur10_demo.yaml"})
    )


@pytest.fixture(scope="module")
def port_device_run(config):
    """The port's device loop: cold solve at t0 = one tick, then TICKS ticks."""
    prob = tbuild(config, N=N, **CPU64)
    sim = UprightSimulation(config["simulation"], **CPU64)
    init_carry, run = build_device_loop(prob, sim, ctrl_rate=RATE)
    carry0 = init_carry(t0=1.0 / RATE)
    carry, metrics = run(carry0, TICKS)
    return carry0, carry, metrics


def test_device_loop_matches_host_loop(config, port_device_run):
    """The host loop (ControllerManager.step + UprightSimulation.step, the
    mpc_sim loop) from the same start, tick for tick."""
    dt = 1.0 / RATE
    sim = UprightSimulation(config["simulation"], **CPU64)
    ctrl = ControllerManager(tbuild(config, N=N, **CPU64))
    state = sim.initial_state()
    nq = sim.robot.nq
    a_state = np.zeros(nq)
    ctrl.warmstart(0.0, np.concatenate([state.q[0].numpy(), state.v[0].numpy(), a_state]))
    n_sub = max(1, int(round(dt / sim.timestep)))
    t = dt
    for _ in range(TICKS):
        q, v = sim.measure(state)
        x = np.concatenate([q[0].numpy(), v[0].numpy(), a_state])
        _xd, u = ctrl.step(t, x)
        v_cmd = v[0].numpy() + dt * a_state + 0.5 * dt**2 * u[:nq]
        a_state = a_state + dt * u[:nq]
        state = sim.step(state, torch.as_tensor(v_cmd), n_steps=n_sub)
        t += dt

    _, carry, metrics = port_device_run
    np.testing.assert_allclose(carry.sim.q[0].numpy(), state.q[0].numpy(), rtol=0, atol=1e-8)
    np.testing.assert_allclose(carry.a_state[0].numpy(), a_state, rtol=0, atol=1e-7)
    np.testing.assert_allclose(carry.solver.X.numpy(), ctrl.state.X.numpy(), rtol=0, atol=1e-7)
    np.testing.assert_allclose(carry.sim.objects.r.numpy(), state.objects.r.numpy(),
                               rtol=0, atol=1e-8)
    assert metrics.cost.shape == (TICKS,) and torch.isfinite(metrics.cost).all()
    assert torch.isfinite(metrics.eq_viol).all() and metrics.r_ew_w.shape == (TICKS, 3)


def test_device_loop_matches_reference_loop(config, port_device_run):
    """The JAX package's device loop (one jitted scan) from the same cold
    solve, over the same ticks."""
    carry0, carry, metrics = port_device_run
    jp = jbuild(config, N=N)
    jsim = JSim(config["simulation"])
    init_carry, run = jbuild_loop(jp, jsim, ctrl_rate=RATE)
    warm = solver_state_to_numpy(carry0.solver)
    jstate = JState(**{k: jnp.asarray(v[0]) for k, v in warm.items()})
    jcarry, jmetrics = jax.jit(run, static_argnums=1)(
        init_carry(t0=1.0 / RATE, solver_state=jstate), TICKS)

    np.testing.assert_allclose(carry.sim.q[0].numpy(), np.asarray(jcarry.sim.q), rtol=0, atol=1e-8)
    np.testing.assert_allclose(carry.a_state[0].numpy(), np.asarray(jcarry.a_state),
                               rtol=0, atol=1e-7)
    np.testing.assert_allclose(carry.solver.X[0].numpy(), np.asarray(jcarry.solver.X),
                               rtol=0, atol=1e-7)
    np.testing.assert_allclose(carry.sim.objects.r[0].numpy(), np.asarray(jcarry.sim.objects.r),
                               rtol=0, atol=1e-8)
    np.testing.assert_allclose(carry.sim.objects.v[0].numpy(), np.asarray(jcarry.sim.objects.v),
                               rtol=0, atol=1e-7)
    np.testing.assert_allclose(metrics.r_ew_w.numpy(), np.asarray(jmetrics.r_ew_w),
                               rtol=0, atol=1e-8)
    np.testing.assert_allclose(metrics.cost.numpy(), np.asarray(jmetrics.cost),
                               rtol=1e-7, atol=1e-9)


@pytest.mark.slow
def test_device_loop_closed_loop_converges(config):
    """4 s on the port's device loop (full horizon): the EE reaches the
    waypoint, the bottle stays put, the balance equalities settle in the
    1e-3 regime (the JAX package's own gate, tests/test_device_loop.py)."""
    prob = tbuild(config, **CPU64)
    sim = UprightSimulation(config["simulation"], **CPU64)
    init_carry, run = build_device_loop(prob, sim, ctrl_rate=RATE)
    carry, metrics = run(init_carry(), 400)
    target_r = prob.target.poses[0, :3].numpy()
    assert np.linalg.norm(metrics.r_ew_w[-1].numpy() - target_r) < 0.1
    disp = sim.object_displacements(carry.sim)
    assert (disp < 0.03).all(), f"object slid: {disp}"
    assert float(metrics.eq_viol[-1]) < 1e-3
