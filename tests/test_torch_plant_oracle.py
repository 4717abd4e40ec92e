"""The port's plant against the independent contact integrator: the cases of
tests/test_plant_oracle.py with the originals' limits, on the port's
``UprightSimulation`` in float64 on the CPU (the contact wrapper runs its
plain version there).

The oracle (``tests/plant_oracle.py``) is a from-scratch numpy
sequential-impulse solver, the algorithm family of the reference's PyBullet
plant.  Both plants are driven by the same prescribed tray motion (no
controller, no robot) from the same nominal arrangement, and must agree on the
held / slid / tipped outcome of each balanced object, in scenarios chosen away
from the friction and tipping knife edges.
"""

import types

import numpy as np
import pytest
import torch

import upright_tpu_torch.config as cfg
from upright_tpu_torch.core.math import quat_to_rot
from upright_tpu_torch.kinematics.chain import FrameMotion
from upright_tpu_torch.sim.simulation import ObjectsState, SimState, UprightSimulation

from plant_oracle import OracleWorld, classify, oracle_outcomes

CPU64 = dict(device="cpu", dtype=torch.float64)
DT = 1e-3


# -- shared scenario plumbing ------------------------------------------------


def make_sim(arrangement, friction_model="stiction"):
    base = cfg.load_config(cfg.resolve_package_path({"package": "configs", "path": "simulation.yaml"}))
    ur10 = cfg.load_config(cfg.resolve_package_path({"package": "configs", "path": "robots/ur10.yaml"}))
    sc = dict(base)
    sc["arrangement"] = arrangement
    sc["robot"] = ur10["simulation"]["robot"]
    sc["friction_model"] = friction_model
    sc["timestep"] = DT
    return UprightSimulation(sc, **CPU64)


def prescribe(sim, accel):
    """Tray frame: identity rotation at the origin, constant world
    acceleration ``accel`` from rest (accel = 0: static)."""
    a = torch.as_tensor(np.asarray(accel, dtype=float))

    def pm(self, t, q, v):
        lead = t.shape
        tt = t.unsqueeze(-1)
        z = torch.zeros(lead + (3,), dtype=t.dtype)
        return FrameMotion(R=torch.eye(3, dtype=t.dtype).expand(lead + (3, 3)),
                           p=0.5 * a * tt * tt, v=a * tt, w=z, a=a.expand(lead + (3,)), al=z)

    sim._parent_motion = types.MethodType(pm, sim)


def tray_motion(accel):
    a = np.asarray(accel, dtype=float)

    def fn(t):
        return np.eye(3), 0.5 * a * t * t, a * t, np.zeros(3)

    return fn


def plant_state(sim):
    """The nominal arrangement placed at the tray frame (I, 0): the initial
    state with the prescribed frame in place of the robot's pose."""
    s0 = sim.initial_state(1)
    r = torch.as_tensor(np.stack([sp.com_world_ee for sp in sim.specs]))[None]
    q = torch.as_tensor(np.stack([sp.q_init for sp in sim.specs]))[None]
    objects = s0.objects.replace(r=r, q=q)
    assert isinstance(objects, ObjectsState)
    return SimState(t=s0.t, q=s0.q, v=torch.zeros_like(s0.q), objects=objects)


def plant_outcomes(sim, state, accel, T):
    """(disp, tilt, class) per object after running the port's plant."""
    R_t = np.eye(3)
    p_t = 0.5 * np.asarray(accel, dtype=float) * T * T
    r = state.objects.r[0].numpy()
    diverged = state.objects.diverged[0].numpy()
    out = []
    for i, sp in enumerate(sim.specs):
        r_e = R_t.T @ (r[i] - p_t)
        disp = float(np.linalg.norm(r_e - np.asarray(sp.com_world_ee)))
        R0 = quat_to_rot(torch.as_tensor(np.asarray(sp.q_init, dtype=float))).numpy()
        R1 = quat_to_rot(state.objects.q[0, i]).numpy()
        z0, z1 = R0 @ np.array([0.0, 0, 1]), R1 @ np.array([0.0, 0, 1])
        tilt = float(np.arccos(np.clip(z0 @ z1, -1.0, 1.0)))
        if diverged[i]:
            disp = np.inf
        out.append((disp, tilt, classify(disp, tilt)))
    return out


def run_plant(arrangement, accel, T, friction_model="stiction"):
    sim = make_sim(arrangement, friction_model)
    prescribe(sim, accel)
    s1 = sim.step(plant_state(sim), torch.zeros(sim.robot.nq), n_steps=int(round(T / DT)))
    return sim, plant_outcomes(sim, s1, accel, T)


def run_both(arrangement, accel, T, pgs_iters=25):
    sim, plant = run_plant(arrangement, accel, T)
    world = OracleWorld.from_specs(sim.specs, np.eye(3), np.zeros(3), pgs_iters=pgs_iters)
    com_nom = [np.asarray(sp.com_world_ee, dtype=float) for sp in sim.specs]
    R_init = [quat_to_rot(torch.as_tensor(np.asarray(sp.q_init, dtype=float))).numpy()
              for sp in sim.specs]
    motion = tray_motion(accel)
    world.run(T, DT, motion)
    oracle = oracle_outcomes(world, motion(T), com_nom, R_init)
    return plant, oracle


def assert_agree(plant, oracle, expect=None):
    p_cls = [c for _, _, c in plant]
    o_cls = [c for _, _, c in oracle]
    assert p_cls == o_cls, f"plant {plant} vs oracle {oracle}: outcome classes disagree"
    if expect is not None:
        assert p_cls == expect, f"plant {plant}, expected {expect}"


# -- scenarios ---------------------------------------------------------------


@pytest.mark.slow
def test_dice_stack_hold_stationary():
    plant, oracle = run_both("foam_die2", [0.0, 0, 0], 2.0)
    assert_agree(plant, oracle, expect=["held", "held"])


@pytest.mark.slow
def test_dice_stack_hold_below_slide_threshold():
    # tray mu = 0.54: slide threshold 5.3 m/s^2; 2.0 is decisively below
    plant, oracle = run_both("foam_die2", [2.0, 0, 0], 0.6)
    assert_agree(plant, oracle, expect=["held", "held"])


@pytest.mark.slow
def test_dice_stack_tips_above_threshold():
    # 8 m/s^2 exceeds both limits of the 2-die stack; the stack's tipping
    # threshold (4.9 m/s^2) binds before the slide threshold (5.3)
    plant, oracle = run_both("foam_die2", [8.0, 0, 0], 0.35)
    assert_agree(plant, oracle, expect=["tipped", "tipped"])


@pytest.mark.slow
def test_arch_hold_stationary():
    plant, oracle = run_both("box_arch", [0.0, 0, 0], 2.0)
    assert_agree(plant, oracle, expect=["held", "held", "held"])


@pytest.mark.slow
def test_arch_slides_above_threshold():
    # tray mu = 0.30: threshold 2.94 m/s^2; 6 is decisive; every block is
    # dislodged in both plants
    plant, oracle = run_both("box_arch", [6.0, 0, 0], 0.4)
    plant_cls = [c for _, _, c in plant]
    oracle_cls = [c for _, _, c in oracle]
    assert plant_cls == oracle_cls, (plant, oracle)
    assert all(c in ("slid", "tipped") for c in plant_cls), plant


@pytest.mark.slow
def test_wedge_hold_stationary():
    # box on the 15 deg incline: tan(15 deg) = 0.268 < mu = 0.30, it rests
    plant, oracle = run_both("wedge", [0.0, 0, 0], 2.0)
    assert_agree(plant, oracle, expect=["held", "held"])


@pytest.mark.slow
def test_wedge_slides_under_lateral_acceleration():
    # 6 m/s^2 is 2x the wedge-tray slide threshold (mu g = 2.94)
    plant, oracle = run_both("wedge", [6.0, 0, 0], 0.4)
    plant_cls = [c for _, _, c in plant]
    oracle_cls = [c for _, _, c in oracle]
    assert plant_cls == oracle_cls, (plant, oracle)
    assert any(c in ("slid", "tipped") for c in plant_cls), plant


@pytest.mark.slow
def test_long_quasistatic_hold():
    """30 s stationary stacked-dice hold under stiction: guards the
    resting-contact damping instability and anchor-drag ratcheting; true
    static friction holds a quiescent stack indefinitely, so the gate is
    mm-scale after 30 s."""
    _, out = run_plant("foam_die2", [0.0, 0, 0], 30.0)
    disps = [d for d, _, _ in out]
    tilts = [t for _, t, _ in out]
    assert max(disps) < 2e-3, f"stacked dice crept over 30 s: {out}"
    assert max(tilts) < np.radians(2.0), f"stacked dice tilted: {out}"
