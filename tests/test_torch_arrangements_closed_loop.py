"""Closed loops over the harder arrangements on the port: the cases of
tests/test_arrangements_closed_loop.py with the originals' limits, through the
port's closed-loop script (``upright_tpu_torch/scripts/mpc_sim.py``) in
float64 on the CPU, where both kernels' wrappers run their plain versions.

Each runs the full MPC + plant loop and checks that the EE reaches its
waypoint while the objects stay in place; the freespace ablations check the
differential between balancing and unconstrained controllers; the aligned
differential under noise runs, as the original does, in float32 subprocesses
(``upright_tpu_torch/scripts/aligned_differential_study.py`` ``run_leaf``).
All are slow: each is minutes of plain-plant substeps on the CPU.
"""

import copy
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import upright_tpu_torch.config as cfg
from upright_tpu_torch.scripts.mpc_sim import run_closed_loop

CPU64 = dict(device="cpu", dtype=torch.float64)
REPO = Path(__file__).resolve().parents[1]


def _load(path):
    return copy.deepcopy(cfg.load_config(cfg.resolve_package_path({"package": "configs", "path": path})))


def _ur10_with_arrangement(arrangement, waypoint=(-0.25, -0.45, 0.25), frictionless=True):
    """ur10_demo with another arrangement.  The default waypoint is the
    demo's: the home pose is near full extension, so waypoints move back
    toward the base."""
    config = _load("demos/ur10_demo.yaml")
    config["simulation"]["arrangement"] = arrangement
    config["controller"]["balancing"]["arrangement"] = arrangement
    config["controller"]["balancing"]["frictionless"] = frictionless
    config["controller"]["waypoints"] = [
        {"time": 0, "position": list(waypoint), "orientation": [0, 0, 0, 1]}
    ]
    return config


def _target_r(ctrl):
    return ctrl.problem.target.poses[0, :3].numpy()


def _run(config, duration=4.0, disp_tol=0.03, ee_tol=0.1):
    sim, state, ctrl, _ = run_closed_loop(config, duration=duration, ctrl_rate=50.0, **CPU64)
    target_r = _target_r(ctrl)
    _, r_ew = sim.ee_pose(state)
    assert np.linalg.norm(r_ew[0] - target_r) < ee_tol, (
        f"EE {np.round(r_ew[0], 3)} vs target {np.round(target_r, 3)}")
    disp = sim.object_displacements(state)
    assert (disp < disp_tol).all(), f"objects slid: {disp}"
    return sim, state, ctrl


@pytest.mark.slow
def test_closed_loop_arch():
    """Three-block arch: the bridge block touches both pillars."""
    _run(_ur10_with_arrangement("box_arch"))


@pytest.mark.slow
def test_closed_loop_cups():
    """Seven cups on the tray (the largest multi-object arrangement)."""
    _run(_ur10_with_arrangement("blue_cups"))


@pytest.mark.slow
def test_closed_loop_fixture():
    """Box next to a rigid fixture block whose side face supports it
    laterally; frictional, as the reference's fixture experiments."""
    _run(_ur10_with_arrangement("simulation_box_with_fixture", frictionless=False))


@pytest.mark.slow
def test_closed_loop_wedge():
    """Block riding a wedge's sloped top face; the frictional controller
    tilts the tray to keep the minimum feasible friction."""
    _run(_ur10_with_arrangement("wedge", waypoint=(-0.15, -0.3, 0.15), frictionless=False))


@pytest.mark.slow
@pytest.mark.parametrize(
    "leaf,min_disp",
    [
        ("full_dice_point1", None),     # frictional balancing: holds
        ("robust_dice_point1", None),   # frictionless balancing: holds
        ("aligned_dice_point1", None),  # alignment heuristic: holds without noise
        ("none_dice_point1", 0.02),     # no constraints: dice slip
        ("upward_dice_point1", 0.02),   # level tray: dice slip
    ],
)
def test_freespace_ablation_differential(leaf, min_disp):
    """The RA-L'23 freespace ablation: the balancing controllers carry the
    stacked foam dice through the point1 motion with mm displacement, while
    the unconstrained baselines lose grip.  At the production 100 Hz replan
    cadence, as the original."""
    config = _load(f"ral23/freespace/{leaf}.yaml")
    sim, state, _, _ = run_closed_loop(config, duration=4.0, ctrl_rate=100.0, **CPU64)
    disp = sim.object_displacements(state)
    if min_disp is None:
        assert (disp < 0.03).all(), f"controller slid objects: {disp}"
    else:
        assert disp.max() > min_disp, f"ablated baseline unexpectedly held: {disp}"


@pytest.mark.slow
def test_aligned_differential_under_noise():
    """At 0.002 rad/s of process noise the full balancing controller carries
    the stacked dice with mm displacement while the alignment heuristic,
    planning at zero friction margin, loses the top die: aligned displaces
    >= 10x full and beyond the half-tray failure threshold.

    The contrast lives at float32 (in float64 both hold), so each run goes
    through the study's ``run_leaf`` in a float32 subprocess on the CPU.
    The port's noise is a ``torch.Generator`` stream, not the JAX package's
    keys, so the gate reads the median over three seeds (one subprocess per
    seed, in parallel)."""
    seeds = (0, 1, 2)
    script = (
        "import sys, torch\n"
        "from upright_tpu_torch.scripts.aligned_differential_study import run_leaf\n"
        "seed = int(sys.argv[1])\n"
        "kw = dict(knob='process', device='cpu', dtype=torch.float32)\n"
        "full = run_leaf('full', 0.002, seed=seed, **kw)\n"
        "aligned = run_leaf('aligned', 0.002, seed=seed, **kw)\n"
        "print(f'RESULT {full} {aligned}')\n"
    )
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    procs = [subprocess.Popen([sys.executable, "-c", script, str(s)], cwd=str(REPO), env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for s in seeds]
    fulls, aligneds = [], []
    for p in procs:
        out, err = p.communicate(timeout=3600)
        assert p.returncode == 0, err[-2000:]
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT")][0]
        full, aligned = (float(v) for v in line.split()[1:])
        fulls.append(full)
        aligneds.append(aligned)
    full, aligned = float(np.median(fulls)), float(np.median(aligneds))
    assert full < 0.03, f"full balancing lost the dice under noise: {fulls}"
    assert aligned > max(0.07, 10.0 * full), (
        f"aligned ablation unexpectedly held: {aligneds} (full {fulls})")


@pytest.mark.slow
@pytest.mark.parametrize("mode", ["robust", "aligned"])
def test_closed_loop_aligned_failure_stack(mode):
    """extra/aligned_failure: the Thing carries a cardboard box with a bottle
    stacked on top through the point1 motion; in this simulation's friction
    regime both controllers hold the stack, the robust one trading EE
    tracking for constraint satisfaction."""
    config = _load(f"ral23/extra/aligned_failure/{mode}_brown_box_bottle_point1.yaml")
    sim, state, ctrl, _ = run_closed_loop(config, duration=4.0, ctrl_rate=50.0, **CPU64)
    disp = sim.object_displacements(state)
    assert (disp < 0.02).all(), f"stack slid: {disp}"
    _, r_ew = sim.ee_pose(state)
    assert np.linalg.norm(r_ew[0] - _target_r(ctrl)) < 0.35


@pytest.mark.slow
def test_closed_loop_sudden_obstacle():
    """A controlled obstacle jumps into the path at t = 1.0 s: the planner
    re-routes around it (ral23 sudden_obstacle family)."""
    config = _load("ral23/sudden_obstacle/sudden_t1.0.yaml")
    config["simulation"]["duration"] = 4.0
    _run(config, duration=4.0, ee_tol=0.35)
    # the obstacle actually moved (the controlled servo integrated)
    obs = run_closed_loop.last_obstacles[0]
    assert np.linalg.norm(obs.position(4.0) - np.array([1.25, 1.5, 0.25])) < 0.05


@pytest.mark.slow
def test_unreachable_target_with_error_clamp():
    """ral23 arm_only regime: the point waypoints sit about 2 m outside the
    fixed UR10's workspace.  With ee_error_clamp the arm stretches to its
    envelope and the bottle stays; the arm moves toward the target."""
    config = _load("ral23/freespace/full_bottle_arm_only.yaml")
    assert config["controller"]["ee_error_clamp"] == 0.5
    sim, state, ctrl, logger = run_closed_loop(config, duration=5.0, ctrl_rate=100.0, **CPU64)
    disp = float(sim.object_displacements(state)[0, 0])
    assert disp < 0.02, disp
    _, r_ew = sim.ee_pose(state)
    d0 = np.asarray(logger.as_arrays()["r_ew_w"][0])
    target_r = _target_r(ctrl)
    assert np.linalg.norm(r_ew[0] - target_r) < np.linalg.norm(d0 - target_r) - 0.5
