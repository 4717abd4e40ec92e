"""The three cases of tests/test_robust_planning.py, run on the port
(``upright_tpu_torch/robust/planning.py``) with their original limits, in
float64 on the CPU (the plain versions of the Riccati and plant kernels).

Apart from tests/test_torch_robust_planning.py (the parity against the JAX
package) because the 2 s tracking sweep alone takes about two minutes on the
port's plain plant here: the two files run on two workers.
"""

import numpy as np
import torch

import upright_tpu_torch.config as tcfg
from upright_tpu_torch.robust import planning as tplanning
from upright_tpu_torch.sim.simulation import UprightSimulation as TSim

CPU64 = dict(device="cpu", dtype=torch.float64)


def tconfig():
    return tcfg.load_config(
        tcfg.resolve_package_path({"package": "configs", "path": "demos/ur10_demo.yaml"}))


_port_nominal = {}


def port_nominal_plan():
    """The nominal plan of the first and the last case (one call for both)."""
    if not _port_nominal:
        _port_nominal["plan"] = tplanning.plan_robust(tconfig(), duration=2.0, iterations=30,
                                                      **CPU64)
    return _port_nominal["plan"]


def test_nominal_offline_plan():
    prob, sol, plan = port_nominal_plan()
    assert plan.X.shape[0] == 21
    assert float(sol.eq_viol) < 0.05
    # plan reaches toward the waypoint
    target = prob.target.poses[0, :3].numpy()
    _, r_end = prob.robot.ee_pose(torch.as_tensor(plan.X[-1][: prob.robot.nq]))
    assert np.linalg.norm(r_end.numpy() - target) < 0.1


def test_vertex_scenario_plan_expands_model():
    prob, sol, plan = tplanning.plan_robust(
        tconfig(), com_half_extents=[[0.01, 0.01, 0.02]], duration=2.0, iterations=30, **CPU64
    )
    # 8 scenario objects, 48 equality rows
    assert prob.ocp.n_eq == 48
    assert np.isfinite(plan.X).all()
    assert float(sol.eq_viol) < 0.2


def test_tracking_sweep_nominal():
    """P-control tracking of the nominal plan keeps the bottle in place for
    nominal and perturbed parameters."""
    prob, sol, plan = port_nominal_plan()
    sim = TSim(tconfig()["simulation"], **CPU64)
    sweep = tplanning.make_param_sweep(
        sim,
        com_offsets=[[0.0, 0, 0], [0.005, 0.005, 0.0]],
        mass_scales=[0.9, 1.1],
        inertia_scales=[1.0],
    )
    disp = tplanning.tracking_sweep(sim, plan, sweep, kp=10.0, ctrl_rate=125.0)
    assert disp.shape == (4, 1)
    assert (disp < 0.05).all(), disp

