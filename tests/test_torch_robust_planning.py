"""The port's offline robust planning (``upright_tpu_torch/robust/planning.py``)
against the JAX package's, on ur10_demo in float64 on the CPU, where the
port's Riccati and plant wrappers run their plain versions.

- ``plan_robust``, nominal and with the 8 CoM-vertex scenarios stacked in one
  model (nx 18, nu 38), at N = 10 for 5 iterations: the solver fields to
  1e-8, as tests/test_torch_solve.py holds the solve, accept/reject equal;
- ``tracking_sweep`` over 4 parameter sets for 0.2 s (25 ticks of 8 plant
  steps): displacements to 1e-10, as tests/test_torch_sim.py holds the plant;
- ``verify_offline_plan`` of one plan, with and without the realizable set:
  every number to 1e-8, the step count equal.

tests/test_torch_robust_planning_gates.py runs the cases of
tests/test_robust_planning.py on the port.
"""

import numpy as np
import pytest
import torch

import upright_tpu.config as jcfg
import upright_tpu_torch.config as tcfg
from upright_tpu.robust import planning as jplanning
from upright_tpu.sim.simulation import UprightSimulation as JSim
from upright_tpu_torch.robust import planning as tplanning
from upright_tpu_torch.sim.simulation import UprightSimulation as TSim

CPU64 = dict(device="cpu", dtype=torch.float64)
TOL = dict(rtol=1e-8, atol=1e-8)
PATH = {"package": "configs", "path": "demos/ur10_demo.yaml"}
COM_BOX = [[0.01, 0.01, 0.02]]
SWEEP = dict(com_offsets=[[0.0, 0, 0], [0.005, 0.005, 0.0]], mass_scales=[0.9, 1.1],
             inertia_scales=[1.0])


def jconfig():
    return jcfg.load_config(jcfg.resolve_package_path(PATH))


def tconfig():
    return tcfg.load_config(tcfg.resolve_package_path(PATH))


_plans = {}


def plans(case):
    """(JAX (prob, sol, plan), port (prob, sol, plan)) at N = 10, 5 iterations."""
    if case not in _plans:
        ext = COM_BOX if case == "vertex" else None
        kw = dict(com_half_extents=ext, duration=1.0, iterations=5)
        _plans[case] = (jplanning.plan_robust(jconfig(), **kw),
                        tplanning.plan_robust(tconfig(), **kw, **CPU64))
    return _plans[case]


@pytest.mark.parametrize("case", ["nominal", "vertex"])
def test_plan_robust_matches_reference(case):
    (jprob, jsol, jplan), (tprob, tsol, tplan) = plans(case)
    assert (tprob.ocp.nx, tprob.ocp.nu, tprob.ocp.n_eq, tprob.ocp.n_ineq) == (
        jprob.ocp.nx, jprob.ocp.nu, jprob.ocp.n_eq, jprob.ocp.n_ineq)
    if case == "vertex":
        assert tprob.ocp.nu == 38 and tprob.balance_model.num_objects == 8
        np.testing.assert_allclose(tprob.balance_model.params.numpy(),
                                   np.asarray(jprob.balance_model.params), **TOL)
    np.testing.assert_allclose(tplan.X, jplan.X, **TOL)
    np.testing.assert_allclose(tplan.U, jplan.U, **TOL)
    np.testing.assert_allclose(tplan.ts, jplan.ts)
    for f in ("lam", "mu", "lam_f"):
        np.testing.assert_allclose(getattr(tsol.state, f)[0].numpy(),
                                   np.asarray(getattr(jsol.state, f)), err_msg=f, **TOL)
    for f in ("K", "cost", "eq_viol", "ineq_viol", "defect"):
        np.testing.assert_allclose(getattr(tsol, f)[0].numpy(), np.asarray(getattr(jsol, f)),
                                   err_msg=f, **TOL)
    assert (float(tsol.defect[0]) == 0.0) == (float(jsol.defect) == 0.0)
    np.testing.assert_allclose(tplan.dense(125.0), jplan.dense(125.0), **TOL)


def test_tracking_sweep_matches_reference():
    """4 parameter sets (CoM offset x mass scale) tracking the JAX plan for
    0.2 s, batched in one loop over ticks against the JAX vmapped rollout."""
    (_, _, jplan), _ = plans("nominal")
    js = JSim(jconfig()["simulation"])
    ts = TSim(tconfig()["simulation"], **CPU64)
    jsweep = jplanning.make_param_sweep(js, **SWEEP)
    tsweep = tplanning.make_param_sweep(ts, **SWEEP)
    for k in ("mass", "inertia", "mu", "com_offset"):
        np.testing.assert_allclose(tsweep[k].numpy(), np.asarray(jsweep[k]), err_msg=k)
    jd = jplanning.tracking_sweep(js, jplan, jsweep, duration=0.2)
    td = tplanning.tracking_sweep(ts, jplan, tsweep, duration=0.2)
    assert td.shape == jd.shape == (4, 1)
    np.testing.assert_allclose(td, jd, rtol=0, atol=1e-10)


@pytest.mark.parametrize("realizable", [False, True])
def test_verify_offline_plan_matches_reference(realizable):
    """The worst-case CWC certification of one plan (the JAX vertex plan),
    over the CoM box x two inertia scales."""
    (jprob, _, jplan), _ = plans("vertex")
    jnominal = jplanning.build_problem(jconfig(), N=10)
    tnominal = tplanning.build_problem(tconfig(), N=10, **CPU64)
    kw = dict(inertia_scales=(1.0, 0.5), realizable=realizable)
    jout = jplanning.verify_offline_plan(jnominal, jplan, COM_BOX, **kw)
    tout = tplanning.verify_offline_plan(tnominal, jplan, COM_BOX, **kw)
    assert set(tout) == set(jout)
    assert tout["violation_steps"] == jout["violation_steps"]
    assert tout["n_states"] == jout["n_states"] == 11
    for k in jout:
        np.testing.assert_allclose(tout[k], jout[k], err_msg=k, **TOL)


def test_study_config_matches_reference():
    """The port's ral25 study builds the JAX study's configuration."""
    import importlib.util
    from pathlib import Path

    from upright_tpu_torch.scripts import ral25_study

    path = Path(__file__).resolve().parents[1] / "scripts" / "ral25_study.py"
    spec = importlib.util.spec_from_file_location("jax_ral25_study", path)
    jstudy = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jstudy)
    assert (ral25_study.WAYPOINTS, ral25_study.MU, ral25_study.COM_XY) == (
        jstudy.WAYPOINTS, jstudy.MU, jstudy.COM_XY)
    for h in (0.20, 0.28):
        assert ral25_study.build_study_config(h) == jstudy.build_study_config(h)
