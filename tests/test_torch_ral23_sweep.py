"""The port's ral23 sweep (``upright_tpu_torch/scripts/ral23_sweep.py``)
against the JAX package's (``scripts/ral23_sweep.py``), in float64 on the CPU.

- ``discover_groups`` forms the same groups on every ``configs/ral23/*``
  family;
- one group, ``static_obstacles/full_bottle_point{1,2,3}``, cut to N = 5
  stages and 5 ticks, through both scripts' ``run_group``: the port's one
  closed loop batched over the three targets against the JAX ``vmap`` of its
  device loop.  Before rounding, each leaf's EE error, its objects'
  displacements, max_eq_viol and the final plant state (robot and objects)
  agree to 1e-8, ``failed`` is identical, and the port's rows round as the
  JAX rows do;
- ``main --out`` writes its JSON (with ``_provenance``), its table and the
  stiction mirror beside ``--out`` and nothing else.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import upright_tpu.config as jcfg
import upright_tpu_torch.config as tcfg
from upright_tpu_torch.scripts import ral23_sweep

REPO = Path(__file__).resolve().parents[1]
FAMILIES = sorted(p.name for p in (REPO / "configs" / "ral23").iterdir() if p.is_dir())
N = 5
TICKS = 5
RATE = 100.0
TOL = 1e-8


@pytest.fixture(scope="module")
def jsweep():
    """The JAX script as a module, without its persistent compile cache."""
    import os

    saved = os.environ.get("BENCH_CACHE_DIR")
    os.environ["BENCH_CACHE_DIR"] = ""
    try:
        spec = importlib.util.spec_from_file_location(
            "jax_ral23_sweep", REPO / "scripts" / "ral23_sweep.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        if saved is None:
            os.environ.pop("BENCH_CACHE_DIR")
        else:
            os.environ["BENCH_CACHE_DIR"] = saved
    return module


def cut_loader(load):
    """``load_config`` with each experiment leaf cut to N stages and TICKS
    ticks (both scripts read the horizon and the duration from the leaf)."""

    def load_cut(path, *args, **kwargs):
        config = load(path, *args, **kwargs)
        if kwargs.get("depth", 0) == 0 and "controller" in config and "simulation" in config:
            dt = float(config["controller"].get("sqp", {}).get("dt", 0.1))
            config["controller"].setdefault("mpc", {})["time_horizon"] = N * dt
            config["simulation"]["duration"] = TICKS / RATE
        return config

    return load_cut


@pytest.mark.parametrize("family", FAMILIES)
def test_discover_groups_matches_reference(jsweep, family):
    family_dir = REPO / "configs" / "ral23" / family
    assert ral23_sweep.discover_groups(family_dir) == jsweep.discover_groups(family_dir)


def recording(sim_class, seen):
    """``sim_class`` whose ``object_displacements`` also appends the state it
    is handed (the final plant state of the group, or of one leaf) to
    ``seen``."""

    class Recording(sim_class):
        def object_displacements(self, state):
            seen.append(state)
            return super().object_displacements(state)

    return Recording


def test_run_group_matches_reference(jsweep, monkeypatch):
    monkeypatch.setattr(jsweep.cfg, "load_config", cut_loader(jcfg.load_config))
    monkeypatch.setattr(ral23_sweep.cfg, "load_config", cut_loader(tcfg.load_config))
    tfinal, jfinal = [], []
    monkeypatch.setattr(ral23_sweep, "UprightSimulation",
                        recording(ral23_sweep.UprightSimulation, tfinal))
    monkeypatch.setattr(jsweep, "UprightSimulation", recording(jsweep.UprightSimulation, jfinal))
    # the JAX rows unrounded: its module's ``round`` shadowed by the identity
    monkeypatch.setattr(jsweep, "round", lambda x, ndigits=None: x, raising=False)
    paths = ral23_sweep.discover_groups(REPO / "configs" / "ral23" / "static_obstacles")[
        "full_bottle"]
    stats = {}
    trows = ral23_sweep.run_group("full_bottle", paths, ctrl_rate=RATE, device="cpu",
                                  dtype=torch.float64, stats=stats)
    jrows = jsweep.run_group("full_bottle", paths, ctrl_rate=RATE)
    assert stats["ticks"] == TICKS and stats["batch"] == 3
    assert (stats["nx"], stats["nu"]) == (27, 21)
    assert len(trows) == len(jrows) == len(jfinal) == 3 and len(tfinal) == 1
    tsim = tfinal[0]
    for b, (t, j, jsim) in enumerate(zip(trows, jrows, jfinal)):
        assert t["leaf"] == j["leaf"]
        assert t["failed"] == j["failed"] is False
        assert abs(stats["ee_err_m"][b] - j["ee_err_m"]) <= TOL, (t["leaf"], stats, j)
        assert t["ee_err_m"] == round(j["ee_err_m"], 4)
        assert abs(max(stats["obj_disp_m"][b]) - j["max_obj_disp_m"]) <= TOL, (t["leaf"], stats, j)
        assert t["max_obj_disp_m"] == round(j["max_obj_disp_m"], 4)
        assert abs(t["max_eq_viol"] - j["max_eq_viol"]) <= TOL, (t["leaf"], t, j)
        for field, tval, jval in (
            ("robot q", tsim.q[b], jsim.q), ("robot v", tsim.v[b], jsim.v),
            ("object r", tsim.objects.r[b], jsim.objects.r),
            ("object q", tsim.objects.q[b], jsim.objects.q),
            ("object v", tsim.objects.v[b], jsim.objects.v),
            ("object w", tsim.objects.w[b], jsim.objects.w),
        ):
            err = float(np.abs(tval.numpy() - np.asarray(jval)).max())
            assert err <= TOL, (t["leaf"], field, err)


def test_main_writes_only_beside_out(monkeypatch, tmp_path):
    monkeypatch.setattr(ral23_sweep.cfg, "load_config", cut_loader(tcfg.load_config))
    out = tmp_path / "ral23_results.json"
    results = ral23_sweep.main([
        "--families", "static_obstacles", "--groups", "full_bottle_arm_only",
        "--device", "cpu", "--dtype", "float64", "--out", str(out),
    ])
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "ral23_results.json", "ral23_results.md",
        "ral23_results_stiction.json", "ral23_results_stiction.md"]
    saved = json.loads(out.read_text())
    assert saved["static_obstacles"] == results["static_obstacles"]
    prov = saved["_provenance"]
    assert prov["script"] == "upright_tpu_torch/scripts/ral23_sweep.py"
    assert prov["dtype"] == "torch.float64" and prov["device"] == "cpu"
    assert [r["leaf"] for r in saved["static_obstacles"]] == [
        "ral23/static_obstacles/full_bottle_arm_only.yaml"]
    mirror = json.loads((tmp_path / "ral23_results_stiction.json").read_text())
    assert mirror["_provenance"]["mirror_of"] == "ral23_results.json"
    assert mirror["static_obstacles"] == saved["static_obstacles"]
    assert "static_obstacles — 1 runs" in out.with_suffix(".md").read_text()
