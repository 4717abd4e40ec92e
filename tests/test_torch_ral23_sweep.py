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

Slow, at full length: the two freespace groups whose outcome the JAX record
and the port disagreed on, in float64 through both scripts; the knife-edge
leaf ``robust_arch_arm_only`` from starts a rounding step apart in each
package; and its float32 departure from float64 in both packages.
"""

import importlib.util
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
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


class Recorder:
    """Stand-in for the ``jax`` module in the JAX script: ``jit`` records what
    each jitted call returns (its last call returns the loop's (final carry,
    metrics)); every other name is ``jax``'s own."""

    def __init__(self, jax_module):
        self._jax = jax_module
        self.returned = []

    def __getattr__(self, name):
        return getattr(self._jax, name)

    def jit(self, fn, *args, **kwargs):
        jitted = self._jax.jit(fn, *args, **kwargs)

        def call(*a, **kw):
            out = jitted(*a, **kw)
            self.returned.append(out)
            return out

        return call


# The float64 EE paths of the two packages: aligned_dice's within 1e-12 over
# all 500 ticks; robust_arch_arm_only's (an unreachable waypoint) part by
# rounding alone, the gap growing smoothly, by about 10x every 20 ticks
# (past 1e-12 at tick 47, 1e-10 at 85, 1e-8 at 130, 0.1 m at 274)
F1_AGREE_TICKS = 80
F1_AGREE_TOL = 1e-8


@pytest.mark.slow
@pytest.mark.parametrize("group", ["aligned_dice", "robust_arch_arm_only"])
def test_freespace_f1_leaves_match_reference_at_full_length(jsweep, monkeypatch, group):
    """The two freespace leaves whose outcome the JAX record (matmul
    precision "high") and the port on the card disagree on (ROADMAP F1), at
    full length (5 s, 500 ticks) through both scripts' ``run_group`` in
    float64 on the CPU: ``failed`` per leaf is the same, and the EE paths
    agree over the first ticks.  Prints the first tick at which the EE paths
    part by each of 1e-12 ... 1e-1 m."""
    import jax

    recorder = Recorder(jax)
    monkeypatch.setattr(jsweep, "jax", recorder)
    monkeypatch.setattr(jsweep, "round", lambda x, ndigits=None: x, raising=False)
    runs = []
    build = ral23_sweep.build_device_loop

    def recording_build(*args, **kwargs):
        init_carry, run = build(*args, **kwargs)

        def recording_run(*a, **kw):
            runs.append(run(*a, **kw))
            return runs[-1]

        return init_carry, recording_run

    monkeypatch.setattr(ral23_sweep, "build_device_loop", recording_build)
    paths = ral23_sweep.discover_groups(REPO / "configs" / "ral23" / "freespace")[group]
    stats = {}
    trows = ral23_sweep.run_group(group, paths, device="cpu", dtype=torch.float64, stats=stats)
    jrows = jsweep.run_group(group, paths)
    assert stats["ticks"] == 500
    t_path = runs[-1][1].r_ew_w.numpy().transpose(1, 0, 2)  # (B, ticks, 3)
    j_path = np.asarray(recorder.returned[-1][1].r_ew_w)  # (B, ticks, 3), the vmap's
    gap = np.abs(t_path - j_path).max(-1)
    for b, (t, j) in enumerate(zip(trows, jrows)):
        firsts = {tol: int(np.argmax(gap[b] > tol)) if (gap[b] > tol).any() else None
                  for tol in (1e-12, 1e-10, 1e-8, 1e-6, 1e-4, 1e-2, 1e-1)}
        print(f"{t['leaf']}: port failed {t['failed']} (disp {max(stats['obj_disp_m'][b]):.4g} m, "
              f"ee_err {stats['ee_err_m'][b]:.4g} m), JAX failed {j['failed']} (disp "
              f"{j['max_obj_disp_m']:.4g} m, ee_err {j['ee_err_m']:.4g} m); first tick the EE "
              f"paths part by more than: {firsts}")
    for b, (t, j) in enumerate(zip(trows, jrows)):
        assert t["leaf"] == j["leaf"]
        assert t["failed"] == j["failed"], (t, j)
        assert gap[b, :F1_AGREE_TICKS].max() <= F1_AGREE_TOL, (t["leaf"], gap[b, :F1_AGREE_TICKS])


# One realisation of tools/ral23_rounding.py's leaf through the JAX script's
# ``run_group`` on the CPU at matmul precision "highest": argv repo, seed (the
# plant's home pose moved as that tool moves it), dtype
JAX_REALISATION = r"""
import importlib.util, json, os, sys
os.environ["BENCH_CACHE_DIR"] = ""
import jax
repo, seed, dtype = sys.argv[1], int(sys.argv[2]), sys.argv[3]
jax.config.update("jax_enable_x64", dtype == "float64")
jax.config.update("jax_default_matmul_precision", "highest")
sys.path.insert(0, repo)
spec = importlib.util.spec_from_file_location(
    "jax_ral23_sweep", os.path.join(repo, "scripts", "ral23_sweep.py"))
sweep = importlib.util.module_from_spec(spec)
spec.loader.exec_module(sweep)
import upright_tpu.config as jcfg
from upright_tpu_torch.tools.ral23_rounding import FAMILY, GROUP, HOME_EPS, perturbed_loader
sweep.cfg.load_config = perturbed_loader(jcfg.load_config, seed)
sweep.round = lambda x, ndigits=None: x
rows = sweep.run_group(GROUP, sweep.discover_groups(FAMILY)[GROUP])
print("REALISATION " + json.dumps({
    "group": GROUP, "seed": seed, "home_eps": HOME_EPS, "device": "cpu", "dtype": dtype,
    "leaves": [{"leaf": r["leaf"], "failed": bool(r["failed"]), "ee_err_m": float(r["ee_err_m"]),
                "max_obj_disp_m": float(r["max_obj_disp_m"])} for r in rows]}))
"""
F1_ROUNDING_SEEDS = range(12)


def realisation(package, seed, dtype):
    """One realisation of ``robust_arch_arm_only`` on the CPU in a process of
    its own (one thread a process for the port): the JSON that it prints."""
    if package == "jax":
        cmd = [sys.executable, "-c", JAX_REALISATION, str(REPO), str(seed), dtype]
    else:
        cmd = [sys.executable, str(REPO / "upright_tpu_torch" / "tools" / "ral23_rounding.py"),
               "--seeds", str(seed), "--device", "cpu", "--dtype", dtype]
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    out = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=3600, check=True)
    line = next(x for x in out.stdout.splitlines() if x.startswith("REALISATION "))
    return json.loads(line[len("REALISATION "):])


@pytest.mark.slow
@pytest.mark.parametrize("package", ["jax", "port"])
def test_robust_arch_arm_only_is_a_draw_of_rounding(package):
    """``robust_arch_arm_only`` at full length through one package's
    ``run_group`` on the CPU, in float32 and in float64, from 12 starts that
    differ by about one float32 rounding step (``tools/ral23_rounding.py``;
    seed 0 is the config as it stands), six processes at a time: among its 24
    realisations the package both holds and fails the leaf.  Prints each
    realisation and the failed seeds per dtype."""
    jobs = [(dtype, seed) for dtype in ("float32", "float64") for seed in F1_ROUNDING_SEEDS]
    with ThreadPoolExecutor(6) as pool:
        outs = list(pool.map(
            lambda job: realisation(package, job[1], job[0]), jobs))
    failed = {"float32": [], "float64": []}
    for (dtype, seed), out in zip(jobs, outs):
        (leaf,) = out["leaves"]
        print(f"{package} {dtype} seed {seed}: failed {leaf['failed']}, largest displacement "
              f"{leaf['max_obj_disp_m']:.4g} m, ee_err {leaf['ee_err_m']:.4g} m")
        assert np.isfinite(leaf["ee_err_m"])
        if leaf["failed"]:
            failed[dtype].append(seed)
    print(f"{package}, failed of {len(F1_ROUNDING_SEEDS)} realisations: " + ", ".join(
        f"{dtype} {len(seeds)} (seeds {seeds})" for dtype, seeds in failed.items()))
    n_failed = sum(len(seeds) for seeds in failed.values())
    assert 0 < n_failed < len(jobs), failed


def duration_loader(load, ticks):
    """``load_config`` with each experiment leaf cut to ``ticks`` ticks at
    100 Hz, its horizon as shipped."""

    def load_cut(path, *args, **kwargs):
        config = load(path, *args, **kwargs)
        if kwargs.get("depth", 0) == 0 and "simulation" in config:
            config["simulation"]["duration"] = ticks / RATE
        return config

    return load_cut


F1_NOISE_TICKS = 30


@pytest.mark.slow
def test_robust_arch_arm_only_float32_departs_from_float64_as_the_reference(jsweep, monkeypatch):
    """How far float32 carries ``robust_arch_arm_only`` off its float64 path
    over the first 30 ticks, in each package (the JAX script at matmul
    precision "highest"): the two packages' float32 EE paths agree within
    two float32 rounding steps over the first 5 ticks, and the port's float32
    departure from float64 is within 2x of the JAX package's at ticks 10, 20
    and 30, by when it has grown 100x or more (about 600x at tick 10 on a
    CPU).  So the port adds no more float32 rounding to this leaf than the
    JAX package does."""
    import jax

    monkeypatch.setattr(jsweep.cfg, "load_config", duration_loader(jcfg.load_config,
                                                                   F1_NOISE_TICKS))
    monkeypatch.setattr(ral23_sweep.cfg, "load_config", duration_loader(tcfg.load_config,
                                                                        F1_NOISE_TICKS))
    recorder = Recorder(jax)
    monkeypatch.setattr(jsweep, "jax", recorder)
    runs = []
    build = ral23_sweep.build_device_loop

    def recording_build(*args, **kwargs):
        init_carry, run = build(*args, **kwargs)

        def recording_run(*a, **kw):
            runs.append(run(*a, **kw))
            return runs[-1]

        return init_carry, recording_run

    monkeypatch.setattr(ral23_sweep, "build_device_loop", recording_build)
    paths = ral23_sweep.discover_groups(REPO / "configs" / "ral23" / "freespace")[
        "robust_arch_arm_only"]
    ee = {}
    for dtype in (torch.float64, torch.float32):
        ral23_sweep.run_group("robust_arch_arm_only", paths, device="cpu", dtype=dtype)
        ee["port", dtype] = runs[-1][1].r_ew_w.double().numpy()[:, 0]  # (ticks, 3)
        with jax.enable_x64(dtype == torch.float64), jax.default_matmul_precision("highest"):
            jsweep.run_group("robust_arch_arm_only", paths)
            ee["jax", dtype] = np.asarray(recorder.returned[-1][1].r_ew_w, dtype=np.float64)[0]
    assert ee["port", torch.float32].shape == (F1_NOISE_TICKS, 3)
    gap = {pkg: np.abs(ee[pkg, torch.float32] - ee[pkg, torch.float64]).max(-1)
           for pkg in ("port", "jax")}
    between = np.abs(ee["port", torch.float32] - ee["jax", torch.float32]).max(-1)
    print("float32 off float64, port / JAX, by tick: " + ", ".join(
        f"{t}: {gap['port'][t]:.2e} / {gap['jax'][t]:.2e}" for t in (0, 5, 10, 20, 29))
        + f"; float32 port against JAX over the first 5 ticks {between[:5].max():.2e}")
    assert np.abs(ee["port", torch.float64] - ee["jax", torch.float64]).max() <= 1e-10
    assert between[:5].max() <= 2e-7
    for t in (10, 20, 29):
        assert gap["jax"][t] >= 100 * gap["jax"][0]
        assert gap["jax"][t] / 2 <= gap["port"][t] <= 2 * gap["jax"][t], (t, gap)
