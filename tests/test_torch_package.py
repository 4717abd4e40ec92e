"""Guards on the port as a package: it imports no JAX and nothing of the JAX
package, and its entry points run on the card unless asked for the CPU."""

import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import upright_tpu_torch
import upright_tpu_torch.config as tcfg
from upright_tpu_torch import _build
from upright_tpu_torch.convert import (
    balance_model_from_numpy,
    params_from_numpy,
    solver_state_from_numpy,
    solver_state_to_numpy,
)
from upright_tpu_torch.ocp.problem import build_problem
from upright_tpu_torch.parallel.batch import batch_solve_fn, batch_warm_starts
from upright_tpu_torch.solver.al import ALConfig, solve
from upright_tpu_torch.solver.ocp import zeros_warm_start

REPO = Path(__file__).resolve().parents[1]
CPU64 = dict(device="cpu", dtype=torch.float64)


def port_modules():
    names = ["upright_tpu_torch"]
    for m in pkgutil.walk_packages(upright_tpu_torch.__path__, "upright_tpu_torch."):
        names.append(m.name)
    return names


def test_importing_the_port_pulls_in_no_jax():
    names = port_modules()
    for module in ("solver.riccati", "sim.contact", "sim.simulation", "solver.mpc",
                   "runtime.device_loop", "scripts.mpc_sim", "core.logging", "runtime.estimator",
                   "runtime.projectile", "runtime.safety", "runtime.tracker", "runtime.native",
                   "runtime.launch", "scripts.runtime_demo", "scripts.launch_stack",
                   "solver.pscan", "robust.modelling", "robust.synthesis", "robust.verification",
                   "robust.scenarios", "robust.realizable", "robust.planning",
                   "scripts.robust_planning", "scripts.ral25_study", "scripts.ral23_sweep",
                   "scripts.aligned_differential_study", "entry", "parallel.multihost",
                   "core.util", "sim.camera", "tracing", "scripts.scaling_curve",
                   "scripts.plot_log", "scripts.analyze_run", "scripts.obj_err_comp_time",
                   "scripts.tune_estimator", "scripts.calibrate_inertia",
                   "scripts.arrangement_geometry", "scripts.balance_at_configuration",
                   "scripts.compute_minimum_mu", "scripts.projectile_playback",
                   "scripts.debug_leaf", "scripts.profile_solve"):
        assert f"upright_tpu_torch.{module}" in names
    assert len(names) >= 30
    code = (
        "import importlib, sys\n"
        f"for n in {names!r}:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'upright_tpu'))\n"
        "print('BAD', bad)\n"
        "import torch\n"
        "assert torch.backends.cuda.matmul.allow_tf32 is False\n"
        "assert torch.get_float32_matmul_precision() == 'highest'\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def test_chip_smoke_source_names_no_jax():
    src = (REPO / "chip_smoke.py").read_text()
    for line in src.splitlines():
        stripped = line.strip()
        if stripped.startswith(("import ", "from ")):
            assert not any(
                stripped.split()[1].split(".")[0] == bad
                for bad in ("jax", "flax", "upright_tpu")
            ), line


def small_problem():
    path = tcfg.resolve_package_path({"package": "configs", "path": "demos/ur10_demo.yaml"})
    return tcfg.load_config(path)


def has_card():
    return torch.cuda.is_available()


def test_entry_points_default_to_the_card():
    """Without ``device`` an entry point asks for the card; on a machine
    without one it raises rather than carrying on on the CPU."""
    if has_card():
        pytest.skip("this machine has a card: the default device exists")
    conf = small_problem()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_problem(conf, N=3)
    prob = build_problem(conf, N=3, **CPU64)
    x0 = prob.x0[None]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        zeros_warm_start(prob.ocp, x0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        batch_warm_starts(prob.ocp, x0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        batch_solve_fn(prob.ocp, ALConfig())
    state = zeros_warm_start(prob.ocp, x0, **CPU64)
    params = params_from_numpy(
        {part: {k: v.numpy() for k, v in leaves.items()}
         for part, leaves in prob.stage_params(0.0).items()},
        batch=1, **CPU64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        solve(prob.ocp, ALConfig(), params, x0, state)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        solver_state_from_numpy(solver_state_to_numpy(state))
    # asked for the CPU, the same calls run
    sol = solve(prob.ocp, ALConfig(line_search_steps=(1.0,)), params, x0, state, **CPU64)
    assert torch.isfinite(sol.state.X).all()


def test_solve_rejects_tensors_of_another_dtype():
    conf = small_problem()
    prob = build_problem(conf, N=3, **CPU64)
    state = zeros_warm_start(prob.ocp, prob.x0[None], **CPU64)
    with pytest.raises(ValueError, match="float32"):
        solve(prob.ocp, ALConfig(), {}, prob.x0[None], state, device="cpu", dtype=torch.float32)


def test_convert_roundtrips():
    rng = np.random.default_rng(0)
    arrays = dict(
        X=rng.standard_normal((4, 6)), U=rng.standard_normal((3, 2)),
        lam=rng.standard_normal((3, 1)), mu=rng.uniform(size=(3, 5)),
        lam_f=rng.standard_normal(2),
    )
    state = solver_state_from_numpy(arrays, **CPU64)
    assert state.X.shape == (1, 4, 6) and state.lam_f.shape == (1, 2)
    back = solver_state_to_numpy(state)
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k][0], v)
    # arrays that already carry the batch axis keep it
    again = solver_state_from_numpy(back, **CPU64)
    assert again.X.shape == (1, 4, 6)
    with pytest.raises(ValueError, match="X has shape"):
        solver_state_from_numpy({**arrays, "X": arrays["X"][0]}, **CPU64)

    params = {"stage": {"t": np.arange(3.0), "obj_params": rng.standard_normal((3, 1, 10))},
              "final": {"t": np.asarray(0.3), "obj_params": rng.standard_normal((1, 10))}}
    tree = params_from_numpy(params, batch=2, **CPU64)
    assert tree["stage"]["t"].shape == (2, 3) and tree["final"]["t"].shape == (2,)
    assert tree["stage"]["obj_params"].shape == (2, 3, 1, 10)
    np.testing.assert_array_equal(tree["stage"]["obj_params"][1].numpy(), params["stage"]["obj_params"])

    model = dict(
        params=rng.standard_normal((1, 10)), mu=rng.uniform(size=4),
        normal=rng.standard_normal((4, 3)), span=rng.standard_normal((4, 2, 3)),
        r1=rng.standard_normal((4, 3)), r2=rng.standard_normal((4, 3)),
        S1=np.ones((1, 4)), S2=np.zeros((1, 4)),
    )
    bm = balance_model_from_numpy(model, **CPU64)
    assert bm.num_objects == 1 and bm.num_contacts == 4
    np.testing.assert_array_equal(bm.span.numpy(), model["span"])


def test_closed_loop_entry_points_default_to_the_card():
    """The plant, the manager, the device loop (through its problem), the
    closed-loop script and the runtime (planner thread and process, the
    runtime demo and the launch stack) ask for the card unless given
    device='cpu', and raise without one."""
    if has_card():
        pytest.skip("this machine has a card: the default device exists")
    from upright_tpu_torch.runtime.device_loop import build_device_loop
    from upright_tpu_torch.scripts.mpc_sim import run_closed_loop
    from upright_tpu_torch.sim.simulation import UprightSimulation
    from upright_tpu_torch.solver.mpc import ControllerManager

    conf = small_problem()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        UprightSimulation(conf["simulation"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ControllerManager.from_config(conf)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_closed_loop(conf, duration=0.01)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_problem(conf, N=3)
    # the runtime: the planner thread's manager, the planner process (which
    # raises before it spawns), and both runtime scripts
    from upright_tpu_torch.runtime.launch import PlannerNode
    from upright_tpu_torch.runtime.tracker import AsyncPlanner
    from upright_tpu_torch.scripts.launch_stack import run_stack
    from upright_tpu_torch.scripts.runtime_demo import run_demo

    path = tcfg.resolve_package_path({"package": "configs", "path": "demos/ur10_demo.yaml"})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AsyncPlanner(ControllerManager.from_config(conf))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PlannerNode(path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_demo(conf, duration=0.01)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_stack(path, duration=0.01)
    # the device loop runs where its problem was built; a plant of another
    # dtype is refused
    prob = build_problem(conf, N=3, **CPU64)
    build_device_loop(prob, UprightSimulation(conf["simulation"], **CPU64))
    with pytest.raises(ValueError, match="dtype"):
        build_device_loop(prob, UprightSimulation(conf["simulation"], device="cpu"))


def test_each_library_lists_its_own_headers():
    """Every CUDA source and header under csrc/ belongs to a library, and each
    library lists exactly the csrc/ headers its source includes: a library is
    rebuilt for a change of its own files only."""
    import re

    files = {f.name for f in _build.CSRC_DIR.iterdir() if f.suffix in (".cu", ".cuh")}
    listed = {f for deps in _build.SOURCES.values() for f in deps}
    assert files == listed
    for name, (src, *headers) in _build.SOURCES.items():
        assert src == f"{name}.cu"
        text = (_build.CSRC_DIR / src).read_text()
        included = set(re.findall(r'#include\s+"([^"]+)"', text))
        assert included == set(headers), name


def test_rebuild_only_for_a_change_of_its_own_files(tmp_path, monkeypatch):
    import os

    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    build.mkdir()
    for deps in _build.SOURCES.values():
        for f in deps:
            (csrc / f).write_text("//")
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", build)
    assert all(_build.is_stale(n) for n in _build.SOURCES)
    for n in _build.SOURCES:
        _build.library_path(n).write_text("")
        os.utime(_build.library_path(n), (2e9, 2e9))
    assert not any(_build.is_stale(n) for n in _build.SOURCES)
    os.utime(csrc / "plant.cu", (3e9, 3e9))
    assert _build.is_stale("plant") and not _build.is_stale("riccati")
    os.utime(csrc / "async_copy.cuh", (3e9, 3e9))
    assert _build.is_stale("riccati")


def test_plant_kernel_is_built_without_fused_multiply_adds(tmp_path, monkeypatch):
    """nvcc gets -fmad=false for the plant kernel and only for it: with fused
    multiply-adds its float32 result leaves the limits it is held to on the
    card (PERF.md), which the CPU emulation cannot show."""
    commands = {}

    class Recorder:
        def __init__(self, cmd, **_kw):
            commands[cmd[-1]] = cmd
            self.returncode = 1

        def communicate(self):
            return "", "recorded"

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(subprocess, "Popen", Recorder)
    with pytest.raises(RuntimeError, match="recorded"):
        _build.build(list(_build.SOURCES))
    flags = {Path(src).stem: cmd for src, cmd in commands.items()}
    assert "-fmad=false" in flags["plant"] and "-fmad=false" not in flags["riccati"]


def test_executor_builds_into_the_port_and_never_into_the_reference(tmp_path, monkeypatch):
    """native.py names no path of the JAX package's cpp/ directory (whose
    own build writes libupright_executor.so there), compiles the port's copy
    of the source, and writes the library into the port's build/."""
    from upright_tpu_torch.runtime import native

    src = Path(native.__file__).read_text()
    assert "upright_tpu/cpp" not in src and "upright_tpu.cpp" not in src
    assert native.SOURCE == _build.BUILD_DIR.parent / "cpp" / "executor.cpp"
    assert native.library_path().parent == _build.BUILD_DIR
    assert _build.BUILD_DIR.parent.name == "upright_tpu_torch"

    commands = []

    class Result:
        returncode, stdout, stderr = 1, "", "recorded"

    def record(cmd, **_kw):
        commands.append(cmd)
        return Result()

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native.subprocess, "run", record)
    with pytest.raises(RuntimeError, match="recorded"):
        native._build_library()
    (cmd,) = commands
    assert cmd[-1] == str(native.SOURCE)
    out = cmd[cmd.index("-o") + 1]
    assert out.startswith(str(tmp_path / "build" / "libupright_executor"))
    assert not any("upright_tpu/" in a for a in cmd)


def test_robust_entry_points_default_to_the_card():
    """Robust planning (the plan, the protocol and its sweep's set-up, the
    scenario solve, the realizable barrier and the script) asks for the card
    unless given device='cpu', and raises without one."""
    if has_card():
        pytest.skip("this machine has a card: the default device exists")
    from upright_tpu_torch.robust.planning import plan_robust, protocol_sweep, ral25_protocol
    from upright_tpu_torch.robust.realizable import RealizableSet, realizable_max_linear
    from upright_tpu_torch.robust.scenarios import robust_solve_fn
    from upright_tpu_torch.scripts import robust_planning

    conf = small_problem()
    box = [[0.01, 0.01, 0.02]]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        plan_robust(conf, duration=0.3, iterations=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ral25_protocol(conf, com_half_extents=box, duration=0.3, iterations=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        protocol_sweep(conf, box)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        robust_planning.run(conf, duration=0.3, iterations=1)
    rset = RealizableSet(lower=-np.ones(3), upper=np.ones(3), com_lower=-0.1 * np.ones(3),
                         com_upper=0.1 * np.ones(3), mass=1.0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        realizable_max_linear(np.eye(10)[:1], rset)
    prob = build_problem(conf, N=3, **CPU64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        robust_solve_fn(prob.ocp, ALConfig())


def test_sweep_entry_points_default_to_the_card():
    """The ral23 sweep's group and the aligned study's leaf ask for the card
    unless given device='cpu', and raise without one."""
    if has_card():
        pytest.skip("this machine has a card: the default device exists")
    from upright_tpu_torch.scripts import aligned_differential_study, ral23_sweep

    paths = ral23_sweep.discover_groups(REPO / "configs" / "ral23" / "static_obstacles")[
        "full_bottle"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ral23_sweep.run_group("full_bottle", paths, duration=0.01)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        aligned_differential_study.run_leaf("full", 0.0, seed=0, duration=0.01)
