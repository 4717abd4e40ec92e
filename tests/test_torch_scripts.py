"""The port's analysis scripts that build the problem, solve, simulate or
track (``upright_tpu_torch/scripts/``): ``arrangement_geometry`` (the cases of
tests/test_tools.py that use it), ``balance_at_configuration`` and
``compute_minimum_mu`` (torch.func in place of jax.jacfwd, the same scipy
SLSQP), ``projectile_playback``, and smoke runs of ``debug_leaf`` (N 5, a few
ticks) and ``profile_solve``; each held to the JAX package's script on the
same inputs where there is one.  Float64 on the CPU.  Tolerances: the
printed results (rounded to 3-4 decimals) equal; the optimiser's optimum to
1e-6 (SLSQP's own tolerance); the tracker (host numpy in both) exactly.
"""

import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))

import upright_tpu.config as jcfg
from upright_tpu_torch.scripts import (
    arrangement_geometry,
    balance_at_configuration,
    compute_minimum_mu,
    debug_leaf,
    profile_solve,
    projectile_playback,
)

REPO = Path(__file__).resolve().parents[1]
UR10 = str(REPO / "configs" / "demos" / "ur10_demo.yaml")


def run_main(main, argv, capsys):
    saved = sys.argv
    sys.argv = ["script"] + [str(a) for a in argv]
    try:
        capsys.readouterr()
        main()
    finally:
        sys.argv = saved
    return capsys.readouterr().out


def test_arrangement_geometry():
    """arch-offsets reproduces the box_arch layout of configs/arrangements.yaml
    and wedge-dims the wedge of configs/objects.yaml, as the JAX tool does."""
    from arrangement_geometry import arch_offsets as jarch
    from arrangement_geometry import wedge_dims as jwedge

    x1, x2, x3 = arrangement_geometry.arch_offsets([0.103, 0.09, 0.038])
    assert abs(x1 - 0.019) < 1e-12
    assert abs(x2 - 0.084) < 1e-12
    assert abs(x3 - (-0.0325)) < 1e-12
    assert (x1, x2, x3) == jarch([0.103, 0.09, 0.038])
    dims = arrangement_geometry.wedge_dims(15.0, 0.15, 0.15)
    assert abs(dims[2] - 0.0401923788646684) < 1e-12
    assert dims == jwedge(15.0, 0.15, 0.15)


def test_model_info(capsys):
    from arrangement_geometry import model_info as jmodel_info

    prob = arrangement_geometry.model_info(UR10, device="cpu", dtype=torch.float64)
    out = capsys.readouterr().out
    assert "actuated joints (6)" in out
    assert "forces=4" in out
    assert prob.dims.num_contacts == 4
    jmodel_info(jcfg.resolve_package_path({"package": "configs", "path": "demos/ur10_demo.yaml"}))
    jout = capsys.readouterr().out
    # joints and dims lines equal; the home pose to the printed 4 decimals
    # (a printed -0.0 may be 0.0 on the other side)
    assert out.splitlines()[:8] == jout.splitlines()[:8]
    def pose(text):
        body = text.split("home EE position:")[1].replace("home EE rotation:", " ")
        return [float(v) for v in body.replace("[", " ").replace("]", " ").split()]

    assert len(pose(out)) == 12
    np.testing.assert_allclose(pose(out), pose(jout), atol=1e-4)


def test_balance_at_configuration_matches_jax(capsys):
    import balance_at_configuration as jbal

    text = run_main(balance_at_configuration.main, ["--config", UR10, "--device", "cpu"], capsys)
    assert "success: True" in text
    jtext = run_main(jbal.main, ["--config", UR10], capsys)
    assert text == jtext


def test_compute_minimum_mu_matches_jax(capsys):
    import compute_minimum_mu as jmu

    res, pairs, rpy, mus, residual = compute_minimum_mu.minimum_mu(
        compute_minimum_mu.cfg.load_config(UR10), device="cpu")
    assert res.success and residual < 1e-10
    assert pairs == [("ee", "bottle")]
    jtext = run_main(jmu.main, ["--config", UR10], capsys)
    line = [ln for ln in jtext.splitlines() if ln.startswith("mu[ee - bottle]")][0]
    np.testing.assert_allclose(mus[0], float(line.split("=")[1]), atol=1e-4)
    text = run_main(compute_minimum_mu.main, ["--config", UR10, "--device", "cpu"], capsys)
    assert line in text


def test_projectile_playback_matches_jax(capsys, tmp_path):
    import projectile_playback as jplay

    argv = ["--dropout", "0.1", "--noise", "0.005", "--seed", "3"]
    text = run_main(projectile_playback.main, argv + ["--plot", tmp_path / "p.png"], capsys)
    assert "flight detected at" in text and (tmp_path / "p.png").exists()
    jtext = run_main(jplay.main, argv, capsys)
    assert text.splitlines()[:3] == jtext.splitlines()[:3]


def test_debug_leaf_smoke():
    leaf = REPO / "configs" / "ral23" / "static_obstacles" / "full_bottle_point1.yaml"
    rows = debug_leaf.debug_leaf(str(leaf), duration=0.04, chunk=0.02, device="cpu",
                                 dtype=torch.float64, N=5, log=lambda *_: None)
    assert [r["t"] for r in rows] == [0.02, 0.04]
    for r in rows:
        assert np.isfinite(r["ee_err"]) and np.isfinite(r["eq_viol"])
        assert len(r["disp"]) == len(r["tilt"]) == 1 and r["disp"][0] < 0.01


def test_profile_solve_smoke():
    out = profile_solve.profile(batch=2, device="cpu", dtype=torch.float64,
                                log=lambda *_: None, N=3)
    assert out["solve_ms"] > 0
    assert set(out["phases_ms"]) == {"al.linearize", "al.backward", "al.line_search",
                                     "al.update"}
    assert all(ms > 0 for ms in out["phases_ms"].values())
    assert sum(out["phases_ms"].values()) <= out["solve_ms"]
    assert "card_ms" not in out  # no card time on the CPU
