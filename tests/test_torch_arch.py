"""The RA-L 2023 box arch (``ral23/static_obstacles/full_arch_point1``), the
one shipped arrangement whose balance rows couple moving objects: two
standing blocks on the tray and a third bridging them, so that block-on-block
forces enter two objects' wrench balances with opposite signs.

On the CPU in float64 at N 3: its problem has live first-body incidence
(``S1``); the port's equality and inequality rows and their Jacobians equal
those of the frozen plain reference (``benchmark/reference``) at seeded
states and inputs; and the span ``ocp.balance`` around the balance rows
opens inside both the linearization and the line search of a solve.
"""

import json

import pytest
import torch
from torch.func import jacfwd, vmap
from torch.profiler import ProfilerActivity, profile

import upright_tpu_torch.config as cfg
from benchmark.reference.ocp.problem import build_problem as build_reference
from upright_tpu_torch.ocp.problem import build_problem
from upright_tpu_torch.solver.al import ALConfig, solve
from upright_tpu_torch.solver.ocp import zeros_warm_start

CPU64 = dict(device="cpu", dtype=torch.float64)
N = 3
B = 3


@pytest.fixture(scope="module")
def conf():
    return cfg.load_config(cfg.resolve_package_path(
        {"package": "configs", "path": "ral23/static_obstacles/full_arch_point1.yaml"}))


@pytest.fixture(scope="module")
def prob(conf):
    return build_problem(conf, N=N, **CPU64)


def test_the_arch_has_contacts_between_moving_objects(prob):
    model = prob.balance_model
    assert tuple(model.S1.shape) == (3, 16)
    # the eight block-on-block contacts, each with a moving first body
    assert float(model.S1.sum()) == 8.0
    assert (prob.ocp.nx, prob.ocp.nu, prob.ocp.n_eq, prob.ocp.n_ineq) == (27, 57, 18, 284)


def _points(prob):
    """B seeded states near the configuration's start and seeded inputs, and
    the first stage's parameters broadcast over them."""
    gen = torch.Generator().manual_seed(16)
    nx, nu = prob.ocp.nx, prob.ocp.nu
    x = prob.x0.expand(B, nx) + 0.1 * torch.randn(B, nx, generator=gen, **CPU64)
    u = torch.randn(B, nu, generator=gen, **CPU64)
    p = {k: v[0].expand((B,) + tuple(v.shape[1:]))
         for k, v in prob.stage_params(0.0)["stage"].items()}
    return x, u, p


@pytest.mark.parametrize("rows", ["eq", "ineq"])
def test_rows_and_jacobians_equal_the_references(conf, prob, rows):
    ref = build_reference(conf, N=N, **CPU64)
    x, u, p = _points(prob)
    f_port, f_ref = getattr(prob.ocp, rows), getattr(ref.ocp, rows)
    want = f_ref(x, u, p)
    got = f_port(x, u, p)
    assert got.shape == want.shape == (B, getattr(prob.ocp, "n_" + rows))
    assert float((got - want).abs().max()) <= 1e-10 * max(1.0, float(want.abs().max()))
    for argnums in (0, 1):
        j_want = vmap(jacfwd(f_ref, argnums=argnums))(x, u, p)
        j_got = vmap(jacfwd(f_port, argnums=argnums))(x, u, p)
        scale = float(j_want.abs().max())
        assert scale > 0.0
        assert float((j_got - j_want).abs().max()) <= 1e-10 * max(1.0, scale), argnums


def _occurrences(events, name):
    return [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
            if e["name"] == name]


def test_the_balance_span_opens_in_the_linearization_and_the_line_search(prob, tmp_path):
    x0 = prob.x0.expand(2, prob.ocp.nx).contiguous()
    params = prob.stage_params(0.0)
    params = {part: {k: v.expand((2,) + tuple(v.shape)) for k, v in d.items()}
              for part, d in params.items()}
    state = zeros_warm_start(prob.ocp, x0, **CPU64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        solve(prob.ocp, ALConfig(iterations=1), params, x0, state, **CPU64)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    balance = _occurrences(events, "ocp.balance")
    assert {e.get("cat") for e in events if e["name"] == "ocp.balance"} == {"cpu_op"}
    for phase in ("al.linearize", "al.line_search"):
        (start, end), = _occurrences(events, phase)
        assert any(start <= s and e <= end for s, e in balance), phase
