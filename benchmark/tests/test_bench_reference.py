"""The reference against the program's CPU path, and the check against a
timed path broken underneath.

On the CPU the program runs its plain versions of K1 and P1, so in float64
it must agree with the reference (a frozen copy of that plain code) to
rounding.  The harness's run (``run.run`` on the CPU, the look for a card
skipped) must come out correct on the sound program and not correct on each
fault the cell can have: a step that returns its state unchanged, half of
the batch left out, an answer altered where it is produced.  A cell on one
chip has no exchange between chips to leave out.  Sizes are cut to what a
test run holds (batch 4, one or two units); the card-only control test
keeps its own size.
"""

import dataclasses

import pytest
import torch

from benchmark import check, generator, registry, run

F64 = torch.float64


def small(name, batch=4, **traffic):
    cell = registry.load_cell(name)
    return dataclasses.replace(cell, batch=batch, traffic={
        **cell.traffic, "samples_per_unit": batch, "cold_samples_per_iteration": batch, **traffic})


def test_reference_solve_equals_the_programs_plain_path():
    from upright_tpu_torch.ocp.problem import build_problem
    from upright_tpu_torch.parallel.batch import batch_solve_fn, batch_warm_starts, broadcast_params
    from upright_tpu_torch.solver.al import ALConfig

    from benchmark.reference.ocp.problem import build_problem as ref_build
    from benchmark.reference.solver.ocp import zeros_warm_start
    from benchmark.reference.steps import solve_cold

    cell = registry.load_cell("thing_demo.batched_solve")
    conf = cell.config["config"]
    prob = build_problem(conf, device="cpu", dtype=F64)
    ref = ref_build(conf, device="cpu", dtype=F64)
    x0 = prob.x0.unsqueeze(0).repeat(2, 1) + 0.01 * torch.randn(
        (2, prob.ocp.nx), generator=torch.Generator().manual_seed(5), dtype=F64)
    cfg = ALConfig(iterations=3, line_search_steps=(1.0, 0.5))
    sol = batch_solve_fn(prob.ocp, cfg, device="cpu", dtype=F64)(
        broadcast_params(prob.stage_params(0.0), 2), x0, batch_warm_starts(prob.ocp, x0, "cpu", F64))
    p = {k: {kk: vv.expand((2,) + tuple(vv.shape)) for kk, vv in v.items()}
         for k, v in ref.stage_params(0.0).items()}
    ref_cfg = check.al_config(__import__("benchmark.reference.solver.al", fromlist=["x"]),
                              {"iterations": 1, "line_search_steps": [1.0, 0.5]})
    rs = solve_cold(ref.ocp, ref_cfg, p, x0, zeros_warm_start(ref.ocp, x0, device="cpu", dtype=F64), 3)
    for a, b in ((sol.state.X, rs.state.X), (sol.state.U, rs.state.U), (sol.K, rs.K),
                 (sol.state.mu, rs.state.mu)):
        assert float((a - b).abs().max()) <= 1e-10


def test_reference_tick_equals_the_programs_plain_path():
    cell = small("full_bottle_point1.sweep_loop", batch=2, samples_per_unit=2)
    wl = generator.make(cell, 7, device="cpu")
    wl.dtype = F64
    wl.setup()
    wl.unit()
    wl.release()
    # the reference judges the float64 program: every gap is rounding
    numbers, info = check.check(cell, wl)
    assert info["pairs"] == 2
    assert max(numbers.values()) <= 1e-9, numbers


def _fault_solve(kind):
    import upright_tpu_torch.parallel.batch as batch

    real = batch.solve

    def broken(ocp, cfg, params, x0, state, **kw):
        sol = real(ocp, cfg, params, x0, state, **kw)
        if kind == "state_unchanged":
            return dataclasses.replace(sol, state=state)
        if kind == "half_batch":
            h = x0.shape[0] // 2
            mixed = {f.name: torch.cat([getattr(sol.state, f.name)[:h], getattr(state, f.name)[h:]])
                     for f in dataclasses.fields(state)}
            return dataclasses.replace(sol, state=dataclasses.replace(state, **mixed))
        U = sol.state.U.clone()
        U[:, :, 0] += 0.01
        return dataclasses.replace(sol, state=dataclasses.replace(sol.state, U=U))

    return batch, "solve", broken


def _fault_loop(kind):
    import upright_tpu_torch.runtime.device_loop as dl
    from upright_tpu_torch.sim.simulation import UprightSimulation

    if kind == "altered":
        real = dl.solve

        def broken(*a, **kw):
            sol = real(*a, **kw)
            U = sol.state.U.clone()
            U[:, 0, 0] += 0.05
            return dataclasses.replace(sol, state=dataclasses.replace(sol.state, U=U))

        return dl, "solve", broken
    real_step = UprightSimulation.step

    def step(self, state, cmd, n_steps=1, **kw):
        nxt = real_step(self, state, cmd, n_steps, **kw)
        if kind == "state_unchanged":
            return state
        h = state.q.shape[0] // 2

        def mix(a, b):
            return None if a is None else torch.cat([a[:h], b[h:]])

        objects = dataclasses.replace(nxt.objects, **{
            f.name: mix(getattr(nxt.objects, f.name), getattr(state.objects, f.name))
            for f in dataclasses.fields(nxt.objects)})
        return dataclasses.replace(nxt, q=mix(nxt.q, state.q), v=mix(nxt.v, state.v),
                                   t=mix(nxt.t, state.t), objects=objects)

    return UprightSimulation, "step", step


CASES = [("thing_demo.batched_solve", None), ("full_bottle_point1.sweep_loop", None)] + [
    (cell, kind) for cell in ("thing_demo.batched_solve", "full_bottle_point1.sweep_loop")
    for kind in ("state_unchanged", "half_batch", "altered")]


@pytest.mark.parametrize("name,fault", CASES, ids=[f"{c}-{f or 'sound'}" for c, f in CASES])
def test_run_is_correct_only_when_the_timed_path_is(name, fault, monkeypatch):
    cell = small(name)
    if fault is not None:
        target, attr, broken = (_fault_solve if cell.traffic["kind"] == "solve"
                                else _fault_loop)(fault)
        monkeypatch.setattr(target, attr, broken)
    code, result, lines = run.run(cell, 2**31 + 101, 0.0, device="cpu")
    # a window of 0 s runs one unit: the batch of 4 once
    assert code == 0 and result["attempted"] == 4
    assert result["correct"] is (fault is None), "\n".join(lines)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["thing_demo.batched_solve", "full_bottle_point1.sweep_loop"])
def test_control_fails_on_the_card(name):
    """The reference in float32 with TF32 products in the program's place is
    not correct, where the program is (batch 256, three units)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 exists only there")
    cell = dataclasses.replace(registry.load_cell(name), batch=256)
    wl = generator.make(cell, 2**31 + 3)
    wl.setup()
    for _ in range(3):
        wl.unit()
    torch.cuda.synchronize()
    wl.release()
    ok, _, lines = check.verdict(check.check(cell, wl)[0], cell.limits, 0)
    assert ok, lines
    bad, _, lines = check.verdict(check.check(cell, wl, control=True)[0], cell.limits, 0)
    assert not bad, lines
