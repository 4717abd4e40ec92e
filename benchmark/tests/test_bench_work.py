"""The frozen operation and byte counts of K1 and P1, at the shapes the
records give their bounds for (PERF.md: K1 0.0253 ms at 512x20x27x13 and
0.0367 ms at 27/21, P1 0.0136 ms for thing_demo at batch 512)."""

import importlib.util
import json

import pytest

from benchmark import peaks, registry, trace


def reader_module(name):
    spec = importlib.util.spec_from_file_location(
        "m_" + name, registry.BENCH_DIR / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("nu,ms", [(13, 0.0253), (21, 0.0367)])
def test_k1_bound_at_the_recorded_shapes(nu, ms):
    k1 = reader_module("k1_roofline")
    t, by = peaks.bound_s(*k1.riccati_work(512, 20, 27, nu, True))
    assert by == "bytes" and round(t * 1e3, 4) == ms


def test_p1_bound_at_the_recorded_shape():
    p1 = reader_module("p1_roofline")
    conf = json.load(open(registry.BENCH_DIR / "configs" / "thing_demo.json"))["config"]
    shape = p1.plant_shape(conf, 100.0)
    assert shape == (1, 16, 1, 16, True, 40, 10)
    t, by = peaks.bound_s(*p1.plant_work(*shape, 512, 4))
    assert by == "operations" and round(t * 1e3, 4) == 0.0136


def test_roofline_readers_divide_the_bound_by_the_mean_launch():
    k1 = reader_module("k1_roofline")
    events = [{"ph": "X", "cat": "user_annotation", "name": trace.WINDOW_SPAN, "ts": 0, "dur": 1e4}]
    events += [{"ph": "X", "cat": "kernel", "name": "void riccati_backward_wide<float>",
                "ts": 10.0 * i, "dur": d} for i, d in enumerate((100.0, 300.0))]
    ctx = {"kind": "solve", "trace": trace.parse(events, 2), "batch": 512,
           "dims": {"N": 20, "nx": 27, "nu": 21}, "linear_dynamics": True}
    bound, _ = peaks.bound_s(*k1.riccati_work(512, 20, 27, 21, True))
    assert k1.read(ctx) == pytest.approx(100 * bound / 200e-6)
    assert k1.read(dict(ctx, kind="loop")) is None
    assert reader_module("p1_roofline").read(dict(ctx, kind="loop")) is None  # no P1 launch
