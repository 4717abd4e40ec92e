"""Percentiles, rates and the union of device intervals, on numbers and
synthetic traces."""

import numpy as np
import pytest

from benchmark import stats, trace


@pytest.mark.parametrize("q", [0, 10, 50, 90, 95, 100])
def test_percentile_is_numpys_linear(q):
    xs = list(np.random.default_rng(3).exponential(size=117))
    assert stats.percentile(xs, q) == pytest.approx(float(np.percentile(xs, q)), rel=1e-12)


def test_rate():
    assert stats.rate(16384 * 10, 4.0) == 40960.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_union_counts_overlap_once():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (8, 8)]
    assert stats.union(iv) == [(0, 3), (5, 6)]
    assert stats.covered(iv) == 4
    assert stats.gaps(iv, -1, 10) == [(-1, 0), (3, 5), (6, 10)]
    assert stats.gaps([(0, 10)], 2, 4) == []


def _ev(cat, name, ts, dur, ph="X"):
    return {"ph": ph, "cat": cat, "name": name, "ts": ts, "dur": dur}


def synthetic():
    return [
        _ev("user_annotation", trace.WINDOW_SPAN, 100.0, 1000.0),
        _ev("gpu_user_annotation", trace.WINDOW_SPAN, 0.0, 5000.0),
        _ev("user_annotation", trace.PROGRAM_SPAN, 140.0, 300.0),
        _ev("cpu_op", "aten::mm", 150.0, 100.0),
        _ev("cpu_op", "aten::cat", 400.0, 300.0),
        _ev("cpu_op", "aten::copy_", 450.0, 50.0),
        _ev("cuda_runtime", "cudaLaunchKernel", 160.0, 5.0),
        _ev("cuda_runtime", "cudaLaunchKernel", 410.0, 5.0),
        _ev("cuda_driver", "cuLaunchKernel", 420.0, 5.0),
        _ev("cuda_runtime", "cudaMemcpyAsync", 430.0, 5.0),
        _ev("cuda_runtime", "cudaLaunchKernel", 50.0, 5.0),  # before the window
        _ev("cuda_runtime", "cudaLaunchKernel", 800.0, 5.0),  # the harness's, between calls
        _ev("kernel", "void riccati_backward_kernel<float, 27, 13>", 200.0, 100.0),
        _ev("kernel", "gemm", 250.0, 100.0),  # overlaps the first
        _ev("kernel", "plant_kernel", 600.0, 50.0),
        _ev("gpu_memset", "Memset", 900.0, 100.0),
    ]


def test_trace_busy_is_the_union_and_idle_is_named_by_the_host():
    tr = trace.parse(synthetic(), units=2)
    assert tr.window == (100.0, 1100.0)
    assert tr.window_s == pytest.approx(1e-3)
    # kernels 200-350 (overlapping), 600-650, memset 900-1000: 300 us of 1000
    assert tr.busy_s == pytest.approx(300e-6)
    # two runtime launches and one driver launch inside the program's call;
    # the harness's launch outside it is not counted
    assert tr.launches == 3
    assert tr.kernel_times(("riccati_backward",)) == [pytest.approx(100e-6)]
    assert tr.device_ops()[0][0] == "void riccati_backward_kernel<float, 27, 13>"
    gaps = dict(tr.idle_gaps())
    # gaps: 100-200 (mid 150: aten::mm starts at 150), 350-600 (mid 475:
    # aten::copy_ inside aten::cat), 650-900 (mid 775: none), 1000-1100
    assert gaps["aten::mm"] == pytest.approx(100e-6)
    assert gaps["aten::copy_"] == pytest.approx(250e-6)
    assert gaps["host outside any operator"] == pytest.approx(350e-6)
    assert sum(gaps.values()) == pytest.approx(tr.window_s - tr.busy_s)


def test_trace_without_its_window_is_refused():
    with pytest.raises(ValueError):
        trace.parse([_ev("kernel", "k", 0.0, 1.0)], units=1)


def test_over_plain_holds_each_gap_against_the_plain_references_own():
    import torch

    from benchmark.check import over_plain

    plain = torch.tensor([1e-6] * 98 + [2e-2, 1e-6], dtype=torch.float64)
    sound = torch.tensor([2e-6] * 98 + [2.1e-2, 1.5e-6], dtype=torch.float64)
    # where the plain reference departs as far, the instance reads about 1;
    # elsewhere the gap over twice the median
    assert float(over_plain(sound, plain, 6e-8).max()) == pytest.approx(1.05, rel=1e-3)
    # a fault on one instance in a hundred is not left out
    broken = sound.clone()
    broken[5] = 1e-3
    assert float(over_plain(broken, plain, 6e-8).max()) == pytest.approx(500.0)
    # the floor holds where the plain reference reads no gap at all
    assert float(over_plain(sound, torch.zeros(100, dtype=torch.float64), 1e-3).max()) \
        == pytest.approx(21.0)
