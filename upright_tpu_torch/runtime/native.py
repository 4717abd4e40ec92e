"""ctypes binding to the native real-time executor (upright_tpu_torch/cpp).

Counterpart of ``upright_tpu/runtime/native.py``.  The C++ executor owns the
high-rate tracking loop (KF, policy interpolation with LQR feedback, safety
gate, command integration) and the lock-free observation/policy/command
buffers: the native counterpart of the reference's mrt_node + ROS transport.
Python (and the card) only post policies and observations and read velocity
commands.

The library is built from ``cpp/executor.cpp`` by ``g++`` at first use into
the git-ignored ``build/`` beside the CUDA libraries (``_build.BUILD_DIR``),
and rebuilt when the source is newer.  A failed build raises.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from upright_tpu_torch import _build

SOURCE = Path(__file__).resolve().parents[1] / "cpp" / "executor.cpp"
# the flags of cpp/Makefile
CXX_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared"]
_BUILD_LOCK = threading.Lock()


def library_path():
    return _build.BUILD_DIR / "libupright_executor.so"


def _build_library():
    """Compile the executor into build/ unless it is there and newer than
    its source; the output is written to a temporary file and moved into
    place when g++ succeeds."""
    out = library_path()
    if out.exists() and out.stat().st_mtime >= SOURCE.stat().st_mtime:
        return
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {SOURCE.name} (exit {proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)


def _load():
    _build_library()
    lib = ctypes.CDLL(str(library_path()))
    d = ctypes.c_double
    dp = ctypes.POINTER(ctypes.c_double)
    lib.upright_executor_create.restype = ctypes.c_void_p
    lib.upright_executor_create.argtypes = [ctypes.c_int, d, d, d, d, dp]
    lib.upright_executor_set_state_limits.argtypes = [ctypes.c_void_p, dp, dp, d]
    lib.upright_executor_post_observation.argtypes = [ctypes.c_void_p, d, dp, dp]
    lib.upright_executor_post_policy.argtypes = [
        ctypes.c_void_p, d, d, ctypes.c_int, dp, dp, dp,
    ]
    lib.upright_executor_post_policy.restype = ctypes.c_int
    lib.upright_executor_get_command.argtypes = [ctypes.c_void_p, dp, dp]
    lib.upright_executor_get_command.restype = ctypes.c_int
    lib.upright_executor_get_state_estimate.argtypes = [ctypes.c_void_p, dp]
    lib.upright_executor_start.argtypes = [ctypes.c_void_p]
    lib.upright_executor_start_at.argtypes = [ctypes.c_void_p, d]
    lib.upright_executor_set_time_scale.argtypes = [ctypes.c_void_p, d]
    lib.upright_executor_stop.argtypes = [ctypes.c_void_p]
    lib.upright_executor_tick.argtypes = [ctypes.c_void_p, d]
    lib.upright_executor_braked.argtypes = [ctypes.c_void_p]
    lib.upright_executor_braked.restype = ctypes.c_int
    lib.upright_executor_stats.argtypes = [ctypes.c_void_p, dp]
    lib.upright_executor_destroy.argtypes = [ctypes.c_void_p]
    return lib


_lib = None


def _get_lib():
    global _lib
    with _BUILD_LOCK:
        if _lib is None:
            _lib = _load()
    return _lib


def _as_ptr(a):
    a = np.ascontiguousarray(a, dtype=np.float64)
    return a, a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


class NativeExecutor:
    """Real-time tracking executor backed by the C++ library."""

    def __init__(self, nq, rate=125.0, kf_init_var=0.1, kf_proc_var=10.0,
                 kf_meas_var=1e-3, x0=None, time_scale=1.0):
        self.nq = nq
        self.nx = 3 * nq
        self.rate = rate
        lib = _get_lib()
        if x0 is None:
            x0 = np.zeros(self.nx)
        x0_a, x0_p = _as_ptr(x0)
        self._h = lib.upright_executor_create(
            nq, rate, kf_init_var, kf_proc_var, kf_meas_var, x0_p
        )
        self._lib = lib
        if time_scale != 1.0:
            # slow motion: sim seconds per wall second (plants that cannot
            # run real time, e.g. a simulated plant sharing its host with
            # the planner)
            lib.upright_executor_set_time_scale(self._h, float(time_scale))

    def set_state_limits(self, lb, ub, margin=0.1):
        lb_a, lb_p = _as_ptr(lb)
        ub_a, ub_p = _as_ptr(ub)
        self._lib.upright_executor_set_state_limits(self._h, lb_p, ub_p, margin)

    def post_observation(self, t, q, v):
        q_a, q_p = _as_ptr(q)
        v_a, v_p = _as_ptr(v)
        self._lib.upright_executor_post_observation(self._h, float(t), q_p, v_p)

    def post_policy(self, t0, dt, X, U, K):
        """X: (N+1, nx), U: (N, nq) robot-jerk columns, K: (N, nq, nx)."""
        X = np.ascontiguousarray(X, dtype=np.float64)
        U = np.ascontiguousarray(U, dtype=np.float64)
        K = np.ascontiguousarray(K, dtype=np.float64)
        N = U.shape[0]
        assert X.shape == (N + 1, self.nx)
        assert U.shape == (N, self.nq)
        assert K.shape == (N, self.nq, self.nx)
        _, X_p = _as_ptr(X)
        _, U_p = _as_ptr(U)
        _, K_p = _as_ptr(K)
        ok = self._lib.upright_executor_post_policy(
            self._h, float(t0), float(dt), N, X_p, U_p, K_p
        )
        if not ok:
            raise ValueError(f"policy horizon N={N} exceeds executor capacity")

    def get_command(self):
        v = np.zeros(self.nq)
        t = ctypes.c_double(0.0)
        _, v_p = _as_ptr(v)
        ok = self._lib.upright_executor_get_command(
            self._h, v.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            ctypes.byref(t),
        )
        return (v, t.value) if ok else (None, None)

    def state_estimate(self):
        x = np.zeros(self.nx)
        self._lib.upright_executor_get_state_estimate(
            self._h, x.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
        )
        return x

    def tick(self, t):
        """One explicit (sim-time) tick without the real-time thread."""
        self._lib.upright_executor_tick(self._h, float(t))

    def start(self, t_now=None):
        if t_now is None:
            self._lib.upright_executor_start(self._h)
        else:
            self._lib.upright_executor_start_at(self._h, float(t_now))

    def stop(self):
        self._lib.upright_executor_stop(self._h)

    @property
    def braked(self):
        return bool(self._lib.upright_executor_braked(self._h))

    def stats(self):
        out = np.zeros(4)
        self._lib.upright_executor_stats(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
        )
        return {
            "ticks": int(out[0]),
            "overruns": int(out[1]),
            "policy_switches": int(out[2]),
            "max_tick_seconds": out[3],
        }

    def close(self):
        if self._h:
            self._lib.upright_executor_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
