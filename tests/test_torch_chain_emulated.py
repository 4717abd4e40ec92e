"""Kernel K2's device code (``csrc/chain.cu``), run on the CPU against the
plain chain and against ``torch.func.jacfwd`` of it.

The kernel itself runs only on a card (``tests/test_torch_gpu.py``).  Here
``upright_tpu_torch/tools/emulate_chain.py`` compiles its device code with
the host's C++ compiler and puts it behind the chain's sweep interface, so a
chain built with the emulated kernel sweeps through the device code with the
launch arguments the CUDA path builds, all sweeps of a test in one run of
the harness (``Emulated.run``).  Both modes run in float64 on four
chains: thing_demo (a mobile base: two prismatic joints, then revolute
ones), full_bottle_point1 (the same robot, with the frames its collision
spheres hang on), ur10_demo (a fixed base) and ridgeback_only (the arm's six
joints locked into fixed transforms).  Kernel and plain chain differ in the
order of their sums only: 1e-12.
"""

import shutil

import numpy as np
import pytest
import torch
from torch.func import jacfwd, vmap

import upright_tpu_torch.config as cfg
from upright_tpu_torch.kinematics.chain import KinematicChain
from upright_tpu_torch.kinematics.robot import build_robot_model
from upright_tpu_torch.tools import emulate_chain

CHAINS = {
    "thing_demo": "demos/thing_demo.yaml",
    "full_bottle_point1": "ral23/static_obstacles/full_bottle_point1.yaml",
    "ur10_demo": "demos/ur10_demo.yaml",
    "ridgeback_only": "experimental/ridgeback_only.yaml",
}
TOL = 1e-12
POINTS = 5


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the emulation harness")
    return emulate_chain.build(tmp_path_factory.mktemp("chain_emulation"))


def chains(name, harness):
    """(plain chain, the same chain through the emulated kernel, the frames
    the config's collision spheres hang on, or a spread of frames)."""
    ctrl = cfg.load_config(cfg.resolve_package_path({"package": "configs", "path": CHAINS[name]}))[
        "controller"]
    plain = build_robot_model(ctrl["robot"]).chain
    names = plain.joint_names
    spheres = ctrl.get("obstacles", {}).get("collision_spheres", [])
    frames = tuple(dict.fromkeys(names.index(s["link"]) for s in spheres))
    if not frames:
        frames = (0, len(names) // 2, len(names) - 1)
    k2 = KinematicChain(plain.joints)
    k2.kernel = emulate_chain.Emulated(harness)
    return plain, k2, frames


def state(nq, seed=0):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.standard_normal((POINTS, 3 * nq)), dtype=torch.float64)


def motion_row(f):
    return torch.cat([f.R.flatten(-2), f.p, f.v, f.w, f.a, f.al], dim=-1)


def assert_close(got, want):
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= TOL


@pytest.mark.parametrize("name", list(CHAINS))
def test_value_mode_matches_the_plain_chain(harness, name):
    plain, k2, frames = chains(name, harness)
    nq = plain.nq
    x = state(nq)
    q, v, a = x[:, :nq], x[:, nq:2 * nq], x[:, 2 * nq:]
    middle = plain.joint_names[frames[len(frames) // 2]]

    def sweeps(chain):
        return [motion_row(chain.ee_motion(q, v, a)), motion_row(chain.ee_motion(q)),
                motion_row(chain.frame_motion(middle, q, v, a)), *chain.frame_poses(q, frames),
                *chain.forward(q), chain.link_positions(q)]

    for got, want in zip(k2.kernel.run(lambda: sweeps(k2)), sweeps(plain), strict=True):
        assert_close(got, want)


@pytest.mark.parametrize("name", list(CHAINS))
def test_jacobian_mode_matches_jacfwd_of_the_plain_chain(harness, name):
    """Along (q, v, a) for the EE's motion, along q alone for the frames'
    poses: the derivative of every number K2 writes."""
    plain, k2, frames = chains(name, harness)
    nq = plain.nq
    x = state(nq, seed=1)

    def ee(chain):
        return lambda x_: motion_row(chain.ee_motion(x_[:nq], x_[nq:2 * nq], x_[2 * nq:]))

    def poses(chain):
        def f(x_):
            R, p = chain.frame_poses(x_[:nq], frames)
            return torch.cat([R.flatten(-3), p.flatten(-2)], dim=-1)
        return f

    def jacobians(chain):
        return [vmap(jacfwd(make(chain)))(x) for make in (ee, poses)]

    for got, want in zip(k2.kernel.run(lambda: jacobians(k2)), jacobians(plain), strict=True):
        assert_close(got, want)
