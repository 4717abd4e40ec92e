"""Where the stacked dice's float32 plant departs from float64: in the load,
not in the port.

On the two stacked dice (ur10_demo + foam_die2, 77 substeps an outer step) a
float32 tick ends far from the float64 one: on an H100 the kernel P1 and its
witness (the plain version in float32) both sit 0.29 rad/s from float64 in
w, past ``tools/plant_data.py`` ``F32_TOL`` (``chip_smoke.py`` phase 7 holds
that case to the witness and the control instead).  Here phase 7's tick
(``dice_b3``: the same seed, batch 3, 10 outer steps) goes through the JAX
package's plant (``UprightSimulation.step``, whose contact substeps are
``_object_substep``) in float64 and in float32, through the port's plain
version in both, and through the emulated P1 in float32
(``tools/emulate_plant.py``).  The float64 results agree to 1e-10; every
float32 result sits as far from float64 as the others, the JAX package's
own included (0.27 rad/s in w on a CPU, the port's 0.29), and the float32
results sit ten times nearer each other than float64.  So the departure is
float32 rounding amplified by the stiff stacked contacts, and the limits
stay as they are.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import upright_tpu.config as jcfg
from upright_tpu.sim.simulation import ObjectsState as JObjectsState
from upright_tpu.sim.simulation import SimState as JSimState
from upright_tpu.sim.simulation import UprightSimulation as JSim
from upright_tpu_torch.convert import plant_params_to_numpy, sim_state_to_numpy
from upright_tpu_torch.sim.contact import advance_objects_plain
from upright_tpu_torch.tools import emulate_plant
from upright_tpu_torch.tools.plant_data import objects_to, plant_for, tick_start

BATCH, N_STEPS = 3, 10
FIELDS = ("r", "q", "v", "w")


def jax_tick(sim, state, cmd, params, dtype):
    """The JAX package's plant over the tick, instance by instance, every
    array as ``dtype`` (float32 with JAX's 64-bit types off)."""
    conf = jcfg.load_config(
        jcfg.resolve_package_path({"package": "configs", "path": "demos/ur10_demo.yaml"}))
    js = JSim(dict(conf["simulation"], arrangement="foam_die2"))
    prm = plant_params_to_numpy(params)

    def f(x):
        return jnp.asarray(np.asarray(x, dtype=dtype))

    def floats(xs):
        return None if xs is None else tuple(f(x) for x in xs)

    out = {k: [] for k in FIELDS}
    for b in range(BATCH):
        a = sim_state_to_numpy(state, sim, index=b)
        o = a["objects"]
        objects = JObjectsState(
            r=f(o["r"]), q=f(o["q"]), v=f(o["v"]), w=f(o["w"]), anchors=floats(o["anchors"]),
            anchor_valid=None if o["anchor_valid"] is None
            else tuple(jnp.asarray(x) for x in o["anchor_valid"]),
            diverged=None if o["diverged"] is None else jnp.asarray(o["diverged"]))
        s = js.step(JSimState(t=f(a["t"]), q=f(a["q"]), v=f(a["v"]), objects=objects),
                    f(cmd[b].numpy()), n_steps=N_STEPS,
                    params={k: f(v[b]) for k, v in prm.items()})
        assert s.objects.w.dtype == dtype
        for k in FIELDS:
            out[k].append(np.asarray(getattr(s.objects, k), dtype=np.float64))
    return {k: np.stack(v) for k, v in out.items()}


def fields(objects):
    return {k: getattr(objects, k).double().numpy() for k in FIELDS}


def distance(a, b):
    return {k: float(np.abs(a[k] - b[k]).max()) for k in FIELDS}


def test_float32_departure_on_the_stacked_dice_belongs_to_the_load(tmp_path):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the plant's emulation harness")
    sim = plant_for("ur10_demo", "foam_die2")
    state, cmd, params = tick_start(sim, BATCH, seed=BATCH)  # phase 7's dice_b3
    frames = sim.robot_steps(state, cmd, N_STEPS)[3]
    objects = state.objects
    port64 = fields(advance_objects_plain(sim.tables, sim.contact, frames, objects, params))
    port32 = fields(advance_objects_plain(  # the witness of float32_witness, without its control
        sim.tables.to(dtype=torch.float32), sim.contact, frames.float(),
        objects_to(objects, "cpu", torch.float32), {k: v.float() for k, v in params.items()}))
    emulated32 = fields(emulate_plant.run(emulate_plant.build(tmp_path), sim.tables, sim.contact,
                                          frames, objects, params, precision="f"))
    jax64 = jax_tick(sim, state, cmd, params, np.float64)
    with jax.enable_x64(False):
        jax32 = jax_tick(sim, state, cmd, params, np.float32)

    off = {"JAX plant": distance(jax32, jax64), "port, plain version": distance(port32, port64),
           "port, emulated P1": distance(emulated32, port64)}
    for name, d in off.items():
        print(f"float32 vs float64, {name}: " + ", ".join(f"{k} {v:.3e}" for k, v in d.items()))
    # both packages compute the same float64 tick
    assert max(distance(port64, jax64).values()) < 1e-10
    # the JAX package's float32 tick departs from float64 in w within 2x of
    # the port's
    ratio = off["JAX plant"]["w"] / off["port, plain version"]["w"]
    assert 0.5 <= ratio <= 2.0, ratio
    # and the float32 ticks sit much nearer each other than float64
    assert distance(jax32, port32)["w"] < 0.2 * off["JAX plant"]["w"]
    assert distance(emulated32, port32)["w"] < 0.2 * off["port, plain version"]["w"]
