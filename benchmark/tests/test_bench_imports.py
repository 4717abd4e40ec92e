"""Nothing the harness or the reference loads is JAX or the JAX package,
compared by whole top-level names; the reference loads nothing of the
program."""

import subprocess
import sys

from benchmark import guard, registry

HARNESS = ["benchmark.run", "benchmark.check", "benchmark.generator", "benchmark.trace",
           "benchmark.registry", "benchmark.calibrate", "benchmark.stats"]
REFERENCE = ["benchmark.reference.ocp.problem", "benchmark.reference.sim.simulation",
             "benchmark.reference.solver.al", "benchmark.reference.steps"]


def loaded_after(modules, extra=""):
    code = ("import sys\n" + "".join(f"import {m}\n" for m in modules) + extra +
            "print(' '.join(sorted({n.split('.')[0] for n in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=registry.ROOT, capture_output=True,
                         text=True, check=True)
    return set(out.stdout.split())


def test_whole_name_compare():
    names = ["upright_tpu_torch", "upright_tpu_torch.solver.al", "upright_tpu.solver",
             "jaxlib", "jax_util", "flaxen", "flax.linen", "jax"]
    assert guard.forbidden_modules(names) == ["flax.linen", "jax", "jaxlib", "upright_tpu.solver"]


def test_harness_and_readers_load_no_jax():
    readers = "".join(
        f"from benchmark import registry as _r; _r.metric_reader({m['name']!r})\n"
        for m in registry.benchmark_spec()["end_to_end"] + registry.benchmark_spec()["per_layer"])
    top = loaded_after(HARNESS, readers)
    assert not top & set(guard.FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    top = loaded_after(REFERENCE)
    assert not top & (set(guard.FORBIDDEN) | {"upright_tpu_torch"})


def test_program_under_the_harness_loads_no_jax():
    top = loaded_after(HARNESS + ["upright_tpu_torch.parallel.batch",
                                  "upright_tpu_torch.runtime.device_loop",
                                  "upright_tpu_torch.solver.mpc"])
    assert "upright_tpu_torch" in top and not top & set(guard.FORBIDDEN)
