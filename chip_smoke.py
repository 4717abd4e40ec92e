#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py [--out results.json] [--breakdown]

Drives the port's main path through the entry points a user would call and
holds every hand-written kernel against its plain PyTorch version:

  1. the card (name, power limit, torch / CUDA versions);
  2. builds the three kernels from upright_tpu_torch/csrc/ (the Riccati
     kernel K1, the plant's contact kernel P1 and the kinematic chain's
     kernel K2, one nvcc each, in parallel) and prints registers, local
     memory and shared memory of each instantiation (K1: the register route
     and the wide route, float32 and float64; P1: float32 and float64, one
     warp and block-wide, two friction models; K2: value and Jacobian mode,
     float32 and float64), all without local memory;
  3. K1 against its plain version (float64): the main-path shapes in
     float32 and float64, the wide route (nu = 45 and 93) in both, and
     batches built to take the jitter fallback and to fail it (nu 26 and 70,
     same NaN pattern); K2 against its plain version (PlainSweep) in both
     modes, float32 and float64, on thing_demo's EE motion along (q, v, a)
     and full_bottle_point1's collision frames along q, at the main path's
     points (512 x 20) and the solve cell's (16,384 x 20); then the public
     helpers no later phase calls (the exact friction cone,
     BalanceModel.with_params, frame_motion at every joint frame) on the card
     in both dtypes against their float64 CPU values;
  4. the batched main path: demos/thing_demo.yaml, N = 20, batch 512, one
     warm-started AL-SQP iteration per solve, solves/s over 10 re-solves, K1
     and K2 launches counted;
  5. the steady replan at batch 1: shift -> heal -> solve -> policy;
  6. kernel times (specialised and runtime-sized instances, both forms, batch
     1, float64, nu = 45, N = 200), each as one eager call of the wrapper and
     as the kernel's device time alone, beside its bound; K2's two modes at
     the solve cell's points the same way, beside their bound and the plain
     version's time;
  7. the plant's contact kernel P1 (csrc/plant.cu) against its plain
     version over one control tick (10 outer steps x 40 substeps):
     thing_demo at batch 1 and 64 with the mass, mu and CoM spread per
     instance, a stacked arrangement (box_arch), seven objects on four warps
     (blue_cups, the block-wide route), the regularized friction model and a
     batch that trips the divergence latch: float64 against the
     plain version, float32 against the plain version run in float32 on the
     same inputs (the witness), and a control that the float32 limits reject;
  8. the closed loop: thing_demo at full width on the device loop
     (runtime/device_loop.py), a 12-iteration cold solve, then 100 ticks at
     100 Hz (1.0 s) through the three kernels (their launches counted):
     costs finite, the bottle within 0.03 m of its place; then 10 ticks of the host loop (ControllerManager +
     UprightSimulation) against the device loop from the same start;
  9. P1's times (thing_demo at batch 1 and 512, box_arch and blue_cups at
     batch 1) beside its bound and its plain version's,
     and the closed loop's host time per tick, replan and plant apart;
 10. the obstacle course, ral23/static_obstacles/full_bottle_point1.yaml
     (frictional cones, 36 collision rows; nx 27, nu 21): batch 512, a
     12-iteration cold solve then warm re-solves (solves/s, K1 launches per
     iteration, eq_viol, the smallest collision row), and the batch-1 replan;
 11. K1 on the stage data the solver hands it at every width of the ral23
     configs (27/21, 27/9, 36/13, 27/33, 27/93; 27/17, 27/25, 27/37, 18/22,
     18/34, 18/54, 27/57 and 18/90, each from a cold solve of its config):
     float64 kernel and float32 kernel against the float64 plain version,
     ms per launch and of one eager call, bound, the torch.linalg loop;
     float64 ms per launch and its bound at the FP64 peak;
 12. full_bottle_point1 in the closed loop on the device loop: a 12-iteration
     cold solve, 50 ticks at 100 Hz (phase 13 runs it 100 ticks in its
     group), the bottle within 0.03 m and the last
     plan's collision rows above -0.05; host ms per tick, replan and plant
     apart;
 13. the closed loop batched over targets: thing_demo at B = 1, 8 and 64
     (the demo's waypoint offset by up to 0.2 m), one batched cold solve, 20
     ticks each, K1 and P1 launched once per tick for the whole batch, ms
     per tick and instance-ticks/s; B = 3 in float64 against three batch-1
     runs (1e-10); the ral23 group full_bottle_point{1,2,3} as one B = 3
     loop of 100 ticks (bottles within 0.03 m, collision rows above -0.05);
 14. the projectile closed loop (demos/thing_projectile_demo.yaml, 2.0 s
     through scripts/mpc_sim.py): the tracker's phases, the ball's closest
     approach, the bottle within 0.03 m;
 15. the asynchronous runtime on ur10_demo (scripts/runtime_demo.py: the
     planner thread on its own stream, the native executor at 125 wall Hz,
     the plant on the card) at time scale 0.1: 0 overruns, policy switches,
     the bottle's displacement printed; and 1.0 s of the launch
     stack with the planner process on the card;
 16. robust planning, the ral25 path (upright_tpu_torch/robust/): the
     study's 20 cm box, robust variant (8 CoM-vertex scenarios in one OCP:
     N 100, nx 27, nu 41), its first waypoint, a 60-iteration plan through
     K1; K1 and the log-depth backward pass (solver/pscan.py) on the plan's
     stage data against the float64 plain version, and K1 at ur10_demo's
     robust plan (18/38, N 30); float64 plans through pscan against plans
     through K1; pscan and K1 timed side by side; the tracking sweep (15
     CoM x 3 inertia scales, worst-case inertias, 10 s at 125 Hz, one P1
     launch a tick for all 45 runs, 0 failures), P1 in float64 on one tick
     of it; the post-hoc verification with the realizable barrier on the
     card against the CPU; K1's float32 error over the long recursions
     beside the plain version's and pscan's;
 17. the ral23 sweep (upright_tpu_torch/scripts/ral23_sweep.py run_group)
     on one group per K1 width no other phase runs in closed loop:
     static_obstacles robust_dice (27/17), robust_arch (27/25), robust_cups
     (27/37) and freespace full_arch (27/57), each a B = 3 loop of 20 ticks
     after its cold solve: K1 and P1 launched once per tick for the group,
     costs finite, no leaf failed, ms per tick;
 18. the multi-device solve (parallel/multihost.py; entry.py
     dryrun_multichip), each part a torch.distributed job of its own rank
     processes with a timeout: (a) one rank on NCCL, the flagship dry run
     (thing_obstacle_demo frictional, N 20, nx 27, nu 21) in float64, every
     tile within 1e-10 of its batch-1 solve, and in float32, entry()'s solve
     step; (b) two ranks sharing the card on gloo with host copies, the
     sharded float64 solve of ur10_demo at global batch 8 (each rank's
     shard within 1e-10) and the dry run across both ranks (dp 1 x sp 2);
     (c) scripts/scaling_curve.py at 1 and 2 ranks (one job of two ranks
     sharing the card), batch 256 a rank; K1 launches and host ms of each
     part;
 19. the ral23 groups at the widest shipped widths, in float64
     (scripts/ral23_sweep.py run_group, dtype float64): freespace full_arch
     (27/57, B = 3), static_obstacles full_cups (27/93, B = 3) and
     full_cups_arm_only (18/90, B = 1), each its cold solve and 10 ticks: K1
     and P1 launched once per tick, costs finite, no leaf failed, the cold
     solve equal to the same solve through the plain backward pass (1e-8 on
     X and U), host ms per tick and K1's float64 ms per launch;
 then one JSON line describing each kernel (time, bound, launches), the
 card's name and power limit, and the final JSON line.

With ``--breakdown`` it also traces three solves with torch.profiler and
prints the host and card ms of each of the solver's spans (``al.linearize``,
``al.backward``, ``al.line_search``, ``al.update``;
``scripts/profile_solve.py``), and times the stage derivatives in each
Jacobian mode (wide, blocked, rev), on thing_demo and full_bottle_point1 at
batch 512 and batch 1, and the phases of one replan of phase 14's projectile
problem: the numbers of PERF.md's "where the time goes".

It needs a CUDA device and the repository around it: it exits non-zero and
prints no result without either.  Any failed check raises, so the exit code
is non-zero and the final line is never printed.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import statistics
import subprocess
import sys
import time

import numpy as np

# Published peaks of the H100 SXM, used for the roofline bound of each kernel
H100_BYTES_PER_S = 3.35e12
H100_FP32_FLOPS = 67e12
# float64: the FP64 tensor cores (DMMA), full IEEE float64; the FP64 pipes
# outside them, which K1 uses, give half (printed beside the bound)
H100_FP64_FLOPS = 67e12
H100_FP64_VECTOR_FLOPS = 34e12

BATCH = 512
HORIZON = 20
TIMED_RESOLVES = 10
WARM_RESOLVES = 3
REPLAN_TICKS = 40
REPLAN_WARMUP = 5


T_START = time.perf_counter()


def log(msg):
    """Print a line; a phase's heading gets the seconds since the start."""
    if msg.startswith("== "):
        msg = f"{msg} [{time.perf_counter() - T_START:.1f} s]"
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(f"chip_smoke check failed: {msg}")
    log(f"  ok: {msg}")


def riccati_work(Bt, N, nx, nu, invariant, elem_bytes=4):
    """(bytes, flops) the Riccati backward pass needs: each input read once,
    each output written once; the recursion's products, one factorisation
    and one substitution pair per stage.  The Qxu block of Q = H + Z^T P Z is
    never read by the recursion, so it is not counted."""
    nz = nx + nu
    per_stage_elems = nz * nz + nz + nx + nu * nx + nu
    if not invariant:
        per_stage_elems += nx * nz
    total_elems = Bt * (N * per_stage_elems + nx * nx + nx)
    if invariant:
        total_elems += nx * nz
    per_stage_flops = (
        2 * nx * nx * nz  # P Z
        + 2 * nx * (nz * nz - nx * nu)  # Z^T (P Z) without the Qxu block
        + 2 * nx * nx + 2 * nz * nx  # P d, Z^T (p + P d)
        + nu**3 // 3  # factorisation of Quu
        + 2 * nu * nu * (nx + 1)  # forward and back substitution of [Qux | Qu]
        + 2 * nx * nx * nu + 2 * nx * nu  # Qux^T K, Qux^T kff
    )
    return elem_bytes * total_elems, Bt * N * per_stage_flops


# Operations of K2's sweep (csrc/chain.cu), counted from the source, a sin or
# a cos as one: the primal of one joint (its fixed transform, then its
# revolute or prismatic DOF), and one direction's tangent through a joint,
# along q (which moves the poses) or along v or a (which moves no pose).
K2_PRIMAL_OPS = {"fixed": 99, "revolute": 123, "prismatic": 84}
K2_TANGENT_OPS = {"fixed": (168, 105), "revolute": (198, 48), "prismatic": (153, 135)}


def chain_work(kinds, nq, n_out, points, n_dir, inputs, elem_bytes=4):
    """(bytes, flops) of one K2 launch on a chain whose joints are ``kinds``
    ("fixed", "revolute", "prismatic") up to the last frame it writes: the
    inputs (``inputs`` of q, v, a) read once, the output written once; the
    primal sweep once a point, and each direction's tangent from its joint
    on.  The Jacobian mode recomputes the primal in every (point, direction)
    thread; that repetition is the kernel's cost, not the function's, and is
    not counted.  n_dir 0 is the value mode."""
    primal = sum(K2_PRIMAL_OPS["fixed"] + (K2_PRIMAL_OPS[k] if k != "fixed" else 0)
                 for k in kinds)
    tangent = 0
    actuated = [i for i, k in enumerate(kinds) if k != "fixed"]
    for d in range(n_dir):
        rot = d < nq
        j0 = actuated[d % nq]
        tangent += K2_TANGENT_OPS[kinds[j0]][0 if rot else 1]
        for k in kinds[j0 + 1:]:
            tangent += K2_TANGENT_OPS["fixed"][0 if rot else 1]
            if k != "fixed":
                tangent += K2_TANGENT_OPS[k][0 if rot else 1]
    nbytes = elem_bytes * points * (nq * inputs + n_out * max(n_dir, 1))
    return nbytes, points * (primal + tangent)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also write the results as JSON here")
    ap.add_argument("--breakdown", action="store_true",
                    help="also trace three solves and print the solver spans' host and card ms")
    args = ap.parse_args()
    t_start = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script runs only "
              "on a GPU.", file=sys.stderr)
        return 2

    import upright_tpu_torch.config as cfg  # the package pins full-float32 products
    from upright_tpu_torch import _build
    from upright_tpu_torch.config.arrangement import parse_control_objects
    from upright_tpu_torch.core import balance
    from upright_tpu_torch.core.logging import DataLogger
    from upright_tpu_torch.core.math import quat_to_rot, rot_to_quat
    from upright_tpu_torch.kinematics import chain as chain_mod
    from upright_tpu_torch.kinematics.robot import build_robot_model
    from upright_tpu_torch.ocp.problem import build_problem
    from upright_tpu_torch.ocp.reference import TargetTrajectory, stack_targets
    from upright_tpu_torch.parallel.batch import (
        batch_solve_fn,
        batch_warm_starts,
        broadcast_params,
    )
    from upright_tpu_torch.runtime.device_loop import build_device_loop
    from upright_tpu_torch.robust.planning import (
        make_param_sweep,
        plan_robust,
        protocol_sweep,
        tracking_sweep,
        verify_offline_plan,
    )
    from upright_tpu_torch.robust.verification import count_failures
    from upright_tpu_torch.scripts import launch_stack, mpc_sim, ral23_sweep, runtime_demo
    from upright_tpu_torch.scripts.profile_solve import span_breakdown
    from upright_tpu_torch.sim import contact
    from upright_tpu_torch.sim import simulation as sim_mod
    from upright_tpu_torch.sim.simulation import UprightSimulation
    from upright_tpu_torch.solver import al, riccati
    from upright_tpu_torch.solver.al import ALConfig, solve
    from upright_tpu_torch.solver.mpc import ControllerManager, MPCSettings
    from upright_tpu_torch.solver.ocp import SolverState
    from upright_tpu_torch.solver.pscan import parallel_backward_pass
    from upright_tpu_torch.tools import k1_float32_error
    from upright_tpu_torch.tools.plant_data import (
        F32_TOL,
        float32_witness,
        max_errors,
        objects_to,
        plant_for,
        tick_inputs,
    )
    from upright_tpu_torch.tools.stage_data import (
        RAL25_HEIGHT,
        RAL25_WAYPOINT,
        capture_stage_data,
        fallback_batch,
        ral25_plan_config,
        random_batch,
        solver_stage_data,
        stage_data,
    )

    dev = torch.device("cuda")
    results = {}

    def cuda_median_ms(fn, reps, warmup=2):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def cuda_launch_ms(fn, reps, inner=20):
        """Device time of one launch: `inner` launches captured back to back
        in a CUDA graph, the replay timed, over `inner`.  (cuda_median_ms of
        one eager call on an idle card also counts the host's time from the
        first event to the launch: argument checks, allocation of K, kff.)"""
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(inner):
                fn()
        return cuda_median_ms(graph.replay, reps, warmup=1) / inner

    # -- 1. the card ------------------------------------------------------
    log("== 1. card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0 and smi.stdout.strip(), "nvidia-smi answered")
    card_line = smi.stdout.strip().splitlines()[0]
    log(card_line)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    check(torch.backends.cuda.matmul.allow_tf32 is False
          and torch.get_float32_matmul_precision() == "highest",
          "float32 products are full float32 (TF32 off)")

    # -- 2. build the kernels ------------------------------------------------
    log("== 2. build")
    t0 = time.perf_counter()
    # one nvcc per source, started together
    _build.build(["riccati", "plant", "chain"], extra_flags=("-Xptxas", "-v"), verbose=True)
    riccati._library()
    contact._library()
    chain_mod._library()
    build_s = time.perf_counter() - t0
    log(f"built csrc/riccati.cu, csrc/plant.cu and csrc/chain.cu in {build_s:.1f} s (set-up)")
    results["build_s"] = build_s
    thing_plant = plant_for("thing_demo")
    for name, a in contact.instance_attrs().items():
        dt_ = torch.float64 if name.startswith("float64") else torch.float32
        log(f"  plant instance {name}: {a['registers']} registers, {a['local_bytes']} bytes of "
            f"local memory per thread, shared memory {a['static_smem_bytes']} static + "
            f"{contact.smem_bytes(thing_plant.tables, thing_plant.object_substeps, dt_)} "
            "dynamic at thing_demo's 1 object, 16 slots and 40 substeps")
    results["plant_instances"] = contact.instance_attrs()
    check(all(a["local_bytes"] == 0 for a in results["plant_instances"].values()),
          "no plant instance has a stack frame or spills (local memory 0)")
    results["chain_instances"] = chain_mod.instance_attrs()
    for name, a in results["chain_instances"].items():
        log(f"  chain instance {name}: {a['registers']} registers, {a['local_bytes']} bytes of "
            f"local memory per thread, shared memory {a['static_smem_bytes']} static")
    check(all(a["local_bytes"] == 0 for a in results["chain_instances"].values()),
          "no K2 instance has a stack frame or spills (local memory 0)")
    attrs = riccati.instance_attrs()
    # the register route (nu <= 16), then the wide route at its shipped widths
    smem_at = {
        "float32 nx=27 nu=13": [(27, 13, torch.float32, False)],
        "float32 nx=18 nu=10": [(18, 10, torch.float32, False)],
        "float32 runtime-sized": [(27, 13, torch.float32, True), (36, 13, torch.float32, True)],
        "float64 runtime-sized": [(27, 13, torch.float64, True), (18, 10, torch.float64, True)],
        "float32 wide": [(27, 21, torch.float32, True), (27, 93, torch.float32, True)],
        "float64 wide": [(27, 57, torch.float64, True), (27, 93, torch.float64, True),
                         (18, 90, torch.float64, True)],
    }
    for name, a in attrs.items():
        dyn = ", ".join(f"{riccati.smem_bytes(nx_, nu_, dt, rt)} at {nx_}/{nu_}"
                        for nx_, nu_, dt, rt in smem_at[name])
        log(f"  instance {name}: {a['registers']} registers, {a['local_bytes']} bytes of local "
            f"memory per thread, shared memory {a['static_smem_bytes']} static + {dyn} dynamic")
    results["instances"] = attrs
    # the float32 runtime-sized instance (the register route at a width with
    # no instance of its own) keeps 8 bytes of spills under CUDA 12.8: the
    # build without them (153 registers, not 72) was 11% faster at batch 1
    # and 59% slower at batch 512 on an H100 (PERF.md, ROADMAP K1-d)
    SPILL_BYTES = {"float32 runtime-sized": 8}
    check(all(a["local_bytes"] <= SPILL_BYTES.get(n, 0) for n, a in attrs.items()),
          f"no K1 instance has local memory, but {SPILL_BYTES} bytes as measured")
    check(all(riccati.smem_bytes(nx_, nu_, dt, rt) <= riccati.MAX_SMEM_BYTES
              for shapes in smem_at.values() for nx_, nu_, dt, rt in shapes),
          f"every shipped width fits one block's {riccati.MAX_SMEM_BYTES} bytes of shared memory "
          "in both dtypes")

    # -- 3. kernel vs plain version ------------------------------------------
    log("== 3. Riccati kernel vs its plain version (float64) on the card")
    reg = 1e-6
    # Tolerances.  float32 kernel: 1e-4 absolute on K and kff (both O(1) here).
    # The float32 recursion rounds differently from float64 over the N
    # dependent stages; on an H100 the largest difference over these cases is
    # 5e-6, so 1e-4 leaves a margin of 20 and is 50 times tighter than the 5e-3
    # the reference holds its own float32 kernel to on the random_batch data.
    # float64 kernel: 1e-10 relative to the largest entry; both sides are
    # float64 and differ in summation order only (1e-14 on an H100), so an
    # indexing fault at a tile edge cannot hide under it.
    KERNEL_ATOL = 1e-4
    KERNEL_RTOL_F64 = 1e-10
    cases = [
        ("form_a_8x6x5x3", random_batch(8, 6, 5, 3), False),
        ("form_a_512x20x27x13", stage_data(BATCH, HORIZON, 27, 13, seed=1), False),
        ("form_b_512x20x27x13", stage_data(BATCH, HORIZON, 27, 13, seed=2, invariant=True), True),
        ("form_b_1x20x27x13", stage_data(1, HORIZON, 27, 13, seed=3, invariant=True), True),
        # the wide-input route (relative jitter instead of the pivot clamp) at
        # the width of the frictional multi-object problems
        ("form_a_64x20x27x45", stage_data(64, HORIZON, 27, 45, seed=4), False),
        ("form_b_64x20x27x45", stage_data(64, HORIZON, 27, 45, seed=5, invariant=True), True),
        ("form_b_64x200x27x13", stage_data(64, 200, 27, 13, seed=6, invariant=True), True),
        # the wide route's widest shipped width (full_cups), float64 included
        ("form_b_64x20x27x93", stage_data(64, HORIZON, 27, 93, seed=7, invariant=True), True),
    ]
    kernel_inputs = {}
    max_abs_err = 0.0

    def compare(name, K, kff, K_ref, kff_ref, tol, relative):
        check(bool(torch.isfinite(K).all() and torch.isfinite(kff).all()), f"{name}: finite")
        scale = max(1.0, float(K_ref.abs().max())) if relative else 1.0
        err_K = float((K.double() - K_ref).abs().max()) / scale
        err_k = float((kff.double() - kff_ref).abs().max()) / scale
        log(f"  {name}: max|K - K_plain| = {err_K:.3e} (|K|max {float(K_ref.abs().max()):.3g}), "
            f"max|kff - kff_plain| = {err_k:.3e}")
        check(max(err_K, err_k) <= tol,
              f"{name}: within {tol} {'of the largest entry' if relative else 'absolute'}")
        results[f"kernel_err_{name}"] = max(err_K, err_k)
        return max(err_K, err_k)

    for name, arrays, invariant in cases:
        f32 = tuple(torch.as_tensor(a, dtype=torch.float32, device=dev) for a in arrays)
        f64 = tuple(t.double() for t in f32)
        K_ref, kff_ref = riccati.riccati_backward_plain(*f64, reg=reg)
        K, kff = riccati.riccati_backward(*f32, reg=reg)
        K64, kff64 = riccati.riccati_backward(*f64, reg=reg)
        torch.cuda.synchronize()
        check(K.dtype == torch.float32 and K64.dtype == torch.float64, f"{name}: output dtypes")
        max_abs_err = max(max_abs_err,
                          compare(name, K, kff, K_ref, kff_ref, KERNEL_ATOL, relative=False))
        compare(name + "_f64", K64, kff64, K_ref, kff_ref, KERNEL_RTOL_F64, relative=True)
        if f32[-1].shape[-1] == 27 and f32[1].shape[-1] == 13:
            # the runtime-sized float32 instance at a shape that has its own
            K_rt, kff_rt = riccati._riccati_backward_cuda(*f32, reg, runtime_sized=True)
            max_abs_err = max(max_abs_err, compare(name + "_runtime_sized", K_rt, kff_rt,
                                                   K_ref, kff_ref, KERNEL_ATOL, relative=False))
        kernel_inputs[name] = f32

    # the jitter fallback, per instance and per stage: where the first
    # factorisation fails the second is taken, where both fail K and kff are
    # NaN from that stage back; the pattern must be the plain version's.  At
    # nu 26 (two panels of the wide route) and 70 (five; the failing pivot in
    # the last)
    for fb_nu in (26, 70):
        fb = tuple(torch.as_tensor(a, dtype=torch.float64, device=dev)
                   for a in fallback_batch(nu=fb_nu))
        K_ref, kff_ref = riccati.riccati_backward_plain(*fb, reg=0.0)
        nan_ref = torch.isnan(K_ref).any(-1).any(-1)  # (Bt, N)
        expect = torch.zeros_like(nan_ref)
        expect[1, 0] = expect[3, 0] = expect[4, 0] = expect[4, 1] = True
        check(bool((nan_ref == expect).all()),
              f"fallback batch at nu {fb_nu}, plain version: instance 4 is NaN from stage 1 back; "
              "instances 1 and 3 take the second factorisation at stage 1 and fail both at stage "
              "0; the rest is finite")
        for dtype, tol in ((torch.float64, KERNEL_RTOL_F64), (torch.float32, KERNEL_ATOL)):
            K, kff = riccati.riccati_backward(*(t.to(dtype) for t in fb), reg=0.0)
            torch.cuda.synchronize()
            same = bool((torch.isnan(K) == torch.isnan(K_ref)).all()
                        and (torch.isnan(kff) == torch.isnan(kff_ref)).all())
            check(same, f"fallback batch at nu {fb_nu}, {dtype}: NaN exactly where the plain "
                  "version has NaN")
            ok = ~torch.isnan(K_ref)
            scale = float(K_ref[ok].abs().max())
            err = max(float((K.double() - K_ref)[ok].abs().max()),
                      float((kff.double() - kff_ref)[~torch.isnan(kff_ref)].abs().max())) / scale
            log(f"  fallback batch at nu {fb_nu}, {dtype}: max err / largest entry = {err:.3e} "
                f"(|K|max {scale:.3g})")
            check(err <= tol, f"fallback batch at nu {fb_nu}, {dtype}: finite entries within "
                  f"{tol} of the largest")
            results[f"kernel_err_fallback_nu{fb_nu}_{str(dtype).split('.')[-1]}"] = err

    # the wrapper has no fallback: what the kernel does not take raises
    small = kernel_inputs["form_a_8x6x5x3"]
    for label, bad in (
        ("mixed float32 / float64", small[:4] + (small[4].double(),) + small[5:]),
        ("bfloat16", tuple(t.bfloat16() for t in small)),
    ):
        try:
            riccati.riccati_backward(*bad, reg=reg)
        except TypeError:
            log(f"  ok: {label} CUDA tensors raise (no quiet fallback to the plain version)")
        else:
            raise AssertionError(f"riccati_backward accepted {label} CUDA tensors")

    # K2 against its plain version (PlainSweep: K2's interface in plain
    # PyTorch, one jacfwd tangent a direction) in both modes and dtypes: the
    # EE's motion along (q, v, a), as the solver's rows read it, on
    # thing_demo's chain, and the poses of the frames full_bottle_point1's
    # collision spheres hang on along q, as its collision rows read them; at
    # the main path's points (phase 4: batch 512 x N 20) and the solve cell's
    # (16,384 x 20).  Tolerances of the card tests, of the largest entry:
    # float64 1e-12 (both sides float64, the same products in another order),
    # float32 2e-6 (both sides float32; the kernel is built -fmad=false)
    log("  the chain's kernel K2 against its plain version:")
    K2_TOL = {torch.float64: 1e-12, torch.float32: 2e-6}
    K2_POINTS = (BATCH * HORIZON, 16384 * HORIZON)
    k2_requests = {}
    for label, conf_path in (("thing_demo", "demos/thing_demo.yaml"),
                             ("full_bottle_point1",
                              "ral23/static_obstacles/full_bottle_point1.yaml")):
        ctrl_k2 = cfg.load_config(cfg.resolve_package_path(
            {"package": "configs", "path": conf_path}))["controller"]
        chain_k2 = build_robot_model(ctrl_k2["robot"]).chain
        last = len(chain_k2.joints) - 1
        if label == "thing_demo":
            k2_requests["thing_demo ee motion"] = (
                chain_mod.SweepRequest(chain_k2, (last,), last), True)
        else:
            frames = tuple(dict.fromkeys(chain_k2.joint_names.index(sp["link"])
                                         for sp in ctrl_k2["obstacles"]["collision_spheres"]))
            k2_requests["full_bottle_point1 collision frames"] = (
                chain_mod.SweepRequest(chain_k2, frames), False)
    k2_err = {}
    t0 = time.perf_counter()
    for label, (req, full) in k2_requests.items():
        nq = req.chain.nq
        for dtype in (torch.float32, torch.float64):
            for P in K2_POINTS:
                gen = torch.Generator(device=dev)
                gen.manual_seed(P)
                x = torch.randn(P, 3 * nq, generator=gen, device=dev, dtype=dtype)
                q = x[:, :nq]
                v, a = (x[:, nq:2 * nq], x[:, 2 * nq:]) if full else (None, None)
                n_dir = 3 * nq if full else nq
                for mode in ("value", "jacobian"):
                    sweep_args = (req, q, v, a) + ((n_dir,) if mode == "jacobian" else ())
                    g = getattr(chain_mod.K2, mode)(*sweep_args)
                    w = getattr(chain_mod.PlainSweep, mode)(*sweep_args)
                    torch.cuda.synchronize()
                    key = f"{label} {mode} {str(dtype)[6:]} P {P}"
                    ok = g.shape == w.shape and g.dtype == dtype and bool(torch.isfinite(g).all())
                    k2_err[key] = float((g - w).abs().max()) / max(1.0, float(w.abs().max()))
                    log(f"  {key}: shape {tuple(g.shape)}, max|K2 - plain| / largest = "
                        f"{k2_err[key]:.3e}")
                    check(ok and k2_err[key] <= K2_TOL[dtype],
                          f"{key}: within {K2_TOL[dtype]} of the largest entry")
                    del g, w
    log(f"  K2 held in {time.perf_counter() - t0:.2f} s")
    results["k2_err"] = k2_err
    k2_max_err_f32 = max(e for k, e in k2_err.items() if "float32" in k)

    # the public helpers that no phase below calls (the exact friction cone,
    # BalanceModel.with_params, KinematicChain.frame_motion at every joint
    # frame) on CUDA tensors in both dtypes against their float64 CPU values,
    # as a fraction of the largest entry
    t0 = time.perf_counter()
    arr_conf = cfg.load_config(cfg.resolve_package_path(
        {"package": "configs", "path": "arrangements.yaml"}))
    arr_conf["balancing"] = {"arrangement": "box_arch", "frictionless": False}
    chain = build_robot_model(cfg.load_config(cfg.resolve_package_path(
        {"package": "configs", "path": "robots/thing.yaml"}))["controller"]["robot"]).chain
    arr_model = parse_control_objects(arr_conf, device="cpu", dtype=torch.float64)[0]
    n_obj, n_c = arr_model.num_objects, arr_model.num_contacts
    rng = np.random.default_rng(0)
    M = rng.standard_normal((4, n_obj, 3, 3))
    helper_in = (rng.standard_normal((4, n_c, 3)), rng.uniform(0.1, 2.0, (4, n_obj)),
                 0.05 * rng.standard_normal((4, n_obj, 3)), 0.01 * M @ np.swapaxes(M, -1, -2),
                 *rng.standard_normal((3, 4, 9)))

    def helpers(device, dtype):
        model = parse_control_objects(arr_conf, device=device, dtype=dtype)[0]
        forces, m, c, inertia, q, v, a = (torch.as_tensor(x, device=device, dtype=dtype)
                                          for x in helper_in)
        out = {"exact cone": balance.contact_force_constraints_exact(model, forces),
               "with_params": model.with_params(m, c, inertia).params}
        for name in chain.joint_names:
            f = chain.frame_motion(name, q, v, a)
            out[f"frame_motion {name}"] = torch.cat([f.R.flatten(-2), f.p, f.v, f.w, f.a, f.al], -1)
        return out

    helper_ref = helpers("cpu", torch.float64)
    worst = {}
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        got = helpers(dev, dtype)
        torch.cuda.synchronize()
        errs = {key: float((got[key].cpu().double() - ref).abs().max())
                / max(1.0, float(ref.abs().max())) for key, ref in helper_ref.items()}
        key = max(errs, key=errs.get)
        worst[str(dtype)[6:]] = errs[key]
        check(all(got[k].shape == ref.shape and got[k].dtype == dtype
                  for k, ref in helper_ref.items()) and errs[key] <= tol,
              f"the helpers on the card in {dtype} within {tol} of their float64 CPU values "
              f"(largest: {key}, {errs[key]:.2e})")
    log(f"  the exact cone (box_arch), with_params and frame_motion at "
        f"{len(chain.joint_names)} frames on the card, batch 4: largest error float64 "
        f"{worst['float64']:.2e}, float32 {worst['float32']:.2e} of the largest entry, "
        f"{time.perf_counter() - t0:.2f} s")
    results["helpers_max_err"] = worst

    # -- 4. batched main path ----------------------------------------------
    log(f"== 4. batched solve: thing_demo, N = {HORIZON}, batch {BATCH}")
    path = cfg.resolve_package_path({"package": "configs", "path": "demos/thing_demo.yaml"})
    config = cfg.load_config(path)
    prob = build_problem(config)  # device="cuda", float32: the defaults
    ocp = prob.ocp
    check((ocp.N, ocp.nx, ocp.nu, ocp.n_eq, ocp.n_ineq, ocp.n_feq)
          == (HORIZON, 27, 13, 6, 80, 21), "thing_demo at full width: N=20 nx=27 nu=13")
    al_cfg = ALConfig(iterations=1, rho_eq=10.0, rho_ineq=10.0,
                      line_search_steps=(1.0, 0.5))
    batched_solve = batch_solve_fn(ocp, al_cfg)

    rng = np.random.default_rng(0)
    x0_np = prob.x0.cpu().numpy()[None, :] + 0.01 * rng.standard_normal((BATCH, ocp.nx))
    x0s = torch.as_tensor(x0_np, dtype=torch.float32, device=dev)
    params = broadcast_params(prob.stage_params(0.0), BATCH)
    cold = batch_warm_starts(ocp, x0s)

    # comparison only (before the counted run): the same cold solve with the
    # plain backward pass passed in explicitly
    sol_plain = solve(ocp, al_cfg, params, x0s, cold,
                      backward=riccati.riccati_backward_plain)
    torch.cuda.synchronize()

    riccati.launch_count = 0
    chain_mod.launch_count.update(value=0, jacobian=0)
    sol = batched_solve(params, x0s, cold)
    torch.cuda.synchronize()

    def rel_err(a, b):
        return float((a - b).abs().max() / max(1.0, float(b.abs().max())))

    # Tolerance: both solves are float32 end to end and differ only in the
    # backward pass's rounding.  Errors are taken relative to the largest
    # entry (K reaches O(100)).  K comes straight out of the backward pass:
    # 1e-3 (about 2e-5 on an H100).  X and U pass through a closed-loop
    # rollout with those gains, which amplifies the difference: 5e-3 (up to
    # 8e-4 on an H100, on the warm solve).
    K_RTOL, SOLVE_RTOL = 1e-3, 5e-3
    for field, a, b in (
        ("X", sol.state.X, sol_plain.state.X),
        ("U", sol.state.U, sol_plain.state.U),
        ("K", sol.K, sol_plain.K),
    ):
        e = rel_err(a, b)
        log(f"  cold solve, kernel vs plain backward: {field} max err / scale = {e:.3e}")
        tol = K_RTOL if field == "K" else SOLVE_RTOL
        check(e <= tol, f"cold solve {field} agrees within {tol}")
        results[f"cold_solve_err_{field}"] = e

    for _ in range(WARM_RESOLVES):
        sol = batched_solve(params, x0s, sol.state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_RESOLVES):
        prev_state = sol.state
        sol = batched_solve(params, x0s, sol.state)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches_batched = riccati.launch_count
    launches_k2_batched = dict(chain_mod.launch_count)
    solves_per_s = BATCH * TIMED_RESOLVES / elapsed
    log(f"  {TIMED_RESOLVES} warm re-solves of batch {BATCH}: {elapsed * 1e3 / TIMED_RESOLVES:.2f} ms"
        f" per call, {solves_per_s:.1f} solves/s")
    results.update(solves_per_s=solves_per_s, batched_call_ms=elapsed * 1e3 / TIMED_RESOLVES)

    n_calls = 1 + WARM_RESOLVES + TIMED_RESOLVES
    check(launches_batched == n_calls * al_cfg.iterations,
          f"the Riccati kernel was launched once per SQP iteration per call ({launches_batched})")
    # K2 in a call of one SQP iteration on the card's wide Jacobian mode: 3
    # Jacobian launches (the stage residuals' and equality rows' sweep under
    # one jacfwd each, the final rows') and 14 value launches, every chain
    # sweep of the call; counted through the same code on the CPU with
    # PlainSweep behind the Function
    K2_PER_SOLVE_CALL = {"value": 14, "jacobian": 3}
    check(al_cfg.iterations == 1 and launches_k2_batched == {
        k: n_calls * n for k, n in K2_PER_SOLVE_CALL.items()},
          f"K2 was launched {K2_PER_SOLVE_CALL} a solve call ({launches_k2_batched} in {n_calls})")
    for name, t in (("X", sol.state.X), ("U", sol.state.U), ("lam", sol.state.lam),
                    ("mu", sol.state.mu), ("lam_f", sol.state.lam_f), ("K", sol.K),
                    ("cost", sol.cost)):
        check(bool(torch.isfinite(t).all()), f"{name} finite on the card")
    check(sol.state.X.shape == (BATCH, HORIZON + 1, 27) and sol.K.shape == (BATCH, HORIZON, 13, 27),
          "output shapes")
    # eq_viol: this problem keeps a residual the frictionless forces cannot
    # cancel at the pinned, perturbed stage 0, so the warm solves settle near
    # 0.1 (the float64 CPU solve too); 0.5 catches a diverging solve.
    EQ_VIOL_BOUND = 0.5
    eq_max = float(sol.eq_viol.max())
    log(f"  after the warm solves: eq_viol max {eq_max:.4f}, median {float(sol.eq_viol.median()):.4f},"
        f" ineq_viol max {float(sol.ineq_viol.max()):.2e}, defect max {float(sol.defect.max()):.2e}")
    check(eq_max < EQ_VIOL_BOUND, f"eq_viol after the warm solves under {EQ_VIOL_BOUND}")
    results["eq_viol_max"] = eq_max

    # comparison only: the last warm solve again with the plain backward.  K
    # comes straight out of the backward pass; X, U also depend on the line
    # search's accept/reject, which float32 merits near convergence can flip,
    # so they are compared on the instances whose decisions agree.
    sol_plain_w = solve(ocp, al_cfg, params, x0s, prev_state,
                        backward=riccati.riccati_backward_plain)
    torch.cuda.synchronize()
    e = rel_err(sol.K, sol_plain_w.K)
    log(f"  warm solve, kernel vs plain backward: K max err / scale = {e:.3e}")
    check(e <= K_RTOL, f"warm solve K agrees within {K_RTOL}")
    same = (sol.defect == 0) == (sol_plain_w.defect == 0)
    check(float(same.float().mean()) >= 0.99, "accept/reject agrees on >= 99% of instances")
    e = rel_err(sol.state.X[same], sol_plain_w.state.X[same])
    log(f"  warm solve X max err / scale = {e:.3e} on {int(same.sum())} instances")
    check(e <= SOLVE_RTOL, f"warm solve X agrees within {SOLVE_RTOL}")
    results["warm_solve_err_K"] = rel_err(sol.K, sol_plain_w.K)

    # -- 5. steady replan ----------------------------------------------------
    log("== 5. steady replan, one instance")
    params1 = broadcast_params(prob.stage_params(0.0), 1)
    state = SolverState(**{f: getattr(sol.state, f)[:1].clone()
                           for f in ("X", "U", "lam", "mu", "lam_f")})
    x_head = state.X[0, 0].cpu().numpy()
    obs_np = x_head[None, :] + 1e-3 * rng.standard_normal((REPLAN_TICKS, ocp.nx))
    obs = torch.as_tensor(obs_np, dtype=torch.float32, device=dev)
    nq = prob.dims.robot_q
    u_lb, u_ub = ocp.u_lb[:nq].cpu(), ocp.u_ub[:nq].cpu()

    riccati.launch_count = 0
    tick_ms = []
    for i in range(REPLAN_TICKS):
        x = obs[i : i + 1]
        t0 = time.perf_counter()
        warm = prob.heal_warm_start(prob.shift_warm_start(state, 0.0), x)
        s = solve(ocp, al_cfg, params1, x, warm)
        u = s.state.U[:, 0] + (s.K[:, 0] @ (x - s.state.X[:, 0]).unsqueeze(-1)).squeeze(-1)
        u_host = u.cpu()  # the command goes back to the host: synchronises
        tick_ms.append((time.perf_counter() - t0) * 1e3)
        state = s.state
        if not bool(torch.isfinite(u_host).all()):
            raise AssertionError(f"replan tick {i}: non-finite input")
        if not bool(((u_host[0, :nq] >= u_lb) & (u_host[0, :nq] <= u_ub)).all()):
            raise AssertionError(f"replan tick {i}: robot input outside its limits")
    launches_replan = riccati.launch_count
    replan_ms = statistics.median(tick_ms[REPLAN_WARMUP:])
    log(f"  {REPLAN_TICKS} ticks: median {replan_ms:.2f} ms per replan "
        f"(max {max(tick_ms[REPLAN_WARMUP:]):.2f}); inputs finite and inside the robot's limits")
    check(launches_replan == REPLAN_TICKS * al_cfg.iterations,
          f"the Riccati kernel was launched once per replan ({launches_replan})")
    results.update(replan_ms=replan_ms)

    # -- 6. kernel times at the main-path shapes -------------------------------
    log("== 6. kernel times (CUDA events, median of 50): one eager call of the wrapper, "
        "and per launch of 20 captured back to back in a CUDA graph")
    inp_b = kernel_inputs["form_b_512x20x27x13"]
    inp_a = kernel_inputs["form_a_512x20x27x13"]
    inp_1 = kernel_inputs["form_b_1x20x27x13"]

    # (label, inputs, runtime-sized instance?, shape for the bound, float64?)
    timed = [
        ("form_b_512x20x27x13", inp_b, False, (BATCH, HORIZON, 27, 13, True), False),
        ("form_a_512x20x27x13", inp_a, False, (BATCH, HORIZON, 27, 13, False), False),
        ("form_b_1x20x27x13", inp_1, False, (1, HORIZON, 27, 13, True), False),
        ("form_b_512x20x27x13_runtime_sized", inp_b, True, (BATCH, HORIZON, 27, 13, True), False),
        ("form_b_1x20x27x13_runtime_sized", inp_1, True, (1, HORIZON, 27, 13, True), False),
        ("form_b_512x20x27x13_f64", tuple(t.double() for t in inp_b), False,
         (BATCH, HORIZON, 27, 13, True), True),
        ("form_b_64x20x27x45", kernel_inputs["form_b_64x20x27x45"], False,
         (64, HORIZON, 27, 45, True), False),
        ("form_a_64x20x27x45", kernel_inputs["form_a_64x20x27x45"], False,
         (64, HORIZON, 27, 45, False), False),
        ("form_b_64x200x27x13", kernel_inputs["form_b_64x200x27x13"], False,
         (64, 200, 27, 13, True), False),
    ]
    # "ms" is one eager call of the wrapper between two events on an idle card,
    # as a caller that waits for each result sees it; "ms_per_launch" is the
    # kernel's device time alone
    kernel_times = {}
    for label, inp, runtime_sized, shape, is_f64 in timed:
        nbytes, flops = riccati_work(*shape, elem_bytes=8 if is_f64 else 4)
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        t_ops = flops / (H100_FP64_FLOPS if is_f64 else H100_FP32_FLOPS) * 1e3
        if runtime_sized:
            call = lambda: riccati._riccati_backward_cuda(*inp, reg, runtime_sized=True)  # noqa: E731
        else:
            call = lambda: riccati.riccati_backward(*inp, reg=reg)  # noqa: E731
        t, t_launch = cuda_median_ms(call, reps=50), cuda_launch_ms(call, reps=50)
        kernel_times[label] = {
            "ms": t, "ms_per_launch": t_launch, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops,
        }
        log(f"  {label}: {t:.4f} ms ({t_launch:.4f} per launch); bound {max(t_bytes, t_ops):.4f} ms "
            f"({nbytes / 1e6:.1f} MB -> {t_bytes:.4f} ms, {flops / 1e9:.3f} GFLOP -> {t_ops:.4f} ms)")
    results["kernel_times"] = kernel_times
    # the bound at ur10_demo's widths, which tools/riccati_times.py times
    for Bt in (BATCH, 1):
        nbytes, flops = riccati_work(Bt, HORIZON, 18, 10, True)
        t_bytes, t_ops = nbytes / H100_BYTES_PER_S * 1e3, flops / H100_FP32_FLOPS * 1e3
        log(f"  bound at {Bt}x{HORIZON}x18x10 (form b, float32): {max(t_bytes, t_ops):.6f} ms "
            f"({'bytes' if t_bytes >= t_ops else 'operations'}; {nbytes / 1e6:.2f} MB -> "
            f"{t_bytes:.6f} ms, {flops / 1e9:.4f} GFLOP -> {t_ops:.6f} ms)")
        results[f"riccati_bound_{Bt}x{HORIZON}x18x10"] = max(t_bytes, t_ops)
    # K2 at the solve cell's points (16,384 x 20) on thing_demo's EE motion,
    # float32: the Jacobian along (q, v, a) (27 directions x 24 numbers), as
    # the linearization launches it, and the value mode; beside their bound
    # (chain_work) and the plain version's Jacobian (PlainSweep: the eager
    # sweep under vmap(jacfwd))
    req_ee = k2_requests["thing_demo ee motion"][0]
    nq_ee, P_ee = req_ee.chain.nq, K2_POINTS[-1]
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    x_ee = torch.randn(P_ee, 3 * nq_ee, generator=gen, device=dev)
    qva_ee = (x_ee[:, :nq_ee], x_ee[:, nq_ee:2 * nq_ee], x_ee[:, 2 * nq_ee:])
    kinds_ee = [j.kind for j in req_ee.chain.joints[:req_ee.n_joints]]
    k2_times = {}
    for mode, n_dir in (("jacobian", 3 * nq_ee), ("value", 0)):
        if n_dir:
            call = functools.partial(chain_mod.K2.jacobian, req_ee, *qva_ee, n_dir)
        else:
            call = functools.partial(chain_mod.K2.value, req_ee, *qva_ee)
        nbytes, flops = chain_work(kinds_ee, nq_ee, req_ee.n_out, P_ee, n_dir, 3)
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        t_ops = flops / H100_FP32_FLOPS * 1e3
        t, t_launch = cuda_median_ms(call, reps=50), cuda_launch_ms(call, reps=50)
        k2_times[mode] = {
            "ms": t, "ms_per_launch": t_launch, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops,
        }
        log(f"  K2 {mode}, P {P_ee}, nq {nq_ee}, float32: {t:.4f} ms ({t_launch:.4f} per launch); "
            f"bound {max(t_bytes, t_ops):.4f} ms ({nbytes / 1e6:.1f} MB -> {t_bytes:.4f} ms, "
            f"{flops / P_ee:.0f} operations a point -> {t_ops:.4f} ms), "
            f"{100 * max(t_bytes, t_ops) / t_launch:.1f}% of it per launch")
    k2_plain_ms = cuda_median_ms(
        functools.partial(chain_mod.PlainSweep.jacobian, req_ee, *qva_ee, 3 * nq_ee),
        reps=3, warmup=1)
    log(f"  K2's plain version, the Jacobian at the same shape: {k2_plain_ms:.2f} ms")
    results.update(k2_times=k2_times, k2_plain_ms=k2_plain_ms)
    del x_ee, qva_ee

    plain_ms = cuda_median_ms(
        lambda: riccati.riccati_backward_plain(*inp_b, reg=reg), reps=3, warmup=1)
    inp_c = kernel_inputs["form_b_64x20x27x45"]
    plain_ms_wide = cuda_median_ms(
        lambda: riccati.riccati_backward_plain(*inp_c, reg=reg), reps=3, warmup=1)

    def riccati_library(A, B, d, grads, hess, gf, Hf):
        """The same recursion on torch.linalg's batched Cholesky (a yardstick
        only: unclamped pivots, no check of the factorisation, and nothing in
        the port calls it)."""
        nx = d.shape[-1]
        Z = torch.cat([A, B], dim=-1)
        eye_u = torch.eye(B.shape[-1], dtype=d.dtype, device=d.device)
        P, p = Hf, gf
        for k in reversed(range(d.shape[1])):
            Pd_p = p + (P @ d[:, k].unsqueeze(-1)).squeeze(-1)
            Q = hess[:, k] + Z.T @ (P @ Z)
            q = grads[:, k] + Pd_p @ Z
            Qux = Q[:, nx:, :nx]
            L, _info = torch.linalg.cholesky_ex(Q[:, nx:, nx:] + reg * eye_u)
            sol_ = -torch.cholesky_solve(torch.cat([Qux, q[:, nx:, None]], dim=-1), L)
            K_k, kff_k = sol_[..., :nx], sol_[..., nx]
            P = Q[:, :nx, :nx] + Qux.transpose(-1, -2) @ K_k
            P = 0.5 * (P + P.transpose(-1, -2))
            p = q[:, :nx] + (Qux.transpose(-1, -2) @ kff_k.unsqueeze(-1)).squeeze(-1)
        return K_k, kff_k

    library_ms = cuda_median_ms(lambda: riccati_library(*inp_b), reps=5, warmup=1)

    # -- 7. the plant's contact kernel vs its plain version -----------------------
    log("== 7. plant kernel P1 vs its plain version on the card, one control tick")
    # Inputs: tools/plant_data.py, made on the CPU in float64 from numpy seeds:
    # the objects settled on a tray that starts to move, nudged, mass and mu
    # within +-20% and the CoM within +-5 mm per instance and object.
    # Tolerances.  float64 kernel against the float64 plain version: 1e-10
    # absolute on r, q, v, w and the anchors, and identical contact and latch
    # flags: both sides are float64 and differ in summation order, fused
    # multiply-adds and the 3 x 3 solve (Cramer's rule against LU), 1e-14 on
    # the emulated kernel.  float32 kernel against the witness, the plain
    # version in float32 on the same float32 inputs: tools/plant_data.py
    # F32_TOL, which the control (the witness with the inertia 10% off) must
    # exceed in every field.  The float32 results' distance from float64 is
    # printed beside, for the kernel and for the witness.
    PLANT_TOL_F64 = 1e-10
    PLANT_TOL_F32 = F32_TOL
    plant_cases = [
        ("thing_b1", ("thing_demo", None, None), 1, ()),
        ("thing_b64", ("thing_demo", None, None), 64, ()),
        ("stacked_b8", ("ur10_demo", "box_arch", None), 8, ()),
        ("cups_b2", ("ur10_demo", "blue_cups", None), 2, ()),
        ("regularized_b8", ("thing_demo", None, "regularized"), 8, ()),
        ("latch_b4", ("thing_demo", None, None), 4, (0, 2)),
        # two stacked dice, 77 substeps a step: phase 17's robust_dice load
        ("dice_b3", ("ur10_demo", "foam_die2", None), 3, ()),
    ]
    # The stacked dice amplify float32 rounding past F32_TOL: on an H100 the
    # kernel and the witness are both 7.7e-3 m/s (v) and 0.29 rad/s (w) from
    # the float64 result and 2.2e-4 / 7.5e-3 from each other, over the limits
    # 1e-4 / 1e-3 (PERF.md, ROADMAP section 3).  There the float32 kernel is
    # held nearer the witness than the control in every field; float64 holds
    # it to PLANT_TOL_F64 as in every case.
    F32_PAST_TOL = {"dice_b3"}

    def fmt(err):
        return ", ".join(f"{k} {v:.2e}" for k, v in err.items())

    plant_err32, plant_err64 = 0.0, 0.0
    plant_inputs, plant_sims, plant_readings = {}, {}, []
    for label, (demo, arrangement, friction), B, diverge in plant_cases:
        sim_cpu = plant_for(demo, arrangement, friction)
        frames, objects, plant_params = tick_inputs(sim_cpu, B, seed=B, diverge=diverge)
        tables64 = sim_cpu.tables.to(device=dev)
        tables32 = tables64.to(dtype=torch.float32)
        consts = sim_cpu.contact

        def on_card(dtype):
            return (frames.to(dev, dtype), objects_to(objects, dev, dtype),
                    {k: v.to(dev, dtype) for k, v in plant_params.items()})

        ref = contact.advance_objects_plain(tables64, consts, *on_card(torch.float64))
        witness, control = float32_witness(tables64, consts, *on_card(torch.float64))
        out64 = contact.advance_objects(tables64, consts, *on_card(torch.float64))
        out32 = contact.advance_objects(tables32, consts, *on_card(torch.float32))
        torch.cuda.synchronize()
        err64, same64 = max_errors(out64, ref)
        err32, same32 = max_errors(out32, witness)
        err_ctl, _ = max_errors(control, witness)
        off64 = {"kernel": max_errors(out32, ref)[0], "witness": max_errors(witness, ref)[0]}
        log(f"  {label} ({demo}{'/' + arrangement if arrangement else ''}, "
            f"{sim_cpu.friction_model}, {sim_cpu.tables.n_slots} slots x batch {B}):\n"
            f"    float64 kernel vs plain: {fmt(err64)}\n"
            f"    float32 kernel vs witness: {fmt(err32)}; flags "
            f"{'identical' if same32 else 'differ'}\n"
            f"    control (inertia x1.1) vs witness: {fmt(err_ctl)}\n"
            f"    float32 vs float64 plain: kernel {fmt(off64['kernel'])}; "
            f"witness {fmt(off64['witness'])}")
        plant_readings.append((label, ref, out32, diverge, err64, same64, err32, err_ctl))
        plant_err64 = max(plant_err64, max(err64.values()))
        plant_err32 = max(plant_err32, max(err32.values()))
        results[f"plant_err_{label}"] = {"float64": err64, "float32_vs_witness": err32,
                                         "control_vs_witness": err_ctl,
                                         "float32_vs_float64": off64}
        plant_inputs[label] = (frames, objects, plant_params)
        plant_sims[label] = sim_cpu
    # every reading is printed before the first check
    for label, ref, out32, diverge, err64, same64, err32, err_ctl in plant_readings:
        check(same64 and max(err64.values()) <= PLANT_TOL_F64,
              f"{label}: float64 within {PLANT_TOL_F64}, contact and latch flags identical")
        if label in F32_PAST_TOL:
            check(all(err32[k] < err_ctl[k] for k in err32),
                  f"{label}: float32 kernel nearer the witness than the control in every field")
        else:
            check(all(err32[k] <= tol for k, tol in PLANT_TOL_F32.items() if k in err32),
                  f"{label}: float32 kernel within {PLANT_TOL_F32} of the witness")
        check(all(err_ctl[k] > tol for k, tol in PLANT_TOL_F32.items() if k in err_ctl),
              f"{label}: the control exceeds every float32 limit")
        check(bool(torch.isfinite(out32.r).all() and torch.isfinite(out32.v).all()),
              f"{label}: float32 state finite")
        if ref.anchor_valid is not None:
            check(bool(ref.anchor_valid.any()), f"{label}: objects in contact after the tick")
        latched = torch.nonzero(ref.diverged.any(-1)).flatten().tolist()
        check(latched == list(diverge) and bool((out32.diverged == ref.diverged).all()),
              f"{label}: latched instances {latched} (float32 and float64 alike)")

    # -- 8. the closed loop ----------------------------------------------------------
    LOOP_TICKS, HOST_TICKS, RATE = 100, 10, 100.0
    log(f"== 8. closed loop on the card: thing_demo, {RATE:.0f} Hz, {LOOP_TICKS} ticks")
    settings = MPCSettings.from_config(config["controller"])
    loop_cfg = settings.al_config()
    sim_l = UprightSimulation(config["simulation"])  # card, float32: the defaults
    check(sim_l.object_substeps == 40 and sim_l.tables.n_slots == 16
          and sim_l.friction_model == "stiction",
          "plant: stiction, 40 substeps per 1 ms step, 16 contact slots")
    init_carry, run = build_device_loop(prob, sim_l, al_cfg=loop_cfg, ctrl_rate=RATE)
    t0 = time.perf_counter()
    carry0 = init_carry()  # the 12-iteration cold solve
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0

    riccati.launch_count = 0
    contact.launch_count = 0
    chain_mod.launch_count.update(value=0, jacobian=0)
    t0 = time.perf_counter()
    carry, metrics = run(carry0, LOOP_TICKS)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    launches_loop_k1, launches_loop_p1 = riccati.launch_count, contact.launch_count
    launches_loop_k2 = dict(chain_mod.launch_count)
    # a tick: 3 Jacobian launches, as phase 4's call, and 17 value launches,
    # 15 of the solve at the loop's settings (the equality rows 6, the stage
    # residuals 5, the final rows 4), the plant's one and the loop's EE pose;
    # counted through the same code on the CPU, as phase 4's
    K2_PER_TICK = {"value": 17, "jacobian": 3}
    check(loop_cfg.iterations == 1 and launches_loop_k2 == {
        k: LOOP_TICKS * n for k, n in K2_PER_TICK.items()},
          f"K2 was launched {K2_PER_TICK} a tick ({launches_loop_k2} in {LOOP_TICKS})")
    check(launches_loop_k1 == LOOP_TICKS * loop_cfg.iterations,
          f"the Riccati kernel was launched once per tick ({launches_loop_k1})")
    check(launches_loop_p1 == LOOP_TICKS,
          f"the plant kernel was launched once per tick ({launches_loop_p1})")
    cost, eq_l, r_ew = metrics.cost.cpu(), metrics.eq_viol.cpu(), metrics.r_ew_w.cpu()
    check(bool(torch.isfinite(cost).all() and torch.isfinite(eq_l).all()
               and torch.isfinite(r_ew).all()), "costs, eq_viol and EE positions finite")
    disp = sim_l.object_displacements(carry.sim)[0]
    target_r = prob.target.poses[0, :3].cpu()
    ee_err = [float(torch.linalg.vector_norm(r_ew[i] - target_r)) for i in (0, -1)]
    log(f"  {LOOP_TICKS} ticks in {loop_s:.2f} s ({loop_s * 1e3 / LOOP_TICKS:.2f} ms per tick; "
        f"cold solve {cold_s:.2f} s); EE error to the first waypoint {ee_err[0]:.4f} -> "
        f"{ee_err[1]:.4f} m; final eq_viol {float(eq_l[-1]):.2e}; bottle displacement "
        f"{float(disp.max()):.2e} m")
    check(bool(np.isfinite(disp).all() and (disp < 0.03).all()),
          "the bottle stays within 0.03 m of its place on the tray")
    results.update(loop_ticks=LOOP_TICKS, loop_s=loop_s, cold_solve_s=cold_s,
                   loop_ee_err=ee_err, loop_eq_viol_final=float(eq_l[-1]),
                   loop_bottle_displacement=float(disp.max()))

    # the host loop (ControllerManager + UprightSimulation, as mpc_sim runs it)
    # against the device loop from the same cold solve.  Tolerances: the host
    # loop carries the acceleration belief and the command in float64 numpy and
    # hands the solver float32, the device loop stays float32 throughout; on
    # the CPU in float32 the two differ after 10 ticks by 7e-12 in q, 1e-7 in
    # the acceleration belief, 3e-6 in X (|X| 1.6) and 0 in the bottle's
    # position, and the tolerances leave a margin of 30 or more
    ctrl = ControllerManager(prob, settings)
    sim_h = UprightSimulation(config["simulation"])
    state_h = sim_h.initial_state()
    nq = sim_h.robot.nq
    a_h = np.zeros(nq)
    dt_ctrl = 1.0 / RATE
    ctrl.warmstart(0.0, np.concatenate([state_h.q[0].cpu().numpy(),
                                        state_h.v[0].cpu().numpy(), a_h]))
    carry_d, _ = run(init_carry(t0=dt_ctrl, solver_state=ctrl.state), HOST_TICKS)
    t = dt_ctrl
    for _ in range(HOST_TICKS):
        q_m, v_m = sim_h.measure(state_h)
        v_np = v_m[0].cpu().numpy()
        x = np.concatenate([q_m[0].cpu().numpy(), v_np, a_h])
        _xd, u = ctrl.step(t, x)
        v_cmd = v_np + dt_ctrl * a_h + 0.5 * dt_ctrl**2 * u[:nq]
        a_h = a_h + dt_ctrl * u[:nq]
        state_h = sim_h.step(state_h, torch.as_tensor(v_cmd), n_steps=10)
        t += dt_ctrl
    torch.cuda.synchronize()
    HOST_TOL = {"q": 1e-6, "a_state": 1e-4, "X": 1e-4, "bottle r": 1e-6}
    host_err = {
        "q": float((carry_d.sim.q - state_h.q).abs().max()),
        "a_state": float((carry_d.a_state[0].cpu().double() - torch.as_tensor(a_h)).abs().max()),
        "X": float((carry_d.solver.X - ctrl.state.X).abs().max()),
        "bottle r": float((carry_d.sim.objects.r - state_h.objects.r).abs().max()),
    }
    log("  host loop vs device loop after 10 ticks: "
        + ", ".join(f"{k} {v:.2e}" for k, v in host_err.items()))
    check(all(host_err[k] <= tol for k, tol in HOST_TOL.items()),
          f"host loop and device loop agree within {HOST_TOL}")
    results["host_vs_device_loop"] = host_err

    # -- 9. times: P1 and the closed loop's tick ---------------------------------
    log("== 9. plant kernel times (CUDA events, median) and the closed loop's host time per tick")
    tables32 = sim_l.tables

    def plant_in(label, repeat=1, n=None):
        frames, objects, params = plant_inputs[label]
        if n is not None:  # the first n instances
            frames, params = frames[:n], {k: v[:n] for k, v in params.items()}
            objects = objects.replace(**{k: getattr(objects, k)[:n] for k in (
                "r", "q", "v", "w", "anchors", "anchor_valid", "diverged")
                if getattr(objects, k) is not None})
        f32 = objects_to(objects, dev, torch.float32)
        if repeat > 1:
            f32 = f32.replace(**{k: getattr(f32, k).repeat((repeat,) + (1,) * (getattr(f32, k).ndim - 1))
                                 for k in ("r", "q", "v", "w", "anchors", "anchor_valid", "diverged")})
        return (frames.to(dev, torch.float32).repeat(repeat, 1, 1), f32,
                {k: v.to(dev, torch.float32).repeat((repeat,) + (1,) * (v.ndim - 1))
                 for k, v in params.items()})

    plant_times = {}
    cups, arch = plant_sims["cups_b2"], plant_sims["stacked_b8"]
    for name, inp, tables_, consts_ in (
        ("batch1", plant_in("thing_b1"), tables32, sim_l.contact),
        ("batch512", plant_in("thing_b64", 8), tables32, sim_l.contact),
        ("box_arch_batch1", plant_in("stacked_b8", n=1),
         arch.tables.to(device=dev, dtype=torch.float32), arch.contact),
        ("blue_cups_batch1", plant_in("cups_b2", n=1),
         cups.tables.to(device=dev, dtype=torch.float32), cups.contact),
    ):
        B = inp[0].shape[0]
        call = lambda: contact.advance_objects(tables_, consts_, *inp)  # noqa: E731
        nbytes, flops = contact.plant_work(tables_, consts_, B, inp[0].shape[1], 4)
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        t_ops = flops / H100_FP32_FLOPS * 1e3
        t, t_launch = cuda_median_ms(call, reps=20), cuda_launch_ms(call, reps=10, inner=5)
        plant_times[name] = {"ms": t, "ms_per_launch": t_launch, "bound_ms": max(t_bytes, t_ops),
                             "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                             "bytes": nbytes, "flops": flops}
        log(f"  P1 {name}: {t:.4f} ms ({t_launch:.4f} per launch); bound {max(t_bytes, t_ops):.6f} ms "
            f"({nbytes / 1e3:.1f} kB -> {t_bytes:.6f} ms, {flops / 1e6:.2f} MFLOP -> {t_ops:.6f} ms)")
    inp1 = plant_in("thing_b1")
    plant_plain_ms = cuda_median_ms(
        lambda: contact.advance_objects_plain(tables32, sim_l.contact, *inp1), reps=1, warmup=0)
    log(f"  P1 plain version, one tick at batch 1: {plant_plain_ms:.1f} ms")

    # host time per tick of the closed loop (between synchronisations, median
    # of 20): one tick of the device loop, and the plant's step alone
    def host_ms(fn, reps=20):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    tick_ms = host_ms(lambda: run(carry, 1))
    plant_step_ms = host_ms(lambda: sim_l.step(carry.sim, carry.sim.v, n_steps=10))
    log(f"  closed loop, host ms per tick: {tick_ms:.2f} = replan {tick_ms - plant_step_ms:.2f} "
        f"+ plant {plant_step_ms:.2f} (of which P1 {plant_times['batch1']['ms']:.3f})")
    results.update(plant_times=plant_times, plant_plain_ms=plant_plain_ms, loop_tick_ms=tick_ms,
                   loop_plant_ms=plant_step_ms, loop_replan_ms=tick_ms - plant_step_ms)

    # -- 10. the obstacle course: full_bottle_point1 --------------------------------
    FB_PATH = "ral23/static_obstacles/full_bottle_point1.yaml"
    log(f"== 10. batched solve and steady replan: {FB_PATH}, N = {HORIZON}, batch {BATCH}")
    fb_config = cfg.load_config(cfg.resolve_package_path({"package": "configs", "path": FB_PATH}))
    fb = build_problem(fb_config)  # device="cuda", float32: the defaults
    fb_ocp = fb.ocp
    check((fb_ocp.N, fb_ocp.nx, fb_ocp.nu, fb_ocp.n_eq, fb_ocp.n_ineq, fb_ocp.n_feq)
          == (HORIZON, 27, 21, 6, 152, 21),
          "full_bottle_point1 at full width: nx 27, nu 21 (4 frictional contacts), n_eq 6, "
          "152 inequality rows (cones 20, state 54, input 42, collisions 36)")
    groups_at, off = {}, 0
    for name, n_rows in fb.ineq_groups:
        groups_at[name] = slice(off, off + n_rows)
        off += n_rows
    coll = groups_at["collision_pair_distances"]

    def min_collision_row(problem, X, U, t):
        p = broadcast_params(problem.stage_params(t), X.shape[0])["stage"]
        return float(problem.ocp.ineq(X[:, :-1], U, p)[..., coll].min())

    fb_x0s = torch.as_tensor(
        fb.x0.cpu().numpy()[None, :] + 0.01 * np.random.default_rng(0).standard_normal(
            (BATCH, fb_ocp.nx)), dtype=torch.float32, device=dev)
    fb_params = broadcast_params(fb.stage_params(0.0), BATCH)
    # a cold solve of 12 iterations with the controller's line-search ladder
    # (from the cold start neither step of (1.0, 0.5) is taken), then the
    # warm re-solves of phase 4's configuration
    fb_cold_cfg = ALConfig(iterations=12, rho_eq=10.0, rho_ineq=10.0)
    fb_solve = batch_solve_fn(fb_ocp, al_cfg)
    riccati.launch_count = 0
    t0 = time.perf_counter()
    fb_sol = solve(fb_ocp, fb_cold_cfg, fb_params, fb_x0s, batch_warm_starts(fb_ocp, fb_x0s))
    torch.cuda.synchronize()
    fb_cold_s = time.perf_counter() - t0
    for _ in range(WARM_RESOLVES):
        fb_sol = fb_solve(fb_params, fb_x0s, fb_sol.state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_RESOLVES):
        fb_prev_state = fb_sol.state
        fb_sol = fb_solve(fb_params, fb_x0s, fb_sol.state)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches_fb = riccati.launch_count
    fb_solves_per_s = BATCH * TIMED_RESOLVES / elapsed
    fb_calls = 1 + WARM_RESOLVES + TIMED_RESOLVES
    fb_iterations = fb_cold_cfg.iterations + (WARM_RESOLVES + TIMED_RESOLVES) * al_cfg.iterations
    log(f"  cold solve (12 iterations, batch {BATCH}) {fb_cold_s:.2f} s; {TIMED_RESOLVES} warm "
        f"re-solves: {elapsed * 1e3 / TIMED_RESOLVES:.2f} ms per call, {fb_solves_per_s:.1f} "
        f"solves/s (thing_demo in phase 4: {solves_per_s:.1f})")
    check(launches_fb == fb_iterations,
          f"K1 was launched once per SQP iteration: {launches_fb} launches in {fb_calls} calls "
          f"of {fb_iterations} iterations ({launches_fb / fb_iterations:.0f} per iteration, "
          f"{al_cfg.iterations} per warm solve)")
    for name, t in (("X", fb_sol.state.X), ("U", fb_sol.state.U), ("mu", fb_sol.state.mu),
                    ("K", fb_sol.K), ("cost", fb_sol.cost)):
        check(bool(torch.isfinite(t).all()), f"full_bottle {name} finite on the card")
    fb_eq = float(fb_sol.eq_viol.max())
    fb_coll = min_collision_row(fb, fb_sol.state.X, fb_sol.state.U, 0.0)
    log(f"  after the warm solves: eq_viol max {fb_eq:.4f}, median "
        f"{float(fb_sol.eq_viol.median()):.4f}; ineq_viol max {float(fb_sol.ineq_viol.max()):.2e};"
        f" smallest collision row of the solutions {fb_coll:.4f} m")
    # eq_viol: 12 cold iterations leave this problem short of the 150 its
    # config asks for (0.42 at batch 8 in float32 on the CPU, the same code);
    # 1.0 catches a diverging solve
    FB_EQ_VIOL_BOUND = 1.0
    check(fb_eq < FB_EQ_VIOL_BOUND,
          f"full_bottle eq_viol after the warm solves under {FB_EQ_VIOL_BOUND}")
    check(fb_coll > -0.05, "full_bottle: the planned spheres stay clear of the obstacles "
          "(smallest collision row above -0.05)")
    results.update(fb_solves_per_s=fb_solves_per_s, fb_batched_call_ms=elapsed * 1e3 / TIMED_RESOLVES,
                   fb_cold_solve_s=fb_cold_s, fb_eq_viol_max=fb_eq, fb_min_collision_row=fb_coll,
                   fb_launches_per_iteration=launches_fb / fb_iterations)

    # the steady replan, as phase 5
    fb_params1 = broadcast_params(fb.stage_params(0.0), 1)
    fb_state = SolverState(**{f: getattr(fb_sol.state, f)[:1].clone()
                              for f in ("X", "U", "lam", "mu", "lam_f")})
    fb_obs = torch.as_tensor(
        fb_state.X[0, 0].cpu().numpy()[None, :]
        + 1e-3 * rng.standard_normal((REPLAN_TICKS, fb_ocp.nx)), dtype=torch.float32, device=dev)
    fb_nq = fb.dims.robot_q
    fb_u_lb, fb_u_ub = fb_ocp.u_lb[:fb_nq].cpu(), fb_ocp.u_ub[:fb_nq].cpu()
    riccati.launch_count = 0
    fb_tick_ms = []
    for i in range(REPLAN_TICKS):
        x = fb_obs[i : i + 1]
        t0 = time.perf_counter()
        warm = fb.heal_warm_start(fb.shift_warm_start(fb_state, 0.0), x)
        s = solve(fb_ocp, al_cfg, fb_params1, x, warm)
        u = s.state.U[:, 0] + (s.K[:, 0] @ (x - s.state.X[:, 0]).unsqueeze(-1)).squeeze(-1)
        u_host = u.cpu()
        fb_tick_ms.append((time.perf_counter() - t0) * 1e3)
        fb_state = s.state
        if not bool(torch.isfinite(u_host).all()):
            raise AssertionError(f"full_bottle replan tick {i}: non-finite input")
        if not bool(((u_host[0, :fb_nq] >= fb_u_lb) & (u_host[0, :fb_nq] <= fb_u_ub)).all()):
            raise AssertionError(f"full_bottle replan tick {i}: robot input outside its limits")
    launches_fb_replan = riccati.launch_count
    fb_replan_ms = statistics.median(fb_tick_ms[REPLAN_WARMUP:])
    log(f"  {REPLAN_TICKS} replan ticks: median {fb_replan_ms:.2f} ms per replan (max "
        f"{max(fb_tick_ms[REPLAN_WARMUP:]):.2f}; thing_demo in phase 5: {replan_ms:.2f})")
    check(launches_fb_replan == REPLAN_TICKS * al_cfg.iterations,
          f"K1 was launched once per replan ({launches_fb_replan})")
    results.update(fb_replan_ms=fb_replan_ms)

    # -- 11. K1 on the solver's own stage data ----------------------------------------
    log("== 11. K1 against its plain version on the stage data the solver hands it")
    # (label, config, batch): each width's stage data is the second iteration
    # of a cold solve (tools/stage_data.py solver_stage_data)
    widths = [
        ("27x21", FB_PATH, BATCH),
        ("27x9", "ral23/static_obstacles/aligned_bottle_point1.yaml", 64),
        ("36x13", "ral23/sudden_obstacle/sudden_t1.0.yaml", 64),
        ("27x33", "ral23/freespace/full_dice_point1.yaml", 64),
        ("27x93", "ral23/static_obstacles/full_cups_point2.yaml", 64),
        # the other widths of the ral23 configs (phase 17 runs the first
        # three and 27/57 in closed loop)
        ("27x17", "ral23/static_obstacles/robust_dice_point1.yaml", 64),
        ("27x25", "ral23/static_obstacles/robust_arch_point1.yaml", 64),
        ("27x37", "ral23/static_obstacles/robust_cups_point1.yaml", 64),
        ("18x22", "ral23/static_obstacles/robust_arch_arm_only.yaml", 64),
        ("18x34", "ral23/static_obstacles/robust_cups_arm_only.yaml", 64),
        ("18x54", "ral23/static_obstacles/full_arch_arm_only.yaml", 64),
        ("27x57", "ral23/freespace/full_arch_point1.yaml", 64),
        ("18x90", "ral23/static_obstacles/full_cups_arm_only.yaml", 64),
    ]

    def k1_on_solver_data(label, data, source):
        """K1 in float32 and float64 against the float64 plain version on the
        stage data ``data`` (float32, as the solver hands it), the plain
        version's own float32 error beside; times and bounds in both dtypes,
        torch.linalg loop.  Returns (timing, reading)."""
        (B, horizon, nx_), nu_ = data[2].shape, data[1].shape[-1]
        f64 = tuple(t.double() for t in data)
        K_ref, kff_ref = riccati.riccati_backward_plain(*f64, reg=reg)
        K_w, kff_w = riccati.riccati_backward_plain(*data, reg=reg)  # the plain version in float32
        K32, kff32 = riccati.riccati_backward(*data, reg=reg)
        torch.cuda.synchronize()
        scale = max(1.0, float(K_ref.abs().max()))

        def err(K, kff):
            return max(float((K.double() - K_ref).abs().max()),
                       float((kff.double() - kff_ref).abs().max())) / scale

        K64, kff64 = riccati.riccati_backward(*f64, reg=reg)
        torch.cuda.synchronize()
        reading = {"float32": err(K32, kff32), "plain_float32": err(K_w, kff_w),
                   "float64": err(K64, kff64), "abs_K_max": scale}
        invariant = data[0].ndim == 2
        inst = attrs["float32 runtime-sized" if nu_ <= 16 else "float32 wide"]
        call = lambda: riccati.riccati_backward(*data, reg=reg)  # noqa: E731
        call64 = lambda: riccati.riccati_backward(*f64, reg=reg)  # noqa: E731
        timing = {
            "ms": cuda_median_ms(call, reps=20), "ms_per_launch": cuda_launch_ms(call, reps=20),
            "ms_per_launch_float64": cuda_launch_ms(call64, reps=10),
            "library_ms": cuda_median_ms(lambda: riccati_library(*data), reps=5, warmup=1),
            "plain_ms": cuda_median_ms(lambda: riccati.riccati_backward_plain(*data, reg=reg),
                                       reps=1, warmup=0),
            "smem_bytes": riccati.smem_bytes(nx_, nu_, torch.float32, True),
            "smem_bytes_float64": riccati.smem_bytes(nx_, nu_, torch.float64, True),
            "registers": inst["registers"], "local_bytes": inst["local_bytes"],
            "batch": B, "route": ("register elimination" if nu_ <= 16 else
                                  "wide route, clamped pivots" if nu_ <= riccati.MAX_NU
                                  else "wide route, jitter and NaN fallback"),
        }
        # the bounds: float32 at the FP32 peak, float64 at the FP64 peak
        for suffix, elem_bytes, peak in (("", 4, H100_FP32_FLOPS), ("_float64", 8, H100_FP64_FLOPS)):
            nbytes, flops = riccati_work(B, horizon, nx_, nu_, invariant, elem_bytes=elem_bytes)
            t_bytes, t_ops = nbytes / H100_BYTES_PER_S * 1e3, flops / peak * 1e3
            timing.update({f"bound_ms{suffix}": max(t_bytes, t_ops),
                           f"bound_by{suffix}": "bytes" if t_bytes >= t_ops else "operations",
                           f"bytes{suffix}": nbytes, f"flops{suffix}": flops})
        log(f"  {label} ({source}, batch {B}, N {horizon}, form {'b' if invariant else 'a'}, "
            f"{timing['route']}): float32 kernel {reading['float32']:.2e}, plain float32 "
            f"{reading['plain_float32']:.2e}, float64 kernel {reading['float64']:.2e} of the "
            f"largest entry {scale:.3g}\n    {timing['ms']:.4f} ms eager, "
            f"{timing['ms_per_launch']:.4f} ms per launch; bound {timing['bound_ms']:.4f} ms "
            f"({timing['bound_by']}); float64 {timing['ms_per_launch_float64']:.4f} ms per launch, "
            f"bound {timing['bound_ms_float64']:.4f} ms ({timing['bound_by_float64']}; "
            f"{timing['flops_float64'] / H100_FP64_VECTOR_FLOPS * 1e3:.4f} ms of operations "
            f"outside the tensor cores); "
            f"torch.linalg loop {timing['library_ms']:.2f} ms; plain {timing['plain_ms']:.1f} ms; "
            f"float32 instance {timing['registers']} registers, {timing['local_bytes']} bytes of "
            f"local memory, {timing['smem_bytes']} bytes of shared memory a block "
            f"({timing['smem_bytes_float64']} in float64) [{card_line}]")
        return timing, reading

    solver_widths, width_readings = {}, []
    for label, path, B in widths:
        data = solver_stage_data(path, B)
        nx_, nu_ = data[2].shape[-1], data[1].shape[-1]
        check(f"{nx_}x{nu_}" == label, f"{path}: the solver hands K1 nx {nx_}, nu {nu_}")
        timing, reading = k1_on_solver_data(label, data, path)
        solver_widths[label] = {**timing, "errors": reading, "config": path}
        width_readings.append((label, reading))
    # the same readings on phase 3's seeded 27/45 data (numpy seed 5), a
    # reading only: phase 3 holds the kernel there
    timing, reading = k1_on_solver_data("27x45", kernel_inputs["form_b_64x20x27x45"],
                                        "seeded data, tools/stage_data.py seed 5")
    solver_widths["27x45_seeded"] = {**timing, "errors": reading, "config": None}
    # every reading is printed before the first check.  Tolerances: the
    # float64 kernel at every width, phase 3's float64 tolerance, 1e-10 of
    # the largest entry.
    # The float32 kernel: phase 3's 1e-4 holds on its random stage data, but
    # on the solver's data the plain version run in float32 is itself 1.15e-4
    # from float64 at 27/21 (on an H100), so K1 in float32 is held to phase
    # 4's tolerance on K from the solver path, 1e-3 of the largest entry, and
    # to within 3x of the plain version's own float32 error (at most 1.4x over
    # the five widths on an H100)
    W32_FACTOR = 3.0
    for label, reading in width_readings:
        check(reading["float64"] <= KERNEL_RTOL_F64,
              f"{label}: float64 kernel within {KERNEL_RTOL_F64} of the largest entry")
        check(reading["float32"] <= K_RTOL
              and reading["float32"] <= W32_FACTOR * reading["plain_float32"],
              f"{label}: float32 kernel within {K_RTOL} of the largest entry and within "
              f"{W32_FACTOR}x of the plain version's float32 error")
    results["solver_widths"] = solver_widths

    # -- 12. the obstacle course in the closed loop ----------------------------------
    FB_TICKS = 50
    log(f"== 12. closed loop on the card: full_bottle_point1, {RATE:.0f} Hz, {FB_TICKS} ticks")
    fb_loop_cfg = MPCSettings.from_config(fb_config["controller"]).al_config()
    sim_fb = UprightSimulation(fb_config["simulation"])
    init_fb, run_fb = build_device_loop(fb, sim_fb, al_cfg=fb_loop_cfg, ctrl_rate=RATE)
    t0 = time.perf_counter()
    carry_fb0 = init_fb()  # the 12-iteration cold solve
    torch.cuda.synchronize()
    fb_loop_cold_s = time.perf_counter() - t0
    riccati.launch_count = 0
    contact.launch_count = 0
    t0 = time.perf_counter()
    carry_fb, metrics_fb = run_fb(carry_fb0, FB_TICKS)
    torch.cuda.synchronize()
    fb_loop_s = time.perf_counter() - t0
    launches_fb_loop_k1, launches_fb_loop_p1 = riccati.launch_count, contact.launch_count
    check(launches_fb_loop_k1 == FB_TICKS * fb_loop_cfg.iterations,
          f"K1 was launched ticks x SQP iterations times ({launches_fb_loop_k1})")
    check(launches_fb_loop_p1 == FB_TICKS, f"P1 was launched once per tick ({launches_fb_loop_p1})")
    cost_fb, eq_fb, r_fb = metrics_fb.cost.cpu(), metrics_fb.eq_viol.cpu(), metrics_fb.r_ew_w.cpu()
    check(bool(torch.isfinite(cost_fb).all() and torch.isfinite(eq_fb).all()
               and torch.isfinite(r_fb).all()), "costs, eq_viol and EE positions finite")
    disp_fb = sim_fb.object_displacements(carry_fb.sim)[0]
    t_last = float(carry_fb.t) - 1.0 / RATE  # the time of the last replan
    coll_fb = min_collision_row(fb, carry_fb.solver.X, carry_fb.solver.U, t_last)
    target_fb = fb.target.poses[0, :3].cpu()
    ee_err_fb = [float(torch.linalg.vector_norm(r_fb[i] - target_fb)) for i in (0, -1)]
    log(f"  {FB_TICKS} ticks in {fb_loop_s:.2f} s ({fb_loop_s * 1e3 / FB_TICKS:.2f} ms per tick; "
        f"cold solve {fb_loop_cold_s:.2f} s); EE error to the first waypoint {ee_err_fb[0]:.4f} -> "
        f"{ee_err_fb[1]:.4f} m; final eq_viol {float(eq_fb[-1]):.2e}; bottle displacement "
        f"{float(disp_fb.max()):.2e} m; smallest collision row of the last plan {coll_fb:.4f} m")
    check(bool(np.isfinite(disp_fb).all() and (disp_fb < 0.03).all()),
          "the bottle stays within 0.03 m of its place on the tray")
    check(coll_fb > -0.05, "the last plan keeps every collision row above -0.05")
    fb_tick_host_ms = host_ms(lambda: run_fb(carry_fb, 1))
    fb_plant_ms = host_ms(lambda: sim_fb.step(carry_fb.sim, carry_fb.sim.v, n_steps=10))
    log(f"  closed loop, host ms per tick: {fb_tick_host_ms:.2f} = replan "
        f"{fb_tick_host_ms - fb_plant_ms:.2f} + plant {fb_plant_ms:.2f} (thing_demo in phase 9: "
        f"{tick_ms:.2f})")
    results.update(fb_loop_ticks=FB_TICKS, fb_loop_s=fb_loop_s, fb_loop_cold_solve_s=fb_loop_cold_s,
                   fb_loop_ee_err=ee_err_fb, fb_loop_eq_viol_final=float(eq_fb[-1]),
                   fb_loop_bottle_displacement=float(disp_fb.max()),
                   fb_loop_min_collision_row=coll_fb, fb_loop_tick_ms=fb_tick_host_ms,
                   fb_loop_plant_ms=fb_plant_ms, fb_loop_replan_ms=fb_tick_host_ms - fb_plant_ms)

    # -- 13. the closed loop batched over targets -------------------------------------
    BATCHES, BATCH_TICKS = (1, 8, 64), 20
    log(f"== 13. batched closed loop on the card: thing_demo, B = {BATCHES} targets, "
        f"{RATE:.0f} Hz, {BATCH_TICKS} ticks each")
    # each instance's waypoint: the demo's, offset by up to 0.2 m (numpy seed 0)
    offsets = np.random.default_rng(0).uniform(-0.2, 0.2, (max(BATCHES), 3))

    def offset_targets(problem, offs):
        """One target per offset: the problem's, moved by it."""
        targets = []
        for off in offs:
            poses = problem.target.poses.clone()
            poses[:, :3] += torch.as_tensor(off, dtype=poses.dtype, device=poses.device)
            targets.append(TargetTrajectory(times=problem.target.times, poses=poses))
        return targets

    batched_loop = {}
    launches_batched_loop = {}
    for Bn in BATCHES:
        stack = stack_targets(offset_targets(prob, offsets[:Bn]))
        t0 = time.perf_counter()
        carry_b = init_carry(target=stack)  # one batched 12-iteration cold solve
        torch.cuda.synchronize()
        cold_b = time.perf_counter() - t0
        riccati.launch_count = 0
        contact.launch_count = 0
        t0 = time.perf_counter()
        carry_b, metrics_b = run(carry_b, BATCH_TICKS, target=stack)
        torch.cuda.synchronize()
        loop_b = time.perf_counter() - t0
        k1_b, p1_b = riccati.launch_count, contact.launch_count
        launches_batched_loop[Bn] = (k1_b, p1_b)
        check(k1_b == BATCH_TICKS * loop_cfg.iterations and p1_b == BATCH_TICKS,
              f"B = {Bn}: K1 ({k1_b}) and P1 ({p1_b}) launched once per tick for the whole batch")
        cost_b = metrics_b.cost.cpu()
        check(cost_b.shape == (BATCH_TICKS, Bn) and bool(torch.isfinite(cost_b).all())
              and bool(torch.isfinite(metrics_b.r_ew_w).all()),
              f"B = {Bn}: costs and EE positions finite, one column per instance")
        disp_b = sim_l.object_displacements(carry_b.sim)
        ms_tick = loop_b * 1e3 / BATCH_TICKS
        batched_loop[Bn] = {"ms_per_tick": ms_tick, "instance_ticks_per_s": Bn * BATCH_TICKS / loop_b,
                            "cold_solve_s": cold_b, "bottle_displacement_max": float(disp_b.max())}
        log(f"  B = {Bn}: {ms_tick:.2f} ms per tick, {Bn * BATCH_TICKS / loop_b:.1f} instance-ticks/s "
            f"(cold solve {cold_b:.2f} s); largest bottle displacement {float(disp_b.max()):.2e} m")
    check(all(v["bottle_displacement_max"] < 0.03 for v in batched_loop.values()),
          "every bottle of every batch within 0.03 m of its place")
    log(f"  ms per tick at B = 64 / B = 1: "
        f"{batched_loop[64]['ms_per_tick'] / batched_loop[1]['ms_per_tick']:.2f}; instance-ticks/s "
        f"{batched_loop[64]['instance_ticks_per_s'] / batched_loop[1]['instance_ticks_per_s']:.1f}x")

    # B = 3 in float64 against three batch-1 runs: the same arithmetic per
    # instance (K1 and P1 run one block per instance), so 1e-10 absolute (the
    # CPU test's tolerance) leaves room for cuBLAS's batch-dependent orders
    EQUAL_TICKS, EQUAL_TOL = 5, 1e-10
    prob64 = build_problem(config, device="cuda", dtype=torch.float64)
    sim64 = UprightSimulation(config["simulation"], device="cuda", dtype=torch.float64)
    init64, run64 = build_device_loop(prob64, sim64, al_cfg=loop_cfg, ctrl_rate=RATE)
    singles = offset_targets(prob64, offsets[:3])
    stack64 = stack_targets(singles)
    carry64, _ = run64(init64(target=stack64), EQUAL_TICKS, target=stack64)
    equal_err = 0.0
    for b, single in enumerate(singles):
        c1, _ = run64(init64(target=single), EQUAL_TICKS, target=single)
        for a_, b_ in ((carry64.sim.q[b], c1.sim.q[0]), (carry64.solver.X[b], c1.solver.X[0]),
                       (carry64.a_state[b], c1.a_state[0]),
                       (carry64.sim.objects.r[b], c1.sim.objects.r[0])):
            equal_err = max(equal_err, float((a_ - b_).abs().max()))
    torch.cuda.synchronize()
    log(f"  float64, B = 3 against three batch-1 runs over {EQUAL_TICKS} ticks: max |diff| "
        f"{equal_err:.2e} (q, X, a_state, bottle r)")
    check(equal_err <= EQUAL_TOL, f"the batch equals the batch-1 runs within {EQUAL_TOL}")
    results.update(batched_loop=batched_loop, batched_loop_float64_err=equal_err)

    # the ral23 group of scripts/ral23_sweep.py: full_bottle_point{1,2,3} as one loop
    GROUP_TICKS = 100
    group_paths = [f"ral23/static_obstacles/full_bottle_point{i}.yaml" for i in (1, 2, 3)]
    log(f"  the group {group_paths[0][:-11]}point{{1,2,3}}: one B = 3 loop of {GROUP_TICKS} ticks")
    nq_fb = fb.dims.robot_q
    R0, r0 = fb.robot.ee_pose(fb.x0[:nq_fb])
    q0 = rot_to_quat(R0)
    group = stack_targets([
        TargetTrajectory.from_waypoints(
            cfg.load_config(cfg.resolve_package_path({"package": "configs", "path": p}))
            ["controller"].get("waypoints", [{"time": 0.0}]), r0.cpu().numpy(), q0.cpu().numpy())
        for p in group_paths])
    t0 = time.perf_counter()
    carry_g = init_fb(target=group)
    torch.cuda.synchronize()
    group_cold_s = time.perf_counter() - t0
    riccati.launch_count = 0
    contact.launch_count = 0
    t0 = time.perf_counter()
    carry_g, metrics_g = run_fb(carry_g, GROUP_TICKS, target=group)
    torch.cuda.synchronize()
    group_s = time.perf_counter() - t0
    launches_group = (riccati.launch_count, contact.launch_count)
    check(launches_group == (GROUP_TICKS * fb_loop_cfg.iterations, GROUP_TICKS),
          f"K1 and P1 launched once per tick for the group ({launches_group})")
    disp_g = sim_fb.object_displacements(carry_g.sim)[:, 0]
    t_last_g = float(carry_g.t) - 1.0 / RATE
    coll_g = [min_collision_row(fb, carry_g.solver.X[b : b + 1], carry_g.solver.U[b : b + 1],
                                t_last_g) for b in range(3)]
    r_g = metrics_g.r_ew_w[-1].cpu()
    ee_err_g = [float(torch.linalg.vector_norm(r_g[b] - group.poses[b, 0, :3].cpu()))
                for b in range(3)]
    log(f"  {GROUP_TICKS} ticks in {group_s:.2f} s ({group_s * 1e3 / GROUP_TICKS:.2f} ms per tick for "
        f"3 loops; cold solve {group_cold_s:.2f} s); bottle displacement "
        + ", ".join(f"{d:.2e}" for d in disp_g) + " m; smallest collision row of the last plans "
        + ", ".join(f"{c:.4f}" for c in coll_g) + " m; EE to the waypoints "
        + ", ".join(f"{e:.4f}" for e in ee_err_g) + " m")
    check(bool(torch.isfinite(metrics_g.cost).all()), "group: costs finite")
    check(bool(np.isfinite(disp_g).all() and (disp_g < 0.03).all()),
          "group: every bottle within 0.03 m of its place")
    check(min(coll_g) > -0.05, "group: every last plan keeps its collision rows above -0.05")
    results.update(group_ms_per_tick=group_s * 1e3 / GROUP_TICKS, group_cold_solve_s=group_cold_s,
                   group_bottle_displacement=disp_g.tolist(), group_min_collision_row=coll_g,
                   group_ee_err=ee_err_g)

    # -- 14. the projectile closed loop ------------------------------------------
    PROJ_PATH, PROJ_S = "demos/thing_projectile_demo.yaml", 2.0
    log(f"== 14. projectile closed loop on the card: {PROJ_PATH}, {PROJ_S} s at 125 Hz "
        "(scripts/mpc_sim.py run_closed_loop; the ball is thrown at 1.0 s)")
    proj_config = cfg.load_config(cfg.resolve_package_path({"package": "configs", "path": PROJ_PATH}))
    proj_log = DataLogger(timestep=0.0)  # every tick
    riccati.launch_count = 0
    contact.launch_count = 0
    t0 = time.perf_counter()
    sim_p, state_p, ctrl_p, proj_log = mpc_sim.run_closed_loop(proj_config, duration=PROJ_S,
                                                               log=proj_log)
    torch.cuda.synchronize()
    proj_s = time.perf_counter() - t0
    launches_proj = (riccati.launch_count, contact.launch_count)
    data_p = proj_log.as_arrays()
    n_ticks_p = len(data_p["t"])
    n_solves_p = len(ctrl_p.replanning_durations)
    check(ctrl_p.problem.dims.num_obstacles == 1 and (ctrl_p.problem.ocp.nx, ctrl_p.problem.ocp.nu)
          == (36, 13), "thing_projectile_demo: one 9-state obstacle, nx 36, nu 13")
    check(launches_proj == (ctrl_p.settings.warmstart_iterations
                            + (n_solves_p - 1) * ctrl_p.settings.iterations, n_ticks_p),
          f"K1 launched once per SQP iteration of {n_solves_p} solves, P1 once per tick "
          f"({launches_proj})")
    phases_p = [int(p) for p in data_p["projectile_phase"]]
    sequence = [phases_p[0]] + [p for a_, p in zip(phases_p, phases_p[1:]) if p != a_]
    names = {0: "PREFLIGHT", 1: "FLIGHT", 2: "POSTFLIGHT"}
    # the ball's distance from the centre of the balanced object's collision
    # sphere (on the EE frame, 0.07 m along its z: configs/obstacles/projectile.yaml)
    R_p = quat_to_rot(torch.as_tensor(data_p["Q_we"], dtype=torch.float64)).numpy()
    sphere = data_p["r_ew_w"] + R_p @ np.array([0.0, 0.0, 0.07])
    ball_dist = np.linalg.norm(data_p["projectile_position"] - sphere, axis=-1)
    disp_p = sim_p.object_displacements(state_p)[0]
    replans_p = np.asarray(ctrl_p.replanning_durations[1:]) * 1e3
    log(f"  {n_ticks_p} ticks in {proj_s:.2f} s ({proj_s * 1e3 / n_ticks_p:.2f} ms per tick with the "
        f"per-tick log; {replans_p.size} replans, median {np.median(replans_p):.2f} ms, thing_demo in "
        f"phase 5 {replan_ms:.2f} ms); tracker phases {' -> '.join(names[p] for p in sequence)} "
        f"(flight from t = {data_p['t'][phases_p.index(1)] if 1 in phases_p else float('nan'):.3f} s); "
        f"smallest ball-to-sphere-centre distance {ball_dist.min():.4f} m; bottle displacement "
        f"{float(disp_p.max()):.2e} m")
    check(sequence[0] == 0 and 1 in sequence, "the tracker leaves its pre-flight phase")
    check(bool(np.isfinite(data_p["cost"]).all()), "costs finite")
    check(bool(np.isfinite(disp_p).all() and (disp_p < 0.03).all()),
          "the bottle stays within 0.03 m of its place on the tray")
    results.update(projectile_ticks=n_ticks_p, projectile_s=proj_s,
                   projectile_ms_per_tick=proj_s * 1e3 / n_ticks_p,
                   projectile_replan_ms_median=float(np.median(replans_p)),
                   projectile_phases=[names[p] for p in sequence],
                   projectile_min_ball_distance=float(ball_dist.min()),
                   projectile_bottle_displacement=float(disp_p.max()))

    # -- 15. the asynchronous runtime ----------------------------------------------
    # slow motion at 0.1: the plant keeps pace beside the planner thread
    RUNTIME_PATH, RUNTIME_S, RUNTIME_SCALE = "demos/ur10_demo.yaml", 2.0, 0.1
    log(f"== 15. runtime demo on the card: {RUNTIME_PATH}, {RUNTIME_S} s of simulated time at time "
        f"scale {RUNTIME_SCALE} (AsyncPlanner on its own stream, NativeExecutor at 125 wall Hz, "
        "the plant on the card)")
    rt_path = cfg.resolve_package_path({"package": "configs", "path": RUNTIME_PATH})
    rt_config = cfg.load_config(rt_path)
    riccati.launch_count = 0
    contact.launch_count = 0
    out = runtime_demo.run_demo(rt_config, duration=RUNTIME_S, time_scale=RUNTIME_SCALE)
    stats, rp = out["executor"], out["replan_s"] * 1e3
    runtime = {
        "time_scale": RUNTIME_SCALE, "ticks": stats["ticks"], "overruns": stats["overruns"],
        "policy_switches": stats["policy_switches"],
        "max_tick_ms": stats["max_tick_seconds"] * 1e3, "replans": int(rp.size),
        "replan_ms_p99": float(np.percentile(rp, 99)), "replan_ms_median": float(np.median(rp)),
        "plant_busy_ms_median": float(np.median(out["busy_s"]) * 1e3),
        "plant_busy_ms_p99": float(np.percentile(out["busy_s"], 99) * 1e3),
        "behind_ms_max": float(out["behind_s"].max() * 1e3),
        "behind_ms_end": float(out["behind_s"][-1] * 1e3), "wall_s": out["wall_s"],
        "ee_error": out["ee_error"],
        "bottle_displacement": float(out["object_displacement"].max()),
        "launches": (riccati.launch_count, contact.launch_count),
    }
    r = runtime
    log(f"  executor {r['ticks']} ticks, {r['overruns']} overruns, {r['policy_switches']} policy "
        f"switches, max tick {r['max_tick_ms']:.3f} ms; planner {r['replans']} replans, median "
        f"{r['replan_ms_median']:.2f} ms, p99 {r['replan_ms_p99']:.2f} ms; the plant loop busy "
        f"{r['plant_busy_ms_median']:.2f} ms a tick (p99 {r['plant_busy_ms_p99']:.2f}), behind the "
        f"scaled wall clock by at most {r['behind_ms_max']:.1f} ms ({r['behind_ms_end']:.1f} at the "
        f"end, {r['wall_s']:.1f} s of wall time); EE error {r['ee_error']:.4f} m, bottle "
        f"displacement {r['bottle_displacement']:.2e} m; K1 / P1 launches {r['launches']}")
    check(r["launches"][0] > 0 and r["launches"][1] > 0,
          "the planner thread launched K1 and the plant P1")
    # The bottle's displacement is printed and not held to a bound.  On this
    # schedule (a replan of about 0.25 s, a plant tick of about 25 ms, time
    # scale 0.1) the JAX package's own planner and plant drop the bottle as
    # the port's do: tests/test_torch_async_runtime.py replays the demo on a
    # virtual wall clock through both packages and finds the same fall.
    check(r["overruns"] == 0 and r["policy_switches"] > 0
          and np.isfinite(r["ee_error"]) and np.isfinite(r["bottle_displacement"]),
          "0 overruns, policy switches, the robot and the bottle finite")
    check(r["behind_ms_max"] < 1e3 * RUNTIME_S / RUNTIME_SCALE / 10,
          "the plant loop kept pace with the scaled wall clock (within a tenth of the run)")
    stack_out = launch_stack.run_stack(rt_path, duration=1.0, time_scale=RUNTIME_SCALE)
    log(f"  launch stack (PlannerNode on the card, 1.0 s at time scale {RUNTIME_SCALE}): ready after "
        f"{stack_out['startup_s']:.2f} s (the child's first two solves), {stack_out['switches']} "
        f"policies after the first; executor {stack_out['executor']['ticks']} ticks, "
        f"{stack_out['executor']['overruns']} overruns; bottle displacement "
        f"{float(stack_out['object_displacement'].max()):.2e} m")
    check(stack_out["startup_s"] is not None and stack_out["first_policy"] is not None
          and stack_out["planner_alive"],
          "the planner process sent 'ready' and a policy, and ran to the end")
    results.update(runtime_demo=runtime,
                   launch_stack={"startup_s": stack_out["startup_s"],
                                 "switches": stack_out["switches"],
                                 "executor": stack_out["executor"]})

    # -- 16. robust planning: the ral25 path ------------------------------------------
    RB_H, RB_WP, RB_DURATION, RB_ITERATIONS, RB_SCALES = (
        RAL25_HEIGHT, list(RAL25_WAYPOINT), 10.0, 60, (1.0, 0.5, 0.1))
    # the JAX package's record of this plan (docs/ral25_results_h20.json,
    # robust variant, this waypoint; the same 0.2861 in float64 on a CPU at
    # 60 and at 120 iterations: its line search stalls there)
    RB_JAX_EQ_VIOL = 0.28600239753723145
    RB_JAX_PSCAN_DIFF = 7.660416766697153e-05  # see the plans through pscan and K1 below
    # pscan against the float64 plain version on this plan's stage data: the
    # plain version adds route (c)'s jitter (1e-7 trace(Quu) / nu) to Quu,
    # pscan solves with R + reg alone; 6.1e-6 of the largest entry on a CPU
    PSCAN_RTOL_F64 = 1e-5
    log(f"== 16. robust planning: the ral25 study's {RB_H * 100:.0f} cm box, robust variant, "
        f"waypoint {RB_WP}, {RB_DURATION:.0f} s [{card_line}]")
    rb_config, rb_box = ral25_plan_config()

    riccati.launch_count = 0
    t0 = time.perf_counter()
    rb_prob, rb_sol, rb_plan = plan_robust(rb_config, com_half_extents=rb_box,
                                           duration=RB_DURATION, iterations=RB_ITERATIONS)
    torch.cuda.synchronize()
    rb_plan_s = time.perf_counter() - t0
    launches_rb_plan = riccati.launch_count
    rb_ocp = rb_prob.ocp
    rb_eq = float(rb_sol.eq_viol[0])
    log(f"  plan: N {rb_ocp.N}, nx {rb_ocp.nx}, nu {rb_ocp.nu}, n_eq {rb_ocp.n_eq}, n_ineq "
        f"{rb_ocp.n_ineq}; {RB_ITERATIONS} iterations in {rb_plan_s * 1e3:.1f} ms "
        f"({rb_plan_s * 1e3 / RB_ITERATIONS:.2f} ms per iteration), K1 launches "
        f"{launches_rb_plan}; eq_viol {rb_eq:.4f} (JAX record {RB_JAX_EQ_VIOL:.4f}; the "
        f"ur10 vertex-plan gate 0.2), ineq_viol {float(rb_sol.ineq_viol[0]):.2e}")
    check((rb_ocp.N, rb_ocp.nx, rb_ocp.nu, rb_ocp.n_eq, rb_ocp.n_ineq) == (100, 27, 41, 48, 136),
          "the robust plan at full width: N 100, nx 27, nu 41 (8 scenarios x 4 contacts), "
          "n_eq 48, n_ineq 136")
    check(launches_rb_plan == RB_ITERATIONS, f"K1 launched once per SQP iteration ({launches_rb_plan})")
    check(bool(np.isfinite(rb_plan.X).all() and np.isfinite(rb_plan.U).all()
               and np.isfinite(rb_eq)), "the plan is finite")
    check(rb_eq <= 1.25 * RB_JAX_EQ_VIOL,
          f"eq_viol within 1.25x of the JAX package's plan of the same problem ({RB_JAX_EQ_VIOL:.4f})")

    # K1 and the log-depth backward pass on the plan's own stage data
    rb_data = capture_stage_data(rb_prob, rb_sol.state)
    rb_k1, rb_k1_err = k1_on_solver_data("27x41", rb_data, "ral25 robust plan")
    ur_config = cfg.load_config(cfg.resolve_package_path(
        {"package": "configs", "path": "demos/ur10_demo.yaml"}))
    ur_prob, ur_sol, _ = plan_robust(ur_config, com_half_extents=[[0.02, 0.02, 0.04]],
                                     duration=3.0, iterations=5)
    ur_data = capture_stage_data(ur_prob, ur_sol.state)
    check(tuple(ur_data[2].shape) == (1, 30, 18) and ur_data[1].shape[-1] == 38,
          "ur10_demo robust plan (scripts/robust_planning.py): 1x30x18x38")
    ur_k1, ur_k1_err = k1_on_solver_data("18x38", ur_data, "ur10_demo robust plan")
    pscan_err = {}
    for label, data in (("27x41", rb_data), ("18x38", ur_data)):
        f64 = tuple(t.double() for t in data)
        K_ref, kff_ref = riccati.riccati_backward_plain(*f64, reg=reg)
        scale = max(1.0, float(K_ref.abs().max()))
        for name, inp in (("float64", f64), ("float32", data)):
            Kp, kffp = parallel_backward_pass(*inp, reg=reg)
            pscan_err[f"{label}_{name}"] = max(float((Kp.double() - K_ref).abs().max()),
                                               float((kffp.double() - kff_ref).abs().max())) / scale
    log("  pscan on the same data against the float64 plain version, of the largest entry: "
        + ", ".join(f"{k} {v:.2e}" for k, v in pscan_err.items()))
    log("  float32 over the long recursions, of the largest entry: " + "; ".join(
        f"{label}: K1 {reading['float32']:.2e}, plain version {reading['plain_float32']:.2e}, "
        f"pscan {pscan_err[label + '_float32']:.2e}"
        for label, reading in (("27x41", rb_k1_err), ("18x38", ur_k1_err))) + f" [{card_line}]")
    # K1 in float32 against two float32 witnesses on the same data, the plain
    # version and pscan: over 30-100 stages the float32 error of the
    # recursion depends on the order of its sums (at N 100 the plain version
    # reads 5.22e-6 on the card, 2.6e-5 on a CPU, pscan 3.21e-5), so K1 is
    # held within 3x of the larger witness and to phase 11's 1e-3
    for label, reading in (("27x41", rb_k1_err), ("18x38", ur_k1_err)):
        witness = max(reading["plain_float32"], pscan_err[f"{label}_float32"])
        check(reading["float64"] <= KERNEL_RTOL_F64,
              f"{label}: float64 kernel within {KERNEL_RTOL_F64} of the largest entry")
        check(reading["float32"] <= K_RTOL and reading["float32"] <= W32_FACTOR * witness,
              f"{label}: float32 kernel within {K_RTOL} of the largest entry and within "
              f"{W32_FACTOR}x of the larger float32 witness error (plain version, pscan)")
    check(all(pscan_err[f"{w}_float64"] <= PSCAN_RTOL_F64
              and np.isfinite(pscan_err[f"{w}_float32"]) for w in ("27x41", "18x38")),
          f"pscan float64 within {PSCAN_RTOL_F64} of the largest entry, float32 finite")

    # K1 against the JAX package's own Pallas kernel on the same bits (ROADMAP
    # K1-e): the plan's stage data committed beside tools/k1_float32_error.py
    # (made on a CPU in float32), where the JAX kernel in float32 reads
    # K1E_JAX_PALLAS of the largest entry against the float64 plain version
    # (tests/test_torch_k1_float32_error.py, interpret mode on a CPU)
    K1E_JAX_PALLAS, K1E_FACTOR = 2.3496e-5, 2.0
    k1e_arrays = k1_float32_error.load_or_make()
    k1e_ref = k1_float32_error.reference(k1e_arrays)
    k1e_in = [torch.as_tensor(a, device=dev) for a in k1e_arrays]
    k1e_err = {
        name: k1_float32_error.relative_error(
            *(t.cpu() for t in fn(*k1e_in, reg=k1_float32_error.REG)), *k1e_ref)
        for name, fn in (("k1", riccati.riccati_backward),
                         ("plain", riccati.riccati_backward_plain),
                         ("pscan", parallel_backward_pass))}
    log(f"  K1-e, the committed ral25 stage data in float32, of the largest entry "
        f"{float(np.abs(k1e_ref[0]).max()):.4g}: K1 {k1e_err['k1']:.4e}, plain version "
        f"{k1e_err['plain']:.4e}, pscan {k1e_err['pscan']:.4e}; the JAX Pallas kernel "
        f"{K1E_JAX_PALLAS:.3g} (CPU): K1 at {k1e_err['k1'] / K1E_JAX_PALLAS:.2f}x [{card_line}]")
    check(k1e_err["k1"] <= K1E_FACTOR * K1E_JAX_PALLAS,
          f"K1-e: float32 kernel within {K1E_FACTOR}x of the JAX Pallas kernel's error on the "
          f"same stage data ({K1E_JAX_PALLAS})")

    # float64 plans of 10 iterations through pscan against the same through
    # K1: at tests/test_backward_options.py's case (ur10_demo, N 40, route
    # (b)) to its 1e-5; at this problem, where K1 and the reference's scan
    # add route (c)'s jitter to Quu and pscan does not, to the JAX package's
    # own difference between its two plans (7.6604e-05 on a CPU), to 1e-8
    plan_diff, plan_f64_ms = {}, {}
    for label, conf, kw in (("ur10_N40", ur_config, dict(duration=4.0)),
                            ("ral25_N100", rb_config, dict(com_half_extents=rb_box,
                                                           duration=RB_DURATION))):
        plans_ = {}
        for backward in ("K1", "pscan"):
            t0 = time.perf_counter()
            plans_[backward] = plan_robust(conf, iterations=10, dtype=torch.float64,
                                           use_parallel_scan=backward == "pscan", **kw)[2]
            torch.cuda.synchronize()
            plan_f64_ms[f"{label}_{backward}"] = (time.perf_counter() - t0) * 1e3 / 10
        plan_diff[label] = max(float(np.abs(plans_["pscan"].X - plans_["K1"].X).max()),
                               float(np.abs(plans_["pscan"].U - plans_["K1"].U).max()))
    log(f"  float64, 10 iterations, the plan through pscan against the plan through K1, X and U: "
        f"ur10_demo N 40 {plan_diff['ur10_N40']:.2e}, this problem {plan_diff['ral25_N100']:.6e} "
        f"(the JAX package's {RB_JAX_PSCAN_DIFF:.6e}); ms per iteration (host, float64) "
        + ", ".join(f"{k} {v:.1f}" for k, v in plan_f64_ms.items()))
    check(plan_diff["ur10_N40"] <= 1e-5, "ur10_demo N 40: the pscan plan equals the K1 plan to 1e-5")
    check(abs(plan_diff["ral25_N100"] - RB_JAX_PSCAN_DIFF) <= 1e-8,
          "this problem: pscan and K1 plans differ as the JAX package's do, to 1e-8")

    # pscan and K1 per call, float32, side by side
    pscan_times = {}
    for label, inp in (("1x100x27x41", rb_data),
                       ("64x200x27x13", kernel_inputs["form_b_64x200x27x13"])):
        ps = lambda: parallel_backward_pass(*inp, reg=reg)  # noqa: E731
        k1 = lambda: riccati.riccati_backward(*inp, reg=reg)  # noqa: E731
        pscan_times[label] = {
            "pscan_ms": cuda_median_ms(ps, reps=10),
            "k1_ms": cuda_median_ms(k1, reps=20), "k1_ms_per_launch": cuda_launch_ms(k1, reps=20),
        }
        t_ = pscan_times[label]
        log(f"  {label}: pscan {t_['pscan_ms']:.4f} ms eager; K1 "
            f"{t_['k1_ms']:.4f} ms eager, {t_['k1_ms_per_launch']:.4f} ms per launch [{card_line}]")

    # the tracking sweep: 15 CoM x 3 inertia scales, the worst-case inertias,
    # the protocol's raised substep count; one P1 launch a tick for all 45
    _cfg_sweep, rb_sim, rb_offsets, rb_inertias = protocol_sweep(rb_config, rb_box, RB_SCALES)
    rb_params = make_param_sweep(rb_sim, com_offsets=rb_offsets, inertia_scales=list(RB_SCALES),
                                 inertias=rb_inertias)
    n_sub_nominal = UprightSimulation(rb_config["simulation"]).object_substeps
    rb_smem = {dt_: contact.smem_bytes(rb_sim.tables, rb_sim.object_substeps, dt_)
               for dt_ in (torch.float32, torch.float64)}
    log(f"  sweep: {rb_params['mass'].shape[0]} runs, object substeps {n_sub_nominal} -> "
        f"{rb_sim.object_substeps} (sqrt(I_nom / I_min)), P1 shared memory "
        f"{rb_smem[torch.float32]} bytes a block in float32, {rb_smem[torch.float64]} in float64")
    CAPTURE_TICK = 200  # 1.6 s into the motion
    tick_inputs_rb, ticks_seen = {}, [0]
    real_advance = sim_mod.advance_objects

    def capturing_advance(tables, consts, frames, objects, params):
        """The plant's kernel entry, keeping one tick's inputs (no launch of its own)."""
        if ticks_seen[0] == CAPTURE_TICK:
            tick_inputs_rb.update(frames=frames.clone(), objects=objects_to(objects, dev, frames.dtype),
                                  params={k: v.clone() for k, v in params.items()})
        ticks_seen[0] += 1
        return real_advance(tables, consts, frames, objects, params)

    sim_mod.advance_objects = capturing_advance
    contact.launch_count = 0
    try:
        t0 = time.perf_counter()
        rb_disp = tracking_sweep(rb_sim, rb_plan, rb_params)
        torch.cuda.synchronize()
        rb_sweep_s = time.perf_counter() - t0
    finally:
        sim_mod.advance_objects = real_advance
    launches_rb_sweep = contact.launch_count
    rb_ticks = int(np.floor(rb_plan.ts[-1] * 125.0))
    rb_worst = rb_disp.max(axis=1)
    rb_fail = count_failures(rb_disp)
    rb_div = int((~np.isfinite(rb_worst)).sum())
    rb_max_disp = float(rb_worst[np.isfinite(rb_worst)].max())
    log(f"  {rb_ticks} ticks at 125 Hz in {rb_sweep_s:.2f} s ({rb_sweep_s * 1e3 / rb_ticks:.3f} ms "
        f"per tick for all 45 runs), P1 launches {launches_rb_sweep}; failures {rb_fail} / "
        f"{len(rb_worst)}, n_diverged {rb_div}, max displacement {rb_max_disp:.4f} m [{card_line}]")
    check(launches_rb_sweep == rb_ticks == 1250, "P1 launched once per tick for the whole batch (1,250)")
    check(rb_fail == 0 and rb_div == 0, "failures 0 / 45, none diverged (the JAX study's record)")

    # P1 on one tick of that batch: float64 kernel against the float64 plain version
    fr, ob, pr = tick_inputs_rb["frames"], tick_inputs_rb["objects"], tick_inputs_rb["params"]
    tables64 = rb_sim.tables.to(dtype=torch.float64)
    in64 = (fr.double(), objects_to(ob, dev, torch.float64), {k: v.double() for k, v in pr.items()})
    ref_rb = contact.advance_objects_plain(tables64, rb_sim.contact, *in64)
    out_rb = contact.advance_objects(tables64, rb_sim.contact, *in64)
    torch.cuda.synchronize()
    err_rb, same_rb = max_errors(out_rb, ref_rb)
    sweep_call = lambda: contact.advance_objects(rb_sim.tables, rb_sim.contact, fr, ob, pr)  # noqa: E731
    nbytes_rb, ops_rb = contact.plant_work(rb_sim.tables, rb_sim.contact, fr.shape[0], fr.shape[1], 4)
    p1_sweep = {"ms": cuda_median_ms(sweep_call, reps=20),
                "ms_per_launch": cuda_launch_ms(sweep_call, reps=10),
                "bound_ms": max(nbytes_rb / H100_BYTES_PER_S, ops_rb / H100_FP32_FLOPS) * 1e3,
                "bound_by": "bytes" if nbytes_rb / H100_BYTES_PER_S >= ops_rb / H100_FP32_FLOPS
                else "operations",
                "substeps": fr.shape[1] * rb_sim.object_substeps}
    log(f"  P1, tick {CAPTURE_TICK} of the sweep (batch 45, {fr.shape[1]} x {rb_sim.object_substeps} "
        f"substeps): float64 kernel vs plain {fmt(err_rb)}, flags "
        f"{'identical' if same_rb else 'differ'}; float32 {p1_sweep['ms']:.4f} ms eager, "
        f"{p1_sweep['ms_per_launch']:.4f} ms per launch, bound {p1_sweep['bound_ms']:.6f} ms "
        f"({p1_sweep['bound_by']}) [{card_line}]")
    check(same_rb and max(err_rb.values()) <= PLANT_TOL_F64,
          f"sweep tick: float64 within {PLANT_TOL_F64}, contact and latch flags identical")

    # the post-hoc verification, vertex form and the realizable set (the
    # barrier on the card), against the same call on the CPU
    rb_nominal = build_problem(rb_config, N=rb_ocp.N)
    t0 = time.perf_counter()
    rb_ver = verify_offline_plan(rb_nominal, rb_plan, rb_box, inertia_scales=RB_SCALES, realizable=True)
    torch.cuda.synchronize()
    rb_ver_s = time.perf_counter() - t0
    rb_ver_cpu = verify_offline_plan(build_problem(rb_config, N=rb_ocp.N, device="cpu",
                                                   dtype=torch.float64),
                                     rb_plan, rb_box, inertia_scales=RB_SCALES, realizable=True)
    ver_diff = max(abs(rb_ver[k] - rb_ver_cpu[k]) for k in rb_ver)
    log(f"  verification ({rb_ver_s:.2f} s): worst-case CWC violation "
        f"{rb_ver['worst_case_cwc_violation']:.4f}, realizable "
        f"{rb_ver['worst_case_cwc_violation_realizable']:.4f}, violation steps "
        f"{rb_ver['violation_steps']} / {rb_ver['n_states']} (JAX record: -0.0141, 0 / 51); "
        f"card against CPU {ver_diff:.2e}")
    check(ver_diff <= 1e-8 and rb_ver["violation_steps"] == rb_ver_cpu["violation_steps"],
          "the verification on the card equals the CPU's (float64, 1e-8)")
    results["robust"] = {
        "plan_ms": rb_plan_s * 1e3, "plan_ms_per_iteration": rb_plan_s * 1e3 / RB_ITERATIONS,
        "plan_launches_k1": launches_rb_plan, "plan_eq_viol": rb_eq,
        "k1_27x41": {**rb_k1, "errors": rb_k1_err}, "k1_18x38": {**ur_k1, "errors": ur_k1_err},
        "k1e_committed_data": k1e_err,
        "pscan_err": pscan_err, "pscan_vs_k1_plan_diff_f64": plan_diff, "times": pscan_times,
        "plan_f64_ms_per_iteration": plan_f64_ms,
        "sweep_s": rb_sweep_s, "sweep_ms_per_tick": rb_sweep_s * 1e3 / rb_ticks,
        "sweep_launches_p1": launches_rb_sweep, "failures": rb_fail, "n_diverged": rb_div,
        "max_displacement_m": rb_max_disp, "object_substeps": rb_sim.object_substeps,
        "p1_smem_bytes": {str(k): v for k, v in rb_smem.items()}, "p1_sweep_tick": p1_sweep,
        "p1_sweep_err_f64": err_rb, "verification": rb_ver, "verification_s": rb_ver_s,
    }

    # -- 17. the ral23 sweep on the card ---------------------------------------
    SWEEP_TICKS = 20  # cut from 30, so that phase 19 fits the same time
    SWEEP_GROUPS = [  # (family, group, the K1 width it reaches)
        ("static_obstacles", "robust_dice", "27x17"),
        ("static_obstacles", "robust_arch", "27x25"),
        ("static_obstacles", "robust_cups", "27x37"),
        ("freespace", "full_arch", "27x57"),
    ]
    log(f"== 17. the ral23 sweep on the card (scripts/ral23_sweep.py run_group): "
        f"{len(SWEEP_GROUPS)} groups, {SWEEP_TICKS} ticks each at 100 Hz after the cold solve")
    sweep = {}
    for family, name, width in SWEEP_GROUPS:
        paths = ral23_sweep.discover_groups(ral23_sweep.REPO / "configs" / "ral23" / family)[name]
        stats = {}
        riccati.launch_count = 0
        contact.launch_count = 0
        rows = ral23_sweep.run_group(name, paths, duration=SWEEP_TICKS / 100.0, stats=stats)
        k1_s, p1_s = riccati.launch_count, contact.launch_count
        ms_tick = stats["loop_s"] * 1e3 / SWEEP_TICKS
        sweep[f"{family}/{name}"] = {**stats, "ms_per_tick": ms_tick, "k1_launches": k1_s,
                                     "p1_launches": p1_s, "rows": rows}
        log(f"  {family}/{name}: K1 at {stats['nx']}/{stats['nu']}, B {stats['batch']}, "
            f"{ms_tick:.2f} ms per tick (cold solve {stats['cold_s']:.2f} s), K1 {k1_s} and P1 "
            f"{p1_s} launches; displacements "
            + ", ".join(str(r["max_obj_disp_m"]) for r in rows) + " m, EE errors "
            + ", ".join(f"{r['ee_err_m']:.3f}" for r in rows) + f" m [{card_line}]")
        check(f"{stats['nx']}x{stats['nu']}" == width and stats["batch"] == len(paths) == 3,
              f"{name}: one B = 3 loop at K1 width {width}")
        # the cold solve launches K1 once per iteration (12), then each tick
        # once per SQP iteration for the whole group
        check(k1_s == 12 + SWEEP_TICKS and p1_s == SWEEP_TICKS,
              f"{name}: K1 ({k1_s}) and P1 ({p1_s}) launched once per tick for the whole group "
              "(K1 also 12 times in the cold solve)")
        check(stats["costs_finite"] and not any(r["failed"] for r in rows),
              f"{name}: costs finite and no leaf failed")
    launches_sweep = (sum(v["k1_launches"] for v in sweep.values()),
                      sum(v["p1_launches"] for v in sweep.values()))
    results["ral23_sweep"] = sweep

    # -- 18. the multi-device solve: dp x sp over torch.distributed -----------
    # Each part is a job of its own processes (one per rank), started here
    # with a timeout; a rank that fails or times out fails the run.  The
    # kernels were built in phase 2: the ranks load them.
    # float32 dry run against batch-1 float32 solves: batched and batch-1
    # solves round differently in float32 (the library picks its products by
    # batch size) and one SQP iteration's 20-stage Riccati recursion carries
    # it; held to 1e-3, phase 11's float32 limit for K1's own output.
    DRYRUN_F32_TOL = 1e-3
    MH_TIMEOUT_S = 240

    def free_port():
        import socket

        with socket.socket() as s_:
            s_.bind(("127.0.0.1", 0))
            return s_.getsockname()[1]

    def run_ranks(world, extra, timeout=MH_TIMEOUT_S):
        """One rank process each of parallel/multihost.py's worker; their
        REPORT lines and the job's host ms."""
        port = free_port()
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-m", "upright_tpu_torch.parallel.multihost", str(r), str(world),
             str(port)] + extra, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]
        outs = []
        try:
            for proc in procs:
                outs.append(proc.communicate(timeout=timeout)[0])
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        job_ms = (time.perf_counter() - t0) * 1e3
        reports = []
        for r, (proc, out) in enumerate(zip(procs, outs)):
            check(proc.returncode == 0, f"rank {r} of the {world}-rank job exited 0:\n{out[-3000:]}")
            reports.append(json.loads(
                [ln for ln in out.splitlines() if ln.startswith("REPORT ")][-1][7:]))
        return reports, job_ms

    log("== 18. the multi-device solve (parallel/multihost.py, entry.py dryrun_multichip): "
        "dp x sp over torch.distributed, each rank its own process")
    multi = {}
    # refused before NCCL is asked: two ranks on one card
    try:
        from upright_tpu_torch.parallel.multihost import initialize_distributed

        initialize_distributed("127.0.0.1:1", torch.cuda.device_count() + 1, 0, backend="nccl")
        refused = False
    except ValueError as e:
        refused = "one GPU per rank" in str(e)
    check(refused, "nccl with more ranks than cards raises before any process group")

    # 18a: one rank, NCCL
    (rep,), job_ms = run_ranks(1, ["--backend", "nccl", "--global-batch", "2",
                                   "--dryrun", "float64,float32", "--entry"])
    d64, d32 = rep["dryrun_float64"], rep["dryrun_float32"]
    log(f"  18a, 1 rank, {rep['backend']}: solve check (ur10_demo, batch 2) err "
        f"{rep['solve_check_err']:.2e}, {rep['solve_check_ms']:.1f} ms, K1 "
        f"{rep['solve_check_k1_launches']}; dry run (thing_obstacle_demo frictional, N 20, 27/21) "
        f"float64 err {d64['err']:.2e}, {d64['ms']:.1f} ms (tile {d64['steady_ms']:.1f} ms "
        f"steady), K1 {d64['k1_launches']}; float32 err {d32['err']:.2e}, {d32['ms']:.1f} ms, "
        f"K1 {d32['k1_launches']}; entry() {rep['entry']['ms']:.1f} ms, K1 "
        f"{rep['entry']['k1_launches']}; job {job_ms:.0f} ms [{card_line}]")
    check(rep["backend"] == "nccl" and rep["device"].startswith("cuda"), "18a ran on NCCL on the card")
    check(d64["err"] < 1e-10, "18a: float64 dry run, every tile within 1e-10 of its batch-1 solve")
    check(d32["err"] < DRYRUN_F32_TOL,
          f"18a: float32 dry run within {DRYRUN_F32_TOL} of batch-1 float32 solves")
    check(rep["entry"]["finite"] and rep["entry"]["X"] == [1, HORIZON + 1, 27],
          "18a: entry()'s solve step ran, finite")
    # K1 once per solve: the solve check's sharded solve + 2 batch-1 solves;
    # the dry run's tile twice (first, steady) + 2 batch-1 solves; entry once
    check((rep["solve_check_k1_launches"], d64["k1_launches"], d32["k1_launches"],
           rep["entry"]["k1_launches"]) == (3, 4, 4, 1), "18a: K1 launched once per solve")
    multi["one_rank_nccl"] = {**rep, "job_ms": job_ms}

    # 18b: two ranks sharing the card, gloo with host copies
    reps_b, job_ms = run_ranks(2, ["--backend", "gloo", "--global-batch", "8",
                                   "--dryrun", "float64"])
    for rep in reps_b:
        d64 = rep["dryrun_float64"]
        log(f"  18b, rank {rep['rank']} of 2, {rep['backend']} on {rep['device']}: solve check "
            f"(ur10_demo, global batch 8, {rep['local_shards']} shard) err "
            f"{rep['solve_check_err']:.2e}, {rep['solve_check_ms']:.1f} ms, K1 "
            f"{rep['solve_check_k1_launches']}; dry run dp 1 x sp 2 err {d64['err']:.2e}, "
            f"{d64['ms']:.1f} ms (tile {d64['steady_ms']:.1f} ms steady), K1 "
            f"{d64['k1_launches']}, layout {d64['layout']}")
        check(rep["solve_check_err"] < 1e-10 and d64["err"] < 1e-10,
              f"18b rank {rep['rank']}: its shard and every tile within 1e-10 (float64)")
        check(d64["layout"] == [[0, 0, 0], [0, 2, 1]],
              "18b: the scenario axis across the two processes (dp 1 x sp 2)")
        # 1 sharded solve + 4 batch-1; the tile twice + 4 batch-1 (every tile)
        check((rep["solve_check_k1_launches"], d64["k1_launches"]) == (5, 6),
              f"18b rank {rep['rank']}: K1 launched once per solve")
    log(f"  18b job {job_ms:.0f} ms [{card_line}]")
    multi["two_ranks_one_card_gloo"] = {"ranks": reps_b, "job_ms": job_ms}

    # 18c: the scaling curve, 1 and 2 ranks on the card (one job of two
    # ranks; rank 1 waits while rank 0 measures alone), batch 256 a rank
    SCALING_REPS = 5
    t0 = time.perf_counter()
    sc = subprocess.run(
        [sys.executable, "-m", "upright_tpu_torch.scripts.scaling_curve", "--ranks", "1,2",
         "--batch-per-rank", "256", "--reps", str(SCALING_REPS)],
        capture_output=True, text=True, timeout=2 * MH_TIMEOUT_S)
    job_ms = (time.perf_counter() - t0) * 1e3
    check(sc.returncode == 0, f"scaling_curve exited 0:\n{sc.stderr[-3000:]}")
    curve = [json.loads(ln) for ln in sc.stdout.splitlines() if ln.startswith("{")]
    for row in curve:
        log(f"  18c, {row['ranks']} rank(s), {row['backend']}, batch {row['batch']}: "
            f"{row['solves_per_s']:.1f} instance-solves/s, {row['ms_per_solve_step']:.1f} ms a "
            f"step, x{row['speedup_vs_first']:.3f}; K1 {row['k1_launches_rank0']} on rank 0")
    log(f"  18c job {job_ms:.0f} ms [{card_line}]")
    check([r["ranks"] for r in curve] == [1, 2]
          and all(r["k1_launches_rank0"] == SCALING_REPS for r in curve),
          "18c: one line per rank count, K1 once per timed solve")
    multi["scaling_curve"] = {"rows": curve, "job_ms": job_ms}
    rep_a = multi["one_rank_nccl"]
    launches_multi = (
        rep_a["solve_check_k1_launches"] + rep_a["dryrun_float64"]["k1_launches"]
        + rep_a["dryrun_float32"]["k1_launches"] + rep_a["entry"]["k1_launches"]
        + sum(r["solve_check_k1_launches"] + r["dryrun_float64"]["k1_launches"] for r in reps_b)
        + sum(r["k1_launches_rank0"] for r in curve))
    results["multi_device"] = multi

    # -- 19. the float64 ral23 groups on the card ---------------------------------
    # The three widest shipped widths, whose float64 blocks take the most shared
    # memory.  Each group as scripts/ral23_sweep.py runs it (one device loop
    # batched over the group's leaves), in float64: its cold solve, then
    # F64_TICKS ticks.  The cold solve is captured and solved again with the
    # plain backward pass (comparison only, no K1 launch): both float64, the
    # backward passes 1e-12 apart, so X and U to 1e-8 of the largest entry.
    F64_TICKS, COLD_RTOL_F64 = 10, 1e-8
    F64_GROUPS = [  # (family, group, the K1 width it reaches, B)
        ("freespace", "full_arch", "27x57", 3),
        ("static_obstacles", "full_cups", "27x93", 3),
        ("static_obstacles", "full_cups_arm_only", "18x90", 1),
    ]
    log(f"== 19. the float64 ral23 groups on the card (scripts/ral23_sweep.py run_group, float64): "
        f"{len(F64_GROUPS)} groups, {F64_TICKS} ticks each at 100 Hz after the cold solve")
    from upright_tpu_torch.runtime import device_loop as dl_mod

    real_solve, real_backward = dl_mod.solve, al.riccati_backward
    sweep64 = {}
    for family, name, width, batch in F64_GROUPS:
        paths = ral23_sweep.discover_groups(ral23_sweep.REPO / "configs" / "ral23" / family)[name]
        cold, last_k1 = [], []

        def capturing_solve(*a, **kw):
            """The device loop's solve, keeping the first call (the cold solve)."""
            out = real_solve(*a, **kw)
            if not cold:
                cold.append((a, kw, out))
            return out

        def capturing_backward(*a, **kw):
            """K1's wrapper, keeping the inputs of its last call."""
            last_k1[:] = [a, kw]
            return real_backward(*a, **kw)

        dl_mod.solve, al.riccati_backward = capturing_solve, capturing_backward
        stats = {}
        riccati.launch_count = 0
        contact.launch_count = 0
        try:
            rows = ral23_sweep.run_group(name, paths, duration=F64_TICKS / 100.0,
                                         dtype=torch.float64, stats=stats)
        finally:
            dl_mod.solve, al.riccati_backward = real_solve, real_backward
        k1_s, p1_s = riccati.launch_count, contact.launch_count
        (a, kw, sol_k1), (k1_args, k1_kw) = cold[0], last_k1
        sol_plain = real_solve(*a, **{**kw, "backward": riccati.riccati_backward_plain})
        torch.cuda.synchronize()
        cold_err = {f: rel_err(getattr(sol_k1.state, f), getattr(sol_plain.state, f))
                    for f in ("X", "U")}
        ms_tick = stats["loop_s"] * 1e3 / F64_TICKS
        k1_ms = cuda_launch_ms(lambda: real_backward(*k1_args, **k1_kw), reps=10)
        (Bk, Nk, nxk), nuk = k1_args[2].shape, k1_args[1].shape[-1]
        sweep64[f"{family}/{name}"] = {
            **stats, "ms_per_tick": ms_tick, "k1_launches": k1_s, "p1_launches": p1_s,
            "rows": rows, "cold_solve_err_vs_plain_backward": cold_err,
            "k1_ms_per_launch_float64": k1_ms, "k1_shape": [Bk, Nk, nxk, nuk],
            "dtype": str(k1_args[2].dtype)}
        log(f"  {family}/{name}: float64, K1 at {stats['nx']}/{stats['nu']}, B {stats['batch']}, "
            f"{ms_tick:.2f} ms per tick (cold solve {stats['cold_s']:.2f} s), K1 {k1_s} and P1 "
            f"{p1_s} launches; K1 {k1_ms:.4f} ms per launch at {Bk}x{Nk}x{nxk}x{nuk} "
            f"({k1_args[2].dtype}); cold solve against the plain backward pass: X "
            f"{cold_err['X']:.2e}, U {cold_err['U']:.2e}; displacements "
            + ", ".join(str(r["max_obj_disp_m"]) for r in rows) + f" m [{card_line}]")
        check(f"{stats['nx']}x{stats['nu']}" == width and stats["batch"] == len(paths) == batch
              and k1_args[2].dtype == torch.float64,
              f"{name}: one B = {batch} loop at K1 width {width}, float64")
        check(k1_s == 12 + F64_TICKS and p1_s == F64_TICKS,
              f"{name}: K1 ({k1_s}) and P1 ({p1_s}) launched once per tick for the whole group "
              "(K1 also 12 times in the cold solve)")
        check(stats["costs_finite"] and not any(r["failed"] for r in rows),
              f"{name}: costs finite and no leaf failed")
        check(max(cold_err.values()) <= COLD_RTOL_F64,
              f"{name}: the float64 cold solve through K1 equals the one through the plain "
              f"backward pass to {COLD_RTOL_F64} on X and U")
    launches_sweep64 = (sum(v["k1_launches"] for v in sweep64.values()),
                        sum(v["p1_launches"] for v in sweep64.values()))
    results["ral23_float64"] = sweep64

    # -- optional: where one solve's time goes ---------------------------------
    def phase_breakdown(label, ocp, p, x0, st):
        return span_breakdown(ocp, al_cfg, p, x0, st, label=label, log=log)

    def jac_mode_times(label, problem, p, x0, st):
        """Host time of the stage derivatives in each Jacobian mode between
        synchronisations, the modes taken in turns (wide, blocked, rev, rev,
        blocked, wide; three rounds, the median of six per mode), and each
        mode's largest difference from the wide one relative to the largest
        entry."""
        X = torch.cat([x0.unsqueeze(1), st.X[:, 1:]], dim=1)
        x, u = X[:, :-1], st.U
        nq_ = problem.dims.robot_q
        blocks = (nq_,) * 3 + ((9 * problem.dims.num_obstacles,) if problem.dims.num_obstacles
                               else ())
        fns = {}
        for mode, kw in (("wide", dict(x_jac_blocks=None, jac_mode="fwd")),
                         ("blocked", dict(x_jac_blocks=blocks, jac_mode="fwd")),
                         ("rev", dict(x_jac_blocks=None, jac_mode="rev"))):
            o = dataclasses.replace(problem.ocp, **kw)
            fns[mode] = (lambda o=o: al._stage_derivatives(o, al_cfg, x, u, p["stage"],
                                                          st.lam, st.mu))
        outs = {mode: fn() for mode, fn in fns.items()}  # warm-up, and the values
        times = {mode: [] for mode in fns}
        for _ in range(3):
            for mode in list(fns) + list(reversed(fns)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fns[mode]()
                torch.cuda.synchronize()
                times[mode].append((time.perf_counter() - t0) * 1e3)
        g_ref, H_ref = outs["wide"]
        out = {}
        for mode, (g, H) in outs.items():
            diff = max(float((g - g_ref).abs().max()) / max(1.0, float(g_ref.abs().max())),
                       float((H - H_ref).abs().max()) / max(1.0, float(H_ref.abs().max())))
            out[mode] = {"ms": statistics.median(times[mode]), "diff_from_wide": diff}
        log(f"  [{label}] stage derivatives: " + ", ".join(
            f"{m} {v['ms']:.2f} ms (vs wide {v['diff_from_wide']:.1e})" for m, v in out.items()))
        return out

    if args.breakdown:
        log("== 20. breakdown of one solve (optional)")
        # the Jacobian modes before the profiler trace and in turns, so that
        # neither what ran before nor the order favours a mode
        log("  the three Jacobian modes of the stage derivatives (OCP.x_jac_blocks, jac_mode)")
        results["jac_modes"] = {
            "thing_demo_batch512": jac_mode_times(f"thing_demo, batch {BATCH}", prob, params,
                                                  x0s, prev_state),
            "thing_demo_batch1": jac_mode_times("thing_demo, batch 1", prob, params1,
                                                obs[-1:].clone(), state),
            "full_bottle_batch512": jac_mode_times(f"full_bottle_point1, batch {BATCH}", fb,
                                                   fb_params, fb_x0s, fb_prev_state),
            "full_bottle_batch1": jac_mode_times("full_bottle_point1, batch 1", fb, fb_params1,
                                                 fb_obs[-1:].clone(), fb_state),
        }
        results["breakdown_batch512"] = phase_breakdown(
            f"thing_demo, batch {BATCH}", ocp, params, x0s, prev_state)
        results["breakdown_batch1"] = phase_breakdown(
            "thing_demo, batch 1", ocp, params1, obs[-1:].clone(), state)
        results["breakdown_full_bottle_batch512"] = phase_breakdown(
            f"full_bottle_point1, batch {BATCH}", fb_ocp, fb_params, fb_x0s, fb_prev_state)
        results["breakdown_full_bottle_batch1"] = phase_breakdown(
            "full_bottle_point1, batch 1", fb_ocp, fb_params1, fb_obs[-1:].clone(), fb_state)
        # phase 14's last replan: the projectile problem (36/13, one dynamic obstacle)
        results["breakdown_projectile_batch1"] = phase_breakdown(
            "thing_projectile_demo, batch 1", ctrl_p.problem.ocp,
            ctrl_p._params(ctrl_p.last_plan_time), ctrl_p.state.X[:, 0].clone(), ctrl_p.state)

    def t_ms(label, key="ms"):
        return round(kernel_times[label][key], 6)

    main = kernel_times["form_b_512x20x27x13"]
    log(f"  plain version: {plain_ms:.2f} ms ({plain_ms_wide:.2f} ms at 64x20x27x45); "
        f"torch.linalg loop: {library_ms:.2f} ms")
    kernels = {
        "kernels": [
            {
                "name": "riccati_backward",
                "route": "cuda",
                "source": "upright_tpu_torch/csrc/riccati.cu",
                "replaces": "upright_tpu/solver/pallas_riccati.py:186",
                "launches": launches_batched + launches_replan + launches_rb_plan + launches_sweep[0]
                + launches_multi + launches_sweep64[0],
                "max_abs_err": max_abs_err,
                "ms": t_ms("form_b_512x20x27x13"),
                "plain_ms": plain_ms,
                "bound_ms": main["bound_ms"],
                "bound_by": main["bound_by"],
                "library_ms": library_ms,
                "shape": "form (b), batch 512, N 20, nx 27, nu 13, float32",
                "ms_form_a": t_ms("form_a_512x20x27x13"),
                "ms_batch1": t_ms("form_b_1x20x27x13"),
                "ms_runtime_sized": t_ms("form_b_512x20x27x13_runtime_sized"),
                "ms_runtime_sized_batch1": t_ms("form_b_1x20x27x13_runtime_sized"),
                "ms_float64": t_ms("form_b_512x20x27x13_f64"),
                "ms_wide_64x20x27x45": t_ms("form_b_64x20x27x45"),
                "ms_long_64x200x27x13": t_ms("form_b_64x200x27x13"),
                "plain_ms_wide_64x20x27x45": plain_ms_wide,
                # the kernel's device time alone, for each of the ms keys above
                "ms_per_launch": {name: t_ms(label, "ms_per_launch") for name, label in (
                    ("batch512", "form_b_512x20x27x13"), ("form_a", "form_a_512x20x27x13"),
                    ("batch1", "form_b_1x20x27x13"),
                    ("runtime_sized", "form_b_512x20x27x13_runtime_sized"),
                    ("runtime_sized_batch1", "form_b_1x20x27x13_runtime_sized"),
                    ("float64", "form_b_512x20x27x13_f64"),
                    ("wide_64x20x27x45", "form_b_64x20x27x45"),
                    ("long_64x200x27x13", "form_b_64x200x27x13"))}
                # phase 11's widths, as its ms_<width> keys below
                | {w: round(v["ms_per_launch"], 6) for w, v in solver_widths.items()},
                "launches_batched_path": launches_batched,
                "launches_replan_path": launches_replan,
                "launches_closed_loop": launches_loop_k1,
                "launches_per_solve": al_cfg.iterations,
                # phase 11: the solver's own stage data at this slice's widths
                # (runtime-sized instance, float32), one eager call; per launch
                # in ms_per_launch
                **{f"ms_{w}": round(v["ms"], 6) for w, v in solver_widths.items()},
                "bound_ms_solver_widths": {w: v["bound_ms"] for w, v in solver_widths.items()},
                "library_ms_solver_widths": {w: v["library_ms"] for w, v in solver_widths.items()},
                "plain_ms_solver_widths": {w: v["plain_ms"] for w, v in solver_widths.items()},
                "launches_full_bottle_batched_path": launches_fb,
                "launches_full_bottle_replan_path": launches_fb_replan,
                "launches_full_bottle_closed_loop": launches_fb_loop_k1,
                # phases 13-15: one launch per SQP iteration of a tick for the
                # whole batch; the projectile loop's solves; the planner thread
                "launches_batched_loop": {f"B{b}": k for b, (k, _) in launches_batched_loop.items()},
                "launches_group_loop": launches_group[0],
                "launches_projectile_loop": launches_proj[0],
                "launches_runtime_demo": runtime["launches"][0],
                # phase 16: the ral25 robust plan (1x100x27x41), one launch per
                # SQP iteration; K1 and pscan on its stage data and at 18/38
                "launches_robust_plan": launches_rb_plan,
                "ms_27x41_N100": round(results["robust"]["k1_27x41"]["ms"], 6),
                "ms_18x38_N30": round(results["robust"]["k1_18x38"]["ms"], 6),
                "pscan": results["robust"]["times"],
                # phase 17: the ral23 sweep's groups, 12 cold-solve launches
                # and one a tick each
                "launches_ral23_sweep": {k: v["k1_launches"] for k, v in sweep.items()},
                # phase 18: the multi-device jobs (every rank's launches; the
                # scaling curve's rank 0 during its timed solves)
                "launches_multi_device": launches_multi,
                # phase 11 in float64: ms per launch and the FP64 bound
                "ms_per_launch_float64_solver_widths": {
                    w: round(v["ms_per_launch_float64"], 6) for w, v in solver_widths.items()},
                "bound_ms_float64_solver_widths": {
                    w: v["bound_ms_float64"] for w, v in solver_widths.items()},
                # phase 19: the float64 ral23 groups, 12 cold-solve launches
                # and one a tick each
                "launches_ral23_float64": {k: v["k1_launches"] for k, v in sweep64.items()},
                "ms_per_launch_ral23_float64": {
                    k: round(v["k1_ms_per_launch_float64"], 6) for k, v in sweep64.items()},
            },
            {
                "name": "chain_sweep",
                "route": "cuda",
                "source": "upright_tpu_torch/csrc/chain.cu",
                "replaces": "upright_tpu/kinematics/chain.py KinematicChain._propagate "
                            "(no Pallas kernel)",
                "launches": sum(launches_k2_batched.values()) + sum(launches_loop_k2.values()),
                "max_abs_err": k2_max_err_f32,
                "ms": round(k2_times["jacobian"]["ms"], 6),
                "plain_ms": k2_plain_ms,
                "bound_ms": k2_times["jacobian"]["bound_ms"],
                "bound_by": k2_times["jacobian"]["bound_by"],
                "library_ms": None,
                "shape": f"thing_demo's EE motion, Jacobian along (q, v, a): P {P_ee}, "
                         f"nq {nq_ee}, {3 * nq_ee} directions x {req_ee.n_out} numbers, float32",
                "ms_value": round(k2_times["value"]["ms"], 6),
                "bound_ms_value": k2_times["value"]["bound_ms"],
                "ms_per_launch": {k: round(v["ms_per_launch"], 6) for k, v in k2_times.items()},
                "max_err": results["k2_err"],
                "launches_batched_path": launches_k2_batched,
                "launches_closed_loop": launches_loop_k2,
                "launches_per_solve": K2_PER_SOLVE_CALL,
                "launches_per_tick": K2_PER_TICK,
            },
            {
                "name": "plant_substeps",
                "route": "cuda",
                "source": "upright_tpu_torch/csrc/plant.cu",
                "replaces": "upright_tpu/sim/simulation.py:324-644 (no Pallas kernel)",
                "launches": launches_loop_p1 + launches_rb_sweep + launches_sweep[1]
                + launches_sweep64[1],
                "max_abs_err": plant_err32,
                "ms": round(plant_times["batch1"]["ms"], 6),
                "plain_ms": plant_plain_ms,
                "bound_ms": plant_times["batch1"]["bound_ms"],
                "bound_by": plant_times["batch1"]["bound_by"],
                "library_ms": None,
                "shape": "thing_demo, one control tick: batch 1, 10 outer steps x 40 substeps, "
                         "16 contact slots, float32",
                "ms_batch512": round(plant_times["batch512"]["ms"], 6),
                "bound_ms_batch512": plant_times["batch512"]["bound_ms"],
                "ms_box_arch_batch1": round(plant_times["box_arch_batch1"]["ms"], 6),
                "ms_blue_cups_batch1": round(plant_times["blue_cups_batch1"]["ms"], 6),
                "ms_per_launch": {k: round(v["ms_per_launch"], 6) for k, v in plant_times.items()},
                "max_abs_err_float64": plant_err64,
                "launches_per_tick": launches_loop_p1 / LOOP_TICKS,
                "launches_full_bottle_closed_loop": launches_fb_loop_p1,
                "launches_batched_loop": {f"B{b}": p for b, (_, p) in launches_batched_loop.items()},
                "launches_group_loop": launches_group[1],
                "launches_projectile_loop": launches_proj[1],
                "launches_runtime_demo": runtime["launches"][1],
                # phase 16: the tracking sweep, batch 45, one launch a tick
                "launches_tracking_sweep": launches_rb_sweep,
                "ms_tracking_sweep_batch45": round(results["robust"]["p1_sweep_tick"]["ms"], 6),
                "ms_per_launch_tracking_sweep_batch45":
                    round(results["robust"]["p1_sweep_tick"]["ms_per_launch"], 6),
                # phase 17: one launch a tick for each group of the ral23 sweep
                "launches_ral23_sweep": {k: v["p1_launches"] for k, v in sweep.items()},
                # phase 19: the same in float64
                "launches_ral23_float64": {k: v["p1_launches"] for k, v in sweep64.items()},
            },
        ]
    }
    results.update(kernels=kernels["kernels"], card=card_line,
                   total_s=time.perf_counter() - t_start)
    if args.out:
        import os

        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)

    log(f"solves_per_s={solves_per_s:.1f} replan_ms={replan_ms:.3f} "
        f"loop_tick_ms={tick_ms:.2f} fb_solves_per_s={fb_solves_per_s:.1f} "
        f"fb_replan_ms={fb_replan_ms:.3f} fb_loop_tick_ms={fb_tick_host_ms:.2f} "
        f"batched_loop_ms_per_tick={'/'.join(f'{v['ms_per_tick']:.2f}' for v in batched_loop.values())} "
        f"projectile_ms_per_tick={proj_s * 1e3 / n_ticks_p:.2f} "
        f"runtime_replan_p99_ms={runtime['replan_ms_p99']:.2f} "
        f"robust_plan_ms_per_iteration={results['robust']['plan_ms_per_iteration']:.2f} "
        f"sweep_ms_per_tick={results['robust']['sweep_ms_per_tick']:.3f} "
        f"ral23_ms_per_tick={'/'.join(f'{v['ms_per_tick']:.2f}' for v in sweep.values())} "
        f"ral23_float64_ms_per_tick={'/'.join(f'{v['ms_per_tick']:.2f}' for v in sweep64.values())} "
        f"scaling_solves_per_s={'/'.join(f'{r['solves_per_s']:.1f}' for r in curve)} "
        f"total_s={time.perf_counter() - t_start:.1f}")
    print(json.dumps(kernels), flush=True)
    print(card_line, flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
