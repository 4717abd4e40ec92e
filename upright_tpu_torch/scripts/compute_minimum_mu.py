"""Minimum feasible friction coefficients for an arrangement.

Counterpart of ``scripts/compute_minimum_mu.py``: jointly optimise the
(static) EE orientation, one friction coefficient per object pair, and the
contact forces, minimising the weighted friction norm subject to static
balance:

    min  0.5 * || mu / sqrt(mu0) ||^2
    s.t. object_dynamics_constraints(forces, EE@rpy, g) = 0   (Newton-Euler)
         linearized friction cones(mu, forces)        >= 0
         0 <= mu <= mu0

The result answers "how slippery could the surfaces be before this stack
cannot even be held statically?".  The constraint Jacobians come from
``torch.func.jacfwd`` over the balance model the OCP uses (float64 on
``--device``, the card by default), the optimiser is scipy's SLSQP.

    python -m upright_tpu_torch.scripts.compute_minimum_mu --config configs/demos/ur10_demo.yaml
        [--mu0 1.0] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch
from scipy.optimize import minimize

import upright_tpu_torch.config as cfg
from upright_tpu_torch import resolve_device
from upright_tpu_torch.config.arrangement import parse_control_objects
from upright_tpu_torch.core import balance as bal
from upright_tpu_torch.core import math as core_math


def contact_pair_index(contacts):
    """Contact index -> pair index; contacts between the same two objects
    share one friction coefficient."""
    pairs = {}
    idx = np.zeros(len(contacts), dtype=int)
    for i, c in enumerate(contacts):
        key = (c.first, c.second)
        if key not in pairs:
            pairs[key] = len(pairs)
        idx[i] = pairs[key]
    return idx, list(pairs)


def minimum_mu(config, mu0=1.0, device="cuda", dtype=torch.float64):
    """(SLSQP result, pairs, rpy, mus, max |balance residual|), or None when
    the arrangement has no contacts."""
    dev = resolve_device(device)
    model, _names, _objects, contacts = parse_control_objects(config["controller"], device=dev,
                                                              dtype=dtype)
    n_c = len(contacts)
    if n_c == 0:
        return None
    pair_idx, pairs = contact_pair_index(contacts)
    n_pair = int(pair_idx.max()) + 1
    mu0 = np.full(n_pair, float(mu0))

    def tens(a):
        return torch.as_tensor(np.asarray(a, dtype=float), dtype=dtype, device=dev)

    gravity = tens(cfg.parse_array(config["controller"].get("gravity", [0, 0, -9.81])))
    pair_idx_t = torch.as_tensor(pair_idx, device=dev)
    sqrt_mu0 = tens(np.sqrt(mu0))
    ee_rest = bal.EEState.zero(device=dev, dtype=dtype)

    def split(z):
        return z[:3], z[3:3 + n_pair], z[3 + n_pair:].reshape(n_c, 3)

    def ee_state(rpy):
        return dataclasses.replace(ee_rest, C_we=core_math.rpy_to_rot(rpy))

    def eq_fn(z):
        rpy, _, forces = split(z)
        return bal.object_dynamics_constraints(model, forces, ee_state(rpy), gravity)

    def ineq_fn(z):
        _, mus, forces = split(z)
        return bal.contact_force_constraints_linearized(model.replace(mu=mus[pair_idx_t]), forces)

    def cost_fn(z):
        _, mus, _ = split(z)
        y = mus / sqrt_mu0
        return 0.5 * (y * y).sum()

    def on_dev(fn):
        return lambda z: fn(tens(z)).detach().cpu().numpy()

    z0 = np.concatenate([np.zeros(3), mu0, np.zeros(3 * n_c)])
    bounds = [(None, None)] * 3 + [(0.0, float(m)) for m in mu0] + [(None, None)] * (3 * n_c)
    res = minimize(
        lambda z: float(on_dev(cost_fn)(z)), z0, jac=on_dev(torch.func.grad(cost_fn)),
        method="slsqp", bounds=bounds,
        constraints=[
            {"type": "eq", "fun": on_dev(eq_fn), "jac": on_dev(torch.func.jacfwd(eq_fn))},
            {"type": "ineq", "fun": on_dev(ineq_fn), "jac": on_dev(torch.func.jacfwd(ineq_fn))},
        ],
    )
    rpy, mus, _forces = split(res.x)
    residual = float(np.abs(on_dev(eq_fn)(res.x)).max())
    return res, pairs, rpy, mus, residual


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config", required=True)
    parser.add_argument("--mu0", type=float, default=1.0,
                        help="upper bound (and weighting) for every pair's mu")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    out = minimum_mu(cfg.load_config(args.config), mu0=args.mu0, device=args.device)
    if out is None:
        print("arrangement has no contacts")
        return None
    res, pairs, rpy, mus, residual = out
    if not res.success:
        print(f"optimization did not converge: {res.message}")
    print(f"EE rpy = {np.round(rpy, 4)}")
    for (first, second), mu in zip(pairs, mus):
        print(f"mu[{first} - {second}] = {mu:.4f}")
    print(f"max |balance residual| = {residual:.2e}")
    return out


if __name__ == "__main__":
    main()
