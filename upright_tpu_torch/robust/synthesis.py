"""Worst-case inertia synthesis for the robust sim protocol.

The port's own copy of ``upright_tpu/robust/synthesis.py`` (numpy and scipy
only; it imports nothing of the JAX package).

Re-design of the reference's SDP (planning_sim_loop.py:317-355
``max_min_eig_inertia``: place point masses at the bounding-box vertices to
maximize the smallest eigenvalue of the diagonal CoM inertia, subject to the
density-realizability condition Hc >= 0).

The reference solves it with cvxpy+MOSEK.  Here the same program becomes an
exact **linear program** (scipy linprog): with the physical CoM-matching
constraint sum(mu_i v_i) = com added (the reference's companion
``max_trace_inertia`` uses it), Hc = sum mu_i v_i v_i^T - com com^T is the
covariance of the vertex mass distribution, hence automatically PSD — the
one semidefinite constraint drops out and everything left (simplex, CoM
match, diagonality of Hc, the min-eigenvalue epigraph over a diagonal
matrix) is linear in mu.
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import linprog


def box_vertices(half_extents):
    """(8, 3) vertices of an axis-aligned box about the origin."""
    h = np.asarray(half_extents, dtype=float)
    signs = np.array(
        [[sx, sy, sz] for sx in (1, -1) for sy in (1, -1) for sz in (1, -1)],
        dtype=float,
    )
    return signs * h


def box_face_centers(half_extents):
    """Face centers of the box (planning_sim_loop.py:312-314)."""
    x, y, z = np.asarray(half_extents, dtype=float)
    return [[x, 0, 0], [-x, 0, 0], [0, y, 0], [0, -y, 0], [0, 0, z], [0, 0, -z]]


def com_offset_grid(half_extents):
    """The reference's 15 CoM positions: center + 6 face centers + 8
    vertices of the CoM box (planning_sim_loop.py:548-552)."""
    return (
        [[0.0, 0.0, 0.0]]
        + box_face_centers(half_extents)
        + [list(v) for v in box_vertices(half_extents)]
    )


def max_min_eig_inertia(half_extents, com, mass=1.0):
    """Diagonal CoM inertia with maximal smallest eigenvalue realizable by
    point masses at the vertices of the (object bounding) box.

    half_extents: (3,) of the object's bounding box (about its centroid).
    com: (3,) CoM position relative to the box centroid.
    Returns (3,) diagonal of the inertia matrix (scaled by ``mass``).

    LP variables x = [mu (8), t]:
      maximize t
      s.t.  sum mu = 1,  mu >= 0,  sum mu_i v_i = com,
            offdiag(Hc) = 0,
            t <= tr(Hc) - Hc_kk  for k in {x,y,z},
      where Hc = sum mu_i v_i v_i^T - com com^T.
    """
    V = box_vertices(half_extents)  # (8, 3)
    com = np.asarray(com, dtype=float)

    # Hc(mu) = sum mu_i v_i v_i^T - com com^T: precompute per-vertex outer
    outers = np.einsum("ki,kj->kij", V, V)  # (8, 3, 3)
    C = np.outer(com, com)

    n = 8
    c = np.zeros(n + 1)
    c[-1] = -1.0  # maximize t

    # equalities: simplex sum, CoM match (3), off-diagonal Hc zero (3)
    A_eq = []
    b_eq = []
    A_eq.append(np.append(np.ones(n), 0.0))
    b_eq.append(1.0)
    for d in range(3):
        A_eq.append(np.append(V[:, d], 0.0))
        b_eq.append(com[d])
    for (a, b) in [(0, 1), (0, 2), (1, 2)]:
        A_eq.append(np.append(outers[:, a, b], 0.0))
        b_eq.append(C[a, b])

    # inequalities: t - (tr(Hc) - Hc_kk) <= 0
    A_ub = []
    b_ub = []
    tr_coeff = np.trace(outers, axis1=1, axis2=2)  # (8,)
    tr_c = np.trace(C)
    for k in range(3):
        coeff = -(tr_coeff - outers[:, k, k])  # -(contribution to Ic_kk)
        A_ub.append(np.append(coeff, 1.0))
        b_ub.append(-(tr_c - C[k, k]))

    res = linprog(
        c,
        A_ub=np.array(A_ub), b_ub=np.array(b_ub),
        A_eq=np.array(A_eq), b_eq=np.array(b_eq),
        bounds=[(0, None)] * n + [(None, None)],
        method="highs",
    )
    if not res.success:
        raise RuntimeError(
            f"worst-case inertia LP failed for com={com}: {res.message}"
        )
    mu = res.x[:n]
    Hc = np.einsum("k,kij->ij", mu, outers) - C
    Ic = np.trace(Hc) * np.eye(3) - Hc
    return mass * np.diag(Ic)


def parse_robust_bounds(ctrl_config, approx=False):
    """Per-object CoM-uncertainty half-extents from the config's ``bounds``
    schema (reference robust/parsing.py:10-101: each object type may declare
    ``bounds: {approx: {com_lower, com_upper}, realizable: {...}}``).

    Returns a list of (3,) half-extent arrays in arrangement (alphabetical
    dynamic-object) order, or None if no object declares bounds.
    """
    bounds_name = "approx" if approx else "realizable"
    arrangement_name = ctrl_config["balancing"]["arrangement"]
    arrangement = ctrl_config["arrangements"][arrangement_name]
    object_types = ctrl_config["objects"]

    entries = {}
    for conf in sorted(arrangement.get("objects", []), key=lambda c: c["name"]):
        if conf.get("fixture", False):
            continue
        type_conf = object_types[conf["type"]]
        bounds = type_conf.get("bounds")
        if bounds is None or bounds_name not in bounds:
            entries[conf["name"]] = None
            continue
        lo = np.asarray(bounds[bounds_name]["com_lower"], dtype=float)
        hi = np.asarray(bounds[bounds_name]["com_upper"], dtype=float)
        entries[conf["name"]] = 0.5 * (hi - lo)
    if all(v is None for v in entries.values()):
        return None
    return [
        np.zeros(3) if v is None else v
        for _, v in sorted(entries.items())
    ]
