"""Robust-planning models: contact wrench cones + uncertain inertial objects.

The port's own copy of ``upright_tpu/robust/modelling.py`` (numpy and scipy
only; it imports nothing of the JAX package).

Re-design of the reference robust layer (upright_robust/src/upright_robust/
modelling.py, utils.py) without the rigeo/cdd dependency: the double
description (cone span -> face form) runs on scipy's qhull, and worst-case
constraint analysis exploits that the balance residuals are *linear* in the
10-vector inertial parameters — so maxima over box or ellipsoid parameter
sets have closed forms (no MOSEK SDP needed for these set classes).
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import ConvexHull


def skew3(v):
    x, y, z = v
    return np.array([[0, -z, y], [z, 0, -x], [-y, x, 0]], dtype=float)


def skew6(V):
    """Spatial cross-product matrix of a twist V = [v, w] such that
    skew6(V) M V gives the Coriolis/centrifugal wrench (reference
    modelling.py bias via rigeo.skew6)."""
    v, w = V[:3], V[3:]
    Sw = skew3(w)
    Sv = skew3(v)
    return np.block([[Sw, np.zeros((3, 3))], [Sv, Sw]])


class RobustContactPoint:
    """Grasp matrices + friction-cone span form for one contact
    (reference modelling.py:9-44)."""

    def __init__(self, contact):
        self.contact = contact
        self.normal = np.asarray(contact.normal, dtype=float)
        self.span = np.asarray(contact.span, dtype=float)
        mu = float(contact.mu)

        # grasp matrices: contact force -> body wrench about the EE origin
        self.G1 = np.vstack((np.eye(3), skew3(np.asarray(contact.r1))))
        self.G2 = np.vstack((np.eye(3), skew3(np.asarray(contact.r2))))

        # span (generator) form of the friction cone FC = {S z | z >= 0},
        # four generators per contact
        self.S = np.vstack(
            [
                self.normal + mu * self.span[0],
                self.normal + mu * self.span[1],
                self.normal - mu * self.span[0],
                self.normal - mu * self.span[1],
            ]
        ).T


class UncertainObject:
    """Object with inertial quantities about the EE origin
    (reference modelling.py:47-77)."""

    def __init__(self, mass, com, inertia, bounding_box=None, com_box=None):
        self.mass = float(mass)
        self.com = np.asarray(com, dtype=float)
        self.inertia_com = np.asarray(inertia, dtype=float)

        m, c = self.mass, self.com
        Sc = skew3(c)
        # inertia about the EE origin (parallel axis)
        I = self.inertia_com - m * Sc @ Sc
        self.M = np.block([[m * np.eye(3), -m * Sc], [m * Sc, I]])

        self.bounding_box = bounding_box
        self.com_box = com_box

    def bias(self, V):
        """Coriolis/centrifugal wrench."""
        return skew6(np.asarray(V)) @ self.M @ np.asarray(V)

    def wrench(self, A, V):
        """Body-frame inertial wrench M A + skew6(V) M V."""
        return self.M @ np.asarray(A) + self.bias(V)


def compute_object_name_index(names):
    return {name: i for i, name in enumerate(names)}


def compute_grasp_matrix(name_index, contacts):
    """G maps stacked contact forces to stacked object wrenches
    (reference modelling.py:85-103)."""
    no, nc = len(name_index), len(contacts)
    G = np.zeros((no * 6, nc * 3))
    for i, c in enumerate(contacts):
        first = c.contact.first if hasattr(c.contact, "first") else c.contact.object1_name
        second = c.contact.second if hasattr(c.contact, "second") else c.contact.object2_name
        if first in name_index:
            r = name_index[first]
            G[r * 6 : (r + 1) * 6, i * 3 : (i + 1) * 3] = c.G1
        if second in name_index:
            r = name_index[second]
            G[r * 6 : (r + 1) * 6, i * 3 : (i + 1) * 3] = -c.G2
    return G


def compute_cwc_span_form(name_index, contacts):
    """Span form of the contact wrench cone: wrenches reachable by
    cone-feasible contact forces (reference modelling.py:106-121)."""
    no, nc = len(name_index), len(contacts)
    H = np.zeros((no * 6, nc * 4))
    for i, c in enumerate(contacts):
        first = c.contact.first if hasattr(c.contact, "first") else c.contact.object1_name
        second = c.contact.second if hasattr(c.contact, "second") else c.contact.object2_name
        if first in name_index:
            r = name_index[first]
            H[r * 6 : (r + 1) * 6, i * 4 : (i + 1) * 4] = c.G1 @ c.S
        if second in name_index:
            r = name_index[second]
            H[r * 6 : (r + 1) * 6, i * 4 : (i + 1) * 4] = -c.G2 @ c.S
    return H


def cone_span_to_face_form(S, tol=1e-9):
    """Double description: span form {S z | z >= 0} -> face form {x | A x <= 0}.

    qhull-based: the facets of conv({0} u rays) whose hyperplanes pass
    through the origin are exactly the cone's faces (replaces the reference's
    rigeo/cdd SpanForm.to_face_form, utils.py:15-25).
    """
    rays = np.asarray(S, dtype=float).T
    norms = np.linalg.norm(rays, axis=1)
    rays = rays[norms > tol] / norms[norms > tol, None]
    n = rays.shape[1]
    pts = np.vstack([np.zeros(n), rays])
    try:
        hull = ConvexHull(pts)
    except Exception:
        # degenerate (not full-dimensional): joggle
        hull = ConvexHull(pts, qhull_options="QJ")
    A = []
    for eq in hull.equations:
        a, b = eq[:-1], eq[-1]
        if abs(b) < 1e-7:
            A.append(a)
    A = np.asarray(A)
    # deduplicate
    if len(A):
        keep = []
        for i, a in enumerate(A):
            if not any(np.allclose(a, A[j], atol=1e-8) for j in keep):
                keep.append(i)
        A = A[keep]
    return A


def compute_cwc_face_form(name_index, contacts):
    """Face form A of the contact wrench cone: A w <= 0 iff feasible contact
    forces exist to support the wrench w (reference modelling.py:124-132)."""
    H = compute_cwc_span_form(name_index, contacts)
    return cone_span_to_face_form(H)
