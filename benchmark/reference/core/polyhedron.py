"""Convex-polyhedron geometry for contact-patch computation.

Host-side (NumPy) setup code: runs once while building a problem, never on
device.  Functional parity with the reference geometry layer
(upright_core/src/upright_core/polyhedron.py) but re-designed:

  - distance-to-boundary uses the H-representation support function directly
    (closed form) instead of a scipy ``linprog`` call;
  - polygon clipping is a vectorized Sutherland-Hodgman pass;
  - face/vertex incidence is derived from face membership in one shot.
"""

from __future__ import annotations

import numpy as np

DEFAULT_TOLERANCE = 1e-8


def plane_span(normal):
    """Orthonormal basis (2, 3) of the plane orthogonal to ``normal``."""
    n = np.asarray(normal, dtype=float)
    n = n / np.linalg.norm(n)
    a = np.array([1.0, 0.0, 0.0]) if abs(n[0]) < 0.9 else np.array([0.0, 1.0, 0.0])
    t1 = np.cross(n, a)
    t1 /= np.linalg.norm(t1)
    t2 = np.cross(n, t1)
    return np.vstack([t1, t2])


def orth2d(a):
    """2-D vector rotated 90 degrees counter-clockwise (inward normal of a CCW
    polygon edge)."""
    return np.array([-a[1], a[0]])


def wind_polygon_vertices(V):
    """Sort 2-D vertices counter-clockwise about their centroid.

    Returns (sorted_vertices, index_permutation).
    """
    V = np.asarray(V)
    assert V.shape[1] == 2
    c = V.mean(axis=0)
    angles = np.arctan2(V[:, 1] - c[1], V[:, 0] - c[0])
    idx = np.argsort(angles)
    return V[idx], idx


def project_vertices_on_axes(vertices, point, axes):
    """Coordinates of ``vertices`` relative to ``point`` along ``axes`` rows."""
    return (np.atleast_2d(axes) @ (vertices - point).T).T


class ConvexPolyhedron:
    """A convex polyhedron in V-representation with face normals.

    Tracks a nominal ``position``/``rotation`` alongside the vertices so that
    rigid transforms compose (reference polyhedron.py:11-118).
    """

    def __init__(self, vertices, normals, position=None, rotation=None):
        self.vertices = np.asarray(vertices, dtype=float)
        self.normals = np.asarray(normals, dtype=float)
        self.nv = self.vertices.shape[0]
        self.nf = self.normals.shape[0]
        self.position = np.zeros(3) if position is None else np.asarray(position, dtype=float)
        self.rotation = np.eye(3) if rotation is None else np.asarray(rotation, dtype=float)

    # -- factories ---------------------------------------------------------

    @classmethod
    def box(cls, half_extents, position=None, rotation=None):
        """Axis-aligned box from half extents (polyhedron.py:43-63)."""
        h = np.asarray(half_extents, dtype=float)
        assert (h > 0).all(), "Half extents must be positive."
        # all sign combinations of the half extents
        signs = np.array(
            [[sx, sy, sz] for sx in (1, -1) for sy in (1, -1) for sz in (1, -1)],
            dtype=float,
        )
        vertices = signs * h
        normals = np.vstack([np.eye(3), -np.eye(3)])
        return cls(vertices, normals).transform(translation=position, rotation=rotation)

    @classmethod
    def wedge(cls, half_extents, position=None, rotation=None):
        """Right-triangular wedge, slope facing +x (polyhedron.py:65-90)."""
        h = np.asarray(half_extents, dtype=float)
        assert (h > 0).all(), "Half extents must be positive."
        hx, hy, hz = h
        vertices = np.array(
            [
                [-hx, -hy, -hz],
                [hx, -hy, -hz],
                [-hx, -hy, hz],
                [-hx, hy, -hz],
                [hx, hy, -hz],
                [-hx, hy, hz],
            ]
        )
        # slope normal from two edges of the slanted face
        e1 = vertices[2] - vertices[1]
        e2 = vertices[4] - vertices[1]
        n = np.cross(e2, e1)
        n /= np.linalg.norm(n)
        normals = np.vstack([-np.eye(3), [0.0, 1.0, 0.0], n])
        return cls(vertices, normals).transform(translation=position, rotation=rotation)

    # -- transforms --------------------------------------------------------

    def transform(self, translation=None, rotation=None):
        """Rigidly transform; returns a new polyhedron (polyhedron.py:92-118)."""
        t = np.zeros(3) if translation is None else np.asarray(translation, dtype=float)
        R = np.eye(3) if rotation is None else np.asarray(rotation, dtype=float)
        return ConvexPolyhedron(
            vertices=(R @ self.vertices.T).T + t,
            normals=(R @ self.normals.T).T,
            position=R @ self.position + t,
            rotation=R @ self.rotation,
        )

    # -- queries -----------------------------------------------------------

    def limits_along_axis(self, axis):
        """Min/max of the support projection onto ``axis``."""
        axis = np.asarray(axis, dtype=float)
        axis = axis / np.linalg.norm(axis)
        p = self.vertices @ axis
        return np.array([p.min(), p.max()])

    def length_along_axis(self, axis):
        lo, hi = self.limits_along_axis(axis)
        return hi - lo

    def height(self):
        return self.length_along_axis(np.array([0.0, 0.0, 1.0]))

    def max_vertex_along_axis(self, axis):
        axis = np.asarray(axis, dtype=float)
        axis = axis / np.linalg.norm(axis)
        return self.vertices[np.argmax(self.vertices @ axis)]

    def get_vertices_in_plane(self, point, normal, tol=DEFAULT_TOLERANCE):
        d = project_vertices_on_axes(self.vertices, point, normal).ravel()
        return self.vertices[np.abs(d) < tol]

    def get_polygon_in_plane(self, point, plane_normal, plane_span, tol=DEFAULT_TOLERANCE):
        V3 = self.get_vertices_in_plane(point, plane_normal, tol=tol)
        V2 = project_vertices_on_axes(V3, point, plane_span)
        return wind_polygon_vertices(V2)[0]

    def distance_from_centroid_to_boundary(self, axis, offset=None, tol=DEFAULT_TOLERANCE):
        """Distance from ``position + offset`` to the boundary along ``axis``.

        Closed form via the H-representation: the largest step t such that
        ``p + t*axis`` satisfies every face inequality n_f . x <= b_f, with
        face offsets b_f recovered from the support function over vertices.
        (Replaces the reference's scipy linprog, polyhedron.py:196-229.)
        """
        axis = np.asarray(axis, dtype=float)
        axis = axis / np.linalg.norm(axis)
        p = self.position if offset is None else self.position + np.asarray(offset)

        b = (self.normals @ self.vertices.T).max(axis=1)  # support per face
        num = b - self.normals @ p
        den = self.normals @ axis
        with np.errstate(divide="ignore"):
            steps = np.where(den > tol, num / np.maximum(den, tol), np.inf)
        d = steps.min()
        assert d >= -tol, "Distance to boundary is negative!"
        return float(d)


# ---------------------------------------------------------------------------
# polygon clipping
# ---------------------------------------------------------------------------


def _dedup_points(P, tol):
    """Drop points that duplicate an earlier point (vectorized: lower-triangle
    pairwise-distance mask, keep first occurrences)."""
    if len(P) < 2:
        return P
    D = np.linalg.norm(P[:, None, :] - P[None, :, :], axis=-1)
    dup_of_earlier = (D < tol) & np.tri(len(P), k=-1, dtype=bool)
    return P[~dup_of_earlier.any(axis=1)]


def clip_polygon_with_half_space(V, point, normal, tol=DEFAULT_TOLERANCE):
    """Clip CCW polygon ``V`` (n, 2) by the half-space {x : n.(x - p) >= 0}.

    One vectorized Sutherland-Hodgman pass: all vertex signed distances, all
    edge crossings, and the interleaved emit order are computed with array
    ops (functional replacement for the reference's per-edge loop,
    polyhedron.py:350-385).  Returns the clipped vertices or None if the
    polygon lies entirely outside.
    """
    V = np.asarray(V, dtype=float)
    assert V.shape[1] == 2
    n = np.asarray(normal, dtype=float)
    n = n / np.linalg.norm(n)

    d = (V - point) @ n  # signed distance of every vertex
    d_next = np.roll(d, -1)
    V_next = np.roll(V, -1, axis=0)

    # strict sign change across an edge (on-plane endpoints are emitted as
    # vertices, not re-derived as intersections)
    crossing = ((d > tol) & (d_next < -tol)) | ((d < -tol) & (d_next > tol))
    denom = np.where(crossing, d - d_next, 1.0)
    t = np.clip(d / denom, 0.0, 1.0)
    inter = V + t[:, None] * (V_next - V)

    # emit per edge: the start vertex if inside (within tol), then the
    # crossing point if the edge crosses the plane
    m = V.shape[0]
    pts = np.empty((2 * m, 2))
    keep = np.empty(2 * m, dtype=bool)
    pts[0::2] = V
    keep[0::2] = d >= -tol
    pts[1::2] = inter
    keep[1::2] = crossing
    out = _dedup_points(pts[keep], tol)
    return out if len(out) else None


def clip_polygon_with_polygon(V1, V2, tol=DEFAULT_TOLERANCE):
    """Intersection of convex CCW polygons V1 and V2: fold the half-space
    clip over V2's edge half-spaces, whose inward normals are computed in one
    shot (polyhedron.py:388-417 equivalent)."""
    V1, V2 = np.asarray(V1, dtype=float), np.asarray(V2, dtype=float)
    assert V1.shape[1] == 2 and V2.shape[1] == 2
    edges = np.roll(V2, -1, axis=0) - V2  # (m, 2)
    lengths = np.linalg.norm(edges, axis=1)
    if (lengths < tol).any():
        raise ValueError("Clipping polygon has repeated vertices.")
    # inward normals of a CCW polygon: rotate each edge +90 degrees
    inward = np.stack([-edges[:, 1], edges[:, 0]], axis=1) / lengths[:, None]

    V = V1
    for p, n in zip(V2, inward):
        V = clip_polygon_with_half_space(V, p, n, tol=tol)
        if V is None:
            return None
    return V


# ---------------------------------------------------------------------------
# contact patches between touching polyhedra
# ---------------------------------------------------------------------------


def axis_aligned_contact(poly1, poly2, tol=DEFAULT_TOLERANCE):
    """Contact points + shared normal between two just-touching polyhedra.

    Separating-axis search over face normals and pairwise edge cross products,
    then the contact patch is the 2-D intersection of the two touching face
    polygons (reference polyhedron.py:446-514).  Returns (V (k,3), normal)
    with the normal pointing into ``poly1``, or (None, None) if the shapes are
    separated or penetrating.
    """
    crosses = []
    for n1 in poly1.normals:
        for n2 in poly2.normals:
            c = np.cross(n1, n2)
            mag = np.linalg.norm(c)
            if mag > tol:
                crosses.append(c / mag)
    axes = np.vstack([poly1.normals, poly2.normals] + ([crosses] if crosses else []))

    # face normals come first in `axes`; prefer them as the touching axis
    # (cross-product axes carry amplified floating-point noise that can knock
    # face vertices out of the contact plane)
    touch_axis = None
    touch_point = None
    normal_sign = 1.0
    for axis in axes:
        lo1, hi1 = poly1.limits_along_axis(axis)
        lo2, hi2 = poly2.limits_along_axis(axis)
        upper = min(hi1, hi2)
        lower = max(lo1, lo2)
        if abs(upper - lower) < tol:
            # shapes touch exactly on this axis; keep the first (face) axis
            if touch_axis is None:
                if lo1 < lo2:
                    touch_point = poly1.max_vertex_along_axis(axis)
                    normal_sign = -1.0
                else:
                    touch_point = poly2.max_vertex_along_axis(axis)
                    normal_sign = 1.0
                touch_axis = axis
        elif upper < lower:
            return None, None  # separated
    if touch_axis is None:
        return None, None  # penetrating

    # vertex-membership tolerance is looser than the separation tolerance:
    # vertices far from the touch point see lever-amplified axis noise
    plane_tol = max(tol, 100 * DEFAULT_TOLERANCE)
    span = plane_span(touch_axis)
    V1 = poly1.get_polygon_in_plane(touch_point, touch_axis, span, tol=plane_tol)
    V2 = poly2.get_polygon_in_plane(touch_point, touch_axis, span, tol=plane_tol)
    Vp = clip_polygon_with_polygon(V1, V2, tol=tol)
    if Vp is None:
        return None, None
    V = touch_point + Vp @ span
    return V, normal_sign * touch_axis
