"""Object-arrangement parser: YAML config -> stacked BalanceModel.

Counterpart of ``upright_tpu/config/arrangement.py``: host-side numpy up to
the last step, which places the stacked arrays on the requested device as a
``BalanceModel`` of tensors.  Translation of the reference arrangement
pipeline (upright_core/src/upright_core/parsing.py:154-410): walk the parent->child
stacking tree, stack shapes by boundary distances, compute contact patches
between each declared pair (with mu margins and support-area insets), and emit
the balance model as stacked arrays ready for the device.

Object ordering in the stacked arrays is alphabetical by instance name, which
mirrors the reference's ``std::map`` iteration order so constraint rows and
parameter vectors line up (balancing_constraints.cpp:96-103).
"""

from __future__ import annotations

import dataclasses

import numpy as np

import torch

from upright_tpu_torch import resolve_device
from upright_tpu_torch.core import math as core_math
from upright_tpu_torch.core import polyhedron as poly


@dataclasses.dataclass
class BalancedObject:
    """Host-side record of one object in the arrangement (for sim + model)."""

    name: str
    parent: str
    fixture: bool
    mass: float
    com: np.ndarray  # CoM position in the EE frame
    inertia: np.ndarray  # (3,3) about the CoM, in the EE frame
    box: poly.ConvexPolyhedron  # bounding shape, positioned in the EE frame
    shape: str  # cuboid | cylinder | wedge
    shape_config: dict


@dataclasses.dataclass
class ParsedContact:
    first: str
    second: str
    mu: float
    normal: np.ndarray
    span: np.ndarray
    r1: np.ndarray
    r2: np.ndarray


def _local_half_extents(type_conf):
    """Bounding-box half extents of a shape (parsing.py:223-232)."""
    shape = type_conf["shape"].lower()
    if shape in ("cuboid", "wedge"):
        return 0.5 * np.array(type_conf["side_lengths"], dtype=float)
    if shape == "cylinder":
        r, h = type_conf["radius"], type_conf["height"]
        w = np.sqrt(2) * r
        return 0.5 * np.array([w, w, h])
    if shape == "sphere":
        # reference simulation.py:194-205: spheres are approximated by the
        # box with half extents radius/2 for support-area purposes
        r = type_conf["radius"]
        return 0.5 * np.array([r, r, r])
    raise ValueError(f"Unsupported shape type: {shape}")


def _parse_box(type_conf, position=None, rotation=None):
    """Shape -> ConvexPolyhedron (cylinders become 45deg-rotated boxes so
    contacts land on the x/y axes; parsing.py:235-251)."""
    if rotation is None:
        rotation = np.eye(3)
    shape = type_conf["shape"].lower()
    h = _local_half_extents(type_conf)
    if shape == "wedge":
        box = poly.ConvexPolyhedron.wedge(h)
    elif shape == "cuboid":
        box = poly.ConvexPolyhedron.box(h)
    elif shape == "cylinder":
        rotation = rotation @ core_math.rotz_np(np.pi / 4)
        box = poly.ConvexPolyhedron.box(h)
    elif shape == "sphere":
        box = poly.ConvexPolyhedron.box(h)
    else:
        raise ValueError(f"Unsupported shape type: {shape}")
    return box.transform(translation=position, rotation=rotation)


def _parse_inertia(mass, type_conf):
    """Uniform-density inertia for the shape (parsing.py:286-302), or an
    explicit measured matrix when the type declares ``inertia:`` (the
    reference's box2_exact, upright_robust/config/controller.yaml)."""
    if "inertia" in type_conf:
        I = np.asarray(type_conf["inertia"], dtype=float)
        if I.shape == (3,):
            I = np.diag(I)
        elif I.shape != (3, 3):
            raise ValueError(
                f"explicit inertia must be (3,) diagonal or 3x3, got {I.shape}"
            )
        return I
    shape = type_conf["shape"].lower()
    if shape == "cylinder":
        return core_math.cylinder_inertia_matrix(mass, type_conf["radius"], type_conf["height"])
    if shape == "cuboid":
        return core_math.cuboid_inertia_matrix(mass, type_conf["side_lengths"])
    if shape == "wedge":
        D, C = core_math.wedge_inertia_matrix(mass, type_conf["side_lengths"])
        return C @ D @ C.T
    if shape == "sphere":
        return core_math.sphere_inertia_matrix(mass, type_conf["radius"])
    raise ValueError(f"Unsupported shape type {shape}.")


def _parse_body_and_box(type_conf, base_position, quat):
    """Rigid body + positioned shape for one object (parsing.py:305-348).

    ``base_position`` is the point on the support plane directly beneath the
    object's reference position.
    """
    mass = float(type_conf["mass"])
    C = core_math.quat_to_rot_np(quat)

    local_com_offset = np.array(type_conf.get("com_offset", [0, 0, 0]), dtype=float)
    if type_conf["shape"].lower() == "wedge":
        # reference position of a wedge is the centroid of its bounding box;
        # shift to the true centroid of the half-box
        hx, hy, hz = 0.5 * np.array(type_conf["side_lengths"], dtype=float)
        local_com_offset += np.array([-hx, 0, -hz]) / 3
    com_offset = C @ local_com_offset

    local_inertia = _parse_inertia(mass, type_conf)
    inertia = C @ local_inertia @ C.T

    z = np.array([0.0, 0.0, 1.0])
    local_box = _parse_box(type_conf, rotation=C)
    dz = local_box.distance_from_centroid_to_boundary(-z)

    reference_position = np.asarray(base_position, dtype=float) + [0, 0, dz]
    com_position = reference_position + com_offset

    box = _parse_box(type_conf, reference_position, C)
    return mass, com_position, inertia, box


def _contact_points(objects, contact_conf, tol=1e-7):
    """Contact patches for every declared pair (parsing.py:162-220)."""
    contacts = []
    for contact in contact_conf:
        name1, name2 = contact["first"], contact["second"]
        mu = contact["mu"] - contact.get("mu_margin", 0)
        inset = contact.get("support_area_inset", 0)

        o1, o2 = objects[name1], objects[name2]
        points, normal = poly.axis_aligned_contact(o1.box, o2.box, tol=tol)
        assert points is not None, f"No contact points found between {name1} and {name2}."
        span = poly.plane_span(normal)

        for r in points:
            # inset each contact point toward the respective shape's center
            # within the tangent plane (skipped for fixtures, whose dynamics
            # are not constrained)
            def inset_point(box, skip):
                if skip or inset == 0:
                    return r
                t = span @ (r - box.position)
                t_inset = core_math.inset_vertex(t, inset)
                return r + (t_inset - t) @ span

            r1 = inset_point(o1.box, o1.fixture)
            r2 = inset_point(o2.box, False)
            contacts.append(
                ParsedContact(
                    first=name1, second=name2, mu=mu,
                    normal=normal, span=span, r1=r1, r2=r2,
                )
            )
    return contacts


def parse_arrangement(arrangement_conf, object_types):
    """Build all objects and contacts for an arrangement config dict.

    Returns ({name: BalancedObject} incl. the 'ee' fixture, [ParsedContact]).
    """
    # the EE (tray) is a special fixture object (parsing.py:366-374)
    ee_conf = object_types["ee"]
    ee_box = _parse_box(ee_conf, np.array(ee_conf["position"], dtype=float))
    objects = {
        "ee": BalancedObject(
            name="ee", parent=None, fixture=True, mass=1.0,
            com=ee_box.position, inertia=np.eye(3), box=ee_box,
            shape=ee_conf["shape"], shape_config=dict(ee_conf),
        )
    }

    for inst in arrangement_conf.get("objects", []):
        name = inst["name"]
        if name in objects:
            raise ValueError(f"Multiple control objects named {name}.")
        type_conf = dict(object_types[inst["type"]])

        quat = np.array(inst.get("orientation", [0, 0, 0, 1]), dtype=float)
        quat = quat / np.linalg.norm(quat)

        parent = objects[inst["parent"]]
        position = parent.box.position.copy()
        if "offset" in inst:
            from upright_tpu_torch.config import parse_support_offset

            position[:2] += parse_support_offset(inst["offset"])
        position[2] += parent.box.distance_from_centroid_to_boundary(np.array([0.0, 0.0, 1.0]))

        fixture = bool(inst.get("fixture", False))
        mass, com, inertia, box = _parse_body_and_box(type_conf, position, quat)
        objects[name] = BalancedObject(
            name=name, parent=inst["parent"], fixture=fixture,
            mass=mass, com=com, inertia=inertia, box=box,
            shape=type_conf["shape"], shape_config=type_conf,
        )

    contacts = _contact_points(objects, arrangement_conf.get("contacts", []))
    return objects, contacts


def _body_to_params_np(mass, com, inertia):
    """Host-side [m, m*c, vech(I)] (see core/rigid_body.py)."""
    I = np.asarray(inertia, dtype=float)
    vech = [I[0, 0], I[0, 1], I[0, 2], I[1, 1], I[1, 2], I[2, 2]]
    return np.concatenate([[mass], mass * np.asarray(com, dtype=float), vech])


def build_balance_model(objects, contacts, frictionless=False, device="cuda",
                        dtype=torch.float32):
    """Stack objects/contacts into a BalanceModel of tensors on ``device``."""
    from upright_tpu_torch.core.balance import BalanceModel

    device = resolve_device(device)

    # dynamic (non-fixture) objects in alphabetical order
    names = sorted(n for n, o in objects.items() if not o.fixture)
    index = {n: j for j, n in enumerate(names)}
    n_obj, n_c = len(names), len(contacts)

    if n_obj == 0:
        return BalanceModel.empty(device=device, dtype=dtype), names

    params = np.stack(
        [
            _body_to_params_np(objects[n].mass, objects[n].com, objects[n].inertia)
            for n in names
        ]
    )

    S1 = np.zeros((n_obj, n_c))
    S2 = np.zeros((n_obj, n_c))
    mu = np.zeros(n_c)
    normal = np.zeros((n_c, 3))
    span = np.zeros((n_c, 2, 3))
    r1 = np.zeros((n_c, 3))
    r2 = np.zeros((n_c, 3))
    for i, c in enumerate(contacts):
        if c.first in index:
            S1[index[c.first], i] = 1.0
        if c.second in index:
            S2[index[c.second], i] = 1.0
        mu[i] = c.mu
        normal[i] = c.normal
        span[i] = c.span
        r1[i] = c.r1
        r2[i] = c.r2

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    model = BalanceModel(
        params=t(params), mu=t(mu), normal=t(normal), span=t(span),
        r1=t(r1), r2=t(r2), S1=t(S1), S2=t(S2),
    )
    return model, names


def parse_control_objects(ctrl_conf, device="cuda", dtype=torch.float32):
    """Config -> (BalanceModel, names, objects, contacts)
    (parsing.py:351-410)."""
    arrangement_name = ctrl_conf["balancing"]["arrangement"]
    arrangement = ctrl_conf["arrangements"][arrangement_name]
    object_types = dict(ctrl_conf["objects"])

    # tolerate the older nested shape config format (parsing.py:358-364)
    for type_conf in object_types.values():
        shape = type_conf.get("shape")
        if isinstance(shape, dict):
            inner = dict(shape)
            type_conf["shape"] = inner.pop("type")
            type_conf.update(inner)

    objects, contacts = parse_arrangement(arrangement, object_types)
    frictionless = bool(ctrl_conf["balancing"].get("frictionless", True))
    model, names = build_balance_model(
        objects, contacts, frictionless=frictionless, device=device, dtype=dtype
    )
    return model, names, objects, contacts
