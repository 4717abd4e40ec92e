"""Rigid-body simulation of the waiter's problem: the plant of the closed loop.

Counterpart of ``upright_tpu/sim/simulation.py``.  The robot is velocity
commanded; the balanced objects are full 6-DOF rigid bodies on a compliant
(penalty) contact model: each object carries support vertices, each vertex
interacts with the support surfaces of its parents (the tray, the top face of
the object below, the faces of fixtures), normal forces are spring-damper and
friction is stiction (anchor springs) or regularized Coulomb.

The port is batch-first: every state tensor carries a leading instance axis
(``r: (B, n_obj, 3)`` ...), and the parameters may differ per instance (the
robust-sweep axis).  ``step`` advances the robot with a short Python loop over
outer steps, computes the EE motion of every outer step in one batched sweep
of the kinematic chain (``_parent_motion``), and hands the objects' substep
loop to ``sim/contact.py`` ``advance_objects``: one launch of the CUDA kernel
on the card, its plain version on the CPU.

Host-side set-up (``_build_sim_objects`` and its helpers) is numpy, copied
from the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

import benchmark.reference.config as cfg_mod
from benchmark.reference.device import resolve_device
from benchmark.reference.core.math import quat_multiply, rot_to_quat
from benchmark.reference.core.polyhedron import plane_span
from benchmark.reference.kinematics.robot import RobotModel, build_robot_model
from benchmark.reference.sim.base import base_mapping
from benchmark.reference.sim.contact import (
    ContactTables,
    PlantConstants,
    advance_objects,
    pack_frames,
)


class GeneratorNoise:
    """The plant's default draw source: standard normal draws from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (the CPU's and the
    card's streams differ for one seed)."""

    def __init__(self, seed, device):
        self.generator = torch.Generator(device=device)
        self.generator.manual_seed(int(seed))

    def normal(self, shape, dtype, device):
        return torch.randn(shape, generator=self.generator, dtype=dtype, device=device)


class ReplayNoise:
    """A draw source that hands out recorded standard normal draws in the
    order the plant asks for them (measurement q, v, then process, each
    control cycle), e.g. another implementation's noise stream, so that two
    closed loops see the same realisation.  Raises when the record runs out
    or a draw's size does not match."""

    def __init__(self, draws):
        self._draws = [np.array(d) for d in draws]
        self._next = 0

    def normal(self, shape, dtype, device):
        if self._next == len(self._draws):
            raise IndexError(f"the recorded noise ran out after {self._next} draws")
        d = self._draws[self._next]
        if d.size != int(np.prod(shape)):
            raise ValueError(f"draw {self._next} has {d.size} values; the plant asked for {shape}")
        self._next += 1
        return torch.as_tensor(d, dtype=dtype, device=device).reshape(shape)


@dataclasses.dataclass
class ObjectsState:
    """Free rigid-body states of the balanced objects, batch-first.

    ``anchors``/``anchor_valid`` exist only under ``friction_model:
    stiction``: the tangent-frame anchor of each (surface, vertex) contact
    spring, padded to the largest surface and vertex counts (the reference
    keeps a tuple of per-object arrays).  ``diverged`` latches an object
    whose integrator state went non-finite; ``object_displacements`` reports
    inf for it."""

    r: torch.Tensor  # (B, n_obj, 3) CoM positions, world
    q: torch.Tensor  # (B, n_obj, 4) orientations (xyzw), world
    v: torch.Tensor  # (B, n_obj, 3) CoM linear velocities
    w: torch.Tensor  # (B, n_obj, 3) angular velocities, world
    anchors: Optional[torch.Tensor] = None  # (B, n_obj, s_max, k_max, 2)
    anchor_valid: Optional[torch.Tensor] = None  # (B, n_obj, s_max, k_max) bool
    diverged: Optional[torch.Tensor] = None  # (B, n_obj) bool

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass
class SimState:
    t: torch.Tensor  # (B,) time
    q: torch.Tensor  # (B, nq) robot joint positions
    v: torch.Tensor  # (B, nq) robot joint velocities
    objects: ObjectsState

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass
class ContactSurface:
    """A rectangular contact face in a parent body's local frame.

    ``parent == -1`` means the face is rigidly attached to the EE (the tray
    top, and every face of fixture objects); otherwise it is a face of the
    dynamic object with that index.  ``max_depth`` caps the penetration at
    which the face still attracts contact (a vertex deeper than the owning
    box's centroid belongs to the far side)."""

    parent: int  # object index, or -1 for the EE frame (tray / fixtures)
    point: np.ndarray  # a point on the surface (local frame)
    normal: np.ndarray  # unit normal (local frame, pointing away from parent)
    half_extents: np.ndarray  # (2,) rectangular extent in the tangent plane
    tangents: np.ndarray  # (2, 3) tangent basis (local frame)
    max_depth: float = np.inf


@dataclasses.dataclass
class SimObjectSpec:
    name: str
    mass: float
    inertia_local: np.ndarray  # (3,3) about CoM, local frame
    vertices_local: np.ndarray  # (k, 3) contact vertices rel. CoM, local frame
    mu: float  # friction vs parent
    surfaces: list  # ContactSurface list this object can touch
    com_world_ee: np.ndarray  # initial CoM position in the EE frame
    q_init: np.ndarray  # initial orientation in the EE frame
    fixture: bool = False


class UprightSimulation:
    """The plant: construct from config, ``initial_state``, ``step``, object
    poses.  Tensors live on ``device`` as ``dtype`` (the card and float32
    unless the caller asks otherwise)."""

    def __init__(self, sim_config: dict, robot_conf: Optional[dict] = None,
                 timestep: Optional[float] = None, device="cuda", dtype=torch.float32):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.config = sim_config
        self.timestep = float(timestep or sim_config.get("timestep", 1e-3))
        self.gravity = np.asarray(
            cfg_mod.parse_array(sim_config.get("gravity", [0, 0, -9.81])), dtype=float
        )

        robot_conf = robot_conf or sim_config["robot"]
        self.robot: RobotModel = build_robot_model(robot_conf)
        home = cfg_mod.parse_array(robot_conf.get("home", [0.0] * self.robot.nq))
        self.q_home = self._tensor(home)

        # base velocity-command convention: with command_frame: body, commands
        # are interpreted in the base frame and mapped world-ward each outer
        # step (nonholonomic bases also drop the lateral component)
        self.base_type = robot_conf.get("base_type", "fixed").lower()
        self.command_frame = robot_conf.get("command_frame", "world").lower()
        self._base_forward = (
            base_mapping(self.base_type)[0] if self.command_frame == "body" else None
        )

        # actuator velocity limits (clamped in step(); None = unlimited)
        vlim = robot_conf.get("velocity_limits")
        self.v_limit = (
            torch.abs(self._tensor(cfg_mod.parse_array(vlim))) if vlim is not None else None
        )

        # measurement / process noise
        noise = robot_conf.get("noise", {})
        meas = noise.get("measurement", {})
        proc = noise.get("process", {})
        self.q_meas_std = float(meas.get("q_std_dev", 0.0))
        self.v_meas_std = float(meas.get("v_std_dev", 0.0))
        self.v_proc_std = float(proc.get("v_std_dev", 0.0))

        self.specs = _build_sim_objects(sim_config)
        self.n_obj = len(self.specs)

        # contact parameters (see the reference for the reasoning behind each)
        self.k_contact = float(sim_config.get("contact_stiffness", 3.0e4))
        self.c_contact = float(sim_config.get("contact_damping", 200.0))
        self.v_slip = float(sim_config.get("friction_regularization", 2e-4))
        self.friction_model = str(sim_config.get("friction_model", "regularized")).lower()
        if self.friction_model not in ("regularized", "stiction"):
            raise ValueError(f"unknown friction_model {self.friction_model!r}")
        self.max_contact_force = float(sim_config.get("max_contact_force", 500.0))
        # an object past this EE-frame displacement (m) freezes; 0 disables
        self.divergence_freeze = float(sim_config.get("divergence_freeze", 1.0))
        # inner substeps of the object dynamics: explicit integration of the
        # penalty contacts needs dt_obj * omega well below 1 for the stiffest
        # coupled mode (rotational effective mass at the largest lever, times
        # the number of simultaneous contacts)
        if "object_substeps" in sim_config:
            self.object_substeps = int(sim_config["object_substeps"])
        elif self.specs:
            m_eff_min = min(_effective_mass(sp) for sp in self.specs)
            n_eff = max(
                max(1, len(np.asarray(sp.vertices_local)) // 2) for sp in self.specs
            )
            omega = np.sqrt(self.k_contact / m_eff_min * n_eff)
            self.object_substeps = int(
                np.clip(np.ceil(self.timestep * omega * 4.0 / 0.3), 1, 128)
            )
        else:
            self.object_substeps = 1

        self.contact = PlantConstants(
            gravity=tuple(float(g) for g in self.gravity),
            k_contact=self.k_contact, c_contact=self.c_contact, v_slip=self.v_slip,
            max_contact_force=self.max_contact_force,
            divergence_freeze=self.divergence_freeze,
            dt_obj=self.timestep / self.object_substeps, n_sub=self.object_substeps,
            stiction=self.friction_model == "stiction",
        )
        self.tables = ContactTables.from_specs(self.specs, self.device, dtype)
        # what step() uses when given no parameters: made once, so that a
        # step copies nothing from the host
        self._defaults = self.default_params()

    def _tensor(self, a):
        return torch.as_tensor(np.asarray(a, dtype=float), dtype=self.dtype, device=self.device)

    # -- runtime inertial parameters (the robust-sweep axis) -------------

    def default_params(self, batch: Optional[int] = None):
        """Inertial/friction parameters as a dict of tensors: of one instance
        (mass (n_obj,) ...) or, with ``batch``, with a leading instance axis
        (copies, so a sweep may write each instance's values)."""
        specs = self.specs
        params = {
            "mass": self._tensor([sp.mass for sp in specs]).reshape(self.n_obj),
            "inertia": self._tensor(
                np.stack([sp.inertia_local for sp in specs]) if specs else np.zeros((0, 3, 3))
            ),
            "mu": self._tensor([sp.mu for sp in specs]).reshape(self.n_obj),
            # extra CoM shift relative to the nominal CoM (moves the contact
            # vertices the other way), in the object's local frame
            "com_offset": self._tensor(np.zeros((self.n_obj, 3))),
        }
        if batch is not None:
            params = {k: v.expand((batch,) + tuple(v.shape)).clone() for k, v in params.items()}
        return params

    # -- initialization --------------------------------------------------

    def initial_state(self, batch: int = 1) -> SimState:
        """The robot at home, every object at its nominal place on the tray,
        repeated ``batch`` times."""
        q = self.q_home.expand(batch, self.robot.nq).clone()
        R_we, r_ew = self.robot.ee_pose(q)
        q_we = rot_to_quat(R_we)
        n, B = self.n_obj, batch
        if n:
            com = self._tensor(np.stack([sp.com_world_ee for sp in self.specs]))
            q_init = self._tensor(np.stack([sp.q_init for sp in self.specs]))
            r = r_ew[:, None] + (R_we[:, None] @ com.unsqueeze(-1)).squeeze(-1)
            qo = quat_multiply(q_we[:, None].expand(B, n, 4), q_init.expand(B, n, 4))
        else:
            r = self._tensor(np.zeros((B, 0, 3)))
            qo = self._tensor(np.zeros((B, 0, 4)))
        zeros3 = torch.zeros((B, n, 3), dtype=self.dtype, device=self.device)
        anchors = anchor_valid = None
        if self.friction_model == "stiction" and n:
            shape = (B, n, self.tables.s_max, self.tables.k_max)
            anchors = torch.zeros(shape + (2,), dtype=self.dtype, device=self.device)
            anchor_valid = torch.zeros(shape, dtype=torch.bool, device=self.device)
        objects = ObjectsState(
            r=r, q=qo, v=zeros3, w=zeros3.clone(), anchors=anchors, anchor_valid=anchor_valid,
            diverged=torch.zeros((B, n), dtype=torch.bool, device=self.device) if n else None,
        )
        return SimState(
            t=torch.zeros(B, dtype=self.dtype, device=self.device), q=q,
            v=torch.zeros_like(q), objects=objects,
        )

    # -- measurement -----------------------------------------------------

    def measure(self, state: SimState, noise=None):
        """Joint measurements, with the configured noise when a draw source
        (``GeneratorNoise``, ``ReplayNoise``) is given: q's draw first, then
        v's, as the reference splits its key."""
        q, v = state.q, state.v
        if noise is not None and (self.q_meas_std > 0 or self.v_meas_std > 0):
            q = q + self.q_meas_std * noise.normal(q.shape, q.dtype, q.device)
            v = v + self.v_meas_std * noise.normal(v.shape, v.dtype, v.device)
        return q, v

    # -- dynamics --------------------------------------------------------

    def step(self, state: SimState, cmd_vel, n_steps: int = 1, params=None,
             noise=None) -> SimState:
        """Advance the plant by n_steps * timestep under a (held) joint
        velocity command (B, nq) or (nq,).  ``params`` overrides the inertial
        parameters (see default_params); a draw source ``noise`` enables
        process noise on the command for this control cycle."""
        if params is None:
            params = self._defaults
        B = state.q.shape[0]
        cmd = torch.as_tensor(cmd_vel, dtype=self.dtype, device=state.q.device)
        cmd = cmd.expand(B, self.robot.nq)
        if self.v_limit is not None:
            # actuator velocity limits: runaway commands saturate physically
            cmd = torch.clamp(cmd, -self.v_limit, self.v_limit)
        if noise is not None and self.v_proc_std > 0:
            cmd = cmd + self.v_proc_std * noise.normal(cmd.shape, cmd.dtype, cmd.device)
        return self._step_impl(state, cmd, int(n_steps), params)

    def _step_impl(self, state: SimState, cmd_vel, n_steps, params):
        t, q, v, frames = self.robot_steps(state, cmd_vel, n_steps)
        objects = state.objects
        if self.n_obj:
            objects = advance_objects(self.tables, self.contact, frames, objects, params)
        return SimState(t=t, q=q, v=v, objects=objects)

    def robot_steps(self, state: SimState, cmd_vel, n_steps):
        """The robot's part of ``step`` (the command already clamped):
        (t, q, v) after n_steps, and the EE motion at the start of each outer
        step packed as the contact kernel reads it, (B, n_steps, FRAME_DIM),
        or None without objects."""
        dt = self.timestep
        t, q, v = state.t, state.q, state.v
        ts, qs, vs = [], [], []
        for _ in range(n_steps):
            # velocity-commanded robot, with the optional body->world
            # base-command mapping applied at the current yaw
            cmd = cmd_vel if self._base_forward is None else self._base_forward(q, cmd_vel)
            ts.append(t)
            qs.append(q)
            vs.append(v)
            q = q + dt * cmd
            v = cmd
            t = t + dt
        frames = None
        if self.n_obj:
            ee = self._parent_motion(
                torch.stack(ts, dim=1), torch.stack(qs, dim=1), torch.stack(vs, dim=1)
            )
            frames = pack_frames(ee).contiguous()
        return t, q, v, frames

    def _parent_motion(self, t, q, v):
        """World motion of the EE at the start of each outer step, from the
        step's time t (B, n), joint positions q and velocities v (B, n, nq):
        one sweep of the chain at zero joint acceleration.  Tests override it
        to prescribe the tray frame."""
        return self.robot.chain.ee_motion(q, v, torch.zeros_like(q))

    # -- observation -----------------------------------------------------

    def object_poses(self, state: SimState):
        """(r, q) per object as numpy, (B, n_obj, 3) and (B, n_obj, 4)."""
        return state.objects.r.cpu().numpy(), state.objects.q.cpu().numpy()

    def ee_pose(self, state: SimState):
        R, p = self.robot.ee_pose(state.q)
        return R.cpu().numpy(), p.cpu().numpy()

    def object_displacements(self, state: SimState):
        """Object CoM displacement in the EE frame vs the nominal arrangement,
        (B, n_obj) numpy; inf for an object whose integrator diverged."""
        R_we, r_ew = self.robot.ee_pose(state.q)
        r_oe = ((state.objects.r - r_ew[:, None]).unsqueeze(-2) @ R_we[:, None]).squeeze(-2)
        com = self._tensor(
            np.stack([sp.com_world_ee for sp in self.specs]) if self.specs else np.zeros((0, 3))
        )
        out = torch.linalg.vector_norm(r_oe - com, dim=-1).cpu().numpy()
        if state.objects.diverged is not None and out.size:
            out = np.where(state.objects.diverged.cpu().numpy(), np.inf, out)
        return out


def _effective_mass(spec):
    """Worst-case (rotational) effective mass of a contact vertex: a force at
    lever arm L sees 1/(1/m + L^2/I_min)."""
    L2 = float(np.max(np.sum(np.asarray(spec.vertices_local) ** 2, axis=1)))
    I_min = float(np.min(np.diag(np.asarray(spec.inertia_local))))
    return 1.0 / (1.0 / spec.mass + L2 / max(I_min, 1e-12))


def _box_face_surface(box, direction, origin, parent_idx, min_depth=0.03):
    """ContactSurface for the face of ``box`` whose outward normal best
    aligns with ``direction``, expressed relative to ``origin``.

    The rectangular extent is recovered from the face's vertex polygon, and
    ``max_depth`` (penetration beyond which contact releases) is the
    centroid-to-face distance so far-side vertices are not captured."""
    direction = np.asarray(direction, dtype=float)
    n_idx = int(np.argmax(box.normals @ direction))
    n = box.normals[n_idx]
    b = float((box.vertices @ n).max())
    face_verts = box.vertices[box.vertices @ n >= b - 1e-6]
    span = plane_span(n)  # (2, 3)
    centroid = face_verts.mean(axis=0)
    t = (face_verts - centroid) @ span.T
    half = np.abs(t).max(axis=0)
    depth = max(b - float(n @ box.position), min_depth)
    return ContactSurface(
        parent=parent_idx, point=centroid - np.asarray(origin, dtype=float),
        normal=n, half_extents=half, tangents=span, max_depth=depth,
    )


def _object_contact_vertices(obj):
    """Contact vertices of an object relative to its CoM, in the EE frame at
    t=0 (== the object's local frame: the arrangement rotation is baked into
    obj.box).  Boxes and wedges use their polyhedron vertices; cylinders get
    top and bottom contact rings of 8."""
    if obj.shape == "cylinder":
        tc = obj.shape_config
        rr, h = float(tc["radius"]), float(tc["height"])
        ang = np.linspace(0, 2 * np.pi, 8, endpoint=False)
        ring = np.stack([rr * np.cos(ang), rr * np.sin(ang)], axis=1)
        local = np.concatenate(
            [
                np.concatenate([ring, -h / 2 * np.ones((8, 1))], axis=1),
                np.concatenate([ring, h / 2 * np.ones((8, 1))], axis=1),
            ]
        )
        world = (obj.box.rotation @ local.T).T + obj.box.position
        return world - obj.com
    return obj.box.vertices - obj.com


def _build_sim_objects(sim_config):
    """Arrangement config -> sim object specs with contact surfaces.

    Fixture objects (attached rigidly to the tray) are not integrated;
    instead every face of each fixture becomes an EE-attached contact
    surface, so fixtures support neighbours laterally through their side
    faces."""
    arrangement_name = sim_config.get("arrangement", "nothing")
    if arrangement_name == "nothing":
        return []
    arr_conf = sim_config["arrangements"][arrangement_name]
    conf = {
        "balancing": {"arrangement": arrangement_name},
        "arrangements": sim_config["arrangements"],
        "objects": sim_config["objects"],
    }
    _model, names, objects, contacts = cfg_mod.parse_control_objects(
        conf, device="cpu", dtype=torch.float64
    )

    # friction per (parent, child) pair
    mu_map = {}
    for c in arr_conf.get("contacts", []):
        mu_map[(c["first"], c["second"])] = float(c["mu"])

    # every face of every fixture box, attached to the EE frame
    fixture_faces = {}
    for name, obj in objects.items():
        if name != "ee" and obj.fixture:
            fixture_faces[name] = [
                _box_face_surface(obj.box, n, np.zeros(3), -1) for n in obj.box.normals
            ]

    dynamic = [
        (name, obj) for name, obj in objects.items() if name != "ee" and not obj.fixture
    ]
    name_index = {name: i for i, (name, _) in enumerate(dynamic)}

    def _support_face(owner_name, direction):
        """Face of ``owner`` pointing along ``direction`` (toward the
        supported object), in the owner's frame convention."""
        owner = objects[owner_name]
        if owner_name == "ee" or owner.fixture:
            return _box_face_surface(owner.box, direction, np.zeros(3), -1)
        return _box_face_surface(owner.box, direction, owner.com, name_index[owner_name])

    specs = []
    for name, obj in dynamic:
        # one surface per declared contact pair this object rests on
        surfaces = []
        supported_normals = {}  # owner -> normals already covered
        for c in contacts:
            if c.second != name or c.first not in objects:
                continue
            # c.normal points into `first`; the face toward `second` is -n.
            # One ParsedContact exists per contact POINT, so dedup faces by
            # (owner, normal) to avoid stacking duplicate springs.
            surf = _support_face(c.first, -np.asarray(c.normal))
            if any(np.allclose(surf.normal, n) for n in supported_normals.get(c.first, [])):
                continue
            surfaces.append(surf)
            supported_normals.setdefault(c.first, []).append(surf.normal)
        if not surfaces:
            surfaces.append(_support_face(obj.parent, np.array([0.0, 0, 1])))

        # remaining fixture faces: lateral catch surfaces beyond the
        # declared pairs (skip faces already covered above)
        for fname, faces in fixture_faces.items():
            covered = supported_normals.get(fname, [])
            for face in faces:
                if any(np.allclose(face.normal, n) for n in covered):
                    continue
                surfaces.append(face)

        mu = mu_map.get((obj.parent, name), mu_map.get((name, obj.parent), 0.5))

        # lateral (side-face) contact patches get their own vertices: the
        # arrangement's parsed contact-patch corners, shrunk 10% toward the
        # patch centroid so they sit strictly inside the face
        verts = _object_contact_vertices(obj)
        for key in {(c.first, c.second) for c in contacts}:
            pair = [c for c in contacts if (c.first, c.second) == key]
            if abs(float(np.asarray(pair[0].normal)[2])) >= 0.9:
                continue  # top/bottom support: corners already engage
            if key[1] == name:
                pts = np.asarray([c.r2 for c in pair])
            elif key[0] == name:
                pts = np.asarray([c.r1 for c in pair])
            else:
                continue
            patch = pts - obj.com
            patch = patch + 0.1 * (patch.mean(axis=0) - patch)
            verts = np.concatenate([verts, patch])

        specs.append(
            SimObjectSpec(
                name=name,
                mass=obj.mass,
                inertia_local=np.asarray(obj.inertia),
                vertices_local=verts,
                mu=mu,
                surfaces=surfaces,
                com_world_ee=np.asarray(obj.com),
                q_init=np.array([0.0, 0, 0, 1]),
                fixture=False,
            )
        )
    return specs
