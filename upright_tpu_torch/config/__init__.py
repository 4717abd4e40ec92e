"""Configuration system: YAML include composition + numeric literal grammar.

Behavior-compatible with the reference config layer (the YAML schema demands
identical merge/expansion semantics — see upright_core/src/upright_core/parsing.py
for the schema it must honor), implemented here as:

* a small regex grammar for the ``"<k>pi"`` / ``"<v>rep<n>"`` literals,
* an explicit-stack tree merge (no recursion),
* include resolution as a fold over child-first include lists.

ROS package paths resolve against this repository's ``configs/`` tree
(or absolute paths) instead of rospkg.  The ``configs/`` directory is data
shared with the JAX package ``upright_tpu``; this module is the port's own
copy of that package's numpy-only config code (counterpart:
``upright_tpu/config/__init__.py``) and imports nothing from it.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import yaml

from upright_tpu_torch.config.arrangement import parse_control_objects  # noqa: F401

_REPO_ROOT = Path(__file__).resolve().parents[2]

# Map of "package" names (reference uses ROS packages) to local directories.
PACKAGE_PATHS = {
    "upright_tpu": _REPO_ROOT,
    "upright_tpu_torch": _REPO_ROOT,
    "upright_cmd": _REPO_ROOT / "configs",
    "configs": _REPO_ROOT / "configs",
}

# Literal grammar: a float with an optional trailing unit.  "0.5pi" scales by
# pi; "2rep3" means the value 2.0 repeated 3 times.
_FLOAT = r"[+-]?(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?"
_PI_RE = re.compile(rf"^({_FLOAT})pi$")
_REP_RE = re.compile(rf"^({_FLOAT})rep(\d+)$")


def resolve_package_path(d, as_string=True):
    """Resolve a {package, path} dict to a local path."""
    pkg = d.get("package")
    if pkg is None:
        path = Path(d["path"])
    else:
        root = PACKAGE_PATHS.get(pkg)
        if root is None:
            raise KeyError(f"Unknown config package '{pkg}'.")
        path = root / d["path"]
    return path.as_posix() if as_string else path


def recursive_dict_update(default, custom):
    """Overlay ``custom`` onto ``default``: nested dicts merge key-by-key,
    anything else is replaced.  Mutates and returns ``default``.

    Implemented with an explicit work stack rather than recursion.
    """
    if not (isinstance(default, dict) and isinstance(custom, dict)):
        raise TypeError("recursive_dict_update requires two dicts")
    pending = [(default, custom)]
    while pending:
        base, overlay = pending.pop()
        for key, val in overlay.items():
            if isinstance(val, dict) and isinstance(base.get(key), dict):
                pending.append((base[key], val))
            else:
                base[key] = val
    return default


def _read_yaml(path):
    with open(path) as f:
        return yaml.safe_load(f) or {}


def load_config(path, depth=0, max_depth=5):
    """Load one YAML file plus its ``include`` chain.

    Each entry of ``include`` is a {package?, path, key?} dict; included trees
    are folded together in list order and the including file's own keys win.
    A ``key`` entry nests the included tree under that key.  ``depth`` /
    ``max_depth`` bound the include chain (cycles terminate with an error).
    """
    if depth > max_depth:
        raise RuntimeError(
            f"Config include chain is deeper than the inclusion depth limit"
            f" ({max_depth}); is there an include cycle?"
        )

    doc = _read_yaml(path)
    own_keys = {k: v for k, v in doc.items() if k != "include"}

    layers = []
    for entry in doc.get("include", ()):
        subtree = load_config(
            resolve_package_path(entry), depth=depth + 1, max_depth=max_depth
        )
        if "key" in entry:
            subtree = {entry["key"]: subtree}
        layers.append(subtree)
    layers.append(own_keys)

    composed = {}
    for layer in layers:
        recursive_dict_update(composed, layer)
    return composed


def parse_number(x, dtype=float):
    """Scalar with optional ``pi`` unit: 3, "1.5", "0.5pi", "-2pi"."""
    if isinstance(x, str):
        m = _PI_RE.match(x.strip())
        if m:
            return dtype(float(m.group(1)) * np.pi)
    return dtype(x)


def parse_array_element(x):
    """Expand one array element to a 1-D float array.

    Accepts plain numbers, ``"<k>pi"`` (one element, k*pi) and
    ``"<v>rep<n>"`` (n copies of v).
    """
    if isinstance(x, str):
        s = x.strip()
        m = _REP_RE.match(s)
        if m:
            return np.full(int(m.group(2)), float(m.group(1)))
        m = _PI_RE.match(s)
        if m:
            return np.array([float(m.group(1)) * np.pi])
        try:
            return np.array([float(s)])
        except ValueError:
            raise ValueError(f"'{x}' is not a number, pi-literal, or rep-literal.")
    return np.array([float(x)])


def parse_array(a):
    """Parse a 1-D iterable with literal expansion."""
    return np.concatenate([parse_array_element(x) for x in a])


def parse_diag_matrix_dict(d):
    """{scale, diag} dict -> scaled diagonal matrix."""
    return parse_number(d["scale"]) * np.diag(parse_array(d["diag"]))


def parse_support_offset(d):
    """x/y (+ optional polar r, theta) offset dict -> [x, y]."""
    xy = np.array([d.get("x", 0.0), d.get("y", 0.0)], dtype=float)
    polar = [k for k in ("r", "θ", "theta") if k in d]
    if polar:
        if "r" not in polar or len(polar) < 2:
            raise ValueError(
                "Polar support offset needs both a radius 'r' and an angle"
                " 'θ'/'theta'."
            )
        r = d["r"]
        theta = parse_number(d.get("θ", d.get("theta")))
        xy = xy + r * np.array([np.cos(theta), np.sin(theta)])
    return xy
