"""Numeric literal grammar of the configuration files.

Frozen copy of the port's ``config`` parsers (``parse_number``,
``parse_array`` and friends): the reference reads the configuration dict that
``benchmark/configs/<name>.json`` holds, already composed, so it needs no
include resolution and reads no file.
"""

from __future__ import annotations

import re

import numpy as np

from benchmark.reference.config.arrangement import parse_control_objects  # noqa: F401

# Literal grammar: a float with an optional trailing unit.  "0.5pi" scales by
# pi; "2rep3" means the value 2.0 repeated 3 times.
_FLOAT = r"[+-]?(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?"
_PI_RE = re.compile(rf"^({_FLOAT})pi$")
_REP_RE = re.compile(rf"^({_FLOAT})rep(\d+)$")


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
