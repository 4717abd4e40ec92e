"""What a run must not load: JAX, or the JAX package the port sits beside."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "upright_tpu")


def forbidden_modules(modules=None):
    """Names in ``sys.modules`` whose top-level name (the part before the
    first dot) is, whole, one of ``FORBIDDEN``.  ``upright_tpu_torch``
    begins with ``upright_tpu`` and is not one of them."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
