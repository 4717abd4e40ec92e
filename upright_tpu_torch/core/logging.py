"""Data logging (host-side numpy and yaml).

Counterpart of ``upright_tpu/core/logging.py``'s ``DataLogger``, copied: a
rate-limited in-memory log, saved as a timestamped directory with
``data.npz`` plus the flattened ``config.yaml`` next to it for
reproducibility.  ``DataPlotter`` is not ported yet.
"""

from __future__ import annotations

import datetime
from pathlib import Path

import numpy as np
import yaml


class DataLogger:
    def __init__(self, timestep=0.01):
        self.timestep = timestep
        self.data = {}
        self._last_t = -np.inf

    def ready(self, t):
        """Rate limiter: true when a new sample is due (logging.py:24-31)."""
        if t >= self._last_t + self.timestep - 1e-9:
            self._last_t = t
            return True
        return False

    def append(self, name, value):
        self.data.setdefault(name, []).append(np.asarray(value))

    def append_dict(self, entries: dict):
        for k, v in entries.items():
            self.append(k, v)

    def as_arrays(self):
        return {k: np.asarray(v) for k, v in self.data.items()}

    def save(self, log_dir, config=None, name=None):
        """Save to <log_dir>/<timestamp>/data.npz (+ config.yaml)
        (logging.py:41-69)."""
        stamp = name or datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
        out = Path(log_dir) / stamp
        out.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(out / "data.npz", **self.as_arrays())
        if config is not None:
            with open(out / "config.yaml", "w") as f:
                yaml.safe_dump(_yamlable(config), f)
        return out

    @staticmethod
    def load(path):
        d = np.load(Path(path) / "data.npz")
        return {k: d[k] for k in d.files}


def _yamlable(obj):
    """Recursively convert numpy values for yaml dumping."""
    if isinstance(obj, dict):
        return {k: _yamlable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_yamlable(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (np.floating, np.integer)):
        return obj.item()
    return obj
