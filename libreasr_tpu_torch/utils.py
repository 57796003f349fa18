"""Small shared helpers (the JAX package's utils.py, the parts the
port's serving needs)."""

from __future__ import annotations

import numpy as np


def tensorize(data: bytes) -> np.ndarray:
    """Wire bytes (little-endian float32 pcm) -> a float32 array."""
    return np.frombuffer(data, dtype=np.float32).copy()
