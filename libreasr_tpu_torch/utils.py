"""Small shared helpers (the JAX package's utils.py, the parts the
port's serving and dataset tools need)."""

from __future__ import annotations

import re

import numpy as np

_SANITIZE_RE = re.compile(r"[^a-z' ]")


def tensorize(data: bytes) -> np.ndarray:
    """Wire bytes (little-endian float32 pcm) -> a float32 array."""
    return np.frombuffer(data, dtype=np.float32).copy()


def sanitize_str(s: str) -> str:
    """A label as the datasets store it: lower case, '-' and '_' as
    spaces, every character but a-z, ' and space dropped, runs of
    whitespace as one space, stripped."""
    s = s.lower().replace("-", " ").replace("_", " ")
    s = _SANITIZE_RE.sub("", s)
    return re.sub(r"\s+", " ", s).strip()
