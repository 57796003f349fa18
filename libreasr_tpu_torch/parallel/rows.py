"""Random draws over the global batch.

A data-parallel step must draw what the single-process step on the
global batch draws: SpecAugment's integers, dropout and zoneout masks.
Every rank seeds its generators alike; inside `row_scope(n_global,
rows)` a draw whose batch axis has this rank's row count is made at the
global batch's shape and cut to this rank's rows, so the generators
advance alike on every rank and each row gets the single-process bits.
Outside a scope a draw is made as asked.
"""

from __future__ import annotations

from contextlib import contextmanager

_SCOPE: list = []   # stack of (n_global, rows: slice)


@contextmanager
def row_scope(n_global: int, rows: slice):
    _SCOPE.append((n_global, rows))
    try:
        yield
    finally:
        _SCOPE.pop()


def draw_rows(draw, shape, dim: int = 0):
    """draw(shape) -> tensor; under a row scope, draw at the global
    shape along `dim` (the batch axis) and keep this rank's rows."""
    if not _SCOPE:
        return draw(tuple(shape))
    n_global, rows = _SCOPE[-1]
    n_local = rows.stop - rows.start
    if shape[dim] != n_local:
        raise ValueError(f"draw of shape {tuple(shape)}: batch axis {dim} holds "
                         f"{shape[dim]} rows, this rank holds {n_local}")
    full = list(shape)
    full[dim] = n_global
    return draw(tuple(full)).narrow(dim, rows.start, n_local)
