"""The (data, model[, pipe]) mesh (the JAX package's parallel/mesh.py).

A mesh has one of two forms:

- over processes (`devices=None`): one process per device, the
  torch.distributed idiom. Ranks are laid out as JAX reshapes its
  devices, rank = (d * model + m) * pipe + p, and each axis of more
  than one rank has the process groups along it (the ranks that differ
  only in that axis); an axis of one rank has none, so nothing is
  exchanged over it, as GSPMD emits no collective over such an axis.
  This is the form a Learner trains on. Without an initialised process
  group it is the single process, data = model = pipe = 1, no groups.
- over a list of devices in this process (`devices=[cuda:0, cuda:1]`,
  or CPU devices in tests): the form a StreamingEngine shards its
  streams over.

- "data": the batch rows; gradients are summed over the data group.
- "model": the wide matrices are stored as column blocks
  (`leaf_spec`), gathered whole for the forward.
- "pipe": GPipe stages of the encoder's uniform LSTM tail
  (parallel/pipeline.py).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field

import numpy as np

AXES = ("data", "model", "pipe")


@dataclass(eq=False)
class Mesh:
    """shape: {"data": D, "model": M} plus "pipe": P when P > 1, as JAX's
    mesh.shape. devices: the device-list form's devices, laid out
    [D, M, P] (None over processes). coords: this process's index on
    each axis; groups: the process group along each axis of more than
    one rank (None in the single process, on an axis of one rank and in
    the device-list form)."""

    shape: dict
    devices: list | None = None
    coords: dict = field(default_factory=dict)
    groups: dict = field(default_factory=dict)

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def group(self, axis: str):
        return self.groups.get(axis)

    def index_global(self) -> int:
        """This process's rank in the mesh (0 without process groups)."""
        c = self.coords
        return ((c.get("data", 0) * self.size("model") + c.get("model", 0))
                * self.size("pipe") + c.get("pipe", 0))

    def device_grid(self) -> np.ndarray:
        """The device-list form's devices as an array [D, M, P]."""
        if self.devices is None:
            raise ValueError("a mesh over processes has no device list")
        arr = np.empty(len(self.devices), dtype=object)
        arr[:] = self.devices
        return arr.reshape(self.size("data"), self.size("model"),
                           self.size("pipe"))


def _world():
    import torch.distributed as dist

    if _initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _dims(n: int, data: int, model: int, pipe: int) -> int:
    """JAX's inference and checks (mesh.py:23-46), with its messages."""
    if data == -1:
        if n % (model * pipe):
            raise AssertionError(
                f"{n} devices not divisible by model={model} x pipe={pipe}")
        data = n // (model * pipe)
    if data * model * pipe > n:
        raise AssertionError(f"mesh {data}x{model}x{pipe} > {n} devices")
    return data


def _shape(data, model, pipe) -> dict:
    shape = {"data": data, "model": model}
    if pipe > 1:
        shape["pipe"] = pipe
    return shape


def make_mesh(data: int = -1, model: int = 1, pipe: int = 1,
              devices=None) -> Mesh:
    """A ("data", "model"[, "pipe"]) mesh; data=-1 infers it from the
    device (or process) count, and pipe > 1 adds the pipe axis. Over
    processes, every rank of the world must call this (it creates the
    axes' process groups) and the mesh must use every rank."""
    if devices is not None:
        import torch

        devices = [torch.device(d) for d in devices]
        data = _dims(len(devices), data, model, pipe)
        return Mesh(_shape(data, model, pipe),
                    devices=devices[: data * model * pipe])
    world, rank = _world()
    data = _dims(world, data, model, pipe)
    if data * model * pipe != world:
        raise ValueError(f"mesh {data}x{model}x{pipe} leaves "
                         f"{world - data * model * pipe} of {world} processes "
                         "out; a mesh over processes uses every rank")
    shape = _shape(data, model, pipe)
    d, rest = divmod(rank, model * pipe)
    m, p = divmod(rest, pipe)
    coords = {"data": d, "model": m, "pipe": p}
    groups = _axis_groups(data, model, pipe, rank) if _initialized() else {}
    return Mesh(shape, None, coords, groups)


def _initialized() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def _axis_groups(data, model, pipe, rank) -> dict:
    """The process group along each axis of more than one rank that
    holds `rank`. Every rank creates every group, in one order
    (torch.distributed.new_group is collective)."""
    import torch.distributed as dist

    grid = np.arange(data * model * pipe).reshape(data, model, pipe)
    groups = {}
    for ax, axis in enumerate(AXES):
        if grid.shape[ax] == 1:
            continue
        others = [range(s) for i, s in enumerate(grid.shape) if i != ax]
        for idx in itertools.product(*others):
            sl = list(idx)
            sl.insert(ax, slice(None))
            ranks = [int(r) for r in grid[tuple(sl)]]
            g = dist.new_group(ranks)
            if rank in ranks:
                groups[axis] = g
    return groups


def mesh_from_config(conf: dict, devices=None) -> Mesh:
    m = conf.get("mesh", {}) or {}
    return make_mesh(data=m.get("data", -1), model=m.get("model", 1),
                     pipe=m.get("pipe", 1), devices=devices)


def leaf_spec(name: str, shape, model_size: int) -> str | None:
    """The tensor-parallel rule (JAX's _leaf_spec): "model" (the last
    axis split in column blocks over the model axis) for a leaf of at
    least 2 dims whose last dim divides the axis and is at least 8 per
    block, unless it is a learnable initial state (h0) or a batch
    statistic; else None (replicated)."""
    if model_size == 1:
        return None
    parts = name.split(".")
    if "batch_stats" in parts or "h0" in parts:
        return None
    shape = tuple(shape)
    last = shape[-1] if shape else 1
    wide = last % model_size == 0 and last >= 8 * model_size
    return "model" if len(shape) >= 2 and wide else None


def param_shardings(mesh: Mesh, tree) -> dict:
    """{name: "model" or None} for a module's parameters (its buffers are
    batch statistics: replicated) or for a {name: array} dict (names
    under "batch_stats" replicated)."""
    import torch

    model_size = mesh.size("model")
    if isinstance(tree, torch.nn.Module):
        out = {n: leaf_spec(n, p.shape, model_size)
               for n, p in tree.named_parameters()}
        out.update({n: None for n, _ in tree.named_buffers()})
        return out
    return {n: leaf_spec(n, np.shape(x), model_size) for n, x in tree.items()}


def shard_batch(mesh: Mesh, batch):
    """This process's rows of a global batch (a tuple of arrays or
    tensors with the batch first): the data index's contiguous block."""
    from .distributed import process_row_slice

    rows = process_row_slice(mesh, len(batch[0]))
    cut = [x[rows] for x in batch]
    return type(batch)(*cut) if hasattr(batch, "_fields") else tuple(cut)
