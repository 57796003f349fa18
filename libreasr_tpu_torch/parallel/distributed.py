"""Process bootstrap and per-process batch rows (the JAX package's
parallel/distributed.py), one process per device.

- `initialize` starts torch.distributed: from the CLI's flags
  (`tcp://host:port`, or any init-method URL), or from the environment
  `torchrun` sets (`env://`), or not at all (the single process, with
  JAX's `[distributed] single-process mode` line). NCCL on the card,
  gloo on the CPU; a failed NCCL start raises, it never falls back.
- every rank iterates the same deterministic loader and keeps its data
  index's rows of each global batch (`process_row_slice`,
  `global_batch`); there is no global tensor.
- `replicate_tree` makes every rank hold rank 0's values, then keeps its
  column block of the model-sharded leaves.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch

from .mesh import make_mesh


def _dist():
    import torch.distributed as dist

    return dist


def initialize(coordinator: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, *, device="cuda",
               timeout_s: float = 600.0) -> None:
    """Start the process group (no-op for a single process). `device`
    picks the backend: NCCL for cuda, gloo for cpu. On cuda each process
    takes the card of its local rank (LOCAL_RANK under torchrun, else
    its rank modulo the visible cards)."""
    dist = _dist()
    dev = torch.device(device)
    env = os.environ
    if coordinator:
        init = coordinator if "://" in coordinator else f"tcp://{coordinator}"
        world, rank = int(num_processes or 1), int(process_id or 0)
    elif "WORLD_SIZE" in env and "RANK" in env and "MASTER_ADDR" in env:
        init, world, rank = "env://", int(env["WORLD_SIZE"]), int(env["RANK"])
    else:
        print("[distributed] single-process mode (no coordinator given and "
              "no torchrun environment)")
        return
    if dist.is_initialized():
        print("[distributed] single-process mode (already initialized)")
        return
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("libreasr_tpu_torch: distributed on cuda needs "
                               "a card; pass device='cpu' for gloo")
        if not dist.is_nccl_available():
            raise RuntimeError("libreasr_tpu_torch: this torch has no NCCL; "
                               "distributed on cuda needs it")
        local = int(env.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        backend = "nccl"
    else:
        backend = "gloo"
    kw = {"init_method": init, "timeout": datetime.timedelta(seconds=timeout_s)}
    if init != "env://":
        kw.update(world_size=world, rank=rank)
    if backend == "nccl":
        kw["device_id"] = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group(backend, **kw)


def process_count() -> int:
    dist = _dist()
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    dist = _dist()
    return dist.get_rank() if dist.is_initialized() else 0


def local_device(device="cuda") -> torch.device:
    """This process's device: its card on cuda, the host on cpu."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def global_mesh(model: int = 1, pipe: int = 1):
    """A mesh over every process, the data axis inferred."""
    return make_mesh(data=-1, model=model, pipe=pipe)


def local_batch_size(mesh, global_bs: int) -> int:
    """Rows of the global batch this process holds: those of its data
    index (the model and pipe axes hold the same rows)."""
    d = mesh.size("data")
    if global_bs % d:
        raise AssertionError(f"global batch {global_bs} not divisible by "
                             f"{d} processes on the data axis")
    return global_bs // d


def process_row_slice(mesh, global_bs: int) -> slice:
    """Which rows of the global batch belong to this process."""
    n = local_batch_size(mesh, global_bs)
    d = mesh.index("data")
    return slice(d * n, (d + 1) * n)


def global_batch(mesh, local_tree, device="cpu"):
    """This process's rows, already cut (`process_row_slice`), as tensors
    on its device. The global batch exists only as every rank's rows."""
    out = [torch.as_tensor(x).to(device) for x in local_tree]
    return type(local_tree)(*out) if hasattr(local_tree, "_fields") else tuple(out)


@torch.no_grad()
def replicate_tree(mesh, tree: dict, shardings: dict | None = None) -> dict:
    """{name: tensor} -> every rank holds rank 0's values (a broadcast
    over the world), cut to its column block where the leaf is sharded
    on "model" (mesh.param_shardings)."""
    from .mesh import param_shardings

    dist = _dist()
    if shardings is None:
        shardings = param_shardings(mesh, tree)
    out = {}
    for name, x in tree.items():
        x = x.detach().clone()
        if dist.is_initialized():
            dist.broadcast(x, src=0)
        if shardings.get(name) == "model":
            x = column_block(x, mesh.size("model"), mesh.index("model"))
        out[name] = x
    return out


def column_block(x: torch.Tensor, parts: int, index: int) -> torch.Tensor:
    """Block `index` of `parts` along the last axis (a copy)."""
    w = x.shape[-1] // parts
    return x[..., index * w:(index + 1) * w].clone()


def rank0_says(flag: bool, device) -> bool:
    """Rank 0's `flag` on every process (a decision every rank must take
    alike, such as a collective checkpoint on a timer)."""
    dist = _dist()
    if not dist.is_initialized():
        return bool(flag)
    t = torch.tensor([int(flag)], device=device)
    dist.broadcast(t, src=0)
    return bool(t.item())


def all_processes_agree(value: float) -> bool:
    """Every process holds the same scalar (gathered and compared)."""
    dist = _dist()
    if not dist.is_initialized():
        return True
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend() == "nccl" else torch.device("cpu")
    t = torch.tensor([float(value)], dtype=torch.float64, device=dev)
    got = [torch.zeros_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(got, t)
    vals = torch.cat(got).cpu().numpy()
    return bool(np.allclose(vals, vals[0]))
