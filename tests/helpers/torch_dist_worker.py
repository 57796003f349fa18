"""One rank of a multi-process run of the port on the CPU (gloo), for the
tests of libreasr_tpu_torch/parallel. Imports no JAX.

    python tests/helpers/torch_dist_worker.py SPEC.json RANK

SPEC (written by the test): "store" (a file for the file:// rendezvous,
so that concurrent tests never share a port), "world", "mesh" ({"data",
"model", "pipe"}), "scenario" and its inputs, "out" (a directory).
Each rank writes out/rank{RANK}.json; rank 0 also writes the whole
model after the run as out/params.pt.

Scenarios:
- "train": a Learner on the mesh (from "conf" with its seed, or from
  "cfg" + "weights" with the optimizer "opt"), "steps" steps on this
  rank's rows of the global batches in "batches"; with "save", a
  checkpoint afterwards; with "restore", a restore before the steps
  ("restore_like_jax": keep only the train state, as JAX's
  restore_train_state does: no carries, fresh generators); with
  "resume", JAX's save-restore-step sequence; with "then_restore",
  another checkpoint restored into a fresh learner that steps on the
  next batch.
- "pipeline": pipeline_lstm_stack forward and backward on "stack".

With "variants" (a list of dicts), the scenario runs once for each,
the dict merged over SPEC, and rank{RANK}.json holds the list of results
(params{i}.pt for variant i).
"""

import json
import os
import sys


def _learner(spec, mesh):
    import torch

    from libreasr_tpu_torch.convert import load_jax_variables
    from libreasr_tpu_torch.models.transducer import Transducer, TransducerConfig
    from libreasr_tpu_torch.training import optimizers as topt
    from libreasr_tpu_torch.training.learner import Learner, LossConfig

    pp_micro = spec.get("pp_micro", 4)
    if "conf" in spec:
        return Learner.from_config(spec["conf"], device="cpu", mesh=mesh,
                                   pp_micro=pp_micro)
    model = Transducer(TransducerConfig(**spec["cfg"]))
    load_jax_variables(model, torch.load(spec["weights"], weights_only=False))
    opt = spec["opt"]
    tx = topt.build_optimizer(opt["name"], opt["lr"],
                              **opt.get("kw", {}))
    return Learner(model, tx, None, LossConfig(**spec.get("loss", {})),
                   seed=spec.get("seed", 0), mesh=mesh, pp_micro=pp_micro)


def _rows(batches, k, mesh):
    import torch

    from libreasr_tpu_torch.parallel import distributed as dist
    from libreasr_tpu_torch.training.learner import Batch

    arrs = [batches[f][k] for f in Batch._fields]
    rows = dist.process_row_slice(mesh, arrs[0].shape[0])
    return Batch(*(torch.from_numpy(a[rows]) for a in arrs))


def _bytes(tensors) -> int:
    return int(sum(t.numel() * t.element_size() for t in tensors))


def run_train(spec, mesh, rank):
    import numpy as np
    import torch

    from libreasr_tpu_torch.parallel import distributed as dist
    from libreasr_tpu_torch.training.checkpoint import (restore_train_state,
                                                        save_train_state)

    batches = dict(np.load(spec["batches"]))
    learner = _learner(spec, mesh)
    res = {"losses": [], "resumed": []}

    def restore(learner, path):
        restore_train_state(path, learner)
        if spec.get("restore_like_jax"):
            learner.carries = {}
            seed = spec.get("seed", 0)
            learner.host_gen.manual_seed(seed)
            learner.gen.manual_seed(seed + 1)

    if spec.get("restore"):
        restore(learner, spec["restore"])
    for k in range(spec["steps"]):
        m = learner.step(_rows(batches, k, mesh))
        res["losses"].append(float(m["loss"]))
    if spec.get("resume"):
        # JAX's run_steps_with_checkpoint: save, a fresh learner, restore,
        # the same batch again
        save_train_state(spec["resume"], learner)
        fresh = _learner(spec, mesh)
        restore(fresh, spec["resume"])
        res["resumed"].append(float(fresh.step(_rows(batches, 0, mesh))["loss"]))
    if spec.get("then_restore"):
        # another run's checkpoint into a fresh learner, then the next batch
        fresh = _learner(spec, mesh)
        restore(fresh, spec["then_restore"])
        res["resumed"].append(float(fresh.step(
            _rows(batches, spec["steps"], mesh))["loss"]))
    for v in res["losses"] + res["resumed"]:
        assert dist.all_processes_agree(v), "loss differs across processes"
    sharded = [p for n, p in zip(learner.held, learner.params)
               if learner.layout[n] == "model"]
    ids = {id(p) for p in sharded}
    res["sharded_bytes"] = _bytes(sharded)
    res["moment_bytes"] = _moment_bytes(learner.state.opt_state, learner.params,
                                        ids)
    res["params_bytes"] = _bytes(learner.params)
    sd = learner.state_dict()
    if spec.get("save"):
        save_train_state(spec["save"], learner)
    if rank == 0:
        torch.save({k: v.clone() for k, v in sd.items()},
                   os.path.join(spec["out"], spec.get("params_file", "params.pt")))
    return res


def _moment_bytes(opt_state, params, sharded_ids) -> int:
    """Bytes of the optimizer's per-parameter tensors that belong to
    the model-sharded parameters."""
    from libreasr_tpu_torch.training.checkpoint import _per_param

    lists = []
    _per_param(opt_state, len(params), lambda t: lists.append(t) or t)
    idx = [i for i, p in enumerate(params) if id(p) in sharded_ids]
    return sum(lst[i].numel() * lst[i].element_size()
               for lst in lists for i in idx)


def run_pipeline(spec, mesh, rank):
    import numpy as np
    import torch

    from libreasr_tpu_torch.ops.rnn import LSTMParams
    from libreasr_tpu_torch.parallel.pipeline import pipeline_lstm_stack

    d = dict(np.load(spec["stack"]))
    stacked = LSTMParams(*(torch.from_numpy(d[f]).requires_grad_()
                           for f in LSTMParams._fields))
    x = torch.from_numpy(d["x"]).requires_grad_()
    lengths = torch.from_numpy(d["lengths"]) if "lengths" in d else None
    y = pipeline_lstm_stack(stacked, x, mesh=mesh, n_micro=spec["n_micro"],
                            lengths=lengths)
    (y ** 2).sum().backward()
    import torch.distributed as tdist

    grads = [getattr(stacked, f).grad.clone() for f in LSTMParams._fields]
    for g in grads:  # each stage holds its layers' gradients
        tdist.all_reduce(g, group=mesh.group("pipe"))
    if rank == 0:
        np.savez(os.path.join(spec["out"], "pipeline.npz"),
                 y=y.detach().numpy(), dx=x.grad.numpy(),
                 **{f"d_{f}": g.numpy() for f, g in zip(LSTMParams._fields,
                                                        grads)})
    return {}


def main():
    spec = json.load(open(sys.argv[1]))
    rank = int(sys.argv[2])
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))
    import torch

    torch.set_num_threads(1)
    from libreasr_tpu_torch.parallel import distributed as dist
    from libreasr_tpu_torch.parallel.mesh import make_mesh

    dist.initialize("file://" + spec["store"], spec["world"], rank,
                    device="cpu", timeout_s=60)
    m = spec.get("mesh", {})
    mesh = make_mesh(data=m.get("data", -1), model=m.get("model", 1),
                     pipe=m.get("pipe", 1))
    run = {"train": run_train, "pipeline": run_pipeline}[spec["scenario"]]
    if "variants" in spec:
        res = [run({**spec, **v, "params_file": f"params{i}.pt"}, mesh, rank)
               for i, v in enumerate(spec["variants"])]
    else:
        res = run(spec, mesh, rank)
    with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    import torch.distributed as tdist

    tdist.barrier()
    tdist.destroy_process_group()


if __name__ == "__main__":
    main()
