"""A cell's configuration cut to a size the CPU runs in seconds: the same
files, the widths and depths shrunk, a few slots and short utterances.
For the CPU tests only; the cells run at their published widths."""

from __future__ import annotations

import copy
import os

import torch

from benchmark import core
from benchmark.run import Bench


def tiny_config(config: dict, compute: str | None = None) -> dict:
    c = copy.deepcopy(config)
    conf = c["conf"]
    conf["melkwargs"]["n_mels"] = 16
    conf["model"].update(feature_sz=160, embed_sz=24, hidden_sz=32, out_sz=32,
                         joint_sz=32, vocab_sz=64)
    conf["model"]["encoder"]["num_layers"] = 2
    if compute:
        conf["dtypes"]["compute"] = compute
    if (conf.get("lm") or {}).get("enable"):
        conf["lm"].update(vocab_sz=64, embed_sz=16, hidden_sz=16, num_layers=2)
    return c


def tiny_bench(workload: str, seed: int, *, bias: float = 0.7,
               gain: float = 1.0, compute: str | None = None,
               streams: int = 4) -> Bench:
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    cell = core.load_json("workloads", workload)
    config = tiny_config(core.load_json("configs", cell["config"]), compute)
    # the tiny model's weights come from the test's seed (the seeds the
    # tests name are ones whose tiny models emit)
    config.pop("weight_seed", None)
    config["blank_bias"] = bias
    config["gain"] = {"model.joint.out.kernel": gain}
    traffic = dict(core.load_json("traffic", cell["traffic"]), streams=streams,
                   utt_s=[0.5, 2.0], pool=64, sample_utts=8)
    return Bench(workload, seed, "cpu", config=config, traffic=traffic)
