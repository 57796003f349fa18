"""A cell's configuration cut to a size the CPU runs in seconds: the same
files, the widths and depths shrunk, a few slots and short utterances.
For the CPU tests only; the cells run at their published widths."""

from __future__ import annotations

import os

import torch

from benchmark import core
from benchmark.run import Bench


def tiny_config(config: dict, compute: str | None = None) -> dict:
    """The configuration cut by its family's `tiny`; `compute`, the
    towers' compute dtype in place of the configuration's."""
    c = core.family(config["conf"]).tiny(config)
    if compute:
        c["conf"]["dtypes"]["compute"] = compute
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
    config["gain"] = dict.fromkeys(config.get("gain", {}), gain)
    traffic = dict(core.load_json("traffic", cell["traffic"]), streams=streams,
                   utt_s=[0.5, 2.0], pool=64, sample_utts=8)
    return Bench(workload, seed, "cpu", config=config, traffic=traffic)
