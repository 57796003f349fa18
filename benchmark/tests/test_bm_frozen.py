"""What the accepted configurations read stays as it was before the
model's architecture moved into its family file
(`benchmark/families/`): for both, the leaf plan, the
leaves drawn on the CPU from the configuration's weight_seed, and
mfu.backlog's FLOP total for fixed counters equal the numbers frozen
from the harness that had them built in."""

import hashlib
import json
import math
import re

import pytest

from benchmark import core
from benchmark import weights as W

H100 = "NVIDIA H100 80GB HBM3"
COUNTERS = {"frames": 1000003, "tokens": 700001, "window_s": 51.0}

# (leaves, elements, sha256 of the plan as JSON, sha256 of every leaf's
# name, shape and float32 bytes in order, FLOP total, mfu.backlog's
# reading)
FROZEN = {
    "rnnt-base-bf16": (
        76, 69820928,
        "58738edea9ecbb6ea9dde73125d30e7278edd68ed7fdc98802de7ddda882348b",
        "05dd84dc3d36f28dcee60d0712cc9cd5cd65228b6ca513dcce8ea52b565a9401",
        179446669875200.0, 0.35576968194294095),
    "rnnt-base-lm-en-beam4": (
        89, 90280448,
        "489d17b99b69f29c95b724bccb13a8e76878f42f504f874d9a6f0e814a33b826",
        "c4c0614d9a15f615e304386528aa3a41777d87b9a0be61f5b6c96b9604f474e8",
        634005435422720.0, 18.55444645662043),
}


def _plan(name):
    config = core.load_json("configs", name)
    family = core.family(config["conf"])
    return config, family, family.plan(config["conf"])


@pytest.mark.parametrize("name", sorted(FROZEN))
def test_plan_is_frozen(name):
    n, elems, plan_sha, _, _, _ = FROZEN[name]
    _, _, plan = _plan(name)
    assert len(plan) == n
    assert sum(math.prod(s) for _, s, _, _ in plan) == elems
    assert hashlib.sha256(json.dumps(plan).encode()).hexdigest() == plan_sha


@pytest.mark.parametrize("name", sorted(FROZEN))
def test_leaves_are_frozen(name):
    config, family, plan = _plan(name)
    leaves = W.draw(plan, config["weight_seed"], "cpu", family.BLANK_LEAF,
                    config["blank_bias"], config.get("gain"))
    h = hashlib.sha256()
    for k, t in leaves.items():
        h.update(k.encode())
        h.update(repr(tuple(t.shape)).encode())
        h.update(t.contiguous().numpy().tobytes())
    assert h.hexdigest() == FROZEN[name][3]


@pytest.mark.parametrize("name", sorted(FROZEN))
def test_flop_total_is_frozen(name, capsys):
    reader = core.load_module("metrics", "mfu.backlog")
    ctx = {"counters": COUNTERS, "config": core.load_json("configs", name),
           "device_name": H100}
    assert reader.read(ctx) == FROZEN[name][5]
    said = re.search(r"# mfu\.backlog: (\S+) FLOPs", capsys.readouterr().err)
    assert float(said.group(1)) == FROZEN[name][4]
