"""The port's debug tools (training/debug.py) against the JAX package's
on the same weights: activation statistics keyed by JAX's intermediates
paths, parameter statistics, a profiler trace, and NaN debugging.

Tolerances: the forward passes agree to ~1e-6 (float32, the scan path,
tests/test_torch_model.py); means, stds and absmax of those outputs to
1e-5 absolute; parameter statistics come from the same float32 values
through the same numpy calls: exact.
"""

import json
import math
import os
import re

import numpy as np
import pytest
import torch

from libreasr_tpu_torch.models.transducer import Transducer, TransducerConfig
from libreasr_tpu_torch.training import debug
from test_torch_model import SMALL, _pair

TOL = 1e-5


def _inputs(n=2, t=9, u=3):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n, t, SMALL["model"]["feature_sz"])).astype(np.float32)
    y = rng.integers(1, SMALL["model"]["vocab_sz"], (n, u)).astype(np.int32)
    return x, y, np.array([t, t - 3]), np.array([u, 2])


def _check(stats, jstats):
    assert stats
    missing = set(stats) - set(jstats)
    assert not missing, missing
    # JAX's nn.Dropout is a module (Dropout_0); the port's dropout is a
    # function, so those keys alone have no port counterpart
    assert all("Dropout_" in k for k in set(jstats) - set(stats))
    for k, v in stats.items():
        for f in ("mean", "std", "absmax"):
            assert math.isclose(v[f], jstats[k][f], rel_tol=0, abs_tol=TOL), (k, f)
        assert v["nan"] == jstats[k]["nan"] is False


def test_activation_stats_match_jax():
    from libreasr_tpu.models.transducer import Transducer as JaxTransducer
    from libreasr_tpu.training.debug import activation_stats as jax_stats

    jmodel, jvars, tmodel = _pair(SMALL, seed=2)
    x, y, xl, yl = _inputs()
    enc = debug.activation_stats(tmodel, torch.from_numpy(x), method=tmodel.encode)
    _check(enc, jax_stats(jmodel, jvars, x, method=JaxTransducer.encode))
    assert "encoder/rnn_stack/layer1/__call__" in enc and "__call__" not in enc
    full = debug.activation_stats(tmodel, torch.from_numpy(x),
                                  torch.from_numpy(y).long(),
                                  torch.from_numpy(xl), torch.from_numpy(yl))
    _check(full, jax_stats(jmodel, jvars, x, y, xl, yl))
    assert {"__call__", "joint/enc_proj/__call__", "predictor/embed/__call__"} <= set(full)


def test_param_stats_match_jax():
    from libreasr_tpu.training.debug import param_stats as jax_param_stats

    _, jvars, tmodel = _pair(SMALL, seed=3)
    stats = debug.param_stats(tmodel)
    # JAX's keys are key strings, "['encoder']['rnn_stack']...['cell'].kernel"
    jstats = {".".join(a or b for a, b in re.findall(r"\['([^']+)'\]|\.(\w+)", k)): v
              for k, v in jax_param_stats(jvars["params"]).items()}
    assert set(stats) == set(jstats)
    for k, v in stats.items():
        assert v == jstats[k], k


def test_perf_trace_writes_a_trace(tmp_path):
    model = Transducer(TransducerConfig.from_config(SMALL))
    x = torch.zeros(1, 5, SMALL["model"]["feature_sz"])
    with debug.perf_trace(str(tmp_path / "trace")) as d:
        model.encode(x)
    with open(os.path.join(d, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)


def test_enable_nan_debugging_raises_at_the_first_nan():
    model = Transducer(TransducerConfig.from_config(SMALL))
    x = torch.zeros(1, 5, SMALL["model"]["feature_sz"])
    x[0, 2, 3] = float("nan")
    debug.enable_nan_debugging()
    try:
        with pytest.raises(FloatingPointError, match="LayerNorm"):
            model.encode(x)
        assert torch.is_anomaly_enabled()
    finally:
        debug.enable_nan_debugging(False)
    assert not torch.is_anomaly_enabled()
    out, _ = model.encode(x)  # off again: the NaN flows through
    assert torch.isnan(out).any()
