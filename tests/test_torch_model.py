"""The port's Transducer against the JAX package's, in eval, on weights
carried across with `convert.load_jax_variables`: small random configs
(every leaf perturbed, batch statistics and learnable h0 included) and
the golden bundle's trained weights.

The JAX side runs with LIBREASR_FORCE_PALLAS=1, so where T >= 16 both
sides run the bf16-R sequence recurrence (JAX: the Pallas kernel in
interpret mode; the port: the kernel's plain twin on the CPU).

Tolerances: float32 configs on the scan path differ only in summation
order (1e-4 after a few layers and the joint). Where the bf16-R
recurrence runs, that order difference can flip the bf16 rounding of h
(one bf16 ulp, 2**-8 relative), which moves the next step's gates:
2e-3. With bf16 compute, the joint's outputs are bf16 on both sides
(one ulp is 2**-8 relative, ~1e-2 at these logit sizes): 5e-2.
"""

import copy
import os

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from libreasr_tpu.api import ASRBundle as JaxBundle
from libreasr_tpu.models.transducer import Transducer as JaxTransducer
from libreasr_tpu.models.transducer import TransducerConfig as JaxConfig
from libreasr_tpu.models.transducer import init_transducer
from libreasr_tpu.ops.frontend import features_batch as jax_features
from libreasr_tpu_torch.api import ASRBundle
from libreasr_tpu_torch.convert import load_jax_variables
from libreasr_tpu_torch.models.transducer import Transducer, TransducerConfig
from libreasr_tpu_torch.models.transducer import learnable_states

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "golden")

SMALL = {
    "model": {
        "feature_sz": 24, "embed_sz": 8, "vocab_sz": 11, "hidden_sz": 16,
        "out_sz": 12, "joint_sz": 10, "joint": {"method": "concat"},
        "encoder": {"rnn_type": "LSTM", "num_layers": 2, "dropout": 0.0},
        "predictor": {"rnn_type": "NBRC", "num_layers": 1, "dropout": 0.0},
    },
    "dtypes": {"compute": "float32"},
}


def _bf16_reduced():
    conf = copy.deepcopy(SMALL)
    m = conf["model"]
    m.update(embed_sz=20, hidden_sz=20, out_sz=20, joint_sz=14)
    m["encoder"].update(num_layers=3, norm="layer", reduction_indices=[1],
                        reduction_factors=[2])
    m["predictor"]["num_layers"] = 2
    conf["dtypes"]["compute"] = "bfloat16"
    return conf


def _perturbed_variables(conf, seed):
    """JAX-initialised variables with every leaf moved off its init
    value (so biases, h0 and batch statistics all matter)."""
    _, variables = init_transducer(JaxConfig.from_config(conf),
                                   jax.random.PRNGKey(seed))
    tree = serialization.to_state_dict(jax.tree_util.tree_map(np.asarray, variables))
    rng = np.random.default_rng(seed)

    def move(path, v):
        v = np.asarray(v, np.float32) + 0.1 * rng.standard_normal(v.shape).astype(np.float32)
        return np.abs(v) + 0.5 if path[-1].key == "var" else v

    tree = jax.tree_util.tree_map_with_path(move, tree)
    return serialization.from_state_dict(variables, tree), tree


def _pair(conf, seed):
    jvars, np_vars = _perturbed_variables(conf, seed)
    jmodel = JaxTransducer(JaxConfig.from_config(conf))
    tmodel = Transducer(TransducerConfig.from_config(conf))
    load_jax_variables(tmodel, np_vars)
    return jmodel, jvars, tmodel


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _close(a, b, tol):
    np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=tol)


def _close_tree(a, b, tol):
    fa = jax.tree_util.tree_leaves(a)
    fb = jax.tree_util.tree_leaves(b)
    assert len(fa) == len(fb)
    for x, y in zip(fa, fb):
        _close(x, y, tol)


@pytest.mark.parametrize("conf,t,tol,logit_tol", [
    (SMALL, 8, 1e-4, 1e-4),        # scan path
    (SMALL, 20, 2e-3, 2e-3),       # sequence kernel path
    (_bf16_reduced(), 40, 2e-3, 5e-2),  # bf16 compute, time reduction
])
def test_encode_predict_lattice_match_jax(conf, t, tol, logit_tol, monkeypatch):
    monkeypatch.setenv("LIBREASR_FORCE_PALLAS", "1")
    jmodel, jvars, tmodel = _pair(conf, seed=t)
    rng = np.random.default_rng(t)
    n, u = 3, 4
    f = conf["model"]["feature_sz"]
    x = rng.standard_normal((n, t, f)).astype(np.float32)
    xl = np.array([t, t - 5, 1], np.int32)
    y = rng.integers(0, conf["model"]["vocab_sz"], (n, u)).astype(np.int32)
    y[:, 1] = 0  # blank embeddings are pinned to zero
    yl = np.array([u, 2, 0], np.int32)
    tx, txl = torch.from_numpy(x), torch.from_numpy(xl).long()
    ty, tyl = torch.from_numpy(y).long(), torch.from_numpy(yl).long()

    for lengths in (xl, None):
        jo, js = jmodel.apply(jvars, x, lengths=lengths,
                              method=JaxTransducer.encode)
        to, ts = tmodel.encode(tx, lengths=None if lengths is None else txl)
        _close(to, jo, tol)
        _close_tree(ts, js, tol)

    jo, js = jmodel.apply(jvars, y, lengths=yl, method=JaxTransducer.predict)
    to, ts = tmodel.predict(ty, lengths=tyl)
    _close(to, jo, tol)
    _close_tree(ts, js, tol)

    jl, (jes, jps) = jmodel.apply(jvars, x, y, xl, yl)
    tl, (tes, tps) = tmodel(tx, ty, txl, tyl)
    assert tuple(tl.shape) == jl.shape
    assert tl.dtype == (torch.bfloat16 if jl.dtype != np.float32 else torch.float32)
    _close(tl, jl, logit_tol)
    _close_tree(tes, jes, tol)
    _close_tree(tps, jps, tol)

    h, hp = rng.standard_normal((2, n, conf["model"]["out_sz"])).astype(np.float32)
    _close(tmodel.joint_step(torch.from_numpy(hp), torch.from_numpy(h)),
           jmodel.apply(jvars, hp, h, method=JaxTransducer.joint_step), logit_tol)


def test_learnable_states_and_mapping_errors():
    jmodel, jvars, tmodel = _pair(SMALL, seed=3)
    from libreasr_tpu.models.transducer import learnable_states as jax_states

    for tower, layers in (("encoder", 2), ("predictor", 1)):
        _close_tree(learnable_states(tmodel, tower, 5),
                    jax_states(jvars["params"], tower, 5, layers), 0.0)
    _, np_vars = _perturbed_variables(SMALL, 3)
    del np_vars["params"]["joint"]["out"]["bias"]
    with pytest.raises(ValueError, match="missing"):
        load_jax_variables(Transducer(TransducerConfig.from_config(SMALL)), np_vars)


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    jb = JaxBundle.from_bundle(os.path.join(FIXTURES, "model.tar.gz"),
                               extract_to=str(tmp_path_factory.mktemp("j")))
    tb = ASRBundle.from_bundle(os.path.join(FIXTURES, "model.tar.gz"),
                               extract_to=str(tmp_path_factory.mktemp("t")),
                               device="cpu")
    return jb, tb


@pytest.mark.parametrize("samples", [16000, 48000])
def test_golden_weights_encode_and_lattice(golden, samples, monkeypatch):
    monkeypatch.setenv("LIBREASR_FORCE_PALLAS", "1")
    jb, tb = golden
    rng = np.random.default_rng(samples)
    audio = np.zeros((3, samples), np.float32)
    audio[:, :16000] = rng.standard_normal((3, 16000)).astype(np.float32) * 0.1
    lengths = np.array([16000, 12000, 16000])
    feats, flens = jax_features(audio, lengths, jb.frontend)
    feats, flens = np.asarray(feats), np.asarray(flens)
    tol = 1e-4 if feats.shape[1] < 16 else 2e-3
    jo, js = jb.encode(feats, flens)
    to, ts = tb.encode(torch.tensor(feats), torch.tensor(flens).long())
    _close(to, jo, tol)
    _close_tree(ts, js, tol)
    y = rng.integers(1, tb.cfg.vocab_sz, (3, 5)).astype(np.int32)
    yl = np.array([5, 3, 1], np.int32)
    jl, _ = jb.model.apply(jb.variables, feats, y, flens, yl)
    with torch.inference_mode():
        tl, _ = tb.model(torch.tensor(feats), torch.from_numpy(y).long(),
                         torch.tensor(flens).long(), torch.from_numpy(yl).long())
    _close(tl, jl, tol)
