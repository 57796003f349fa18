"""The tiny transducer of tests/test_beam.py and a small random LM, built
once in JAX and carried into the port with the same weights, with the
decoder endpoints of both sides. Used by the port's beam and fusion
tests (tests/test_torch_beam.py, tests/test_torch_lm.py)."""

from __future__ import annotations

import numpy as np
import torch

TINY = dict(feature_sz=8, embed_sz=6, vocab_sz=12, hidden_sz=8, out_sz=8,
            joint_sz=8, enc_num_layers=1, pred_num_layers=1)
TINY_LM = dict(vocab_sz=12, embed_sz=8, hidden_sz=8, num_layers=1)


def np_variables(variables) -> dict:
    """A flax variables tree as a nested dict of numpy arrays."""
    import jax
    from flax import serialization

    return serialization.to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                              variables))


def build(seed: int = 5, lm_seed: int = 9, lm_cfg: dict | None = None):
    """Returns (jax_fns, jax_fns_lm, port_fns, port_fns_lm, jax_encode,
    port_model, port_lm): DecoderFns without and with the LM on both
    sides, and the JAX encoder bound to its variables."""
    import jax
    import jax.numpy as jnp

    from libreasr_tpu.models import decode as jdecode
    from libreasr_tpu.models.lm import LMConfig as JaxLMConfig
    from libreasr_tpu.models.lm import init_lm
    from libreasr_tpu.models.transducer import Transducer as JaxTransducer
    from libreasr_tpu.models.transducer import TransducerConfig as JaxConfig
    from libreasr_tpu.models.transducer import init_transducer
    from libreasr_tpu_torch.convert import load_jax_lm_variables, load_jax_variables
    from libreasr_tpu_torch.models.decode import DecoderFns
    from libreasr_tpu_torch.models.lm import LM, LMConfig
    from libreasr_tpu_torch.models.transducer import Transducer, TransducerConfig

    lm_cfg = lm_cfg or TINY_LM
    jmodel, jvars = init_transducer(JaxConfig(**TINY), jax.random.PRNGKey(seed))
    jlm, jlm_vars = init_lm(JaxLMConfig(**lm_cfg), jax.random.PRNGKey(lm_seed))

    def j_predict(y, state):
        return jmodel.apply(jvars, y, state=state, method=JaxTransducer.predict)

    def j_joint(h_pred, h_enc):
        return jmodel.apply(jvars, h_pred, h_enc, method=JaxTransducer.joint_step)

    def j_lm_step(y, state):
        return jlm.apply(jlm_vars, y, state=state)

    def j_lm_init(n):
        return tuple((jnp.zeros((n, lm_cfg["hidden_sz"])),
                      jnp.zeros((n, lm_cfg["hidden_sz"])))
                     for _ in range(lm_cfg["num_layers"]))

    def j_encode(x):
        return jmodel.apply(jvars, jnp.asarray(x), method=JaxTransducer.encode)[0]

    model = Transducer(TransducerConfig(**TINY))
    load_jax_variables(model, np_variables(jvars))
    lm = LM(LMConfig(**lm_cfg))
    load_jax_lm_variables(lm, np_variables(jlm_vars))
    jfns = jdecode.DecoderFns(predict_step=j_predict, joint_step=j_joint)
    jfns_lm = jdecode.DecoderFns(predict_step=j_predict, joint_step=j_joint,
                                 lm_step=j_lm_step, lm_init_state=j_lm_init)
    tfns = DecoderFns(predict_step=model.predict, joint_step=model.joint_step)
    tfns_lm = DecoderFns(predict_step=model.predict, joint_step=model.joint_step,
                         lm_step=lm, lm_init_state=lm.init_state)
    return jfns, jfns_lm, tfns, tfns_lm, j_encode, model, lm


def leaves(tree) -> list:
    """The tensors or arrays of nested tuples, in order."""
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def assert_state_equal(jstate, tstate, fields, tol: float, exact=()) -> None:
    """Every leaf of each field of a JAX state (a NamedTuple) against the
    port's (a dataclass): `exact` fields and integer/bool leaves equal,
    the rest within `tol` absolute."""
    for name in fields:
        a = leaves(getattr(jstate, name))
        b = leaves(getattr(tstate, name))
        assert len(a) == len(b), name
        for i, (x, y) in enumerate(zip(a, b)):
            x = np.asarray(x)
            y = y.detach().cpu().numpy() if isinstance(y, torch.Tensor) else y
            assert x.shape == y.shape, (name, i, x.shape, y.shape)
            if name in exact or x.dtype.kind in "biu":
                np.testing.assert_array_equal(y, x, err_msg=f"{name}[{i}]")
            else:
                np.testing.assert_allclose(y, x, rtol=0, atol=tol,
                                           err_msg=f"{name}[{i}]")
