"""A seeded release of the reference LibreASR in its own layout, numpy
only (no torch, no JAX): a Transducer state_dict as the reference's
torch modules name and shape it (LSTM encoder with batch norms, NBRC
predictor, concat joint) and a youtokentome vocabulary of a chosen size.
chip_smoke's import phase packs them into a release archive."""

import itertools

import numpy as np


def reference_state_dict(rng, *, feature_sz, embed_sz, vocab_sz, hidden_sz,
                         joint_sz, enc_layers, pred_layers) -> dict:
    """Weights drawn with a 1/sqrt(fan-in) scale, so that a deep stack
    keeps unsaturated activations."""
    f, h, e, v, j = feature_sz, hidden_sz, embed_sz, vocab_sz, joint_sz

    def r(*shape, fan=None):
        scale = 1.0 / np.sqrt(fan or shape[-1])
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    sd = {"encoder.input_norm.weight": 1 + r(f, fan=100),
          "encoder.input_norm.bias": r(f, fan=100)}
    in_sz = f
    for i in range(enc_layers):
        p = f"encoder.rnn_stack.rnns.{i}"
        sd[f"{p}.weight_ih_l0"] = r(4 * h, in_sz)
        sd[f"{p}.weight_hh_l0"] = r(4 * h, h)
        sd[f"{p}.bias_ih_l0"] = r(4 * h, fan=100)
        sd[f"{p}.bias_hh_l0"] = r(4 * h, fan=100)
        sd[f"encoder.rnn_stack.hs.{i}"] = r(2, 1, 1, h, fan=100)
        _bn(sd, f"encoder.rnn_stack.bns.{i}", h, r)
        in_sz = h
    sd["predictor.embed.weight"] = r(v, e)
    sd["predictor.embed.weight"][0] = 0  # padding_idx
    sd["predictor.ffn.weight"] = r(h, e)
    sd["predictor.ffn.bias"] = r(h, fan=100)
    for i in range(pred_layers):
        p = f"predictor.rnn_stack.rnns.{i}"
        sd[f"{p}.kernel"] = r(h, 3 * h, fan=h)
        sd[f"{p}.recurrent_kernel"] = r(h, 3 * h, fan=h)
        sd[f"{p}.bias"] = r(3 * h, fan=100)
        sd[f"{p}.recurrent_bias"] = r(3 * h, fan=100)
        sd[f"predictor.rnn_stack.hs.{i}"] = r(1, 1, 1, h, fan=100)
        _bn(sd, f"predictor.rnn_stack.bns.{i}", h, r)
    sd["joint.joint.0.weight"] = r(j, 2 * h)
    sd["joint.joint.0.bias"] = r(j, fan=100)
    sd["joint.joint.2.weight"] = r(v, j)
    sd["joint.joint.2.bias"] = r(v, fan=100)
    return sd


def _bn(sd, p, h, r):
    sd[f"{p}.weight"] = 1 + r(h, fan=100)
    sd[f"{p}.bias"] = r(h, fan=100)
    sd[f"{p}.running_mean"] = r(h, fan=100)
    sd[f"{p}.running_var"] = 1 + np.abs(r(h, fan=100))


def yttm_vocabulary(vocab_sz: int):
    """(alphabet, merges) for write_yttm_model with exactly vocab_sz ids:
    the 4 specials, a word-start mark and 26 letters, then merges of
    earlier tokens, shortest first."""
    alphabet = "▁abcdefghijklmnopqrstuvwxyz"
    want = vocab_sz - 4 - len(alphabet)
    tokens, seen, merges = list(alphabet), set(alphabet), []
    for a, b in itertools.product(alphabet, repeat=2):
        if len(merges) == want:
            break
        merges.append((a, b))
        seen.add(a + b)
        tokens.append(a + b)
    for a, b in itertools.product(tokens[len(alphabet):], alphabet):
        if len(merges) == want:
            break
        if a + b not in seen:
            merges.append((a, b))
            seen.add(a + b)
    if len(merges) != want:
        raise ValueError(f"cannot make a vocabulary of {vocab_sz}")
    return alphabet, merges
