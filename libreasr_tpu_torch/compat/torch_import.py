"""Import checkpoints of the reference LibreASR (torch state_dicts) into
the JAX layout the port loads (convert.load_jax_variables); the port's
own copy of the JAX package's compat/torch_import.py, numpy only.

Layout contracts being mapped:
- torch nn.LSTM: weight_ih_l0 [4H, I] with gate order (i, f, g, o);
  ours: kernel [I, 4H] with haste order (i, g, f, o), single fused bias
  (torch's bias_ih + bias_hh).
- "NBRC" == haste GRU port (layers/haste/nbrc.py): attributes kernel
  [I, 3H], recurrent_kernel [H, 3H], bias, recurrent_bias in (z, r, g)
  order — identical to ours, no permutation.
- learnable initial states: reference hs.{i} [n_state, 1, 1, H]
  (custom_rnn.py:75-82) -> h0 [n_state, 1, H].
- BatchNorm1d running stats -> flax batch_stats.
- Joint Linear over cat(pred, enc) [J, 2*out] (models.py:125-136)
  -> pred_proj [out, J] + enc_proj [out, J] split.

Operates on a plain {name: np.ndarray} dict so torch is only needed to
*read* .pth files (load_torch_state_dict), not to convert.
"""

from __future__ import annotations

import numpy as np

# torch LSTM gate order (i, f, g, o) -> haste/ours (i, g, f, o)
_TORCH_TO_HASTE = [0, 2, 1, 3]


def load_torch_state_dict(path: str) -> dict:
    """Read a torch .pth into numpy (requires torch at call time)."""
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    if "model" in sd and isinstance(sd["model"], dict):
        sd = sd["model"]  # fastai learn.save layout
    return {k: v.detach().cpu().numpy() for k, v in sd.items()}


def _permute_lstm_gates(w: np.ndarray, h: int) -> np.ndarray:
    """Reorder the leading 4H axis from torch to haste gate order."""
    parts = [w[i * h : (i + 1) * h] for i in range(4)]
    return np.concatenate([parts[j] for j in _TORCH_TO_HASTE], axis=0)


def convert_torch_lstm(sd: dict, prefix: str, layer: int = 0) -> dict:
    """torch nn.LSTM params -> our LSTMParams dict."""
    w_ih = np.asarray(sd[f"{prefix}.weight_ih_l{layer}"])  # [4H, I]
    w_hh = np.asarray(sd[f"{prefix}.weight_hh_l{layer}"])  # [4H, H]
    h = w_hh.shape[1]
    b = np.zeros(4 * h, np.float32)
    if f"{prefix}.bias_ih_l{layer}" in sd:
        b = np.asarray(sd[f"{prefix}.bias_ih_l{layer}"]) + np.asarray(
            sd[f"{prefix}.bias_hh_l{layer}"]
        )
    return {
        "kernel": _permute_lstm_gates(w_ih, h).T.astype(np.float32),
        "recurrent_kernel": _permute_lstm_gates(w_hh, h).T.astype(np.float32),
        "bias": _permute_lstm_gates(b[:, None], h)[:, 0].astype(np.float32),
    }


def convert_haste_gru(sd: dict, prefix: str) -> dict:
    """haste-port NBRC/GRU params (already [I, 3H] z,r,g) -> ours."""
    return {
        "kernel": np.asarray(sd[f"{prefix}.kernel"], np.float32),
        "recurrent_kernel": np.asarray(sd[f"{prefix}.recurrent_kernel"], np.float32),
        "bias": np.asarray(sd[f"{prefix}.bias"], np.float32),
        "recurrent_bias": np.asarray(sd[f"{prefix}.recurrent_bias"], np.float32),
    }


def _linear(sd: dict, prefix: str) -> dict:
    out = {"kernel": np.asarray(sd[f"{prefix}.weight"], np.float32).T}
    if f"{prefix}.bias" in sd:
        out["bias"] = np.asarray(sd[f"{prefix}.bias"], np.float32)
    return out


def _layernorm(sd: dict, prefix: str) -> dict:
    return {
        "scale": np.asarray(sd[f"{prefix}.weight"], np.float32),
        "bias": np.asarray(sd[f"{prefix}.bias"], np.float32),
    }


def _stack(sd, prefix: str, num_layers: int, rnn_type: str):
    """CustomRNN stack -> (params, batch_stats)."""
    params, stats = {}, {}
    for i in range(num_layers):
        rnn_prefix = f"{prefix}.rnns.{i}"
        if rnn_type == "LSTM":
            cell = convert_torch_lstm(sd, rnn_prefix)
        else:
            cell = convert_haste_gru(sd, rnn_prefix)
        h0 = np.asarray(sd[f"{prefix}.hs.{i}"], np.float32)
        params[f"layer{i}"] = {
            "cell": cell,
            "h0": h0.reshape(h0.shape[0], 1, h0.shape[-1]),
        }
        bn = f"{prefix}.bns.{i}"
        if f"{bn}.weight" in sd:
            params[f"norm{i}"] = {
                "scale": np.asarray(sd[f"{bn}.weight"], np.float32),
                "bias": np.asarray(sd[f"{bn}.bias"], np.float32),
            }
            stats[f"norm{i}"] = {
                "mean": np.asarray(sd[f"{bn}.running_mean"], np.float32),
                "var": np.asarray(sd[f"{bn}.running_var"], np.float32),
            }
    return params, stats


def convert_transducer(sd: dict, cfg) -> dict:
    """Reference Transducer state_dict -> our {params, batch_stats}."""
    params: dict = {}
    stats: dict = {}

    enc = {"input_norm": _layernorm(sd, "encoder.input_norm")}
    enc_stack, enc_stats = _stack(
        sd, "encoder.rnn_stack", cfg.enc_num_layers, cfg.enc_rnn_type
    )
    enc["rnn_stack"] = enc_stack
    if "encoder.linear.weight" in sd:
        enc["proj"] = _linear(sd, "encoder.linear")
    params["encoder"] = enc
    stats["encoder"] = {"rnn_stack": enc_stats}

    pred = {"embed": {"embedding": np.asarray(sd["predictor.embed.weight"], np.float32)}}
    if "predictor.ffn.weight" in sd:
        pred["ffn"] = _linear(sd, "predictor.ffn")
    pred_stack, pred_stats = _stack(
        sd, "predictor.rnn_stack", cfg.pred_num_layers, cfg.pred_rnn_type
    )
    pred["rnn_stack"] = pred_stack
    if "predictor.linear.weight" in sd:
        pred["proj"] = _linear(sd, "predictor.linear")
    params["predictor"] = pred
    stats["predictor"] = {"rnn_stack": pred_stats}

    # joint: Sequential(Linear(2*out -> J), Tanh, Linear(J -> V))
    w0 = np.asarray(sd["joint.joint.0.weight"], np.float32)  # [J, 2*out]
    b0 = np.asarray(sd["joint.joint.0.bias"], np.float32)
    out_sz = w0.shape[1] // 2
    params["joint"] = {
        "pred_proj": {"kernel": w0[:, :out_sz].T, "bias": b0},
        "enc_proj": {"kernel": w0[:, out_sz:].T},
        "out": _linear(sd, "joint.joint.2"),
    }
    return {"params": params, "batch_stats": stats}


def convert_lm(sd: dict, num_layers: int) -> dict:
    """Reference LM (lm.py:20-41) -> our LM params."""
    params = {
        "embed": {"embedding": np.asarray(sd["embed.weight"], np.float32)}
    }
    for i in range(num_layers):
        params[f"lstm{i}"] = convert_torch_lstm(sd, "rnn", layer=i)
    if "linear.weight" in sd and "linear.weight" != "embed.weight":
        params["out"] = _linear(sd, "linear")
    return {"params": params}
