"""The yardstick's arithmetic: matmul FLOPs of the model's parts from
their shapes, and the card's published peaks.

A frozen copy of the counts in `libreasr_tpu_torch/flops.py` and of
`chip_smoke.py:roofline_ms`, taken over the benchmark's configuration
files so that the program cannot move them. FLOPs count multiply-adds
as 2 (2*M*N*K a [M, K] x [K, N] product); elementwise work is left out,
since a share of the peak describes the matrix units.

Peaks are NVIDIA's data sheet's dense rates for the H100 SXM at its full
700 W. A card that the table does not name raises: a share of another
card's peak would be a wrong number.
"""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bfloat16": 989e12, "int8": 1979e12,
                              "float32": 67e12, "hbm_bytes_per_s": 3.35e12},
}


def peaks(device_name: str) -> dict:
    if device_name not in PEAKS:
        raise ValueError(f"no published peaks for the card {device_name!r}")
    return PEAKS[device_name]


def lstm_step(in_sz: int, h: int) -> float:
    """One LSTM cell step of one row: four gates' input and recurrent
    products."""
    return 2.0 * 4 * h * (in_sz + h)


def gru_step(in_sz: int, h: int) -> float:
    """One GRU (NBRC) cell step of one row: three gates."""
    return 2.0 * 3 * h * (in_sz + h)


def encoder_frame(m: dict) -> float:
    """The encoder on one stacked frame of one stream."""
    f = lstm_step(m["feature_sz"], m["hidden_sz"])
    f += (m["encoder"]["num_layers"] - 1) * lstm_step(m["hidden_sz"], m["hidden_sz"])
    if m["out_sz"] != m["hidden_sz"]:
        f += 2.0 * m["hidden_sz"] * m["out_sz"]
    return f


def predictor_token(m: dict) -> float:
    """The predictor on one token of one stream (the lookup is free)."""
    f = 0.0
    if m["embed_sz"] != m["hidden_sz"]:
        f += 2.0 * m["embed_sz"] * m["hidden_sz"]
    f += m["predictor"]["num_layers"] * gru_step(m["hidden_sz"], m["hidden_sz"])
    if m["out_sz"] != m["hidden_sz"]:
        f += 2.0 * m["hidden_sz"] * m["out_sz"]
    return f


def joint_single(m: dict) -> float:
    """One joint evaluation: both input projections and the head."""
    return (2 * 2.0 * m["out_sz"] * m["joint_sz"]
            + 2.0 * m["joint_sz"] * m["vocab_sz"])


def lm_token(lm: dict) -> float:
    """The LM on one token of one row: its LSTM layers and the head."""
    f = lstm_step(lm["embed_sz"], lm["hidden_sz"])
    f += (lm["num_layers"] - 1) * lstm_step(lm["hidden_sz"], lm["hidden_sz"])
    return f + 2.0 * lm["hidden_sz"] * lm["vocab_sz"]


def frontend_chunk(conf: dict, chunk_samples: int) -> float:
    """The log-mel frontend on one chunk of one stream: the windowed real
    DFT as two products and the mel bank."""
    hop = int(conf["hop_length"] * conf["sr"])
    n_fft, n_mels = conf["melkwargs"]["n_fft"], conf["melkwargs"]["n_mels"]
    frames = chunk_samples // hop
    bins = n_fft // 2 + 1
    return 2.0 * frames * n_fft * bins * 2 + 2.0 * frames * bins * n_mels


def roofline_s(nbytes: float, ops: float, device_name: str,
               dtype: str = "bfloat16") -> tuple[float, str]:
    """Least time for `nbytes` moved and `ops` done on the card: the
    larger of the two over its peaks, and which of the two bounds it."""
    p = peaks(device_name)
    tb, to = nbytes / p["hbm_bytes_per_s"], ops / p[dtype]
    return max(tb, to), ("bytes" if tb >= to else "operations")
