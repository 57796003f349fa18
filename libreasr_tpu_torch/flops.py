"""Analytic model FLOPs and the card's peaks, for MFU and rooflines
(the JAX package's flops.py).

Counts multiply-add matmul FLOPs (2*M*N*K per [M,K]x[K,N] product) for
the transducer's hot paths: the encoder's and predictor's gate
products, the joint, the input projections and the RNN-T loss DP.
Elementwise work (gate nonlinearities, norms, log-softmax) is left out:
MFU here measures the matmul units, which is what a peak FLOP rate
describes. tests/test_torch_flops.py holds the counts equal to the JAX
package's and against torch.utils.flop_counter on the port's model.

Peaks are NVIDIA's published dense rates for the H100 SXM at its full
700 W (data sheet): 989e12 FLOP/s in bf16 on the tensor cores, 1979e12
int8 OP/s, 67e12 FLOP/s in float32 outside the tensor cores, and HBM3 at
3.35e12 B/s. A card set below 700 W (`nvidia-smi --query-gpu=
power.limit`) runs slower under load, so a share of these peaks is
quoted beside the card's power limit. A card the table does not know
raises: a share of another card's peak would be a wrong number.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

# Peaks by a substring of torch.cuda.get_device_name (lower-cased). The
# H100 SXM names itself "NVIDIA H100 80GB HBM3"; the PCIe and NVL parts
# have other rates and names, and raise. "cpu" keeps the JAX package's
# nominal numbers so that tests can call mfu; a CPU share means nothing.
PEAKS = {
    "h100 80gb hbm3": {"bfloat16": 989e12, "int8": 1979e12, "float32": 67e12,
                       "hbm_bytes_per_s": 3.35e12},
    "cpu": {"bfloat16": 1e12, "int8": 1e12, "float32": 1e12,
            "hbm_bytes_per_s": 100e9},
}


def device_peaks(device=None) -> dict:
    """The PEAKS entry of `device` (None: the current card)."""
    from . import resolve_device

    dev = resolve_device(device)
    if dev.type == "cpu":
        return PEAKS["cpu"]
    name = torch.cuda.get_device_name(dev)
    for key, peaks in PEAKS.items():
        if key in name.lower():
            return peaks
    raise ValueError(f"libreasr_tpu_torch.flops: no published peaks for the "
                     f"card {name!r}; add its data sheet's rates to PEAKS")


def device_peak_flops(device=None, dtype: str = "bfloat16") -> float:
    """Peak FLOP/s of `device` (None: the current card) for `dtype`'s
    matmuls: "bfloat16", "int8" or "float32"."""
    return device_peaks(device)[dtype]


def device_hbm_bw(device=None) -> float:
    """Peak device-memory bytes/s of `device` (None: the current card)."""
    return device_peaks(device)["hbm_bytes_per_s"]


def lstm_layer_flops(in_sz: int, hidden_sz: int) -> float:
    """Matmul FLOPs for ONE LSTM cell step of ONE sample: the 4 gate
    products against the input and the recurrent state."""
    return 2.0 * 4 * hidden_sz * (in_sz + hidden_sz)


def gru_layer_flops(in_sz: int, hidden_sz: int) -> float:
    """One GRU ("NBRC", see ops/rnn.py) cell step: 3 gates."""
    return 2.0 * 3 * hidden_sz * (in_sz + hidden_sz)


def _rnn_flops(rnn_type: str, in_sz: int, h: int) -> float:
    return (
        gru_layer_flops(in_sz, h)
        if rnn_type.upper() in ("GRU", "NBRC")
        else lstm_layer_flops(in_sz, h)
    )


def encoder_step_flops(cfg) -> float:
    """One encoder timestep (one stacked 80 ms frame), one sample."""
    f = _rnn_flops(cfg.enc_rnn_type, cfg.feature_sz, cfg.hidden_sz)
    for _ in range(cfg.enc_num_layers - 1):
        f += _rnn_flops(cfg.enc_rnn_type, cfg.hidden_sz, cfg.hidden_sz)
    if cfg.out_sz != cfg.hidden_sz:
        f += 2.0 * cfg.hidden_sz * cfg.out_sz  # proj
    return f


def predictor_step_flops(cfg) -> float:
    """One predictor token step, one sample (embed lookup is free)."""
    f = 0.0
    if cfg.embed_sz != cfg.hidden_sz:
        f += 2.0 * cfg.embed_sz * cfg.hidden_sz  # ffn
    f += _rnn_flops(cfg.pred_rnn_type, cfg.hidden_sz, cfg.hidden_sz)
    for _ in range(cfg.pred_num_layers - 1):
        f += _rnn_flops(cfg.pred_rnn_type, cfg.hidden_sz, cfg.hidden_sz)
    if cfg.out_sz != cfg.hidden_sz:
        f += 2.0 * cfg.hidden_sz * cfg.out_sz
    return f


def joint_proj_flops(cfg) -> float:
    """Joint input projection for ONE encoder (or predictor) position:
    the concat joint is two per-side projections with a broadcast add
    (models/modules.py's Joint), so each side is projected once per its
    own axis, never per (t, u) pair."""
    return 2.0 * cfg.out_sz * cfg.joint_sz


def joint_out_flops(cfg) -> float:
    """Joint output head for ONE (t, u) lattice position: the only part
    of the joint that runs per pair."""
    return 2.0 * cfg.joint_sz * cfg.vocab_sz


def joint_single_flops(cfg) -> float:
    """One isolated joint evaluation (the streaming decode's inner loop:
    one encoder frame x one predictor state): both projections and the
    head."""
    return 2.0 * joint_proj_flops(cfg) + joint_out_flops(cfg)


def loss_dp_flops(T: int, U: int) -> float:
    """RNN-T forward DP over the [T, U] lattice (ops/rnnt_loss.py): ~6
    flops a cell (two adds and a logaddexp), negligible next to the joint
    but counted."""
    return 6.0 * T * U


def frontend_chunk_flops(fe, chunk_samples: int) -> float:
    """The mel frontend for one 80 ms chunk of one stream: the windowed
    real DFT as two [F, n_fft] x [n_fft, n_fft/2+1] products and the
    [F, n_fft/2+1] x [n_fft/2+1, n_mels] filterbank product
    (ops/frontend.py)."""
    frames = chunk_samples // fe.hop
    n_bins = fe.n_fft // 2 + 1
    dft = 2.0 * frames * fe.n_fft * n_bins * 2  # re + im
    fb = 2.0 * frames * n_bins * fe.n_mels
    return dft + fb


def train_step_flops(cfg, batch: int, T: int, U: int) -> float:
    """One training step: the forward (encoder T steps, predictor U+1
    steps, the joint over the whole [T, U+1] lattice, the loss DP) and
    the backward, counted as twice the forward (the convention for
    matmul-dominated programs)."""
    fwd = batch * (
        T * encoder_step_flops(cfg)
        + (U + 1) * predictor_step_flops(cfg)
        + (T + U + 1) * joint_proj_flops(cfg)
        + T * (U + 1) * joint_out_flops(cfg)
        + loss_dp_flops(T, U + 1)
    )
    return 3.0 * fwd


def decode_step_flops(
    cfg, fe, n_streams: int, n_buffer: int, chunk_samples: int,
    iters_per_frame: float = 2.0,
) -> float:
    """One batched streaming-engine step: frontend and encoder for
    n_buffer frames a stream, and the greedy inner loop's predictor and
    joint evaluations. The loop ends early once every stream emits blank,
    so the evaluations a frame depend on the data: iters_per_frame = 1
    (the blank check every frame makes) + the tokens a frame emitted."""
    per_frame = (
        encoder_step_flops(cfg)
        + iters_per_frame
        * (predictor_step_flops(cfg) + joint_single_flops(cfg))
    )
    per_stream = n_buffer * (
        frontend_chunk_flops(fe, chunk_samples) + per_frame
    )
    return n_streams * per_stream


@dataclass(frozen=True)
class MFU:
    flops: float
    seconds: float
    peak: float

    @property
    def achieved(self) -> float:
        return self.flops / self.seconds

    @property
    def mfu(self) -> float:
        return self.achieved / self.peak

    def __str__(self) -> str:  # "12.3% MFU (4.8 TFLOP/s)"
        return f"{self.mfu * 100:.1f}% MFU ({self.achieved / 1e12:.2f} TFLOP/s)"


def mfu(flops: float, seconds: float, device=None) -> MFU:
    """`flops` done in `seconds` against `device`'s bf16 peak."""
    return MFU(flops=flops, seconds=seconds, peak=device_peak_flops(device))


def train_step_ceiling(cfg, batch: int, T: int, U: int,
                       peak: float | None = None, bw: float | None = None):
    """Speed-of-light time for one train step: every matmul component's
    FLOPs at the bf16 peak, and the device-memory traffic floor, with the
    breakdown (fwd:bwd = 1:2 for each component). `peak` and `bw` default
    to the current card's.

    The JAX package caps each component at the share of a TPU's systolic
    array (128 rows) that its row count fills. That cap is the TPU's; the
    card has no single cap of that kind, so every component is counted at
    the full peak: a plainer lower bound than the JAX package's, never
    above it.

    Returns per-component seconds and the totals: sol_s =
    max(compute_sol_s, bandwidth_sol_s), as compute and memory traffic
    can overlap."""
    peak = peak or device_peak_flops()
    comps = {
        # encoder recurrence: per-timestep [batch, H] x [H(+I), 4H]
        "enc_recurrent": 3.0 * batch * T * encoder_step_flops(cfg) / peak,
        # predictor recurrence, (U+1) steps
        "pred_recurrent": 3.0 * batch * (U + 1) * predictor_step_flops(cfg) / peak,
        # joint projections: batch*T and batch*(U+1) rows
        "joint_proj": 3.0 * batch * (T + U + 1) * joint_proj_flops(cfg) / peak,
        # joint head over the lattice
        "joint_head": 3.0 * batch * T * (U + 1) * joint_out_flops(cfg) / peak,
    }
    # the loss DP is elementwise: its memory traffic is counted below
    compute_sol = sum(comps.values())

    bw = bw or device_hbm_bw()
    cdt = compute_itemsize(cfg)
    nparams = _transducer_params(cfg)
    traffic = {}
    # optimizer update: grads f32 write+read, master params f32
    # read+write, m/v f32 read+write, compute-dtype weight copy x2
    traffic["weights_opt"] = nparams * (4 + 4 + 8 + 16 + 2 * cdt)
    # activations saved for backward (gates + hidden per layer), written
    # by the forward and read by the backward, in the compute dtype
    h, L = cfg.hidden_sz, cfg.enc_num_layers
    acts = batch * T * (4 * h + 2 * h) * L
    acts += batch * (U + 1) * (3 * h + h) * cfg.pred_num_layers
    traffic["activations"] = 2 * acts * cdt
    # lattice: alphas/betas [N,T,U] f32 + the joint inputs read again
    traffic["lattice"] = 3 * batch * T * (U + 1) * 4
    # input features + labels
    traffic["inputs"] = batch * T * cfg.feature_sz * cdt + batch * U * 4
    bandwidth_sol = sum(traffic.values()) / bw

    return {
        "compute_sol_s": compute_sol,
        "bandwidth_sol_s": bandwidth_sol,
        "sol_s": max(compute_sol, bandwidth_sol),
        "compute_breakdown_s": comps,
        "traffic_bytes": traffic,
        "peak_flops": peak,
        "hbm_bw": bw,
    }


def compute_itemsize(cfg) -> int:
    """Bytes of one activation in the compute dtype: 2 under bf16
    compute, else 4 (the JAX package's jnp_itemsize)."""
    return 2 if cfg.compute_dtype is not None else 4


def _transducer_params(cfg) -> int:
    """Analytic parameter count of the transducer (within ~1% of the
    model's: biases and norms left out)."""
    h, f = cfg.hidden_sz, cfg.feature_sz
    enc = 4 * h * (f + h) + (cfg.enc_num_layers - 1) * 4 * h * 2 * h
    if cfg.out_sz != h:
        enc += h * cfg.out_sz
    pred = cfg.vocab_sz * cfg.embed_sz + cfg.embed_sz * h
    pred += cfg.pred_num_layers * 3 * h * 2 * h
    if cfg.out_sz != h:
        pred += h * cfg.out_sz
    joint = 2 * cfg.out_sz * cfg.joint_sz + cfg.joint_sz * cfg.vocab_sz
    return enc + pred + joint
