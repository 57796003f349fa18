"""The plain reference of the 6-2-1024 transducer and its LSTM LM.

Plain PyTorch in float32 with TF32 off (the judge turns it off before
it runs), written from the architecture
(LibreASR's Transducer: log-mel frontend, stacked frames, an LSTM
encoder with a batch norm after every layer, an NBRC predictor, the
concat joint; the LSTM LM with its tied head), with none of the
program's modules, kernels, batching or caches. It reads the weights as
the benchmark drew them (`benchmark/weights.py`), by name.

`prec` lowers the precision of every matrix product, for the control:
None keeps float32; "bf16" rounds both operands to bfloat16; "fp8"
rounds both to float8 e4m3 with a scale per tensor for the weight and
per row for the activation, as an fp8 inference path would.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


def _fp8(x: torch.Tensor, dim) -> torch.Tensor:
    amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    s = amax / E4M3_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


def lower(x: torch.Tensor, prec, weight: bool) -> torch.Tensor:
    if prec is None:
        return x
    if prec == "bf16":
        return x.to(torch.bfloat16).float()
    if prec == "fp8":
        return _fp8(x, None if weight else -1)
    raise ValueError(f"no such precision: {prec!r}")


def mm(x, w, prec=None):
    """x [..., I] @ w [I, O] in float32, operands lowered by `prec`."""
    return lower(x, prec, False) @ lower(w, prec, True)


# ---- frontend ---------------------------------------------------------


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)


def mel_bank(n_freqs: int, n_mels: int, sr: int) -> np.ndarray:
    """Triangular HTK-scale filters from 0 Hz to sr/2, no norm."""
    freqs = np.linspace(0, sr // 2, n_freqs)
    pts = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(sr / 2.0),
                                 n_mels + 2))
    diff = pts[1:] - pts[:-1]
    slopes = pts[None, :] - freqs[:, None]
    down = -slopes[:, :-2] / diff[:-1]
    up = slopes[:, 2:] / diff[1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


class Frontend:
    """log(mel power + 1e-6) over a centred, reflect-padded STFT with a
    periodic Hann window of `win` samples inside n_fft, then n_stack
    frames stacked with stride `downsample`."""

    def __init__(self, fe: dict, device):
        self.sr = fe["sr"]
        self.n_fft = fe["n_fft"]
        self.hop = int(fe["hop_length"] * self.sr)
        win = int(fe["win_length"] * self.sr)
        w = torch.hann_window(win, periodic=True, dtype=torch.float64)
        left = (self.n_fft - win) // 2
        self.window = F.pad(w, (left, self.n_fft - win - left)).to(device)
        self.bank = torch.from_numpy(
            mel_bank(self.n_fft // 2 + 1, fe["n_mels"], self.sr)).double().to(device)
        self.n_stack, self.ds = fe["n_stack"], fe["downsample"]

    def __call__(self, pcm: torch.Tensor) -> torch.Tensor:
        """pcm [S] -> stacked frames [T', n_mels * n_stack] (float32;
        the spectrum is taken in float64)."""
        spec = torch.stft(pcm.double(), self.n_fft, self.hop,
                          window=self.window, center=True, pad_mode="reflect",
                          return_complex=True)                  # [bins, T]
        mel = torch.log(spec.abs().pow(2).T @ self.bank + 1e-6).float()
        t = (mel.shape[0] - self.n_stack) // self.ds + 1
        idx = (torch.arange(t, device=mel.device)[:, None] * self.ds
               + torch.arange(self.n_stack, device=mel.device)[None, :])
        win = mel[idx]                                          # [T', stack, M]
        return win.transpose(1, 2).reshape(t, -1)


# ---- the towers -------------------------------------------------------


def batch_norm(w: dict, p: str, x):
    return ((x - w[p + ".mean"]) * torch.rsqrt(w[p + ".var"] + 1e-5)
            * w[p + ".scale"] + w[p + ".bias"])


def lstm_cell(w: dict, p: str, wx_t, h, c, prec):
    """One LSTM step from the input product wx_t (bias included); gates
    i, g, f, o."""
    v = wx_t + mm(h, w[p + ".recurrent_kernel"], prec)
    i, g, f, o = v.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def gru_cell(w: dict, p: str, x, h, prec):
    """One NBRC (haste GRU) step, gates z, r, g, the reset applied after
    the recurrent product."""
    wz, wr, wg = (mm(x, w[p + ".kernel"], prec) + w[p + ".bias"]).chunk(3, -1)
    rz, rr, rg = (mm(h, w[p + ".recurrent_kernel"], prec)
                  + w[p + ".recurrent_bias"]).chunk(3, -1)
    z = torch.sigmoid(wz + rz)
    r = torch.sigmoid(wr + rr)
    g = torch.tanh(wg + r * rg)
    return z * h + (1.0 - z) * g


class Transducer:
    """The transducer's towers and joint over the benchmark's leaves."""

    def __init__(self, leaves: dict, conf: dict, prec=None):
        self.w = {k[len("model."):]: v for k, v in leaves.items()
                  if k.startswith("model.")}
        m = conf["model"]
        self.vocab_sz = m["vocab_sz"]
        self.enc_layers = m["encoder"]["num_layers"]
        self.pred_layers = m["predictor"]["num_layers"]
        self.prec = prec

    def encode(self, x):
        """x [B, T, F] stacked frames -> [B, T, H], every sequence from
        the learnt initial state."""
        w, prec = self.w, self.prec
        x = F.layer_norm(x, (x.shape[-1],), w["encoder.input_norm.scale"],
                         w["encoder.input_norm.bias"], 1e-6)
        for i in range(self.enc_layers):
            p = f"encoder.rnn_stack.layer{i}"
            wx = mm(x, w[p + ".cell.kernel"], prec) + w[p + ".cell.bias"]
            h0 = w[p + ".h0"]
            h = h0[0].expand(x.shape[0], -1)
            c = h0[1].expand(x.shape[0], -1)
            ys = []
            for t in range(x.shape[1]):
                h, c = lstm_cell(w, p + ".cell", wx[:, t], h, c, prec)
                ys.append(h)
            x = batch_norm(w, f"encoder.rnn_stack.norm{i}", torch.stack(ys, 1))
        return x

    def pred_init(self, b: int):
        return tuple(self.w[f"predictor.rnn_stack.layer{i}.h0"][0].expand(b, -1)
                     for i in range(self.pred_layers))

    def pred_step(self, y, state):
        """y [B] token ids -> (output [B, H], state); blank embeds as 0."""
        w, prec = self.w, self.prec
        x = w["predictor.embed.embedding"][y]
        x = torch.where((y == 0)[:, None], torch.zeros_like(x), x)
        if "predictor.ffn.kernel" in w:
            x = mm(x, w["predictor.ffn.kernel"], prec) + w["predictor.ffn.bias"]
        new = []
        for i, h in enumerate(state):
            h = gru_cell(w, f"predictor.rnn_stack.layer{i}.cell", x, h, prec)
            new.append(h)
            x = batch_norm(w, f"predictor.rnn_stack.norm{i}", h)
        return x, tuple(new)

    def predict(self, y):
        """Teacher forcing: y [B, U] -> outputs [B, U, H]."""
        state = self.pred_init(y.shape[0])
        outs = []
        for u in range(y.shape[1]):
            o, state = self.pred_step(y[:, u], state)
            outs.append(o)
        return torch.stack(outs, 1)

    def joint(self, h_pred, h_enc):
        """Log-probs over the vocabulary for matching rows of h_pred and
        h_enc (broadcasting)."""
        w, prec = self.w, self.prec
        x = torch.tanh(mm(h_pred, w["joint.pred_proj.kernel"], prec)
                       + w["joint.pred_proj.bias"]
                       + mm(h_enc, w["joint.enc_proj.kernel"], prec))
        logits = mm(x, w["joint.out.kernel"], prec) + w["joint.out.bias"]
        return torch.log_softmax(logits, dim=-1)


class LM:
    """The LSTM LM: embedding (id 0 embeds as 0), LSTM layers from zero
    state, a head tied to the embedding when the widths agree."""

    def __init__(self, leaves: dict, conf: dict, prec=None):
        self.w = {k[len("lm."):]: v for k, v in leaves.items()
                  if k.startswith("lm.")}
        self.layers = conf["lm"]["num_layers"]
        self.hidden = conf["lm"]["hidden_sz"]
        self.prec = prec

    def init(self, b: int, device):
        z = torch.zeros((b, self.hidden), device=device)
        return tuple((z, z) for _ in range(self.layers))

    def step(self, y, state):
        """y [B] -> (log-probs [B, V], state)."""
        w, prec = self.w, self.prec
        x = w["embed.embedding"][y]
        x = torch.where((y == 0)[:, None], torch.zeros_like(x), x)
        new = []
        for i, (h, c) in enumerate(state):
            p = f"lstm{i}"
            h, c = lstm_cell(w, p, mm(x, w[p + ".kernel"], prec) + w[p + ".bias"],
                             h, c, prec)
            new.append((h, c))
            x = h
        if "out.kernel" in w:
            logits = mm(x, w["out.kernel"], prec) + w["out.bias"]
        else:
            logits = mm(x, w["embed.embedding"].T, prec)
        return torch.log_softmax(logits, dim=-1), tuple(new)
