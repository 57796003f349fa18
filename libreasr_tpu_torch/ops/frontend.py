"""Log-mel frontend on a padded batch (eval path).

Same numerics as the JAX package's ops/frontend.py: n_fft 1024, 25 ms
Hann window, 10 ms hop, center reflect padding, power spectrogram as
two DFT matmuls, 128 HTK mels, log(mel + 1e-6), then stack 10 frames
with stride 8 (feature-major, stack-minor) into 1280-dim frames.

The DFT matmuls run in full float32: the package turns TF32 off on
import, and the JAX package pins the same products to
Precision.HIGHEST.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F


def hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


def mel_filterbank(n_freqs: int, n_mels: int, sr: int) -> np.ndarray:
    """[n_freqs, n_mels] triangular filterbank from 0 Hz to sr/2, HTK
    mel scale, no norm."""
    all_freqs = np.linspace(0, sr // 2, n_freqs)
    m_pts = np.linspace(hz_to_mel(0.0), hz_to_mel(sr / 2.0), n_mels + 2)
    f_pts = mel_to_hz(m_pts)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


def hann_window_padded(win_length: int, n_fft: int) -> np.ndarray:
    """Periodic Hann of win_length, zero-padded centered to n_fft."""
    w = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(win_length) / win_length))
    left = (n_fft - win_length) // 2
    out = np.zeros(n_fft, dtype=np.float32)
    out[left : left + win_length] = w
    return out


def dft_mel_matrices(n_fft: int, n_mels: int, sr: int, win_length: int):
    """Windowed real DFT as two matrices C, S [n_fft, n_freqs] with the
    Hann window folded in, plus the mel bank [n_freqs, n_mels]."""
    k = np.arange(n_fft)[:, None]
    f = np.arange(n_fft // 2 + 1)[None, :]
    ang = 2.0 * np.pi * k * f / n_fft
    w = hann_window_padded(win_length, n_fft)[:, None]
    c = (np.cos(ang) * w).astype(np.float32)
    s = (-np.sin(ang) * w).astype(np.float32)
    return c, s, mel_filterbank(n_fft // 2 + 1, n_mels, sr)


@functools.lru_cache(maxsize=8)
def _dft_mel_tensors(n_fft: int, n_mels: int, sr: int, win_length: int,
                     device: torch.device):
    return tuple(
        torch.from_numpy(m).to(device)
        for m in dft_mel_matrices(n_fft, n_mels, sr, win_length)
    )


def frame_signal(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """[N, S] -> [N, T, n_fft] with center reflect padding,
    T = S // hop + 1."""
    pad = n_fft // 2
    x = F.pad(x, (pad, pad), mode="reflect")
    return x.unfold(-1, n_fft, hop)


def log_mel_spectrogram(audio: torch.Tensor, *, sr: int = 16000,
                        n_fft: int = 1024, win_length: float = 0.025,
                        hop_length: float = 0.01,
                        n_mels: int = 128) -> torch.Tensor:
    """[N, S] float pcm -> [N, T, n_mels] log(mel + 1e-6) features."""
    wl = int(win_length * sr)
    hl = int(hop_length * sr)
    frames = frame_signal(audio.float(), n_fft, hl)
    c, s, fb = _dft_mel_tensors(n_fft, n_mels, sr, wl, audio.device)
    re = frames @ c
    im = frames @ s
    mel = (re * re + im * im) @ fb
    return torch.log(mel + 1e-6)


def num_frames(n_samples, hop: int):
    return n_samples // hop + 1


def stack_downsample(x: torch.Tensor, *, n_stack: int = 10,
                     downsample: int = 8) -> torch.Tensor:
    """[N, T, F] -> [N, T', F * n_stack], T' = (T - n_stack)//ds + 1,
    out[n, t, f * n_stack + s] = x[n, t * ds + s, f]."""
    win = x.unfold(1, n_stack, downsample)  # [N, T', F, n_stack]
    return win.reshape(*win.shape[:2], -1)


def stacked_length(t_frames, *, n_stack: int = 10, downsample: int = 8):
    return torch.clamp((t_frames - n_stack) // downsample + 1, min=0)


@dataclass(frozen=True)
class FrontendConfig:
    sr: int = 16000
    n_fft: int = 1024
    win_length: float = 0.025
    hop_length: float = 0.01
    n_mels: int = 128
    n_stack: int = 10
    downsample: int = 8

    @property
    def hop(self) -> int:
        return int(self.hop_length * self.sr)

    @property
    def feature_sz(self) -> int:
        return self.n_mels * self.n_stack

    @classmethod
    def from_config(cls, conf: dict) -> "FrontendConfig":
        if conf.get("deltas", 0):
            raise NotImplementedError(
                "libreasr_tpu_torch: delta features are not ported yet"
            )
        mk = conf.get("melkwargs", {})
        kw = dict(
            sr=conf.get("sr", 16000),
            n_fft=mk.get("n_fft", 1024),
            n_mels=mk.get("n_mels", 128),
            win_length=conf.get("win_length", 0.025),
            hop_length=conf.get("hop_length", 0.01),
        )
        for stage in (conf.get("transforms") or {}).get("features") or ():
            if (stage or {}).get("name") == "StackDownsample":
                args = stage.get("args") or {}
                kw.update(n_stack=args.get("n_stack", 10),
                          downsample=args.get("downsample", 8))
        return cls(**kw)

    def out_length(self, n_samples):
        return stacked_length(num_frames(n_samples, self.hop),
                              n_stack=self.n_stack, downsample=self.downsample)


def features_batch(audio: torch.Tensor, sample_lengths: torch.Tensor,
                   cfg: FrontendConfig):
    """audio: [N, S] float pcm, or int16 pcm (scaled by 1/32768 here);
    sample_lengths: [N] integer. Returns (features [N, T', feature_sz],
    frame_lengths [N] int64, clipped to [1, T'])."""
    if not audio.is_floating_point():
        audio = audio.float() * (1.0 / 32768.0)
    mel = log_mel_spectrogram(
        audio, sr=cfg.sr, n_fft=cfg.n_fft, win_length=cfg.win_length,
        hop_length=cfg.hop_length, n_mels=cfg.n_mels,
    )
    feats = stack_downsample(mel, n_stack=cfg.n_stack, downsample=cfg.downsample)
    out_len = cfg.out_length(sample_lengths.long())
    return feats, torch.clamp(out_len, 1, feats.shape[1])
