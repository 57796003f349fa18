"""Log-mel frontend on a padded batch, with SpecAugment for training.

Same numerics as the JAX package's ops/frontend.py: n_fft 1024, 25 ms
Hann window, 10 ms hop, center reflect padding, power spectrogram as
two DFT matmuls, 128 HTK mels, log(mel + 1e-6), then stack 10 frames
with stride 8 (feature-major, stack-minor) into 1280-dim frames.

The DFT matmuls run in full float32: the package turns TF32 off on
import, and the JAX package pins the same products to
Precision.HIGHEST.

SpecAugment (the JAX package's cut_frames, mask_time, mask_freq) is
split into a draw, from an explicit torch.Generator, and an apply that
takes the drawn integers: a torch generator cannot give jax.random's
bits, so tests hand the JAX package's draws to the apply functions.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple

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


# ---------------------------------------------------------------------------
# SpecAugment: draws and their application (batched, mask-based)
# ---------------------------------------------------------------------------


class AugmentDraws(NamedTuple):
    """The random integers of one SpecAugment pass over a batch."""

    front: torch.Tensor | None   # [N] frames cut at the front
    back: torch.Tensor | None    # [N] frames cut at the back
    time: torch.Tensor | None    # [N, time_masks] time mask starts
    freq: torch.Tensor | None    # [N, freq_masks] frequency mask starts


def cut_frames(x, lengths, front, back):
    """Roll each row left by `front` frames and shorten it by front +
    back (at least 1 frame stays). x: [N, T, F]. Returns (x, lengths)."""
    t = x.shape[1]
    idx = (torch.arange(t, device=x.device)[None, :] + front[:, None]) % t
    x = torch.gather(x, 1, idx[:, :, None].expand(-1, -1, x.shape[2]))
    return x, torch.clamp(lengths - front - back, min=1)


def _mask_axis(x, starts, size: int, axis: int):
    """Fill [start, start + size) of `axis` with each row's mean over
    time and frequency; starts: [N, num_masks]."""
    fill = x.mean(dim=(1, 2), keepdim=True)
    pos = torch.arange(x.shape[axis], device=x.device)
    hit = ((pos[None, None, :] >= starts[:, :, None])
           & (pos[None, None, :] < starts[:, :, None] + size)).any(dim=1)
    shape = [x.shape[0], 1, 1]
    shape[axis] = x.shape[axis]
    return torch.where(hit.reshape(shape), fill, x)


def mask_time(x, starts, size: int):
    return _mask_axis(x, starts, size, 1)


def mask_freq(x, starts, size: int):
    return _mask_axis(x, starts, size, 2)


@dataclass(frozen=True)
class FrontendConfig:
    sr: int = 16000
    n_fft: int = 1024
    win_length: float = 0.025
    hop_length: float = 0.01
    n_mels: int = 128
    n_stack: int = 10
    downsample: int = 8
    # SpecAugment
    cut_max_front: int = 1
    cut_max_back: int = 1
    time_masks: int = 4
    time_mask_size: int = 2
    freq_masks: int = 4
    freq_mask_size: int = 4

    @property
    def hop(self) -> int:
        return int(self.hop_length * self.sr)

    @property
    def feature_sz(self) -> int:
        return self.n_mels * self.n_stack

    @classmethod
    def from_config(cls, conf: dict) -> "FrontendConfig":
        """SpecAugment follows the config's feature stages, as in the JAX
        package: a stage present turns its augmentation on with its
        args, a stage absent turns it off; without a feature list the
        defaults stand."""
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
        feats = (conf.get("transforms") or {}).get("features")
        if feats:
            def stage(name):
                for st in feats:
                    if (st or {}).get("name") == name:
                        return st.get("args") or {}
                return None

            cut, mt, mf = stage("CutFrames"), stage("MaskTime"), stage("MaskFreq")
            kw.update(
                cut_max_front=cut.get("max_front", 1) if cut is not None else 0,
                cut_max_back=cut.get("max_back", 1) if cut is not None else 0,
                time_masks=mt.get("num_masks", 4) if mt is not None else 0,
                time_mask_size=mt.get("size", 2) if mt is not None else 0,
                freq_masks=mf.get("num_masks", 4) if mf is not None else 0,
                freq_mask_size=mf.get("size", 4) if mf is not None else 0,
            )
            sd = stage("StackDownsample")
            if sd is not None:
                kw.update(n_stack=sd.get("n_stack", 10),
                          downsample=sd.get("downsample", 8))
        return cls(**kw)

    def out_length(self, n_samples):
        return stacked_length(num_frames(n_samples, self.hop),
                              n_stack=self.n_stack, downsample=self.downsample)

    def draw_augment(self, n: int, t: int, generator) -> AugmentDraws:
        """SpecAugment's integers for a batch of n rows of t mel frames,
        from `generator` on its device, with jax.random.randint's ranges."""
        dev = generator.device

        def randint(high, shape):
            return torch.randint(0, high, shape, generator=generator, device=dev)

        cut = self.cut_max_front or self.cut_max_back
        return AugmentDraws(
            front=randint(self.cut_max_front + 1, (n,)) if cut else None,
            back=randint(self.cut_max_back + 1, (n,)) if cut else None,
            time=(randint(max(t - self.time_mask_size, 1), (n, self.time_masks))
                  if self.time_masks and self.time_mask_size else None),
            freq=(randint(max(self.n_mels - self.freq_mask_size, 1),
                          (n, self.freq_masks))
                  if self.freq_masks and self.freq_mask_size else None),
        )


def spec_augment(mel, frame_len, cfg: FrontendConfig, draws: AugmentDraws):
    """Cut frames, then mask time, then frequency, as the JAX package's
    features_batch(augment=True) does. mel: [N, T, n_mels]."""
    if draws.front is not None:
        mel, frame_len = cut_frames(mel, frame_len, draws.front, draws.back)
    if draws.time is not None:
        mel = mask_time(mel, draws.time, cfg.time_mask_size)
    if draws.freq is not None:
        mel = mask_freq(mel, draws.freq, cfg.freq_mask_size)
    return mel, frame_len


def features_batch(audio: torch.Tensor, sample_lengths: torch.Tensor,
                   cfg: FrontendConfig, *, augment: bool = False,
                   generator=None, draws: AugmentDraws | None = None):
    """audio: [N, S] float pcm, or int16 pcm (scaled by 1/32768 here);
    sample_lengths: [N] integer. With `augment`, SpecAugment runs on the
    log-mel frames with `draws`, or with integers drawn from `generator`.
    Returns (features [N, T', feature_sz], frame_lengths [N] int64,
    clipped to [1, T'])."""
    if not audio.is_floating_point():
        audio = audio.float() * (1.0 / 32768.0)
    mel = log_mel_spectrogram(
        audio, sr=cfg.sr, n_fft=cfg.n_fft, win_length=cfg.win_length,
        hop_length=cfg.hop_length, n_mels=cfg.n_mels,
    )
    frame_len = num_frames(sample_lengths.long(), cfg.hop)
    if augment:
        if draws is None:
            if generator is None:
                raise ValueError("features_batch: augment needs a generator "
                                 "or draws")
            draws = cfg.draw_augment(mel.shape[0], mel.shape[1], generator)
        mel, frame_len = spec_augment(mel, frame_len, cfg, draws)
    feats = stack_downsample(mel, n_stack=cfg.n_stack, downsample=cfg.downsample)
    out_len = stacked_length(frame_len, n_stack=cfg.n_stack,
                             downsample=cfg.downsample)
    return feats, torch.clamp(out_len, 1, feats.shape[1])
