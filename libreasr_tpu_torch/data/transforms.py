"""Host-side audio and label stages, resolved by name from the YAML
transform lists (the JAX package's data/transforms.py).

Each stage maps an item dict {file, xstart, xlen, label, ...} on to
{audio [S] float32, sr, label, ids, ylen, ...}. Stages marked random
(the waveform augmentations, or any stage with wrap: true) run only in
training. Their draws come from a numpy Generator handed to each call,
so a pipeline is reproducible from a seed whatever the order in which
items are processed; the JAX package draws from the global `random` and
numpy states instead, so the augmented audio of the two differs, the
rest is equal. Spectral stages (mel, SpecAugment, stacking) belong to
the device frontend (ops/frontend.py) and are skipped here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np

from . import audio as audio_io


@dataclass
class Stage:
    fn: Callable  # (item, rng) -> item
    name: str
    random: bool = False  # augmentation: skipped when not training

    def __call__(self, item, rng, *, training: bool = True):
        if self.random and not training:
            return item
        return self.fn(item, rng)


# ---- audio stages ----------------------------------------------------------


def OpenAudio(**kw):
    """Read (a span of) an audio file; a file that cannot be read gives
    1 s of silence and marks the item bad (the JAX package's rule)."""

    def fn(item, rng):
        try:
            pcm, sr = audio_io.read_audio(item["file"])
            xstart = float(item.get("xstart", 0) or 0)
            xlen = float(item.get("xlen", 0) or 0)
            if xlen > 0:
                a = int(xstart / 1000.0 * sr)
                pcm = pcm[:, a: a + int(xlen / 1000.0 * sr)]
            item["audio"], item["sr"] = pcm, sr
        except Exception:
            item["audio"] = np.zeros((1, 16000), np.float32)
            item["sr"] = 16000
            item["bad"] = True
        return item

    return Stage(fn, "OpenAudio")


def ChannelCut(**kw):
    """Keep channel 0."""

    def fn(item, rng):
        a = item["audio"]
        item["audio"] = a[0] if a.ndim == 2 else a
        return item

    return Stage(fn, "ChannelCut")


def Resample(sr: int = 16000, **kw):
    def fn(item, rng):
        if item["sr"] != sr:
            item["audio"] = audio_io.resample(item["audio"], item["sr"], sr)
            item["sr"] = sr
        return item

    return Stage(fn, "Resample")


def SpeedPerturb(delta: int = 10, sr: int = 16000, **kw):
    """Speed change of up to +-delta percent by resampling."""

    def fn(item, rng):
        pct = int(rng.integers(-delta, delta + 1))
        if pct:
            item["audio"] = audio_io.resample(item["audio"], sr,
                                              int(sr * (100 + pct) / 100))
        return item

    return Stage(fn, "SpeedPerturb", random=True)


def ChangeVolume(pcent: float = 0.03, **kw):
    def fn(item, rng):
        item["audio"] = item["audio"] * (1.0 + rng.uniform(-pcent, pcent))
        return item

    return Stage(fn, "ChangeVolume", random=True)


def AddNoise(noise_level: float = 0.05, color: int = 0, **kw):
    """White noise scaled by the signal's standard deviation."""

    def fn(item, rng):
        a = item["audio"]
        lvl = rng.uniform(0, noise_level) * (np.std(a) + 1e-6)
        item["audio"] = a + rng.standard_normal(a.shape).astype(np.float32) * lvl
        return item

    return Stage(fn, "AddNoise", random=True)


def SignalShifter(max_time: float = 0.1, direction: int = 1, sr: int = 16000,
                  **kw):
    """Roll the signal in time by up to max_time seconds."""

    def fn(item, rng):
        sign = direction if direction else int(rng.choice([-1, 1]))
        shift = int(rng.uniform(0, max_time) * sr) * sign
        item["audio"] = np.roll(item["audio"], shift)
        return item

    return Stage(fn, "SignalShifter", random=True)


def PadderCutter(almins: float = 0.5, almaxs: float = 6.0, sr: int = 16000,
                 **kw):
    """Pad to at least almins seconds, cut to at most almaxs."""

    def fn(item, rng):
        a = item["audio"]
        lo, hi = int(almins * sr), int(almaxs * sr)
        if len(a) < lo:
            a = np.pad(a, (0, lo - len(a)))
        item["audio"] = a[:hi]
        return item

    return Stage(fn, "PadderCutter")


# ---- label stages ----------------------------------------------------------


def OpenLabel(**kw):
    def fn(item, rng):
        item["label"] = str(item.get("label", ""))
        return item

    return Stage(fn, "OpenLabel")


def PadCutLabel(y_max: int = 60, **kw):
    def fn(item, rng):
        item["label"] = item["label"][:y_max]
        return item

    return Stage(fn, "PadCutLabel")


def Numericalize(lang=None, **kw):
    def fn(item, rng):
        item["ids"] = lang.numericalize(item["label"])
        return item

    return Stage(fn, "Numericalize")


def AddLen(**kw):
    def fn(item, rng):
        item["ylen"] = len(item["ids"])
        return item

    return Stage(fn, "AddLen")


_REGISTRY = {
    "OpenAudio": OpenAudio, "MyOpenAudio": OpenAudio,
    "ChannelCut": ChannelCut,
    "Resample": Resample,
    "SpeedPerturb": SpeedPerturb, "ResamplePoly": SpeedPerturb,
    "ChangeVolume": ChangeVolume,
    "AddNoise": AddNoise, "MyAddNoise": AddNoise,
    "SignalShifter": SignalShifter, "MySignalShifter": SignalShifter,
    "PadderCutter": PadderCutter,
    "OpenLabel": OpenLabel, "MyOpenLabel": OpenLabel,
    "PadCutLabel": PadCutLabel,
    "Numericalize": Numericalize, "MyNumericalize": Numericalize,
    "AddLen": AddLen,
}


def parse_stages(specs: list[dict], conf: dict, lang=None) -> list[Stage]:
    """Resolve YAML stage specs by name with the config's shared kwargs;
    names that are not host stages (the device frontend's) are skipped."""
    shared = dict(sr=conf.get("sr", 16000), almins=conf.get("almins", 0.5),
                  almaxs=conf.get("almaxs", 6.0), y_max=conf.get("y_max", 60),
                  lang=lang)
    stages = []
    for spec in specs or []:
        make = _REGISTRY.get(spec["name"])
        if make is None:
            continue
        stage = make(**{**shared, **(spec.get("args") or {})})
        if spec.get("wrap"):
            stage.random = True
        stages.append(stage)
    return stages


class Pipeline:
    """The stages in order. Item i of epoch e draws from
    numpy.random.default_rng((seed, e, i)) when the caller passes
    (e, i), else from the pipeline's own generator."""

    def __init__(self, stages: list[Stage], training: bool = True,
                 seed: int = 0):
        self.stages = stages
        self.training = training
        self.seed = seed
        self.rng = np.random.default_rng(seed)

    def __call__(self, item: dict, key: tuple | None = None) -> dict:
        rng = self.rng if key is None else np.random.default_rng(
            (self.seed, *key))
        for s in self.stages:
            item = s(item, rng, training=self.training)
        return item
