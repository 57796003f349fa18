"""Dataset and pipeline inspection (the JAX package's data/inspect.py):
functions that return dicts, for scripts, notebooks and tests."""

from __future__ import annotations

import numpy as np


def pipeline_statistics(dataset, n_items: int = 32) -> dict:
    """Run up to `n_items` good items through the host pipeline and sum
    up their audio lengths, token counts and loudness."""
    lens, ylens, rms = [], [], []
    bad = 0
    for i, item in enumerate(dataset._items(dataset.epoch)):
        if i >= n_items:
            break
        a = np.asarray(item["audio"])
        lens.append(len(a))
        ylens.append(len(item.get("ids", [])))
        rms.append(float(np.sqrt((a**2).mean() + 1e-12)))
        if item.get("bad"):
            bad += 1
    if not lens:
        return {"items": 0}
    return {
        "items": len(lens),
        "bad": bad,
        "audio_samples": {"min": int(np.min(lens)), "max": int(np.max(lens)),
                          "mean": float(np.mean(lens))},
        "label_tokens": {"min": int(np.min(ylens)), "max": int(np.max(ylens)),
                         "mean": float(np.mean(ylens))},
        "rms": {"mean": float(np.mean(rms)), "max": float(np.max(rms))},
    }


def batch_statistics(dataset, n_batches: int = 8) -> dict:
    """The padding each bucket shape wastes: per shape, its batches and
    the mean share of audio and label padding that holds data."""
    out: dict = {}
    for i, b in enumerate(dataset):
        if i >= n_batches:
            break
        key = tuple(b.audio.shape[1:2]) + tuple(b.labels.shape[1:2])
        audio_len = b.audio_len.double().numpy()
        label_len = b.label_len.double().numpy()
        rec = out.setdefault(str(key), {"batches": 0, "audio_fill": 0.0,
                                        "label_fill": 0.0})
        rec["batches"] += 1
        rec["audio_fill"] += float(np.mean(audio_len / b.audio.shape[1]))
        rec["label_fill"] += float(np.mean(label_len / b.labels.shape[1]))
    for rec in out.values():
        rec["audio_fill"] /= rec["batches"]
        rec["label_fill"] /= rec["batches"]
    return out


def augmentation_preview(dataset, item_idx: int = 0) -> dict:
    """One item through the pipeline with and without its random
    stages, and how far the two differ."""
    raw = dataset.builder.get(item_idx)
    aug_item = dataset.pipeline(dict(raw))
    training = dataset.pipeline.training
    dataset.pipeline.training = False
    try:
        clean_item = dataset.pipeline(dict(raw))
    finally:
        dataset.pipeline.training = training
    a, c = np.asarray(aug_item["audio"]), np.asarray(clean_item["audio"])
    m = min(len(a), len(c))
    return {
        "clean_samples": len(c),
        "aug_samples": len(a),
        "l2_delta": float(np.linalg.norm(a[:m] - c[:m])),
        "changed": bool(len(a) != len(c) or np.abs(a[:m] - c[:m]).max() > 0),
    }
