"""Write a "tone speech" corpus in LibriSpeech layout, with the dataset
CSV of each split (the JAX package's scripts/make_tone_corpus.py, whose
CSVs come from its create_dataset tool).

Each character is a frequency-coded harmonic tone and a space is
silence (data/synth.py: render); train speakers differ from the held-out
dev/test speakers, sentences are disjoint across splits, and each
utterance gets its own tempo jitter and a 12-30 dB SNR. A split
`<out>/<split>/` holds `{spk}/1/{utt}.wav`, `{spk}/1/{spk}-1.trans.txt`
and `asr-dataset.csv` (file,xstart,xlen,label,ylen,sr,bad; xlen in ms,
files relative to the split), which the port's dataset builder reads.

    python -m libreasr_tpu_torch.scripts.make_tone_corpus --out tmp/tone_corpus \\
        [--train 400] [--valid 40] [--test 40] [--speakers 8] \\
        [--heldout-speakers 2] [--seed 0] [--clean]
"""

from __future__ import annotations

import argparse
import csv
import os
import wave

import numpy as np

from ..data.builder import CSV_COLUMNS
from ..data.synth import SR, render, sentences, speaker_params

SPLITS = ("train-clean-100", "dev-clean", "test-clean")


def write_split(root: str, split: str, texts, rng, speakers, clean=False):
    """Utterances round-robin over `speakers`; returns the CSV rows."""
    handles, rows = {}, []
    try:
        for i, text in enumerate(texts):
            spk_id = speakers[i % len(speakers)]
            spk_dir = os.path.join(root, split, str(spk_id), "1")
            os.makedirs(spk_dir, exist_ok=True)
            if spk_id not in handles:
                handles[spk_id] = open(
                    os.path.join(spk_dir, f"{spk_id}-1.trans.txt"), "w")
            utt = f"{spk_id}-1-{split}-{i:05d}"
            pcm = render(
                text, rng,
                spk=None if clean else speaker_params(spk_id),
                snr_db=None if clean else float(rng.uniform(12.0, 30.0)),
            )
            with wave.open(os.path.join(spk_dir, f"{utt}.wav"), "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(SR)
                w.writeframes((pcm * 32767).astype(np.int16).tobytes())
            handles[spk_id].write(f"{utt} {text.upper()}\n")
            rows.append({"file": os.path.join(str(spk_id), "1", f"{utt}.wav"),
                         "xstart": 0, "xlen": len(pcm) / SR * 1000.0,
                         "label": text, "ylen": len(text), "sr": SR,
                         "bad": False})
    finally:
        for f in handles.values():
            f.close()
    os.makedirs(os.path.join(root, split), exist_ok=True)
    with open(os.path.join(root, split, "asr-dataset.csv"), "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=CSV_COLUMNS)
        w.writeheader()
        w.writerows(rows)
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="tmp/tone_corpus")
    p.add_argument("--train", type=int, default=400)
    p.add_argument("--valid", type=int, default=40)
    p.add_argument("--test", type=int, default=40)
    p.add_argument("--speakers", type=int, default=8, help="training-set speakers")
    p.add_argument("--heldout-speakers", type=int, default=2,
                   help="dev/test-only speakers (voice generalization)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--clean", action="store_true",
                   help="single-voice noiseless synthesis")
    a = p.parse_args(argv)
    rng = np.random.default_rng(a.seed)
    all_sents = sentences(rng, a.train + a.valid + a.test)
    train_spk = list(range(1, a.speakers + 1))
    held_spk = list(range(a.speakers + 1, a.speakers + 1 + a.heldout_speakers))
    if a.clean or not held_spk:
        held_spk = train_spk
    cuts = (0, a.train, a.train + a.valid, len(all_sents))
    for k, split in enumerate(SPLITS):
        write_split(a.out, split, all_sents[cuts[k]: cuts[k + 1]], rng,
                    train_spk if k == 0 else held_spk, clean=a.clean)
    print(
        f"tone corpus -> {a.out}: {a.train} train / {a.valid} valid / "
        f"{a.test} test (disjoint sentences; "
        + ("single clean voice)" if a.clean else
           f"{len(train_spk)} train speakers, dev/test on "
           f"{len(held_spk)} held-out speakers, 12-30 dB SNR)")
    )


if __name__ == "__main__":
    main()
