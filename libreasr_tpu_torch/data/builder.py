"""Dataset builder: per-corpus CSVs -> one filtered, shuffled table.

The JAX package's data/builder.py with the stdlib `csv` module and
numpy in place of pandas. Each dataset directory holds
`asr-dataset-{train,valid,test}.csv` (or one `asr-dataset.csv`) with
columns file,xstart,xlen,label,ylen,sr,bad (xstart and xlen in ms).
Rows pass the limits (not bad, audio length in [almins, almaxs] s,
label length in [y_min, y_max], at most y_max_words words), are cut to
the first pcent of them, and are shuffled with the permutation pandas'
`sample(frac=1, random_state=seed)` takes: numpy's
RandomState(seed).permutation.
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass, field

import numpy as np

CSV_COLUMNS = ["file", "xstart", "xlen", "label", "ylen", "sr", "bad"]


def _number(s: str):
    v = float(s)
    return int(v) if v.is_integer() and "." not in s else v


def _parse_row(row: dict) -> dict:
    """Types as pandas reads them: numbers, the label as text, bad as a
    boolean."""
    out = dict(row)
    for k in ("xstart", "xlen", "ylen", "sr"):
        if out.get(k) not in (None, ""):
            out[k] = _number(out[k])
    out["label"] = str(out.get("label") or "")
    out["bad"] = str(out.get("bad", "")).strip().lower() in ("true", "1")
    return out


def resolve_audio_path(p: str, root: str) -> str:
    """A CSV `file` entry against its dataset directory: joined unless it
    is absolute or already resolves (the JAX package's rule)."""
    if not (os.path.isabs(p) or os.path.exists(p)):
        p = os.path.join(root, p)
    return p


def read_dataset_csv(path: str, root: str) -> list[dict]:
    with open(path, newline="") as f:
        rows = [_parse_row(r) for r in csv.DictReader(f)]
    for r in rows:
        r["file"] = resolve_audio_path(str(r["file"]), root)
    return rows


@dataclass
class ASRDatasetBuilder:
    rows: list = field(default_factory=list)
    mode: str = "train"
    config: dict = field(default_factory=dict)

    @classmethod
    def from_config(cls, conf: dict, mode: str = "train") -> "ASRDatasetBuilder":
        rows = []
        for name in conf.get("datasets", []) or []:
            path = conf["dataset_paths"][name]
            csv_path = os.path.join(path, f"asr-dataset-{mode}.csv")
            if not os.path.exists(csv_path):
                csv_path = os.path.join(path, "asr-dataset.csv")
            rows += read_dataset_csv(csv_path, path)
        b = cls(rows=rows, mode=mode, config=conf)
        if conf.get("apply_limits", True):
            b.apply_limits()
        b.subsample((conf.get("pcent", {}) or {}).get(mode, 1.0))
        if (conf.get("shuffle_builder", {}) or {}).get(mode, True):
            b.shuffle(conf.get("seed", 42))
        return b

    def apply_limits(self):
        c = self.config
        lo, hi = c.get("almins", 0.5) * 1000.0, c.get("almaxs", 6.0) * 1000.0
        y_min, y_max = c.get("y_min", 1), c.get("y_max", 60)
        max_words = c.get("y_max_words", 100)
        self.rows = [
            r for r in self.rows
            if not r["bad"] and lo <= r["xlen"] <= hi
            and y_min <= r["ylen"] <= y_max
            and len(r["label"].split()) <= max_words
        ]
        return self

    def subsample(self, pcent: float):
        if pcent < 1.0:
            self.rows = self.rows[: max(int(len(self.rows) * pcent), 1)]
        return self

    def shuffle(self, seed: int = 42):
        perm = np.random.RandomState(seed).permutation(len(self.rows))
        self.rows = [self.rows[i] for i in perm]
        return self

    def __len__(self) -> int:
        return len(self.rows)

    def get(self, idx: int) -> dict:
        return dict(self.rows[idx])

    def dump_labels(self, path: str) -> str:
        """Every label, lower-cased and stripped, one a line (the
        tokenizer's training corpus)."""
        with open(path, "w") as f:
            for r in self.rows:
                f.write(str(r["label"]).lower().strip() + "\n")
        return path

    def train_tokenizer(self, model_file: str, vocab_sz: int = 2048) -> str:
        """Dump the labels and train a BPE model on them."""
        from .bpe import train_bpe

        os.makedirs(os.path.dirname(model_file) or ".", exist_ok=True)
        tmp = model_file + ".labels.txt"
        self.dump_labels(tmp)
        train_bpe(tmp, model_file, vocab_sz)
        os.remove(tmp)
        return model_file

    def stats(self) -> dict:
        if not self.rows:
            return {"utts": 0}
        xlen = np.array([r["xlen"] for r in self.rows], np.float64)
        ylen = np.array([r["ylen"] for r in self.rows], np.float64)
        return {"utts": len(self.rows), "hours": float(xlen.sum()) / 3.6e6,
                "xlen_ms_mean": float(xlen.mean()),
                "ylen_mean": float(ylen.mean())}
