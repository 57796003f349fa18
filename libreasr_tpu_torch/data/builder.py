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
import re
from dataclasses import dataclass, field

import numpy as np

CSV_COLUMNS = ["file", "xstart", "xlen", "label", "ylen", "sr", "bad"]


_POW10 = [float(f"1e{k}") for k in range(309)]
_DECIMAL = re.compile(r"([+-]?)(\d*)(?:\.(\d*))?(?:[eE]([+-]?\d+))?")


def pandas_float(s: str) -> float:
    """A float cell as pandas' C parser reads it by default (its
    precise_xstrtod): at most 17 significant digits accumulated in a
    double, then one multiplication or division by a power of ten. That
    is not always the nearest double, which float() gives: pandas reads
    "1015.9374999999999" as 1015.9375, and writes it back so."""
    v = float(s)  # raises on what is no number
    m = _DECIMAL.fullmatch(s.strip())
    if m is None or not (m.group(2) or m.group(3)):
        return v  # nan, inf
    number, digits, exponent = 0.0, 0, 0
    for ch in m.group(2):
        if digits < 17:
            number, digits = number * 10.0 + int(ch), digits + 1
        else:
            exponent += 1
    for ch in (m.group(3) or "")[: max(17 - digits, 0)]:
        number, exponent = number * 10.0 + int(ch), exponent - 1
    if m.group(1) == "-":
        number = -number
    exponent += int(m.group(4) or 0)
    if exponent > 308:
        return v  # beyond a double's range: float()'s inf
    if exponent > 0:
        return number * _POW10[exponent]
    if exponent < -308:
        return 0.0 if exponent < -616 else number / _POW10[-308 - exponent] / _POW10[308]
    return number / _POW10[-exponent]


def _number(s: str):
    v = pandas_float(s)
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


def resolve_audio_paths(rows: list[dict], root: str, absolute: bool = False):
    """Resolve each row's `file` against the dataset directory `root`
    (the JAX package's rule, on row dicts in place of a DataFrame).

    A relative path is joined unless it already resolves: create_dataset
    writes root-prefixed relative paths when given a relative root, and
    joining those again would double the prefix. `absolute=True` also
    pins every path with abspath (the 960 recipe merges per-split CSVs
    into one directory, where relative paths must not survive). Returns
    `rows`, changed in place."""
    for r in rows:
        p = str(r["file"])
        if not (os.path.isabs(p) or os.path.exists(p)):
            p = os.path.join(root, p)
        r["file"] = os.path.abspath(p) if absolute else p
    return rows


def read_dataset_csv(path: str, root: str) -> list[dict]:
    with open(path, newline="") as f:
        rows = [_parse_row(r) for r in csv.DictReader(f)]
    return resolve_audio_paths(rows, root)


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
