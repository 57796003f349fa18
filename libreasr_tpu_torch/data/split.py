"""Split asr-dataset.csv into test, valid and train parts (the JAX
package's data/split.py, with the stdlib `csv` module in place of
pandas): one permutation of the rows from numpy's
default_rng(seed), the first `test` share of it the test part, the next
`valid` share the valid part, the rest train. Each part is written as
asr-dataset-{test,valid,train}.csv beside the input, with the bytes
pandas writes (the cells as read, a missing one empty).

    python -m libreasr_tpu_torch.data.split <dataset-dir> [--valid 0.05] [--test 0.05]
"""

from __future__ import annotations

import argparse
import csv
import io
import os

import numpy as np

from .create_dataset import NA_VALUES


def split_dataset(path: str, valid: float = 0.05, test: float = 0.05,
                  seed: int = 42) -> dict[str, list[list[str]]]:
    """-> {"test": rows, "valid": rows, "train": rows}, each row the
    CSV's cells."""
    src = os.path.join(path, "asr-dataset.csv") if os.path.isdir(path) else path
    base = os.path.dirname(src)
    with open(src, newline="") as f:
        header, *rows = [r for r in csv.reader(f) if r]
    rows = [["" if c in NA_VALUES else c for c in r] for r in rows]
    idx = np.random.default_rng(seed).permutation(len(rows))
    n_test, n_valid = int(len(rows) * test), int(len(rows) * valid)
    parts = {
        "test": idx[:n_test],
        "valid": idx[n_test: n_test + n_valid],
        "train": idx[n_test + n_valid:],
    }
    out = {}
    for name, sel in parts.items():
        part = [rows[i] for i in sel]
        buf = io.StringIO()
        w = csv.writer(buf, lineterminator="\n")
        w.writerow(header)
        w.writerows(part)
        dst = os.path.join(base, f"asr-dataset-{name}.csv")
        with open(dst, "w", newline="") as f:
            f.write(buf.getvalue())
        print(f"{name}: {len(part)} rows -> {dst}")
        out[name] = part
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("path")
    p.add_argument("--valid", type=float, default=0.05)
    p.add_argument("--test", type=float, default=0.05)
    p.add_argument("--seed", type=int, default=42)
    a = p.parse_args(argv)
    split_dataset(a.path, a.valid, a.test, a.seed)


if __name__ == "__main__":
    main()
