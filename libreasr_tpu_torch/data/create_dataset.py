"""Dataset creation CLI: corpus directory -> asr-dataset.csv (the JAX
package's data/create_dataset.py, with the stdlib `csv` module in place
of pandas).

Walks a corpus, probes every audio file and writes one row (file, xstart,
xlen, label, ylen, sr, bad) per utterance, with labels from one of five
corpus layouts:
- librispeech: `<id>.trans.txt` files next to the audio;
- common-voice: `validated.tsv` (and train/dev/test.tsv), columns path
  and sentence;
- tatoeba: `<name>.csv` sentence lists (tab-separated, the first column
  the file's name, the last the sentence);
- tf-speech: the label is the parent directory's name;
- yt: a `.vtt` subtitle file beside each audio file, one row a cue.

The CSV bytes are those pandas writes (`\\n` line ends, minimal quoting,
bools as True/False, a column with any float written as floats), so
either package reads the other's files and both write the same bytes on
the same corpus. Probing runs in a process pool (spawn) by default, and
an interrupted run resumes from its partial CSV.

    python -m libreasr_tpu_torch.data.create_dataset <path> --format librispeech
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import csv
import io
import os
import re
import sys

from ..utils import sanitize_str
from . import audio as audio_io
from .builder import pandas_float

AUDIO_EXTS = (".flac", ".wav", ".mp3", ".ogg", ".oga")
COLUMNS = ["file", "xstart", "xlen", "label", "ylen", "sr", "bad"]
# the strings pandas' read_csv reads as missing by default
NA_VALUES = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"})


def audio_files(path: str):
    for root, _, files in os.walk(path):
        for f in sorted(files):
            if f.lower().endswith(AUDIO_EXTS):
                yield os.path.join(root, f)


def probe(path: str):
    """-> (duration_ms, sr), or None when the file does not decode."""
    try:
        pcm, sr = audio_io.read_audio(path)
        return pcm.shape[-1] / sr * 1000.0, sr
    except Exception:
        return None


# ---- reading tables as pandas does ------------------------------------------


def _read_table(path: str, sep: str) -> list[list[str]]:
    """Rows of a delimited text file; blank lines skipped."""
    with open(path, newline="") as f:
        return [r for r in csv.reader(f, delimiter=sep) if r]


def _number(s: str):
    try:
        return int(s)
    except ValueError:
        return pandas_float(s)


def _column_values(cells: list) -> list:
    """The values pandas gives a column of text cells: all integers ->
    int, all numbers (or missing among numbers) -> float, else strings
    with missing cells as NaN."""
    present = [c for c in cells if c is not None and c not in NA_VALUES]
    try:
        nums = [_number(c) for c in present]
    except ValueError:
        return [float("nan") if c is None or c in NA_VALUES else c for c in cells]
    floats = len(present) < len(cells) or any(isinstance(v, float) for v in nums)
    out, it = [], iter(nums)
    for c in cells:
        if c is None or c in NA_VALUES:
            out.append(float("nan"))
        else:
            v = next(it)
            out.append(float(v) if floats else v)
    return out


# ---- label extractors ------------------------------------------------------


def labels_librispeech(path: str) -> dict[str, str]:
    """Every `<utt-id> <TRANSCRIPT>` line of the *.trans.txt files."""
    out = {}
    for root, _, files in os.walk(path):
        for f in files:
            if f.endswith(".trans.txt"):
                with open(os.path.join(root, f)) as fh:
                    for line in fh:
                        utt, _, text = line.strip().partition(" ")
                        out[utt] = sanitize_str(text)
    return out


def labels_common_voice(path: str) -> dict[str, str]:
    out = {}
    for tsv in ("validated.tsv", "train.tsv", "dev.tsv", "test.tsv"):
        p = os.path.join(path, tsv)
        if not os.path.exists(p):
            continue
        header, *rows = _read_table(p, "\t")
        if "path" not in header or "sentence" not in header:
            raise ValueError(f"{p}: no path and sentence columns")
        ip, isent = header.index("path"), header.index("sentence")
        for r in rows:
            cells = [r[i] if i < len(r) else None for i in (ip, isent)]
            key, sentence = (str(v) for v in (
                float("nan") if c is None or c in NA_VALUES else c for c in cells))
            out[os.path.splitext(os.path.basename(key))[0]] = sanitize_str(sentence)
    return out


def labels_tatoeba(path: str) -> dict[str, str]:
    out = {}
    for f in os.listdir(path):
        if not f.endswith(".csv"):
            continue
        try:
            rows = _read_table(os.path.join(path, f), "\t")
        except Exception:
            continue
        if not rows or any(len(r) > len(rows[0]) for r in rows):
            continue  # pandas refuses a row longer than the first
        width = len(rows[0])
        first = _column_values([r[0] for r in rows])
        last = _column_values([r[width - 1] if width - 1 < len(r) else None
                               for r in rows])
        for k, v in zip(first, last):
            out[str(k)] = sanitize_str(str(v))
    return out


_VTT_TS = re.compile(
    r"(?:(\d+):)?(\d{2}):(\d{2})[.,](\d{3})\s*-->\s*(?:(\d+):)?(\d{2}):(\d{2})[.,](\d{3})"
)


def parse_vtt(path: str):
    """WebVTT cues -> [(start_ms, end_ms, text)], the text sanitized and
    its tags removed."""
    cues = []
    with open(path, errors="replace") as f:
        block: list[str] = []
        for raw in list(f) + ["\n"]:
            line = raw.strip()
            if line:
                block.append(line)
                continue
            ts = None
            texts = []
            for b in block:
                m = _VTT_TS.search(b)
                if m:
                    g = m.groups()
                    start = (int(g[0] or 0) * 3600000 + int(g[1]) * 60000
                             + int(g[2]) * 1000 + int(g[3]))
                    end = (int(g[4] or 0) * 3600000 + int(g[5]) * 60000
                           + int(g[6]) * 1000 + int(g[7]))
                    ts = (start, end)
                elif ts is not None:
                    texts.append(re.sub(r"<[^>]+>", "", b))
            if ts and texts:
                cues.append((ts[0], ts[1], sanitize_str(" ".join(texts))))
            block = []
    return cues


# ---- rows -------------------------------------------------------------------


def rows_for_file(path: str, fmt: str, label_map: dict[str, str]):
    info = probe(path)
    if info is None:
        return [dict(file=path, xstart=0, xlen=0, label="", ylen=0, sr=0, bad=True)]
    dur_ms, sr = info
    if fmt == "yt":
        vtt = os.path.splitext(path)[0] + ".vtt"
        if not os.path.exists(vtt):
            return []
        return [dict(file=path, xstart=start, xlen=end - start, label=text,
                     ylen=len(text), sr=sr, bad=False)
                for start, end, text in parse_vtt(vtt) if text]
    if fmt == "tf-speech":
        label = sanitize_str(os.path.basename(os.path.dirname(path)))
    else:
        label = label_map.get(os.path.splitext(os.path.basename(path))[0], "")
    return [dict(file=path, xstart=0, xlen=dur_ms, label=label,
                 ylen=len(label), sr=sr, bad=not label)]


LABELERS = {
    "librispeech": labels_librispeech,
    "common-voice": labels_common_voice,
    "tatoeba": labels_tatoeba,
    "tf-speech": lambda path: {},
    "yt": lambda path: {},
}


def _cell(v, as_float: bool) -> str:
    if isinstance(v, float) and v != v:
        return ""  # missing
    if isinstance(v, bool):
        return str(v)
    if as_float and isinstance(v, (int, float)):
        return repr(float(v))
    if isinstance(v, float):
        return repr(v)
    return str(v)


def format_rows(rows: list[dict], header: bool = True) -> str:
    """`rows` as pandas' DataFrame(rows, columns=COLUMNS).to_csv(index=
    False) writes them: a numeric column holding any float is written
    as floats (repr), bools as True/False, missing values empty."""
    floats = {c for c in COLUMNS
              if any(isinstance(r[c], float) for r in rows)
              and all(isinstance(r[c], (int, float)) and not isinstance(r[c], bool)
                      for r in rows)}
    buf = io.StringIO()
    w = csv.writer(buf, lineterminator="\n")
    if header:
        w.writerow(COLUMNS)
    for r in rows:
        w.writerow([_cell(r[c], c in floats) for c in COLUMNS])
    return buf.getvalue()


def read_rows(text: str) -> list[dict] | None:
    """The rows of a CSV this module wrote, typed as pandas reads them
    (numbers, bools, missing labels as NaN); None when the header is not
    COLUMNS. Lines with more fields than the header are skipped."""
    table = [r for r in csv.reader(io.StringIO(text)) if r]
    if not table or table[0] != COLUMNS:
        return None
    body = [r for r in table[1:] if len(r) <= len(COLUMNS)]
    cols = {}
    for i, c in enumerate(COLUMNS):
        cells = [r[i] if i < len(r) else None for r in body]
        if c == "bad" and all(x in ("True", "False") for x in cells):
            cols[c] = [x == "True" for x in cells]
        else:
            cols[c] = _column_values(cells)
    return [{c: cols[c][j] for c in COLUMNS} for j in range(len(body))]


# process-pool worker state: the label map is built once a worker (the
# initializer), not pickled with every task
_W: dict = {}


def _pool_init(path: str, fmt: str):
    _W["fmt"] = fmt
    _W["labels"] = LABELERS[fmt](path)


def _pool_rows(file: str):
    return rows_for_file(file, _W["fmt"], _W["labels"])


def _restore_partial(partial: str, files: list[str]) -> tuple[list, int]:
    """Crash-resume: the interrupted run's partial CSV -> (rows, resume
    index), the rows of files [0, resume index) in order, the rest to
    process again. The last file's rows are always dropped: a kill can
    tear its final line, and a yt file's rows can straddle a flush.
    Anything after the last newline is dropped before parsing."""
    try:
        with open(partial, "r", errors="replace") as f:
            text = f.read()
        rows = read_rows(text[: text.rfind("\n") + 1])
    except Exception:
        return [], 0
    if not rows:
        return [], 0
    done = list(dict.fromkeys(str(r["file"]) for r in rows))
    order = {f: i for i, f in enumerate(files)}
    prefix = 0  # trust only a prefix of the deterministic file order
    for f in done:
        if order.get(f) != prefix:
            break
        prefix += 1
    prefix = max(prefix - 1, 0)
    keep = set(files[:prefix])
    return [r for r in rows if str(r["file"]) in keep], prefix


def create_dataset(path: str, fmt: str, workers: int = 4,
                   out: str | None = None, pool: str = "process",
                   flush_every: int = 64) -> list[dict]:
    """Corpus directory -> asr-dataset.csv (or `out`); returns the rows.
    Rows are appended to `<out>.partial` every `flush_every` files, an
    interrupted run restores from it (the same final bytes), and the
    finished CSV replaces it. The pool is of processes (spawned, so that
    a caller's CUDA or threads are not forked) or, with pool="thread",
    of threads."""
    files = list(audio_files(path))
    out = out or os.path.join(path, "asr-dataset.csv")
    partial = out + ".partial"

    rows: list = []
    start = 0
    if os.path.exists(partial):
        rows, start = _restore_partial(partial, files)
        if start:
            print(f"resuming: {start}/{len(files)} files restored from {partial}")

    header_needed = True
    if rows:
        with open(partial, "w", newline="") as f:
            f.write(format_rows(rows))
        header_needed = False
    elif os.path.exists(partial):
        os.remove(partial)  # nothing in it to trust

    todo = files[start:]
    buf: list = []

    def flush():
        nonlocal header_needed
        if not buf:
            return
        with open(partial, "a", newline="") as f:
            f.write(format_rows(buf, header=header_needed))
        header_needed = False
        rows.extend(buf)
        buf.clear()

    if pool == "process" and todo:
        import multiprocessing as mp

        ex = cf.ProcessPoolExecutor(
            workers, mp_context=mp.get_context("spawn"),
            initializer=_pool_init, initargs=(path, fmt))
        mapped = ex.map(_pool_rows, todo, chunksize=16)
    elif todo:
        label_map = LABELERS[fmt](path)
        ex = cf.ThreadPoolExecutor(workers)
        mapped = ex.map(lambda f: rows_for_file(f, fmt, label_map), todo)
    else:
        ex, mapped = None, []
    try:
        for done_files, rs in enumerate(mapped, 1):  # in submission order
            buf.extend(rs)
            if done_files % flush_every == 0:
                flush()
        flush()
    finally:
        if ex is not None:
            ex.shutdown()

    with open(out, "w", newline="") as f:
        f.write(format_rows(rows))
    if os.path.exists(partial):
        os.remove(partial)
    print(f"wrote {len(rows)} rows ({sum(bool(r['bad']) for r in rows)} bad) -> {out}")
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("path")
    p.add_argument("--format", required=True, choices=sorted(LABELERS))
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--out")
    p.add_argument("--pool", choices=("process", "thread"), default="process")
    a = p.parse_args(argv)
    create_dataset(a.path, a.format, a.workers, a.out, pool=a.pool)


if __name__ == "__main__":
    main(sys.argv[1:])
