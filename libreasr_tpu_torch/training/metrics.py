"""Quality metrics: CER and WER (the JAX package's training/metrics.py).

cer: character Levenshtein distance over the space-stripped strings,
over the target's length. wer: word Levenshtein distance over the
target's word count. An empty target scores 0 against an empty
prediction, else 1.
"""

from __future__ import annotations


def edit_distance(a, b) -> int:
    """Levenshtein distance between two sequences."""
    b = list(b)
    prev = list(range(len(b) + 1))
    for i, x in enumerate(a, 1):
        cur = [i]
        for j, y in enumerate(b, 1):
            cur.append(min(prev[j - 1] + (x != y), prev[j] + 1, cur[j - 1] + 1))
        prev = cur
    return prev[-1]


def cer(pred: str, target: str) -> float:
    p, t = pred.replace(" ", ""), target.replace(" ", "")
    if not t:
        return 0.0 if not p else 1.0
    return edit_distance(p, t) / len(t)


def wer(pred: str, target: str) -> float:
    p, t = pred.split(), target.split()
    if not t:
        return 0.0 if not p else 1.0
    return edit_distance(p, t) / len(t)
