"""BPE tokenizer: LABPE1 models, trained, read, encoded and decoded (the
JAX package's data/bpe.py).

Id contract: 0 = <PAD> (blank), 1 = <UNK>, 2 = <BOS> (the predictor's
BOS), 3 = <EOS>. A LABPE1 model file is the line "LABPE1", the vocab
size, the merge count, one token per line, then one merge per line.

Training runs the port's own copy of the JAX package's C++ trainer
(csrc/bpe_train.cpp, built with g++ at first use): the token ids depend
on its container order, so no other trainer gives the same model.
Encoding splits each lower-cased word into characters, the word marker
fused with the first (or standing alone, in models converted from
youtokentome, which keep it as a token of its own), and applies the
lowest-ranked merge until none applies. Decoding joins the tokens and
turns the word marker into spaces.
"""

from __future__ import annotations

import ctypes
import os

META = "▁"  # the word marker


def train_bpe(corpus_path: str, model_path: str, vocab_size: int = 2048) -> None:
    """Train a LABPE1 model on a text corpus (one utterance per line)."""
    from ..ops.kernels.build import load_host

    lib = load_host("bpe_train")
    lib.bpe_train.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]
    lib.bpe_train.restype = ctypes.c_int
    rc = lib.bpe_train(corpus_path.encode(), model_path.encode(), int(vocab_size))
    if rc != 0:
        raise RuntimeError(f"bpe_train failed rc={rc} ({corpus_path} -> {model_path})")


class BPELanguage:
    blank = 0
    sos = 2
    eos = 3

    def __init__(self, model_file: str):
        if not os.path.exists(model_file):
            raise FileNotFoundError(model_file)
        self.model_file = model_file  # bundles re-export the tokenizer
        with open(model_file, encoding="utf-8") as f:
            if f.readline().strip() != "LABPE1":
                raise ValueError(f"{model_file}: not a LABPE1 model")
            vocab_sz = int(f.readline())
            n_merges = int(f.readline())
            self.vocab = [f.readline().rstrip("\n") for _ in range(vocab_sz)]
            self.rank = {f.readline().rstrip("\n"): r for r in range(n_merges)}
        self.t2i = {t: i for i, t in enumerate(self.vocab)}
        self.meta_standalone = META in self.t2i

    def _encode_word(self, w: str) -> list[int]:
        syms = [META] + list(w) if self.meta_standalone else [META + w[0]] + list(w[1:])
        while len(syms) > 1:
            best, bi = None, -1
            for i in range(len(syms) - 1):
                r = self.rank.get(syms[i] + " " + syms[i + 1])
                if r is not None and (best is None or r < best):
                    best, bi = r, i
            if bi < 0:
                break
            syms[bi: bi + 2] = [syms[bi] + syms[bi + 1]]
        return [self.t2i.get(s, 1) for s in syms]

    def numericalize(self, text: str, sos: bool = False, dropout: float = 0.0,
                     seed: int = 0, append_eos: bool = True) -> list[int]:
        """Text -> ids: lower-cased, split on whitespace, each word
        encoded; <EOS> appended unless append_eos is False, <BOS> put in
        front when sos. BPE-dropout (dropout > 0) is not ported: the JAX
        package draws it from the C library's rand_r."""
        if dropout > 0:
            raise NotImplementedError(
                "libreasr_tpu_torch: BPE-dropout is not ported (ROADMAP)")
        ids = [i for w in text.lower().strip().split() for i in self._encode_word(w)]
        if append_eos:
            ids.append(self.eos)
        return ([self.sos] if sos else []) + ids

    def denumericalize(self, ids) -> str:
        """Token ids -> text; nothing after EOS, blanks and <...>
        specials dropped."""
        ids = [int(i) for i in ids]
        if self.eos in ids:
            ids = ids[: ids.index(self.eos)]
        s = "".join(
            self.vocab[i] for i in ids
            if 0 <= i < len(self.vocab) and i != self.blank
            and not self.vocab[i].startswith("<")
        )
        return s.replace(META, " ").strip()

    def __len__(self) -> int:
        return len(self.vocab)
