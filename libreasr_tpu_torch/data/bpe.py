"""BPE tokenizer: LABPE1 models, trained, read, encoded and decoded (the
JAX package's data/bpe.py).

Id contract: 0 = <PAD> (blank), 1 = <UNK>, 2 = <BOS> (the predictor's
BOS), 3 = <EOS>. A LABPE1 model file is the line "LABPE1", the vocab
size, the merge count, one token per line, then one merge per line.

Training and encoding run the port's own copy of the JAX package's C++
trainer and native encoder (csrc/bpe_train.cpp, built with g++ at first
use): the token ids depend on the trainer's container order, and
BPE-dropout's draws come from the C library's rand_r, so no other code
gives the same ids.
Encoding splits each lower-cased word into characters, the word marker
fused with the first (or standing alone, in models converted from
youtokentome, which keep it as a token of its own), and applies the
lowest-ranked merge until none applies. Decoding joins the tokens and
turns the word marker into spaces.
"""

from __future__ import annotations

import ctypes
import os
from functools import lru_cache

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


@lru_cache(maxsize=1)
def _encoder_lib() -> ctypes.CDLL:
    from ..ops.kernels.build import load_host

    lib = load_host("bpe_train")
    lib.bpe_load.argtypes = [ctypes.c_char_p]
    lib.bpe_load.restype = ctypes.c_void_p
    lib.bpe_free_model.argtypes = [ctypes.c_void_p]
    lib.bpe_encode_dropout.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int, ctypes.c_double, ctypes.c_uint]
    lib.bpe_encode_dropout.restype = ctypes.c_int
    return lib


def encode(handle, text: str, dropout: float, seed: int) -> list[int]:
    """The ids of lower-cased `text`, each candidate merge skipped with
    probability `dropout`, with a model handle of csrc/bpe_train.cpp's
    bpe_load."""
    raw = text.encode()
    buf = (ctypes.c_int32 * (4 * len(raw) + 8))()
    n = _encoder_lib().bpe_encode_dropout(handle, raw, buf, len(buf),
                                          float(dropout), int(seed) & 0xFFFFFFFF)
    return list(buf[: min(n, len(buf))])


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
            f.readline()  # the merge count: the merges are the C encoder's
            self.vocab = [f.readline().rstrip("\n") for _ in range(vocab_sz)]
        self._handle = None  # the C encoder's model, loaded at first use

    def _encoder(self):
        if self._handle is None:
            self._handle = _encoder_lib().bpe_load(self.model_file.encode())
            if not self._handle:
                raise ValueError(f"{self.model_file}: not a LABPE1 model")
        return self._handle

    def __del__(self):
        if getattr(self, "_handle", None):
            _encoder_lib().bpe_free_model(self._handle)

    def numericalize(self, text: str, sos: bool = False, dropout: float = 0.0,
                     seed: int = 0, append_eos: bool = True) -> list[int]:
        """Text -> ids: lower-cased, split on whitespace, each word
        encoded; <EOS> appended unless append_eos is False, <BOS> put in
        front when sos. With dropout > 0 each candidate merge is skipped
        with that probability (BPE-dropout), drawn from rand_r seeded
        with `seed` for the call."""
        ids = encode(self._encoder(), text.lower().strip(), dropout, seed)
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
