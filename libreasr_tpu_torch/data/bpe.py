"""BPE tokenizer for serving: the LABPE1 model reader and decoder (the
JAX package's data/bpe.py pure-Python path, `_PyBPE` and
`BPELanguage.denumericalize`).

Id contract: 0 = <PAD> (blank), 1 = <UNK>, 2 = <BOS> (the predictor's
BOS), 3 = <EOS>. A LABPE1 model file is the line "LABPE1", the vocab
size, the merge count, one token per line, then one merge per line.
Decoding joins the tokens, turns the word marker into spaces and
strips the ends; encoding and training are not needed to serve.
"""

from __future__ import annotations

import os

META = "▁"  # the word marker


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
            int(f.readline())  # merges: only encoding reads them
            self.vocab = [f.readline().rstrip("\n") for _ in range(vocab_sz)]

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
