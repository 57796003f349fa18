"""Vocabularies. Char level, the same contract as the JAX package:
id 0 = <BLK> (blank/pad), 1 = <s>, 2 = </s> (EOS, and the predictor's
BOS), 3 = <UNK>, then space and punctuation, then a-z."""

from __future__ import annotations

import string

DEFAULT_TOKENS = ["<BLK>", "<s>", "</s>", "<UNK>", " ", ".", "!", "?", ",", "'", "-"]
_SPECIAL = (0, 1, 2, 3)  # blank, sos, eos, unk
_EOS = 2


class CharLanguage:
    blank = 0
    sos = 1
    eos = _EOS  # the streaming engine latches a slot on it

    def __init__(self, tokens: dict[str, int]):
        self.t2i = dict(tokens)
        self.i2t = {i: t for t, i in tokens.items()}

    def numericalize(self, text: str, sos: bool = False) -> list[int]:
        """Text -> ids: lower-cased and stripped, unknown characters
        dropped, EOS appended, <s> put in front when `sos`."""
        ids = [self.t2i[c] for c in text.lower().strip() if c in self.t2i]
        return ([self.sos] if sos else []) + ids + [_EOS]

    def denumericalize(self, ids) -> str:
        """Token ids -> text: specials dropped, and nothing after EOS (a
        decoder's tokens past it are post-terminal drift)."""
        chars = []
        for i in ids:
            i = int(i)
            if i == _EOS:
                break
            tok = self.i2t.get(i)
            if i not in _SPECIAL and tok is not None and not tok.startswith("<"):
                chars.append(tok)
        return "".join(chars)

    def __len__(self) -> int:
        return len(self.t2i)


def get_language(tokens=None, model_file: str | None = None):
    """Returns (lang, vocab_sz): a BPELanguage over a LABPE1 tokenizer
    model when `model_file` is given, else the char vocabulary."""
    if model_file:
        from .bpe import BPELanguage

        lang = BPELanguage(model_file)
        return lang, len(lang)
    tokens = tokens or DEFAULT_TOKENS
    vocab = dict(zip(tokens, range(len(tokens))))
    for i, c in enumerate(string.ascii_lowercase):
        vocab[c] = len(tokens) + i
    lang = CharLanguage(vocab)
    return lang, len(lang)
