"""youtokentome BPE model -> LABPE1 converter (the port's own copy of
the JAX package's compat/yttm_import.py, the same bytes).

The reference ships its release bundles with a youtokentome tokenizer
(`{lang}/tokenizer.yttm-model`, model_utils.py:21-47; loaded at
language.py:116-121). This converts that model file into the LABPE1
format (the port's csrc/bpe_train.cpp reads it) so an imported reference
checkpoint is served with its own subword inventory — token ids must
line up with the embedding/joint rows of the imported weights.

yttm model file format (youtokentome cpp/bpe.cpp BPEState::dump — a
plain text file):

    <n_chars> <n_rules>
    <unicode_code_point> <id>        x n_chars
    <x> <y> <z>                      x n_rules   (merge: id x + id y -> id z)
    <unk_id> <pad_id> <bos_id> <eos_id>          (SpecialTokens::dump)

Both vocabularies share the same conventions: U+2581 (▁) marks a word
start, and the reference's id contract is pad/blank=0, unk=1, bos=2,
eos=3 (language.py:115-155, models.py:225-227) — yttm's defaults. The
converter verifies that contract instead of assuming it: a bundle
trained with non-default special ids would silently decode garbage.
"""

from __future__ import annotations

SPECIAL_NAMES = ("<PAD>", "<UNK>", "<BOS>", "<EOS>")  # LABPE1 ids 0..3


def parse_yttm_model(path: str):
    """Parse a yttm model file -> (id2token dict, merges list, specials).

    merges: list of (left_id, right_id, new_id) in rank order.
    specials: dict name->id with names pad/unk/bos/eos.
    """
    with open(path, "r", encoding="utf-8") as f:
        toks = f.read().split()
    it = iter(toks)

    def nxt() -> int:
        return int(next(it))

    n_chars, n_rules = nxt(), nxt()
    id2token: dict[int, str] = {}
    for _ in range(n_chars):
        code, tid = nxt(), nxt()
        id2token[tid] = chr(code)
    merges = []
    for _ in range(n_rules):
        merges.append((nxt(), nxt(), nxt()))
    unk, pad, bos, eos = nxt(), nxt(), nxt(), nxt()
    specials = {"pad": pad, "unk": unk, "bos": bos, "eos": eos}
    return id2token, merges, specials


def convert_yttm_model(yttm_path: str, out_path: str) -> int:
    """yttm model -> LABPE1 model at out_path. Returns vocab size.

    LABPE1 assigns ids by line order, so the yttm id space must be
    exactly 0..V-1 with the specials at 0..3 in (pad, unk, bos, eos)
    order — the reference's blank=0/bos=2 contract. Anything else is a
    hard error (weights indexed by these ids are being imported too).
    """
    id2token, merges, sp = parse_yttm_model(yttm_path)
    if (sp["pad"], sp["unk"], sp["bos"], sp["eos"]) != (0, 1, 2, 3):
        raise ValueError(
            f"yttm special ids {sp} != the reference contract "
            "(pad=0, unk=1, bos=2, eos=3, language.py/models.py:227)"
        )
    for name, tid in zip(SPECIAL_NAMES, range(4)):
        if tid in id2token:
            raise ValueError(f"yttm char id {tid} collides with special {name}")
        id2token[tid] = name
    # resolve merge targets to strings (rules are in rank order, and a
    # rule may reference a token created by an earlier rule)
    for x, y, z in merges:
        if x not in id2token or y not in id2token:
            raise ValueError(f"merge ({x},{y})->{z} references unknown ids")
        if z in id2token:
            raise ValueError(f"merge target id {z} already assigned")
        id2token[z] = id2token[x] + id2token[y]
    vocab_sz = len(id2token)
    if sorted(id2token) != list(range(vocab_sz)):
        raise ValueError("yttm id space is not contiguous 0..V-1")
    with open(out_path, "w", encoding="utf-8") as f:
        f.write(f"LABPE1\n{vocab_sz}\n{len(merges)}\n")
        for i in range(vocab_sz):
            f.write(id2token[i] + "\n")
        for x, y, _ in merges:
            f.write(f"{id2token[x]} {id2token[y]}\n")
    return vocab_sz


def write_yttm_model(out_path: str, alphabet: str, merges, *,
                     start_id: int = 4) -> None:
    """Emit a yttm-format model file (test fixture writer; the format's
    reader/writer pair is validated round-trip in tests).

    alphabet: characters (ids assigned start_id, start_id+1, ...).
    merges: list of (left_token, right_token) strings over that
    alphabet/earlier merge outputs; ids continue after the alphabet.
    """
    tok2id = {}
    for i, ch in enumerate(alphabet):
        tok2id[ch] = start_id + i
    lines = [f"{len(alphabet)} {len(merges)}"]
    for ch, tid in tok2id.items():
        lines.append(f"{ord(ch)} {tid}")
    nid = start_id + len(alphabet)
    for left, right in merges:
        if left not in tok2id or right not in tok2id:
            raise ValueError(f"merge ({left!r},{right!r}) over unknown tokens")
        lines.append(f"{tok2id[left]} {tok2id[right]} {nid}")
        tok2id[left + right] = nid
        nid += 1
    lines.append("1 0 2 3")  # unk pad bos eos (yttm defaults)
    with open(out_path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
