"""Release bundles: tar.gz of {lang}/model.msgpack, config.json,
tokenizer.labpe-model and lm.msgpack, as the JAX package writes them.

The weights are flax msgpack: a nested map whose array leaves are
msgpack ext type 1 holding a msgpack-packed (shape, dtype-name,
row-major bytes) triple; numpy scalars are ext type 3 with the same
payload. Decoded and encoded here with msgpack and numpy alone; flax's
other ext type (2, Python complex numbers) never occurs in model
weights, and no weight comes near the 1 GiB above which flax splits an
array into chunks.
"""

from __future__ import annotations

import json
import os
import shutil
import tarfile
import tempfile

import msgpack
import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    if dtype_name == b"bfloat16":
        # numpy has no bfloat16: widen the 16-bit patterns to float32
        bits = np.frombuffer(buffer, np.uint16).astype(np.uint32) << 16
        arr = bits.view(np.float32)
    else:
        arr = np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode()))
    return arr.reshape(shape, order="C")


def _ext_hook(code: int, data: bytes):
    if code == _EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == _EXT_NPSCALAR:
        return _ndarray_from_bytes(data)[()]
    raise ValueError(f"unsupported msgpack ext type {code} in flax weights")


def _ndarray_to_bytes(arr: np.ndarray) -> bytes:
    return msgpack.packb((arr.shape, arr.dtype.name, arr.tobytes("C")),
                         use_bin_type=True)


def _ext_pack(x):
    if isinstance(x, np.ndarray):
        return msgpack.ExtType(_EXT_NDARRAY, _ndarray_to_bytes(x))
    if isinstance(x, np.generic):
        return msgpack.ExtType(_EXT_NPSCALAR, _ndarray_to_bytes(np.asarray(x)))
    raise TypeError(f"cannot serialize {type(x).__name__} into flax weights")


def _sorted(tree):
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


def msgpack_serialize(tree: dict) -> bytes:
    """flax `msgpack_serialize`: nested dict of numpy leaves -> bytes.
    Maps are written in sorted key order, as flax (through JAX's pytree
    flattening) writes them, so the bytes equal flax's."""
    return msgpack.packb(_sorted(tree), default=_ext_pack, strict_types=True)


def msgpack_restore(data: bytes) -> dict:
    """flax `msgpack_restore`: bytes -> nested dict of numpy leaves."""
    return msgpack.unpackb(
        data, ext_hook=_ext_hook, raw=False, strict_map_key=False
    )


def save_bundle(out_path: str, lang_name: str, variables: dict, conf: dict,
                tokenizer_file: str | None = None,
                lm_variables: dict | None = None) -> str:
    """Write a release tar.gz as the JAX package's save_bundle does:
    {lang}/model.msgpack (the variables dict of numpy arrays), the
    resolved {lang}/config.json and, when given, the LM's variables as
    {lang}/lm.msgpack and the tokenizer model as
    {lang}/tokenizer.labpe-model."""
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        d = os.path.join(tmp, lang_name)
        os.makedirs(d)
        with open(os.path.join(d, "model.msgpack"), "wb") as f:
            f.write(msgpack_serialize(variables))
        if lm_variables is not None:
            with open(os.path.join(d, "lm.msgpack"), "wb") as f:
                f.write(msgpack_serialize(lm_variables))
        if tokenizer_file and os.path.exists(tokenizer_file):
            shutil.copy(tokenizer_file, os.path.join(d, "tokenizer.labpe-model"))
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(conf, f, indent=2)
        # gzip's fastest level: float weights barely compress, and level
        # 9 spends ~15 s on a full-width model for the same bytes within %
        with tarfile.open(out_path, "w:gz", compresslevel=1) as tar:
            tar.add(d, arcname=lang_name)
    return out_path


def read_bundle_conf(path: str, lang_name: str) -> dict:
    """The bundle's config.json, or {} when it has none."""
    with tarfile.open(path, "r:gz") as tar:
        try:
            f = tar.extractfile(f"{lang_name}/config.json")
        except KeyError:
            return {}
        return json.load(f) if f else {}


def load_bundle(path: str, lang_name: str, extract_to: str = "./tmp"):
    """Extract a bundle. Returns (variables, tokenizer_path_or_None,
    lm_bytes_or_None, conf); variables is the nested
    {"params": ..., "batch_stats": ...} dict of numpy arrays.

    Which members exist is read from the archive's member list, never
    from what lies in `extract_to`: a bundle without a tokenizer or an
    LM, extracted where another bundle was extracted before, must not
    pick up that bundle's files."""
    os.makedirs(extract_to, exist_ok=True)
    d = os.path.join(extract_to, lang_name)
    with tarfile.open(path, "r:gz") as tar:
        members = set(tar.getnames())

        def read(name):
            member = f"{lang_name}/{name}"
            return tar.extractfile(member).read() if member in members else None

        model_bytes = read("model.msgpack")
        if model_bytes is None:
            raise FileNotFoundError(f"{path}: no {lang_name}/model.msgpack")
        variables = msgpack_restore(model_bytes)
        lm_bytes = read("lm.msgpack")
        conf_bytes = read("config.json")
        tar.extractall(extract_to, filter="data")
    tok = None
    if f"{lang_name}/tokenizer.labpe-model" in members:
        tok = os.path.join(d, "tokenizer.labpe-model")
    conf = json.loads(conf_bytes) if conf_bytes is not None else {}
    return variables, tok, lm_bytes, conf
