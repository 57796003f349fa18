"""Release bundles: tar.gz of {lang}/model.msgpack, config.json,
tokenizer.labpe-model and lm.msgpack, as the JAX package writes them.

The weights are flax msgpack: a nested map whose array leaves are
msgpack ext type 1 holding a msgpack-packed (shape, dtype-name,
row-major bytes) triple; numpy scalars are ext type 3 with the same
payload. Decoded here with msgpack and numpy alone; flax's other ext
type (2, Python complex numbers) never occurs in model weights.
"""

from __future__ import annotations

import json
import os
import tarfile

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


def msgpack_restore(data: bytes) -> dict:
    """flax `msgpack_restore`: bytes -> nested dict of numpy leaves."""
    return msgpack.unpackb(
        data, ext_hook=_ext_hook, raw=False, strict_map_key=False
    )


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
    {"params": ..., "batch_stats": ...} dict of numpy arrays."""
    os.makedirs(extract_to, exist_ok=True)
    with tarfile.open(path, "r:gz") as tar:
        tar.extractall(extract_to, filter="data")
    d = os.path.join(extract_to, lang_name)
    with open(os.path.join(d, "model.msgpack"), "rb") as f:
        variables = msgpack_restore(f.read())
    tok = os.path.join(d, "tokenizer.labpe-model")
    tok = tok if os.path.exists(tok) else None
    lm_bytes = None
    lm_path = os.path.join(d, "lm.msgpack")
    if os.path.exists(lm_path):
        with open(lm_path, "rb") as f:
            lm_bytes = f.read()
    conf = {}
    conf_path = os.path.join(d, "config.json")
    if os.path.exists(conf_path):
        with open(conf_path) as f:
            conf = json.load(f)
    return variables, tok, lm_bytes, conf
