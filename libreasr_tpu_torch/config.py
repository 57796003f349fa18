"""YAML config loading with deep-merged override blocks.

Same semantics as the JAX package's config module: `open_config` reads
a YAML file, `apply_overrides` deep-merges `overrides.<block>` sections
in order, `parse_and_apply_config` does both.
"""

from __future__ import annotations

import copy
import os
from typing import Any

DEFAULT_CONFIG = os.path.join(
    os.path.dirname(__file__), "..", "config", "base.yaml"
)


def deep_update(dst: dict, src: dict) -> dict:
    """Recursive dict merge, src wins."""
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            deep_update(dst[k], v)
        else:
            dst[k] = v
    return dst


def open_config(path: str | None = None) -> dict:
    import yaml

    with open(path or DEFAULT_CONFIG) as f:
        return yaml.safe_load(f)


def apply_overrides(conf: dict, blocks: list[str]) -> dict:
    """Deep-merge `conf['overrides'][block]` for each block, in order;
    unknown blocks are ignored."""
    conf = copy.deepcopy(conf)
    overrides = conf.get("overrides", {}) or {}
    for b in blocks:
        if overrides.get(b):
            deep_update(conf, copy.deepcopy(overrides[b]))
    return conf


def parse_and_apply_config(
    *, inference: bool = False, lang: str = "", path: str | None = None
) -> dict:
    conf = open_config(path)
    blocks = []
    if lang:
        blocks.append(lang)
        conf["lang"] = lang
    if inference:
        blocks.append("inference")
    return apply_overrides(conf, blocks)


def conf_get(conf: dict, dotted: str, default: Any = None) -> Any:
    """`conf_get(conf, "model.encoder.num_layers")`: the value at a dotted
    path, or `default` where the path does not exist."""
    node = conf
    for part in dotted.split("."):
        if not isinstance(node, dict) or part not in node:
            return default
        node = node[part]
    return node
