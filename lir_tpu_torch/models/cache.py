"""Converted-parameter cache: convert HF weights once, load fast after.

Port of ``lir_tpu/models/cache.py`` (its ``save_params`` /
``load_params`` / ``has_cached``; the JAX module's KV-cache helpers live
in the port's ``models/decoder.py``). The JAX package writes the
converted pytree with orbax, which the card's machine does not have, so
the port writes its own format, one entry a model:

  <cache_root>/<name>/params.pt   the converted tree (nested dicts of
                                  tensors), ``torch.save``d, read back
                                  with ``torch.load(weights_only=True,
                                  mmap=True)``
  <cache_root>/<name>/cfg.json    the ModelConfig / T5Config, its kind
                                  and the tree's dtype, written
                                  atomically (utils/manifest)

``<name>`` is the checkpoint directory's name, the JAX package's key.
The entry holds the tree as converted, BEFORE quantization, as the JAX
package caches it: int8 weights are quantized from it after every load.
``cfg.json`` is written last, so an entry whose parameters were cut off
mid-write has no config and loads cold. An entry of another dtype than
the caller's (a float32 CPU entry met by a bfloat16 card load, or the
reverse) raises, naming both.
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import Any, Tuple

import torch

from ..utils.logging import get_logger
from ..utils.manifest import atomic_write_text
from .registry import ModelConfig, T5Config

log = get_logger(__name__)

_CFG_KINDS = {"decoder": ModelConfig, "t5": T5Config}
PARAMS_FILE = "params.pt"
CFG_FILE = "cfg.json"


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _cfg_to_json(cfg, dtype: torch.dtype) -> str:
    kind = "t5" if isinstance(cfg, T5Config) else "decoder"
    return json.dumps({"kind": kind, "dtype": _dtype_name(dtype),
                       "fields": dataclasses.asdict(cfg)}, indent=2)


def cache_entry_dir(cache_root: Path, name: str) -> Path:
    return Path(cache_root) / name.replace("/", "__")


def has_cached(cache_root: Path, name: str) -> bool:
    entry = cache_entry_dir(cache_root, name)
    return (entry / CFG_FILE).exists() and (entry / PARAMS_FILE).exists()


def _host_tree(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    raise TypeError(f"the parameter cache holds tensor trees only, not "
                    f"{type(tree).__name__} (quantized leaves are made "
                    f"after a load, never cached)")


def save_params(cache_root: Path, name: str, params: Any, cfg,
                dtype: torch.dtype) -> Path:
    """Write the tree converted at ``dtype`` and its config (replacing
    an entry)."""
    entry = cache_entry_dir(cache_root, name)
    entry.mkdir(parents=True, exist_ok=True)
    (entry / CFG_FILE).unlink(missing_ok=True)
    tmp = entry / f"{PARAMS_FILE}.{os.getpid()}.tmp"
    torch.save(_host_tree(params), tmp)
    os.replace(tmp, entry / PARAMS_FILE)
    atomic_write_text(entry / CFG_FILE,
                      _cfg_to_json(cfg, dtype))
    log.info("cached converted params for %s at %s", name, entry)
    return entry


def load_params(cache_root: Path, name: str, dtype: torch.dtype,
                device) -> Tuple[Any, Any]:
    """(params on ``device``, cfg) of an entry; raises ValueError when
    the entry's dtype is not ``dtype``."""
    entry = cache_entry_dir(cache_root, name)
    meta = json.loads((entry / CFG_FILE).read_text())
    if meta["dtype"] != _dtype_name(dtype):
        raise ValueError(
            f"parameter cache entry {entry} holds {meta['dtype']} "
            f"parameters, but this load asks for {_dtype_name(dtype)}: "
            f"give another --param-cache root or the entry's dtype")
    cfg = _CFG_KINDS[meta["kind"]](**meta["fields"])
    host = torch.load(entry / PARAMS_FILE, map_location="cpu",
                      weights_only=True, mmap=True)

    def to_device(tree):
        if isinstance(tree, dict):
            return {k: to_device(v) for k, v in tree.items()}
        return tree.to(device, copy=True)

    params = to_device(host)
    log.info("restored cached params for %s", name)
    return params, cfg
