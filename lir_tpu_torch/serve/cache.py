"""Content-addressed result cache: dedup for repeated probes. Port of
``lir_tpu/serve/cache.py``.

Perturbation-style traffic re-asks the same questions (a client retrying
a timed-out cell, the unperturbed original scored once a session). The
cache is keyed by a sha256 over everything that decides a score: the
serving engine's key (:func:`engine_key`) plus both prompts and both
targets. Two requests with one address dispatch the same work on the
same inputs, so replaying the stored measurement is the fresh score;
anything that could change the numbers changes the engine key and
misses.

The JAX package's engine key is its XLA compile-manifest key. The port
has no compiled executables; its :func:`engine_key` is a host function
of the same inputs that decide a score: the model config (the int8 KV
flag is one of its fields), the runtime, speculative and cascade knobs,
the quantization mode of the weights, the bucket ladder and the device.

LRU-bounded; entries are plain measurement dicts, safe to share across
threads.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import threading
from collections import OrderedDict
from typing import Any, Dict, Optional

import torch

from ..models.quant import QuantTensor
from ..utils.profiling import ServeStats
from .queue import ServeRequest


def quant_mode(params: Any) -> str:
    """Which leaf flavors a param tree holds: "int8", "int8-dyn" or the
    float dtypes, "+"-joined (the JAX package's fingerprint)."""
    kinds = set()

    def walk(tree):
        if isinstance(tree, dict):
            for v in tree.values():
                walk(v)
        elif isinstance(tree, QuantTensor):
            kinds.add("int8-dyn" if tree.dynamic else "int8")
        elif isinstance(tree, torch.Tensor):
            kinds.add(str(tree.dtype).replace("torch.", ""))

    walk(params)
    return "+".join(sorted(kinds)) or "empty"


def engine_key(engine) -> str:
    """sha256 over what decides an engine's scores (module docstring)."""
    spec = {
        "cfg": dataclasses.asdict(engine.cfg),
        "runtime": dataclasses.asdict(engine.rt),
        "spec": dataclasses.asdict(engine.spec_cfg),
        "cascade": dataclasses.asdict(engine.cascade_cfg),
        "quant": quant_mode(engine.params),
        "buckets": list(engine.buckets),
        "device": engine.device.type,
    }
    return hashlib.sha256(json.dumps(spec, sort_keys=True,
                                     default=str).encode()).hexdigest()


def content_key(engine_key: str, request: ServeRequest) -> str:
    """Content address of one probe under one engine configuration."""
    h = hashlib.sha256()
    for part in (engine_key, request.binary_prompt,
                 request.confidence_prompt, *request.targets):
        h.update(part.encode("utf-8"))
        h.update(b"\x1f")
    return h.hexdigest()


class ResultCache:
    """Thread-safe LRU of measurement payloads keyed by content address.
    ``max_entries <= 0`` disables it (lookups miss, puts drop)."""

    def __init__(self, max_entries: int,
                 stats: Optional[ServeStats] = None):
        self.max_entries = int(max_entries)
        self.stats = stats if stats is not None else ServeStats()
        self._od: "OrderedDict[str, Dict]" = OrderedDict()
        self._lock = threading.Lock()

    def __len__(self) -> int:
        with self._lock:
            return len(self._od)

    def get(self, key: str) -> Optional[Dict]:
        with self._lock:
            payload = self._od.get(key)
            if payload is not None:
                self._od.move_to_end(key)
        if payload is None:
            self.stats.count("dedup_misses")
            return None
        self.stats.count("dedup_hits")
        return dict(payload)

    def put(self, key: str, payload: Dict) -> None:
        if self.max_entries <= 0:
            return
        with self._lock:
            self._od[key] = dict(payload)
            self._od.move_to_end(key)
            while len(self._od) > self.max_entries:
                self._od.popitem(last=False)
