"""High-level model loading: HF checkpoint directory -> ScoringEngine.

Port of ``lir_tpu/models/factory.py``. The flow is

  local checkpoint dir -> config.json (models/loader.config_from_hf, or
  t5_config_from_hf for an encoder-decoder) -> state dict (safetensors
  read here, torch .bin fallback) -> loader.convert_decoder (convert_t5)
  onto the device -> optional int8 -> ScoringEngine

With ``cache_root`` the converted tree goes through the parameter cache
(models/cache.py): converted and written on the first load, read back
on every later one with no conversion.

with neither ``transformers`` nor ``safetensors``: the safetensors format
is parsed here (an 8-byte little-endian header length, a JSON header of
``dtype`` / ``shape`` / ``data_offsets`` per tensor, the data after it)
and each tensor is a view of a memory map of its file. Only the
tokenizer comes from ``transformers`` (``AutoTokenizer``, imported when
no ``tokenizer`` is passed). Everything is local: weights must already
be on disk.
"""

from __future__ import annotations

import dataclasses
import json
import mmap
import re
import struct
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from ..config import CascadeConfig, RuntimeConfig, SpecConfig
from ..device import resolve_device
from ..engine.runner import ScoringEngine
from ..utils.logging import get_logger
from . import cache as cache_mod, loader, quant

log = get_logger(__name__)

# Routing rule "t5|t0|tk-instruct -> Seq2Seq" (compare_instruct_models.py:471-475).
_ENCDEC_PATTERN = re.compile(r"(^|/)(t5|flan-t5|t0|tk-instruct)", re.IGNORECASE)

# safetensors dtype tags the reader decodes.
_ST_DTYPES = {
    "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
    "I32": torch.int32, "I64": torch.int64,
}


def is_encoder_decoder(name_or_path: str, hf_cfg=None) -> bool:
    """The JAX rule: the config says so (a parsed ``config.json`` read
    with its class defaults: a T5 is one), or the name matches."""
    if isinstance(hf_cfg, Mapping):
        default = loader._HF_DEFAULTS.get(hf_cfg.get("model_type"), {})
        if hf_cfg.get("is_encoder_decoder",
                      default.get("is_encoder_decoder", False)):
            return True
    elif hf_cfg is not None and getattr(hf_cfg, "is_encoder_decoder", False):
        return True
    return bool(_ENCDEC_PATTERN.search(str(name_or_path)))


def read_safetensors_header(path: Path) -> Tuple[Dict[str, Any], int]:
    """(header without ``__metadata__``, byte offset of the data)."""
    with open(path, "rb") as f:
        raw = f.read(8)
        if len(raw) != 8:
            raise ValueError(f"{path}: not a safetensors file")
        (n,) = struct.unpack("<Q", raw)
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return header, 8 + n


class _LazyStateDict(Mapping[str, Any]):
    """Tensors straight from safetensors files on demand: one
    ``model.safetensors`` or the shards of
    ``model.safetensors.index.json``'s ``weight_map``. A lookup maps the
    tensor's bytes of its file and returns a tensor over them (no copy;
    the mapping closes when the tensor is freed), so at most the tensors
    in use are resident, never a second copy of the checkpoint. Tensors
    of a dtype the reader does not decode raise only when asked for."""

    def __init__(self, model_dir: Path):
        model_dir = Path(model_dir)
        index_file = model_dir / "model.safetensors.index.json"
        if index_file.exists():
            weight_map = json.loads(index_file.read_text())["weight_map"]
            files = sorted({model_dir / s for s in weight_map.values()})
        else:
            single = model_dir / "model.safetensors"
            if not single.exists():
                raise FileNotFoundError(f"no safetensors found in {model_dir}")
            files = [single]
        self._entries: Dict[str, Tuple[Path, int, Dict[str, Any]]] = {}
        for path in files:
            header, start = read_safetensors_header(path)
            for key, info in header.items():
                self._entries[key] = (path, start, info)

    def __getitem__(self, key: str) -> torch.Tensor:
        path, start, info = self._entries[key]
        dtype = _ST_DTYPES.get(info["dtype"])
        if dtype is None:
            raise TypeError(f"{key}: safetensors dtype {info['dtype']} is "
                            f"not one this reader decodes")
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        itemsize = torch.empty((), dtype=dtype).element_size()
        count = (end - begin) // itemsize
        if count == 0:
            return torch.empty(shape, dtype=dtype)
        # Map the tensor's own bytes only (from the page boundary below
        # them): private copy-on-write pages, a writable buffer for
        # torch.frombuffer that never writes to the file.
        offset = start + begin
        base = offset - offset % mmap.ALLOCATIONGRANULARITY
        with open(path, "rb") as f:
            mm = mmap.mmap(f.fileno(), start + end - base,
                           access=mmap.ACCESS_COPY, offset=base)
        t = torch.frombuffer(mm, dtype=dtype, count=count, offset=offset - base)
        if offset % itemsize:
            t = t.clone()   # an unaligned tensor: copy it out
        return t.reshape(shape)

    def __iter__(self):
        return iter(self._entries)

    def __len__(self) -> int:
        return len(self._entries)


def load_state_dict(model_dir: Path) -> Mapping[str, Any]:
    """safetensors (lazy) preferred; torch ``pytorch_model*.bin`` fallback,
    memory-mapped by ``torch.load``."""
    model_dir = Path(model_dir)
    try:
        return _LazyStateDict(model_dir)
    except FileNotFoundError:
        pass
    bins = sorted(model_dir.glob("pytorch_model*.bin"))
    if not bins:
        raise FileNotFoundError(
            f"no safetensors or pytorch_model*.bin in {model_dir}")
    state: Dict[str, Any] = {}
    for b in bins:
        state.update(torch.load(b, map_location="cpu", weights_only=True,
                                mmap=True))
    return state


def _auto_tokenizer(model_dir: Path):
    try:
        import transformers
    except ImportError as exc:
        raise ImportError(
            f"loading the tokenizer of {model_dir} needs transformers "
            "(AutoTokenizer); without it, pass tokenizer= to load_engine / "
            "engine_factory") from exc
    return transformers.AutoTokenizer.from_pretrained(
        model_dir, local_files_only=True, trust_remote_code=False)


def load_engine(
    model_dir: Path,
    runtime: Optional[RuntimeConfig] = None,
    dtype: Optional[torch.dtype] = None,
    quantize_int8: bool = False,
    int8_dynamic: bool = False,
    spec_config: Optional[SpecConfig] = None,
    cascade_config: Optional[CascadeConfig] = None,
    tokenizer=None,
    device="cuda",
    kv_cache_int8: bool = False,
    governor_config=None,
    cache_root: Optional[Path] = None,
) -> ScoringEngine:
    """Build a ready ScoringEngine from a local HF checkpoint directory
    on ``device`` (the card unless the CPU is asked for).

    A decoder goes through ``loader.config_from_hf`` and
    ``convert_decoder``, an encoder-decoder (T5, flan-t5, T0,
    tk-instruct) through ``t5_config_from_hf`` and ``convert_t5`` into an
    ``encoder_decoder=True`` engine. ``dtype`` defaults to bfloat16 on
    the card and float32 on the CPU. ``quantize_int8`` quantizes the
    loaded tree on the device (``quant.quantize_decoder_params`` or
    ``quantize_encdec_params``, ``dynamic=int8_dynamic``).
    ``kv_cache_int8`` stores a decoder's KV cache in int8
    (``ModelConfig.kv_cache_int8``); an encoder-decoder keeps no KV cache,
    so there it logs the JAX package's warning and goes on without it.
    ``tokenizer=None`` loads the directory's tokenizer with
    ``transformers.AutoTokenizer``. ``governor_config``
    (config.GovernorConfig) configures the engine's device-memory
    governor (engine/hbm.py). ``cache_root`` keeps the converted tree in
    the parameter cache (models/cache.py), keyed by the directory's
    name: a cold load converts and writes the entry, a warm one reads
    it (raising when its dtype is not ``dtype``); quantization runs
    after either."""
    dev = resolve_device(device)
    model_dir = Path(model_dir)
    hf_cfg = json.loads((model_dir / "config.json").read_text())
    encdec = is_encoder_decoder(model_dir.name, hf_cfg)
    if tokenizer is None:
        tokenizer = _auto_tokenizer(model_dir)
    if dtype is None:
        dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    if (cache_root is not None
            and cache_mod.has_cached(cache_root, model_dir.name)):
        params, cfg = cache_mod.load_params(cache_root, model_dir.name,
                                            dtype, dev)
    else:
        if encdec:
            cfg = loader.t5_config_from_hf(hf_cfg, name=str(model_dir))
            params = loader.convert_t5(load_state_dict(model_dir), cfg,
                                       dtype=dtype, device=dev)
        else:
            cfg, family = loader.config_from_hf(hf_cfg,
                                                name=str(model_dir))
            params = loader.convert_decoder(load_state_dict(model_dir),
                                            cfg, family, dtype=dtype,
                                            device=dev)
        if cache_root is not None:
            cache_mod.save_params(cache_root, model_dir.name, params, cfg,
                                  dtype)
    if kv_cache_int8:
        if encdec:
            log.warning(
                "%s: --kv-cache-int8 has no effect on encoder-decoder "
                "models (no KV cache in the seq2seq decode path); "
                "proceeding without it", model_dir.name)
        else:
            cfg = dataclasses.replace(cfg, kv_cache_int8=True)
    if quantize_int8:
        before = quant.param_bytes(params)
        qfn = (quant.quantize_encdec_params if encdec
               else quant.quantize_decoder_params)
        params = qfn(params, dynamic=int8_dynamic)
        log.info("int8-quantized %s: %.2f GB -> %.2f GB", model_dir.name,
                 before / 2**30, quant.param_bytes(params) / 2**30)
    log.info("loaded %s (%s, %s, %s)", model_dir.name,
             "enc-dec" if encdec else "decoder", dtype, dev)
    return ScoringEngine(params, cfg, tokenizer, runtime or RuntimeConfig(),
                         cascade_config=cascade_config,
                         spec_config=spec_config, device=dev,
                         encoder_decoder=encdec,
                         governor_config=governor_config)


def engine_factory(
    checkpoint_root: Path,
    runtime: Optional[RuntimeConfig] = None,
    quantize_int8: bool = False,
    int8_dynamic: bool = False,
    spec_config: Optional[SpecConfig] = None,
    cascade_config: Optional[CascadeConfig] = None,
    tokenizer=None,
    device="cuda",
    kv_cache_int8: bool = False,
    governor_config=None,
    cache_root: Optional[Path] = None,
):
    """EngineFactory for engine.multi: maps an HF repo id to
    ``checkpoint_root/<org>__<name>``, ``checkpoint_root/<name>`` or
    ``checkpoint_root/<org>/<name>``. The device is checked here, before
    any model is asked for."""
    checkpoint_root = Path(checkpoint_root)
    dev = resolve_device(device)

    def factory(model_name: str) -> ScoringEngine:
        candidates = [
            checkpoint_root / model_name.replace("/", "__"),
            checkpoint_root / model_name.split("/")[-1],
            checkpoint_root / model_name,
        ]
        for cand in candidates:
            if cand.is_dir():
                return load_engine(cand, runtime,
                                   quantize_int8=quantize_int8,
                                   int8_dynamic=int8_dynamic,
                                   spec_config=spec_config,
                                   cascade_config=cascade_config,
                                   tokenizer=tokenizer, device=dev,
                                   kv_cache_int8=kv_cache_int8,
                                   governor_config=governor_config,
                                   cache_root=cache_root)
        raise FileNotFoundError(
            f"no local checkpoint for {model_name} under {checkpoint_root} "
            f"(tried {[str(c) for c in candidates]})")

    return factory
