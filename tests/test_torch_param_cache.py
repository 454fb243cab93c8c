"""The converted-parameter cache (``models/cache.py``,
``load_engine(cache_root=)``) on a tiny llama checkpoint written by
``chip_smoke.export_hf_llama`` (fp16 shards; no transformers).

- A cold load converts and writes the entry; a warm one converts
  nothing (the converter is replaced by one that raises). The warm
  parameters are bitwise the cold ones and score the same rows, in
  bf16 and with int8 weights (quantized after each load: the entry holds
  the float tree).
- An entry of another dtype than the load asks for raises, naming both.
"""

import dataclasses

import pytest
import torch

import chip_smoke
from lir_tpu_torch.backends.fake import FakeTokenizer
from lir_tpu_torch.config import RuntimeConfig
from lir_tpu_torch.data import WORD_MEANING_QUESTIONS
from lir_tpu_torch.models import cache, decoder, factory, loader
from lir_tpu_torch.models.quant import QuantTensor
from lir_tpu_torch.models.registry import ModelConfig

CFG = ModelConfig(name="pc-tiny", vocab_size=FakeTokenizer.VOCAB,
                  hidden_size=64, n_layers=2, n_heads=4, n_kv_heads=2,
                  intermediate_size=128, max_seq_len=256)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt")
    params = decoder.init_params(CFG, seed=3, device="cpu")
    chip_smoke.export_hf_llama(params, CFG, root / "tiny__pc")
    return root / "tiny__pc"


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in sorted(tree.items()):
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, QuantTensor):
        yield f"{prefix}.q", tree.q
        yield f"{prefix}.scale", tree.scale
    else:
        yield prefix, tree


def _load(ckpt, root, **kw):
    return factory.load_engine(ckpt, RuntimeConfig(batch_size=4),
                               tokenizer=FakeTokenizer(), device="cpu",
                               cache_root=root, **kw)


def _scores(engine):
    return [dataclasses.astuple(r)
            for r in engine.score_prompts(list(WORD_MEANING_QUESTIONS[:4]))]


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_warm_load_converts_nothing_and_is_bitwise(ckpt, tmp_path,
                                                   monkeypatch, int8):
    root = tmp_path / "pc"
    kw = dict(dtype=torch.bfloat16, quantize_int8=int8)
    cold = _load(ckpt, root, **kw)
    assert cache.has_cached(root, ckpt.name)
    stored = torch.load(root / ckpt.name / cache.PARAMS_FILE,
                        weights_only=True)
    assert all(t.dtype == torch.bfloat16 for _, t in _leaves(stored))
    with monkeypatch.context() as m:
        m.setattr(loader, "convert_decoder", _no_convert)
        warm = _load(ckpt, root, **kw)
    a, b = dict(_leaves(cold.params)), dict(_leaves(warm.params))
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    assert any(isinstance(v, QuantTensor) for v in
               warm.params["layers"].values()) == int8
    assert warm.cfg == cold.cfg
    assert _scores(warm) == _scores(cold)


def test_a_dtype_mismatch_raises_naming_both(ckpt, tmp_path):
    root = tmp_path / "pc"
    _load(ckpt, root, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16.*float32"):
        _load(ckpt, root)          # the CPU's default dtype, float32


def _no_convert(*a, **kw):
    raise AssertionError("a warm load converted the checkpoint")
