"""The port's rephraser against the JAX package's, on the CPU.

- ``parse_numbered_rephrasings`` equals the JAX parser over a corpus of
  edge cases (preambles, "N. text", "N text", continuation lines, blanks).
- ``generate_rephrasings`` through ``load_or_generate_perturbations``
  (default key ``prng_key(42)``) writes JAX's ``perturbations.json`` byte
  for byte: with a scripted rephraser whose texts depend on the key it
  is handed (so the per-batch ``split`` chain must be JAX's), with
  failing batches skipped in both orders (pipelined ``dispatch`` /
  ``fetch`` and synchronous), and with a real tiny model through
  ``rephraser_from_engine`` (temperature 0.9, EOS stop armed).
- ``python -m lir_tpu_torch rephrase --device cpu --sessions 2
  --per-session 3`` on a tiny llama checkpoint (float32 safetensors of
  seeded weights, a trained byte-level BPE tokenizer)
  writes the file ``python -m lir_tpu rephrase`` writes. Both commands
  run over the first two legal prompts (the prompt list patched in both
  packages), each sampling 512 tokens a session, which keeps the test
  inside its time.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

import lir_tpu.cli as jcli
import lir_tpu.data.prompts as jprompts
from lir_tpu.backends.fake import FakeTokenizer as JaxFakeTokenizer
from lir_tpu.config import RuntimeConfig as JaxRuntimeConfig
from lir_tpu.data.prompts import LegalPrompt as JaxLegalPrompt
from lir_tpu.engine import rephrase as jreph
from lir_tpu.engine.runner import ScoringEngine as JaxEngine
from lir_tpu.models.registry import ModelConfig as JaxModelConfig
import lir_tpu_torch.data.prompts as tprompts
from lir_tpu_torch import cli
from lir_tpu_torch.backends.fake import FakeTokenizer
from lir_tpu_torch.config import PerturbationConfig, RuntimeConfig
from lir_tpu_torch.data import LEGAL_PROMPTS, LegalPrompt
from lir_tpu_torch.engine import rephrase as treph
from lir_tpu_torch.engine.runner import ScoringEngine
from lir_tpu_torch.models import decoder, registry
from lir_tpu_torch.models.convert import params_from_jax
from lir_tpu_torch.models.registry import ModelConfig

from test_torch_sample import CFG, seeded_tree

JAX_LEGAL = [JaxLegalPrompt(main=p.main, response_format=p.response_format,
                            target_tokens=p.target_tokens,
                            confidence_format=p.confidence_format)
             for p in LEGAL_PROMPTS]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's tiny launch-bound ops: on a host whose cores are busy
    with other test workers, torch's intra-op thread team makes them many
    times slower. The module runs on one thread and gives the count
    back."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

PARSE_CASES = [
    "Here are 3 rephrasings:\n1. First one.\n2. Second. With a dot\n"
    "3 Third without one\n",
    "1) paren style\n2- dash style\n10. ten\n11\tTab",
    "A preamble line\n1. a\ncontinued line\n\n2. b\n  more of b  ",
    "",
    "\n\n   \n",
    "HERE ARE the variants\n  4.  spaced  \n5 - dashed",
    "1.\n2. \n3",
    "no numbers at all\nsecond line",
    "3.14 is pi\n1984 was a year\nhere are not skipped? yes they are",
    "<12> <7> <3>\n<5>",
]


@pytest.mark.parametrize("text", PARSE_CASES)
def test_parse_numbered_rephrasings_is_jax(text):
    assert (treph.parse_numbered_rephrasings(text)
            == jreph.parse_numbered_rephrasings(text))


def test_perturbation_config_is_jax():
    from lir_tpu.config import PerturbationConfig as JaxPerturbationConfig

    ref = JaxPerturbationConfig()
    for name in ("sessions_per_prompt", "rephrasings_per_session",
                 "rephrase_temperature", "seed"):
        assert getattr(PerturbationConfig(), name) == getattr(ref, name)


class Script:
    """A rephraser whose texts depend on the key words it is handed and
    on the call count; call ``fail_dispatch`` raises in ``dispatch`` (or
    the plain call), call ``fail_fetch`` in ``fetch``."""

    def __init__(self, pipelined: bool, fail_dispatch=2, fail_fetch=4):
        self.calls = self.fetches = 0
        self.fail_dispatch, self.fail_fetch = fail_dispatch, fail_fetch
        if pipelined:
            self.dispatch, self.fetch = self._dispatch, self._fetch

    def _texts(self, texts, key):
        k0, k1 = (int(x) for x in np.asarray(key).reshape(-1))
        return [f"Here are some rephrasings:\n1. {len(t.split())} a {k0}\n"
                f"2 b {k1 % 1000}\ncontinued {i}\n\n3.c {self.calls}"
                for i, t in enumerate(texts)]

    def _dispatch(self, texts, key):
        self.calls += 1
        if self.calls == self.fail_dispatch:
            raise RuntimeError("scripted dispatch failure")
        return self._texts(texts, key)

    def _fetch(self, handle):
        self.fetches += 1
        if self.fetches == self.fail_fetch:
            raise RuntimeError("scripted fetch failure")
        return handle

    def __call__(self, texts, key):
        return self._dispatch(texts, key)


@pytest.mark.parametrize("pipelined", [True, False],
                         ids=["pipelined", "synchronous"])
def test_scripted_rephraser_writes_the_jax_file(tmp_path, pipelined):
    """Two prompts x 10 sessions (batches of 8 and 2), a failing batch
    skipped in each package: the same perturbations.json."""
    kw = dict(sessions_per_prompt=10, rephrasings_per_session=4)
    ref = jreph.load_or_generate_perturbations(
        tmp_path / "jax.json", JAX_LEGAL[:2], Script(pipelined), **kw)
    got = treph.load_or_generate_perturbations(
        tmp_path / "port.json", LEGAL_PROMPTS[:2], Script(pipelined), **kw)
    assert got == ref
    assert ((tmp_path / "port.json").read_bytes()
            == (tmp_path / "jax.json").read_bytes())
    assert 0 < len(got[0][1]) < 10 * 3    # a batch was skipped


@pytest.fixture(scope="module")
def tiny_engines():
    cfg_j = JaxModelConfig(**CFG)
    tree = seeded_tree(cfg_j)
    jeng = JaxEngine(jax.tree.map(jax.numpy.asarray, tree), cfg_j,
                     JaxFakeTokenizer(), JaxRuntimeConfig(
                         batch_size=4, spec_decode=False,
                         piggyback_prefill=False, prefix_cache=False,
                         aot_precompile=False))
    cfg_t = ModelConfig(**CFG)
    teng = ScoringEngine(params_from_jax(tree, cfg_t, device="cpu"), cfg_t,
                         FakeTokenizer(), RuntimeConfig(batch_size=4,
                                                        spec_decode=False),
                         device="cpu")
    return jeng, teng


SHORT = [LegalPrompt(main=f"Is a {w} a vehicle under the rule ?",
                     response_format="Answer Yes or No .",
                     target_tokens=("Yes", "No"),
                     confidence_format="Give a number .")
         for w in ("bicycle", "skateboard")]
JAX_SHORT = [JaxLegalPrompt(main=p.main, response_format=p.response_format,
                            target_tokens=p.target_tokens,
                            confidence_format=p.confidence_format)
             for p in SHORT]


@pytest.mark.parametrize("pipelined", [True, False],
                         ids=["pipelined", "synchronous"])
def test_tiny_model_rephraser_writes_the_jax_file(tiny_engines, tmp_path,
                                                  pipelined):
    """rephraser_from_engine on the same tiny weights (8 new tokens, the
    EOS stop armed): the same sampled texts and file, through the
    closure's dispatch / fetch pair or called as a plain function."""
    jeng, teng = tiny_engines
    jgen = jreph.rephraser_from_engine(jeng, max_new_tokens=8)
    tgen = treph.rephraser_from_engine(teng, max_new_tokens=8)
    if not pipelined:
        jgen_call, tgen_call = jgen, tgen
        jgen = lambda texts, key: jgen_call(texts, key)  # noqa: E731
        tgen = lambda texts, key: tgen_call(texts, key)  # noqa: E731
    kw = dict(sessions_per_prompt=3, rephrasings_per_session=4)
    ref = jreph.load_or_generate_perturbations(tmp_path / "jax.json",
                                               JAX_SHORT, jgen, **kw)
    got = treph.load_or_generate_perturbations(tmp_path / "port.json",
                                               SHORT, tgen, **kw)
    assert got == ref and all(len(r) == 3 for _, r in got)
    assert ((tmp_path / "port.json").read_bytes()
            == (tmp_path / "jax.json").read_bytes())


def write_tiny_llama(path, vocab: int, seed: int = 3) -> None:
    """A float32 HF llama checkpoint (``config.json`` and one safetensors
    file, HF names and (out, in) layouts) of seeded random weights."""
    from safetensors.torch import save_file

    cfg = dataclasses.replace(registry.tiny("llama"), vocab_size=vocab,
                              max_seq_len=1024, tie_embeddings=False)
    p = decoder.init_params(cfg, seed=seed, device="cpu")
    lay = p["layers"]
    tensors = {"model.embed_tokens.weight": p["tok_embed"],
               "model.norm.weight": p["final_ln"]["scale"],
               "lm_head.weight": p["lm_head"].T}
    for i in range(cfg.n_layers):
        pre = f"model.layers.{i}."
        tensors[pre + "input_layernorm.weight"] = lay["ln1"]["scale"][i]
        tensors[pre + "post_attention_layernorm.weight"] = \
            lay["ln2"]["scale"][i]
        for name, key in (("self_attn.q_proj", "wq"), ("self_attn.k_proj", "wk"),
                          ("self_attn.v_proj", "wv"), ("self_attn.o_proj", "wo"),
                          ("mlp.gate_proj", "w_gate"), ("mlp.up_proj", "w_up"),
                          ("mlp.down_proj", "w_down")):
            tensors[pre + name + ".weight"] = lay[key][i].T
    path.mkdir(parents=True)
    save_file({k: v.contiguous() for k, v in tensors.items()},
              str(path / "model.safetensors"))
    (path / "config.json").write_text(json.dumps({
        "architectures": ["LlamaForCausalLM"], "model_type": "llama",
        "vocab_size": vocab, "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size,
        "num_hidden_layers": cfg.n_layers,
        "num_attention_heads": cfg.n_heads,
        "num_key_value_heads": cfg.n_kv_heads,
        "max_position_embeddings": cfg.max_seq_len,
        "rms_norm_eps": cfg.norm_eps, "rope_theta": cfg.rope_theta,
        "hidden_act": "silu", "tie_word_embeddings": False,
        "torch_dtype": "float32"}))


def test_rephrase_command_writes_the_jax_file(tmp_path, monkeypatch):
    """``rephrase`` in both CLIs on one tiny llama checkpoint: the same
    perturbations.json (512 sampled tokens a session, two sessions of
    three rephrasings for each of the first two legal prompts)."""
    from tiny_checkpoints import build_bpe_tokenizer

    fast = build_bpe_tokenizer()
    model = tmp_path / "ckpt" / "tiny__llama-bpe"
    write_tiny_llama(model, len(fast))
    fast.save_pretrained(model)
    monkeypatch.setattr(jprompts, "LEGAL_PROMPTS", jprompts.LEGAL_PROMPTS[:2])
    monkeypatch.setattr(tprompts, "LEGAL_PROMPTS", tprompts.LEGAL_PROMPTS[:2])
    argv = ["rephrase", "--checkpoints", str(tmp_path / "ckpt"), "--model",
            "tiny/llama-bpe", "--sessions", "2", "--per-session", "3"]
    jcli.main(argv + ["--out", str(tmp_path / "jax.json")])
    cli.main(argv + ["--out", str(tmp_path / "port.json"), "--device", "cpu"])
    port = (tmp_path / "port.json").read_bytes()
    assert port == (tmp_path / "jax.json").read_bytes()
    assert [e["original_main"] for e in json.loads(port)] == \
        [p.main for p in LEGAL_PROMPTS[:2]]
