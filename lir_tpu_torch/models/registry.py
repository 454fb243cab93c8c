"""Architecture registry: one ModelConfig dataclass covers every decoder-only
family the reference sweeps (reference: analysis/compare_base_vs_instruct.py:136-180,
analysis/compare_instruct_models.py:145-166) plus the T5 encoder-decoder
description (routing rule "t5|t0|tk-instruct -> Seq2Seq",
compare_instruct_models.py:471-475).

Each family is a small set of orthogonal architectural knobs run through
one functional PyTorch forward (models/decoder.py). A copy of the JAX
package's registry, so that the port carries no import of it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Unified decoder-only transformer description.

    Defaults are Llama-style; presets below override per family.
    """

    name: str = "unnamed"
    vocab_size: int = 32000
    hidden_size: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: Optional[int] = None      # None -> MHA (= n_heads); 1 -> MQA (falcon)
    head_dim: Optional[int] = None        # None -> hidden_size // n_heads
    intermediate_size: int = 11008
    max_seq_len: int = 2048

    # Position encoding
    pos_embedding: str = "rotary"         # "rotary" | "learned" | "alibi"
    rotary_pct: float = 1.0               # gpt-neox/pythia: 0.25
    rope_theta: float = 10000.0
    learned_pos_offset: int = 0           # OPT: positions start at 2

    # Normalization
    norm: str = "rmsnorm"                 # "rmsnorm" | "layernorm"
    norm_eps: float = 1e-5
    embedding_norm: bool = False          # bloom: LayerNorm right after embedding
    final_norm: bool = True

    # Block structure
    parallel_block: bool = False          # gpt-neox/falcon: h = x + attn(ln1 x) + mlp(ln2 x)
    shared_block_ln: bool = False         # falcon-7b: one LN feeds both attn and mlp

    # MLP
    activation: str = "silu"              # "silu" | "gelu" | "gelu_new" | "relu"
    gated_mlp: bool = True                # llama/mistral/qwen: silu(gate) * up

    # Biases
    qkv_bias: bool = False
    attn_out_bias: bool = False
    mlp_bias: bool = False

    # Output head
    tie_embeddings: bool = False
    logit_softcap: Optional[float] = None

    # Full-sequence prefill through the flash kernel (ops/flash_attention)
    # for lengths of at most 128 or multiples of 128; others stay dense.
    # Every 7B preset leaves it off, as in the JAX package.
    use_flash_attention: bool = False

    # Decode attention backend: single-query cached decode steps run the
    # flash-decode kernel (ops/flash_decode.py: split-K online softmax plus
    # a log-sum-exp merge). RuntimeConfig.fused_decode mirrors into this
    # field; off restores the dense decode path.
    fused_decode: bool = True

    # Cascade decode (ops/flash_decode.flash_decode_trunk): on a shared-
    # trunk dispatch the trunk splits read K/V from cache row 0 once per
    # kv head for all rows, bitwise the flat kernel. Mirrored from
    # RuntimeConfig.cascade_decode.
    cascade_decode: bool = True

    # Fused cascade prefill (ops/cascade_prefill): trunk leg, suffix leg
    # and merge in one kernel. Mirrored from
    # RuntimeConfig.cascade_fused_suffix.
    cascade_fused_suffix: bool = True

    # KV-cache storage: int8 payloads with a float32 scale per (kv head,
    # slot, row) vector, half the cache bytes. The cached attention of
    # ``extend``, ``decode_step`` and ``verify_extend`` then runs s8 x s8
    # products with the query and the value-scaled probabilities
    # quantized per vector (ops.kv_int8_attention); the prefill's own
    # attention reads the float k/v. Off by default, as in the JAX
    # package.
    kv_cache_int8: bool = False

    def __post_init__(self) -> None:
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.hidden_size // self.n_heads)
        if self.n_kv_heads is None:
            object.__setattr__(self, "n_kv_heads", self.n_heads)
        assert self.pos_embedding in ("rotary", "learned", "alibi"), self.pos_embedding
        assert self.norm in ("rmsnorm", "layernorm"), self.norm
        assert self.activation in ("silu", "gelu", "gelu_new", "relu"), self.activation
        # shared_block_ln reuses the attention LN for the MLP, which only
        # exists in falcon-style PARALLEL blocks.
        assert not (self.shared_block_ln and not self.parallel_block), (
            "shared_block_ln=True requires parallel_block=True "
            f"({self.name})")

    @property
    def rotary_dim(self) -> int:
        return int(self.head_dim * self.rotary_pct)


@dataclasses.dataclass(frozen=True)
class T5Config:
    """Encoder-decoder (T5 v1.1 / flan-t5 / T0 / tk-instruct) description."""

    name: str = "t5"
    vocab_size: int = 32128
    hidden_size: int = 512                # d_model
    n_layers: int = 8                     # per stack
    n_heads: int = 6
    head_dim: int = 64                    # d_kv (NOT hidden/heads for t5 v1.1)
    intermediate_size: int = 1024         # d_ff
    norm_eps: float = 1e-6
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    gated_mlp: bool = True                # v1.1: gelu-gated; v1.0: relu non-gated
    activation: str = "gelu_new"
    tie_embeddings: bool = False          # v1.1: untied lm_head
    decoder_start_token_id: int = 0


# ---------------------------------------------------------------------------
# Family presets — shapes are the real HF configs for the reference model zoo.
# ---------------------------------------------------------------------------

def gpt2(size: str = "small") -> ModelConfig:
    dims = {"small": (768, 12, 12), "medium": (1024, 24, 16), "large": (1280, 36, 20),
            "xl": (1600, 48, 25)}[size]
    d, l, h = dims
    return ModelConfig(
        name=f"gpt2-{size}", vocab_size=50257, hidden_size=d, n_layers=l, n_heads=h,
        intermediate_size=4 * d, max_seq_len=1024, pos_embedding="learned",
        norm="layernorm", activation="gelu_new", gated_mlp=False,
        qkv_bias=True, attn_out_bias=True, mlp_bias=True, tie_embeddings=True,
    )


def gptneox(name: str = "pythia-6.9b", *, hidden: int = 4096, layers: int = 32,
            heads: int = 32, vocab: int = 50432, rotary_pct: float = 0.25,
            inter: Optional[int] = None, max_seq: int = 2048) -> ModelConfig:
    """Pythia / dolly-v2 / stablelm-alpha / RedPajama-INCITE / h2ogpt family."""
    return ModelConfig(
        name=name, vocab_size=vocab, hidden_size=hidden, n_layers=layers, n_heads=heads,
        intermediate_size=inter if inter is not None else 4 * hidden, max_seq_len=max_seq,
        pos_embedding="rotary", rotary_pct=rotary_pct, norm="layernorm",
        activation="gelu", gated_mlp=False, parallel_block=True,
        qkv_bias=True, attn_out_bias=True, mlp_bias=True,
    )


def llama2_7b() -> ModelConfig:
    return ModelConfig(name="llama-2-7b", vocab_size=32000, hidden_size=4096,
                       n_layers=32, n_heads=32, intermediate_size=11008,
                       max_seq_len=4096, use_flash_attention=False)


def mistral_7b() -> ModelConfig:
    return ModelConfig(name="mistral-7b", vocab_size=32000, hidden_size=4096,
                       n_layers=32, n_heads=32, n_kv_heads=8, intermediate_size=14336,
                       max_seq_len=4096, use_flash_attention=False)


def qwen_7b() -> ModelConfig:
    # Qwen-7B (v1): llama-like but qkv bias and vocab 151936.
    return ModelConfig(name="qwen-7b", vocab_size=151936, hidden_size=4096,
                       n_layers=32, n_heads=32, intermediate_size=11008,
                       max_seq_len=2048, qkv_bias=True, norm_eps=1e-6,
                       use_flash_attention=False)


def pythia_69b() -> ModelConfig:
    """EleutherAI/pythia-6.9b at real size (gptneox: partial rotary 0.25,
    parallel block, LayerNorm) — the base half of the dolly-v2 pair
    (compare_base_vs_instruct.py:136-180)."""
    return gptneox(name="pythia-6.9b")


def h2ogpt_12b() -> ModelConfig:
    """h2oai/h2ogpt-oasst1-512-12b — the reference zoo's largest model
    (compare_instruct_models.py:145-166). Pythia-12b architecture:
    gptneox with hidden 5120 / 36 layers / 40 heads / vocab 50688."""
    return gptneox(name="h2ogpt-oasst1-512-12b", hidden=5120, layers=36,
                   heads=40, vocab=50688)


def baichuan2_7b() -> ModelConfig:
    return ModelConfig(name="baichuan2-7b", vocab_size=125696, hidden_size=4096,
                       n_layers=32, n_heads=32, intermediate_size=11008,
                       max_seq_len=4096, use_flash_attention=False)


def falcon_7b() -> ModelConfig:
    return ModelConfig(
        name="falcon-7b", vocab_size=65024, hidden_size=4544, n_layers=32,
        n_heads=71, n_kv_heads=1, intermediate_size=4 * 4544, max_seq_len=2048,
        pos_embedding="rotary", norm="layernorm", activation="gelu", gated_mlp=False,
        parallel_block=True, shared_block_ln=True, tie_embeddings=True,
        use_flash_attention=False,
    )


def bloom_7b1() -> ModelConfig:
    return ModelConfig(
        name="bloom-7b1", vocab_size=250880, hidden_size=4096, n_layers=30,
        n_heads=32, intermediate_size=4 * 4096, max_seq_len=2048,
        pos_embedding="alibi", norm="layernorm", activation="gelu_new", gated_mlp=False,
        embedding_norm=True, qkv_bias=True, attn_out_bias=True, mlp_bias=True,
        tie_embeddings=True, use_flash_attention=False,
    )


def opt(name: str = "opt-iml-1.3b") -> ModelConfig:
    return ModelConfig(
        name=name, vocab_size=50272, hidden_size=2048, n_layers=24, n_heads=32,
        intermediate_size=8192, max_seq_len=2048, pos_embedding="learned",
        learned_pos_offset=2, norm="layernorm", activation="relu", gated_mlp=False,
        qkv_bias=True, attn_out_bias=True, mlp_bias=True, tie_embeddings=True,
    )


def t5_v1_1(size: str = "base") -> T5Config:
    dims = {"small": (512, 8, 6, 1024), "base": (768, 12, 12, 2048),
            "large": (1024, 24, 16, 2816), "xl": (2048, 24, 32, 5120)}[size]
    d, l, h, ff = dims
    return T5Config(name=f"t5-v1_1-{size}", hidden_size=d, n_layers=l, n_heads=h,
                    intermediate_size=ff)


def flan_t5(size: str = "base") -> T5Config:
    cfg = t5_v1_1(size)
    return dataclasses.replace(cfg, name=f"flan-t5-{size}")


def t0_3b() -> T5Config:
    return T5Config(name="T0_3B", hidden_size=2048, n_layers=24, n_heads=32,
                    intermediate_size=5120)


# Tiny configs for tests.
def tiny(family: str) -> ModelConfig:
    base = dict(vocab_size=256, hidden_size=64, n_layers=2, n_heads=4,
                intermediate_size=128, max_seq_len=128)
    if family == "gpt2":
        return ModelConfig(name="tiny-gpt2", pos_embedding="learned", norm="layernorm",
                           activation="gelu_new", gated_mlp=False, qkv_bias=True,
                           attn_out_bias=True, mlp_bias=True, tie_embeddings=True, **base)
    if family == "gptneox":
        return ModelConfig(name="tiny-gptneox", pos_embedding="rotary", rotary_pct=0.25,
                           norm="layernorm", activation="gelu", gated_mlp=False,
                           parallel_block=True, qkv_bias=True, attn_out_bias=True,
                           mlp_bias=True, **base)
    if family == "llama":
        return ModelConfig(name="tiny-llama", **base)
    if family == "mistral":
        return ModelConfig(name="tiny-mistral", n_kv_heads=2, **base)
    if family == "falcon":
        return ModelConfig(name="tiny-falcon", pos_embedding="rotary", norm="layernorm",
                           activation="gelu", gated_mlp=False, parallel_block=True,
                           shared_block_ln=True, n_kv_heads=1, tie_embeddings=True, **base)
    if family == "bloom":
        return ModelConfig(name="tiny-bloom", pos_embedding="alibi", norm="layernorm",
                           activation="gelu_new", gated_mlp=False, embedding_norm=True,
                           qkv_bias=True, attn_out_bias=True, mlp_bias=True,
                           tie_embeddings=True, **base)
    if family == "opt":
        return ModelConfig(name="tiny-opt", pos_embedding="learned", learned_pos_offset=2,
                           norm="layernorm", activation="relu", gated_mlp=False,
                           qkv_bias=True, attn_out_bias=True, mlp_bias=True,
                           tie_embeddings=True, **base)
    raise KeyError(family)


REGISTRY = {
    "gpt2": gpt2, "gptneox": gptneox, "llama2-7b": llama2_7b,
    "mistral-7b": mistral_7b, "qwen-7b": qwen_7b, "baichuan2-7b": baichuan2_7b,
    "falcon-7b": falcon_7b, "bloom-7b1": bloom_7b1, "opt": opt,
    "t5-v1_1": t5_v1_1, "flan-t5": flan_t5, "t0-3b": t0_3b,
}
