"""int8 weights for the linear layers of the decoder and of T5.

Port of ``lir_tpu/models/quant.py``. The reference's
8-bit mode is bitsandbytes ``BitsAndBytesConfig(load_in_8bit=True)``
(compare_base_vs_instruct.py:431-435). Here, as in the JAX package, the
big matrices are symmetric per-output-channel int8 with float32 scales,
in two modes:

- **weight-only** (``QuantTensor.dynamic`` False): the activation keeps
  its dtype and the product is ``(x @ q) * scale``;
- **dynamic** (True): the activation is quantized per token on the fly
  by the same amax / 127 rule and the product runs s8 x s8 -> s32, the
  analogue of LLM.int8()'s vector-wise quantization without its fp16
  outlier columns. On a card the s32 product is ``torch._int_mm``
  (the JAX package leaves this product to XLA, outside any Pallas
  kernel); on the CPU an int32 ``matmul`` of the payloads gives the same
  exact s32.

Quantization rounds bitwise as the JAX package does: IEEE division by
the scale, round half to even, clip to +-127.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from ..device import resolve_device

Params = Dict[str, Any]


@dataclasses.dataclass
class QuantTensor:
    """Symmetric per-output-channel int8 weight: w ~ q * scale.

    q: int8, the weight's shape (..., D_in, D_out); scale: float32
    (..., D_out). ``dynamic``: quantize the activation per token and run
    the product s8 x s8 -> s32 (see :func:`matmul`)."""

    q: torch.Tensor
    scale: torch.Tensor
    dynamic: bool = False

    @property
    def shape(self):
        return self.q.shape

    def __getitem__(self, i) -> "QuantTensor":
        """Index the leading (layer) axis of payload and scales together."""
        return QuantTensor(q=self.q[i], scale=self.scale[i],
                           dynamic=self.dynamic)


def _scale_of(amax: torch.Tensor) -> torch.Tensor:
    """max(amax, 1e-8) / 127 as an IEEE division on every device. (With a
    Python-number divisor PyTorch's CUDA kernel multiplies by the
    reciprocal instead, which differs in the last bit for some amax.)"""
    return torch.clamp_min(amax, 1e-8) / torch.full(
        (), 127.0, dtype=amax.dtype, device=amax.device)


def quantize(w: torch.Tensor) -> QuantTensor:
    """Quantize a (..., D_in, D_out) weight to int8 with per-output-column
    scales (amax / 127, zero-safe)."""
    wf = w.float()
    scale = _scale_of(wf.abs().amax(dim=-2))
    q = torch.clamp(torch.round(wf / scale[..., None, :]), -127, 127)
    return QuantTensor(q=q.to(torch.int8), scale=scale)


def dynamic_quant(x: torch.Tensor):
    """Symmetric per-vector int8 quantization over the LAST axis:
    x (..., D) -> (int8 payload (..., D), float32 scale (...)), amax / 127
    with a zero-safe floor. The one rule for activations (:func:`matmul`)
    and for the int8 QK^T of the cascade's trunk leg."""
    xf = x.float()
    scale = _scale_of(xf.abs().amax(dim=-1))
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


@dataclasses.dataclass
class QuantActivation:
    """A pre-quantized activation: the :func:`dynamic_quant` pair plus
    the dtype of the activation it came from. :func:`matmul` takes it
    wherever a dynamic QuantTensor is the weight, so one activation
    multiplied against several dynamic matrices (wq/wk/wv, w_up/w_gate)
    is quantized once (:func:`shared_quant`), with the same result."""

    q: torch.Tensor       # int8 (..., D)
    scale: torch.Tensor   # float32 (...)
    out_dtype: torch.dtype = torch.float32

    @classmethod
    def make(cls, x: torch.Tensor) -> "QuantActivation":
        xq, xs = dynamic_quant(x)
        return cls(q=xq, scale=xs, out_dtype=x.dtype)


def shared_quant(x: torch.Tensor, *weights):
    """Pre-quantize ``x`` once when EVERY weight it will multiply is a
    dynamic QuantTensor; pass it through untouched otherwise."""
    if weights and all(isinstance(w, QuantTensor) and w.dynamic
                       for w in weights):
        return QuantActivation.make(x)
    return x


# torch._int_mm's conditions on CUDA: more than 16 rows, inner and outer
# sizes multiples of 8.
_INT_MM_MIN_ROWS = 17
_INT_MM_MULTIPLE = 8


def int8_dot(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """(..., D_in) int8 x (D_in, D_out) int8 -> (..., D_out) int32, exact.

    On a card: ``torch._int_mm``, its rows padded past 16 and sliced
    back; a width it cannot take raises (there is no float fallback). On
    the CPU: an int32 ``matmul`` of the payloads."""
    lead = xq.shape[:-1]
    d_in, d_out = wq.shape
    if xq.shape[-1] != d_in:
        raise ValueError(f"int8 product of {tuple(xq.shape)} and {tuple(wq.shape)}")
    x2 = xq.reshape(-1, d_in)
    if xq.device.type == "cpu":
        y = torch.matmul(x2.to(torch.int32), wq.to(torch.int32))
        return y.reshape(*lead, d_out)
    if xq.device.type != "cuda":
        raise ValueError(f"int8 product needs CPU or CUDA tensors, got {xq.device}")
    if d_in % _INT_MM_MULTIPLE or d_out % _INT_MM_MULTIPLE:
        raise ValueError(
            f"torch._int_mm needs inner and outer sizes that are multiples "
            f"of {_INT_MM_MULTIPLE}, got ({d_in}, {d_out})")
    m = x2.shape[0]
    if m < _INT_MM_MIN_ROWS:
        x2 = torch.cat([x2, x2.new_zeros((_INT_MM_MIN_ROWS - m, d_in))])
    y = torch._int_mm(x2.contiguous(), wq.contiguous())[:m]
    return y.reshape(*lead, d_out)


def matmul(x, w) -> torch.Tensor:
    """x @ w for dense or QuantTensor weights: (..., D_in) x (D_in, D_out).

    - dynamic QuantTensor: s8 x s8 -> s32 (:func:`int8_dot`) on the
      activation quantized per token (or the payload of a
      :class:`QuantActivation`), scales folded on the s32 output in the
      JAX order ``(y32 * x_scale) * w_scale``;
    - weight-only QuantTensor: ``(x @ q) * scale`` in the activation
      dtype, the scale rounded to that dtype first;
    - dense: ``x @ w``.
    """
    if isinstance(w, QuantTensor):
        if isinstance(x, QuantActivation):
            if not w.dynamic:
                raise TypeError("a QuantActivation needs a dynamic weight")
            y = int8_dot(x.q, w.q)
            return (y.float() * x.scale[..., None] * w.scale).to(x.out_dtype)
        if w.dynamic:
            xq, xs = dynamic_quant(x)
            y = int8_dot(xq, w.q)
            return (y.float() * xs[..., None] * w.scale).to(x.dtype)
        y = torch.matmul(x, w.q.to(x.dtype))
        return y * w.scale.to(x.dtype)
    if isinstance(x, QuantActivation):
        # A dense weight with a pre-quantized activation means a call site
        # mis-grouped its weights: dequantize rather than change the
        # weight's semantics.
        x = (x.q.float() * x.scale[..., None]).to(x.out_dtype)
    return torch.matmul(x, w)


# The per-layer matrices worth quantizing (biases and norms stay dense).
LAYER_MATRICES = ("wq", "wk", "wv", "wo", "w_up", "w_gate", "w_down")
# The T5 stacks' matrices (models/encdec.py; norms and the relative-position
# embeddings stay dense).
ENCDEC_MATRICES = ("wq", "wk", "wv", "wo", "wi", "wi_0", "wi_1", "wo_mlp",
                   "cq", "ck", "cv", "co")


def _quantize_block(blk: Params, names, dynamic: bool) -> Params:
    """A shallow copy of a stacked subtree with the named matrices
    quantized (tagged ``dynamic``): the one rule of the decoder and T5
    trees."""
    out = dict(blk)
    for name in names:
        if name in out:
            out[name] = dataclasses.replace(quantize(out[name]),
                                            dynamic=dynamic)
    return out


def quantize_decoder_params(params: Params, dynamic: bool = False) -> Params:
    """Quantize the big linear weights of a decoder param tree (the
    stacked layer matrices and the lm_head); everything else passes
    through. ``dynamic`` tags the LAYER matrices only: the lm_head stays
    weight-only, since its float32 activations feed the logit readout
    directly, and tied embeddings stay dense."""
    out = dict(params)
    out["layers"] = _quantize_block(params["layers"], LAYER_MATRICES, dynamic)
    if "lm_head" in params:
        out["lm_head"] = quantize(params["lm_head"])
    return out


def quantize_encdec_params(params: Params, dynamic: bool = False) -> Params:
    """Quantize a T5 param tree (models/encdec.py layout) by the decoder's
    rules: both stacks' matrices, optionally dynamic; the lm_head
    weight-only; a tied v1.0 embedding stays dense. The reference loads
    its t5/T0/tk-instruct models through the same 8-bit config as the
    decoders (compare_base_vs_instruct.py:431-435)."""
    out = dict(params)
    for side in ("encoder", "decoder"):
        out[side] = _quantize_block(params[side], ENCDEC_MATRICES, dynamic)
    if "lm_head" in params:
        out["lm_head"] = quantize(params["lm_head"])
    return out


def init_quantized_params(cfg, seed: int = 0, device="cuda",
                          dtype=torch.bfloat16, dynamic: bool = False) -> Params:
    """Random param tree at full size with the big matrices born int8:
    the counterpart of the JAX package's ``random_quantized_params``.

    Each quantized leaf is a uniform int8 payload in [-127, 127] drawn on
    ``device`` from a seeded ``torch.Generator``, with the constant scale
    0.02 / 127; every other leaf (norms and biases included, as in the
    JAX function) is 0.02 * normal in ``dtype``. No float copy of a
    quantized matrix is ever made, so peak memory is the int8 footprint.
    The tree has the layout of :func:`quantize_decoder_params` applied to
    ``decoder.init_params``."""
    from .decoder import param_tree

    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    quant_names = set(LAYER_MATRICES) | {"lm_head"}

    def leaf(name, shape, kind):
        if name in quant_names:
            q = torch.randint(-127, 128, shape, generator=gen, device=dev,
                              dtype=torch.int8)
            scale = torch.full(tuple(shape[:-2]) + tuple(shape[-1:]),
                               0.02 / 127.0, dtype=torch.float32, device=dev)
            return QuantTensor(q=q, scale=scale,
                               dynamic=dynamic and name != "lm_head")
        x = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        return x.mul_(0.02).to(dtype)

    return param_tree(cfg, leaf)


def param_bytes(params) -> int:
    """Total payload bytes of a param tree (QuantTensor-aware)."""
    if isinstance(params, dict):
        return sum(param_bytes(v) for v in params.values())
    if isinstance(params, QuantTensor):
        return param_bytes(params.q) + param_bytes(params.scale)
    return params.numel() * params.element_size()
