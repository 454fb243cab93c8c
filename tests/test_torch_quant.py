"""The port's int8 weights (``lir_tpu_torch.models.quant``) against the
JAX package's ``lir_tpu.models.quant``.

The same numpy inputs, made from a seed, go through both. Quantized
payloads and scales must be BITWISE the JAX package's (IEEE division,
round half to even, clip). The products: the dynamic route's s32 dot is
exact on both sides, so float32 results agree to float rounding of the
two scale products (atol = rtol = 1e-6); bf16 results within one bf16
ulp of the output (rtol = 1e-2). The weight-only route contracts in the
activation dtype, whose sums run in another order in the two frameworks
(float32: 1e-5; bf16: 2e-2 relative, a bf16 ulp or two).
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from lir_tpu.models import decoder as jdec
from lir_tpu.models import quant as jq
from lir_tpu.models import registry as jreg
from lir_tpu_torch.models import decoder as tdec
from lir_tpu_torch.models import quant as tq
from lir_tpu_torch.models import registry as treg
from lir_tpu_torch.models.convert import params_from_jax

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# (atol, rtol) of the products, by route and dtype (module docstring).
TOL = {("dynamic", "float32"): (1e-6, 1e-6),
       ("dynamic", "bfloat16"): (1e-6, 1e-2),
       ("weight_only", "float32"): (1e-5, 1e-5),
       ("weight_only", "bfloat16"): (1e-3, 2e-2)}


def _weights(seed, shape, dtype="float32"):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(shape).astype(np.float32)
    w[..., 0, 1] = 0.0
    w[..., :, 2] = 0.0                     # an all-zero column: the 1e-8 floor
    if dtype == "bfloat16":
        w = w.astype(ml_dtypes.bfloat16)
    return w


def _torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _numpy(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", [(16, 24), (3, 16, 24)])
def test_quantize_bitwise(shape, dtype):
    w = _weights(0, shape, dtype)
    ref = jq.quantize(jnp.asarray(w))
    got = tq.quantize(_torch(w))
    assert got.q.dtype == torch.int8 and got.scale.dtype == torch.float32
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(ref.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(ref.scale))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_dynamic_quant_bitwise(dtype):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((4, 5, 32)) * 3).astype(np.float32)
    x[0, 0] = 0.0                           # an all-zero vector
    x[1, 2, :] = np.round(x[1, 2, :])       # exact multiples of the scale
    if dtype == "bfloat16":
        x = x.astype(ml_dtypes.bfloat16)
    qj, sj = jq.dynamic_quant(jnp.asarray(x))
    qt, st = tq.dynamic_quant(_torch(x))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def _activation(seed, dtype, shape=(2, 3, 16)):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    return x.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else x


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("route", ["dynamic", "weight_only"])
def test_matmul_matches_jax(route, dtype):
    _, tdt = DTYPES[dtype]
    w = _weights(2, (16, 24))
    x = _activation(3, dtype)
    dyn = route == "dynamic"
    wj = dataclasses.replace(jq.quantize(jnp.asarray(w)), dynamic=dyn)
    wt = dataclasses.replace(tq.quantize(_torch(w)), dynamic=dyn)
    ref = jq.matmul(jnp.asarray(x), wj)
    got = tq.matmul(_torch(x), wt)
    assert got.dtype == tdt and str(ref.dtype) == dtype
    atol, rtol = TOL[(route, dtype)]
    np.testing.assert_allclose(_numpy(got), np.asarray(ref, np.float32),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_shared_quant_matches_jax(dtype):
    """One pre-quantized activation against three dynamic weights: the
    QuantActivation payload is bitwise, and each product equals the
    per-matrix product exactly (the same quantization)."""
    x = _activation(4, dtype)
    ws = [_weights(5 + i, (16, 8 * (i + 1))) for i in range(3)]
    wj = [dataclasses.replace(jq.quantize(jnp.asarray(w)), dynamic=True)
          for w in ws]
    wt = [dataclasses.replace(tq.quantize(_torch(w)), dynamic=True)
          for w in ws]
    aj = jq.shared_quant(jnp.asarray(x), *wj)
    at = tq.shared_quant(_torch(x), *wt)
    assert isinstance(at, tq.QuantActivation)
    np.testing.assert_array_equal(at.q.numpy(), np.asarray(aj.q))
    np.testing.assert_array_equal(at.scale.numpy(), np.asarray(aj.scale))
    atol, rtol = TOL[("dynamic", dtype)]
    for a, b, w in zip(wj, wt, ws):
        got = tq.matmul(at, b)
        assert torch.equal(got, tq.matmul(_torch(x), b))
        np.testing.assert_allclose(_numpy(got),
                                   np.asarray(jq.matmul(aj, a), np.float32),
                                   atol=atol, rtol=rtol)
    # A weight-only weight among them: the activation passes through.
    plain = tq.shared_quant(_torch(x), wt[0], tq.quantize(_torch(ws[1])))
    assert isinstance(plain, torch.Tensor)


def test_int8_dot_is_exact_on_cpu():
    rng = np.random.default_rng(6)
    a = rng.integers(-127, 128, (5, 4, 4096), dtype=np.int8)
    b = rng.integers(-127, 128, (4096, 24), dtype=np.int8)
    got = tq.int8_dot(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), a.astype(np.int64) @ b.astype(np.int64))


@pytest.mark.parametrize("family", ["llama", "falcon"])
@pytest.mark.parametrize("dynamic", [False, True])
def test_quantize_decoder_params_tree(family, dynamic):
    """The port's tree has the JAX tree's structure: the layer matrices
    quantized and tagged ``dynamic``, the lm_head weight-only, tied
    embeddings and norms dense; payloads bitwise."""
    cfg_j, cfg_t = jreg.tiny(family), treg.tiny(family)
    pj = jax.tree.map(np.asarray, jdec.init_params(cfg_j, jax.random.PRNGKey(0)))
    qj = jq.quantize_decoder_params(jax.tree.map(jnp.asarray, pj),
                                    dynamic=dynamic)
    qt = tq.quantize_decoder_params(params_from_jax(pj, cfg_t, device="cpu"),
                                    dynamic=dynamic)
    assert set(qt) == set(qj) and set(qt["layers"]) == set(qj["layers"])
    for name, leaf in qj["layers"].items():
        got = qt["layers"][name]
        if isinstance(leaf, jq.QuantTensor):
            assert isinstance(got, tq.QuantTensor) and got.dynamic == dynamic
            np.testing.assert_array_equal(got.q.numpy(), np.asarray(leaf.q))
            np.testing.assert_array_equal(got.scale.numpy(),
                                          np.asarray(leaf.scale))
        else:
            assert not isinstance(got, tq.QuantTensor), name
    assert isinstance(qt["tok_embed"], torch.Tensor)
    if "lm_head" in qj:
        assert isinstance(qt["lm_head"], tq.QuantTensor)
        assert not qt["lm_head"].dynamic
    assert tq.param_bytes(qt) == jq.param_bytes(qj)


def test_params_from_jax_takes_a_quantized_tree():
    cfg_j, cfg_t = jreg.tiny("mistral"), treg.tiny("mistral")
    qj = jq.quantize_decoder_params(
        jdec.init_params(cfg_j, jax.random.PRNGKey(1)), dynamic=True)
    tree = jax.tree.map(np.asarray, qj)
    pt = params_from_jax(tree, cfg_t, device="cpu")
    wq = pt["layers"]["wq"]
    assert isinstance(wq, tq.QuantTensor) and wq.dynamic
    assert wq.q.dtype == torch.int8 and wq.scale.dtype == torch.float32
    np.testing.assert_array_equal(wq.q.numpy(), np.asarray(qj["layers"]["wq"].q))
    head = pt["lm_head"]
    assert isinstance(head, tq.QuantTensor) and not head.dynamic
    # A layer slice takes payload and scales together.
    layer1 = tdec._layer(pt["layers"], 1)["wq"]
    assert torch.equal(layer1.q, wq.q[1]) and torch.equal(layer1.scale,
                                                          wq.scale[1])


@pytest.mark.parametrize("dynamic", [False, True])
def test_init_quantized_params_layout(dynamic):
    """init_quantized_params gives quantize_decoder_params' layout of
    init_params: the same keys and shapes, int8 payloads in [-127, 127],
    the lm_head weight-only."""
    cfg = treg.tiny("llama")
    qp = tq.init_quantized_params(cfg, seed=3, device="cpu",
                                  dtype=torch.float32, dynamic=dynamic)
    ref = tq.quantize_decoder_params(tdec.init_params(cfg, device="cpu"),
                                     dynamic=dynamic)

    def shapes(node):
        if isinstance(node, dict):
            return {k: shapes(v) for k, v in node.items()}
        if isinstance(node, tq.QuantTensor):
            return ("q", tuple(node.q.shape), tuple(node.scale.shape),
                    node.dynamic)
        return tuple(node.shape)

    assert shapes(qp) == shapes(ref)
    wq = qp["layers"]["wq"]
    assert int(wq.q.min()) >= -127 and int(wq.q.max()) <= 127
    assert not qp["lm_head"].dynamic
    again = tq.init_quantized_params(cfg, seed=3, device="cpu",
                                     dtype=torch.float32, dynamic=dynamic)
    assert torch.equal(again["layers"]["w_up"].q, qp["layers"]["w_up"].q)
