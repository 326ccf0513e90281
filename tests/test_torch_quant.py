"""The port's int8 serving weights (ops/quant.py, infer/quantize.py)
against the JAX package's, on the CPU.

Inputs come from a numpy seed and cross as numpy arrays
(models/convert.py). Quantization, the int8 product and its epilogue run
the JAX functions' f32 operations in their order, so they are held bit
for bit; the straight-through backward's f32 matmul sums in each
framework's own order (1e-5 relative), and forwards through whole f32
models use tests/test_torch_llama.py's 1e-4. ``torch._int_mm`` on the
card (padded rows) is held against its CPU result in the ``gpu`` case.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_docker_api.infer import quantize as jqz
from tpu_docker_api.infer.engine import GenerateConfig as JGenerateConfig
from tpu_docker_api.infer.engine import make_generate_fn as jmake_generate
from tpu_docker_api.models import llama as jl
from tpu_docker_api.ops import quant as jq
from tpu_docker_api_torch.infer import quantize as tqz
from tpu_docker_api_torch.infer.engine import GenerateConfig, make_generate_fn
from tpu_docker_api_torch.models import llama as tl
from tpu_docker_api_torch.models.convert import (params_from_numpy,
                                                 params_to_numpy)
from tpu_docker_api_torch.ops import quant as tq

TOL = 1e-4


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)
                      if jnp.asarray(x).dtype == jnp.bfloat16 else x)


def _assert_q_equal(tq_leaf, jq_leaf):
    assert isinstance(tq_leaf, tq.QuantizedLinear)
    assert tq_leaf.w_int8.dtype == torch.int8
    assert tq_leaf.scale.dtype == torch.float32
    np.testing.assert_array_equal(tq_leaf.w_int8.numpy(),
                                  np.asarray(jq_leaf.w_int8))
    np.testing.assert_array_equal(tq_leaf.scale.numpy(),
                                  np.asarray(jq_leaf.scale))


def _assert_trees_equal(ttree, jtree):
    """A port tree against a JAX tree, leaf by leaf, bit for bit."""
    if isinstance(ttree, dict):
        assert ttree.keys() == jtree.keys()
        for k in ttree:
            _assert_trees_equal(ttree[k], jtree[k])
    elif isinstance(ttree, tq.QuantizedLinear):
        _assert_q_equal(ttree, jtree)
    else:
        np.testing.assert_array_equal(params_to_numpy(ttree), _np(jtree))


@pytest.fixture(scope="module")
def tiny():
    """The tiny preset in f32 and bf16: JAX params from PRNGKey(0), the
    port's from them."""
    out = {}
    for name, jdt, tdt in (("f32", jnp.float32, torch.float32),
                           ("bf16", jnp.bfloat16, torch.bfloat16)):
        jcfg = dataclasses.replace(jl.llama_presets()["tiny"], dtype=jdt)
        tcfg = dataclasses.replace(tl.llama_presets()["tiny"], dtype=tdt)
        jp = jl.llama_init(jcfg, jax.random.PRNGKey(0))
        tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
        out[name] = (jcfg, tcfg, jp, tp)
    return out


# ------------------------------------------------------------ the leaf


@pytest.mark.parametrize("shape,dtype", [
    ((64, 48), np.float32), ((3, 64, 48), np.float32),
    ((2, 32, 16), jnp.bfloat16), ((5, 8), np.float32)])
def test_quantize_weight_matches_jax(shape, dtype):
    w = (np.random.default_rng(0).standard_normal(shape) * 0.3).astype(dtype)
    if dtype == np.float32:
        w[..., 0, 0] = 0.0  # a zero and a tie-rich column
        w[..., :, 1] = 0.5
    got = tq.quantize_weight(params_from_numpy(w, "cpu"))
    _assert_q_equal(got, jq.quantize_weight(jnp.asarray(w)))
    # logical (…, in, out), stored column-major
    assert tuple(got.shape) == shape and got.w_int8.stride(-2) == 1
    assert got.size == np.prod(shape)


def test_zero_weight_keeps_the_scale_clamp():
    got = tq.quantize_weight(torch.zeros(4, 3))
    _assert_q_equal(got, jq.quantize_weight(jnp.zeros((4, 3))))
    assert torch.equal(got.w_int8, torch.zeros(4, 3, dtype=torch.int8))


def test_dequantize_weight_matches_jax():
    w = np.random.default_rng(1).standard_normal((2, 16, 8)).astype(
        np.float32)
    jqw = jq.quantize_weight(jnp.asarray(w))
    tqw = tq.quantize_weight(torch.from_numpy(w))
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        got = tq.dequantize_weight(tqw, tdt)
        assert got.dtype == tdt
        np.testing.assert_array_equal(params_to_numpy(got),
                                      _np(jq.dequantize_weight(jqw, jdt)))
    # per-channel absmax scaling: error at most half a scale
    err = (tq.dequantize_weight(tqw) - torch.from_numpy(w)).abs()
    assert (err <= tqw.scale[:, None, :] / 2 + 1e-6).all()


def test_stacked_leaf_unbinds_per_layer():
    w = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (3, 16, 8)).astype(np.float32))
    q = tq.quantize_weight(w)
    parts = q.unbind(0)
    assert len(parts) == 3
    for i, part in enumerate(parts):
        alone = tq.quantize_weight(w[i])
        assert torch.equal(part.w_int8, alone.w_int8)
        assert torch.equal(part.scale, alone.scale)
        # views of the stacked storage, still column-major
        assert part.w_int8.data_ptr() == q.w_int8[i].data_ptr()
        assert part.w_int8.stride(-2) == 1
    layers = tl.unstack_layers({"mlp": {"w_up": q}, "norm": torch.ones(3, 4)},
                               3)
    assert isinstance(layers[1]["mlp"]["w_up"], tq.QuantizedLinear)
    assert torch.equal(layers[1]["mlp"]["w_up"].w_int8, parts[1].w_int8)


# -------------------------------------------------------- the product


@pytest.mark.parametrize("x_shape,x_dtype,out_dtype", [
    ((4, 64), "f32", None), ((2, 7, 64), "f32", None),
    ((2, 7, 64), "bf16", None), ((3, 64), "bf16", "f32"),
    ((1, 1, 64), "bf16", "f32")])
def test_int8_linear_matches_jax(x_shape, x_dtype, out_dtype):
    rng = np.random.default_rng(3)
    w = rng.standard_normal((64, 40)).astype(np.float32)
    x = rng.standard_normal(x_shape).astype(np.float32)
    x[..., 0] = 0.0
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}
    jx = jnp.asarray(x).astype(jdt[x_dtype])
    tx = torch.from_numpy(x).to(tdt[x_dtype])
    want = jq.int8_linear(jx, jq.quantize_weight(jnp.asarray(w)),
                          jdt.get(out_dtype))
    got = tq.int8_linear(tx, tq.quantize_weight(torch.from_numpy(w)),
                         tdt.get(out_dtype))
    assert got.dtype == tdt[out_dtype or x_dtype]
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(params_to_numpy(got), _np(want))


def test_int8_matmul_is_exact():
    rng = np.random.default_rng(4)
    a = torch.from_numpy(rng.integers(-127, 128, (9, 40)).astype(np.int8))
    b = torch.from_numpy(rng.integers(-127, 128, (40, 24)).astype(np.int8))
    got = tq.int8_matmul(a, b)
    assert got.dtype == torch.int32
    assert torch.equal(got.long(), a.long() @ b.long())


def test_int8_linear_ste_backward_matches_jax():
    """dL/dx = (g · s_w) @ W_int8ᵀ in f32 (the straight-through rule, not
    the zero gradient of the rounding); the weights get none."""
    rng = np.random.default_rng(5)
    w = rng.standard_normal((32, 24)).astype(np.float32)
    x = rng.standard_normal((3, 5, 32)).astype(np.float32)
    g = rng.standard_normal((3, 5, 24)).astype(np.float32)
    jqw = jq.quantize_weight(jnp.asarray(w))
    want = jax.grad(lambda xx: jnp.sum(jq.int8_linear(xx, jqw) * g))(
        jnp.asarray(x))
    tqw = tq.quantize_weight(torch.from_numpy(w))
    tx = torch.from_numpy(x).requires_grad_()
    (tq.linear(tx, tqw) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    assert not tqw.w_int8.requires_grad and tqw.w_int8.grad is None
    # not the zero gradient of round()
    assert tx.grad.abs().max() > 0.1


def test_linear_dispatches_on_the_leaf_type():
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((2, 16)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((16, 8)).astype(np.float32))
    q = tq.quantize_weight(w)
    assert torch.equal(tq.linear(x, q), tq.int8_linear(x, q))
    assert torch.equal(tq.linear(x, w), x @ w)
    y = tq.linear(x.bfloat16(), q, out_dtype=torch.float32)
    assert y.dtype == torch.float32
    assert torch.equal(y, tq.int8_linear(x.bfloat16(), q, torch.float32))


# ---------------------------------------------------------- whole trees


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantize_llama_params_matches_jax(tiny, dtype):
    _, _, jp, tp = tiny[dtype]
    tqp = tqz.quantize_llama_params(tp)
    _assert_trees_equal(tqp, jqz.quantize_llama_params(jp))
    assert tqp["embed"]["tokens"] is tp["embed"]["tokens"]
    assert tl.param_count(tqp) == jl.param_count(
        jqz.quantize_llama_params(jp))


def test_fused_int8_tree_matches_jax_and_the_unfused_tree(tiny):
    jcfg, tcfg, jp, tp = tiny["bf16"]
    jfused = jqz.fuse_llama_projections(jqz.quantize_llama_params(jp))
    unfused = tqz.quantize_llama_params(tp)
    fused = tqz.fuse_llama_projections(unfused)
    _assert_trees_equal(fused, jfused)
    assert fused["layers"]["attn"]["w_qkv"].w_int8.stride(-2) == 1
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, 256, (2, 24))).long()
    with torch.no_grad():
        a = tl.llama_forward(unfused, toks, tcfg)
        b = tl.llama_forward(fused, toks, tcfg)
    assert torch.equal(a, b)  # bit-identical, as the JAX package pins


@pytest.mark.parametrize("tree", ["float", "int8", "int8-fused"])
def test_quantized_bytes_matches_jax(tiny, tree):
    _, _, jp, tp = tiny["bf16"]
    if tree != "float":
        jp, tp = jqz.quantize_llama_params(jp), tqz.quantize_llama_params(tp)
    if tree == "int8-fused":
        jp, tp = jqz.fuse_llama_projections(jp), tqz.fuse_llama_projections(tp)
    assert tqz.quantized_bytes(tp) == jqz.quantized_bytes(jp)


def test_quantized_bytes_of_llama3_1b():
    """The footprint from the shapes alone (nothing allocated): int8
    projections and head with f32 scales, bf16 embedding and norms."""
    from tpu_docker_api_torch.models import param_shapes

    cfg = tl.llama_presets()["llama3-1b"]
    shapes = param_shapes(cfg)
    int8 = bf16 = 0
    for group in ("attn", "mlp"):
        for s in shapes["layers"][group].values():
            int8 += np.prod(s) + 4 * np.prod(s[:-2] + s[-1:])
    s = shapes["lm_head"]
    int8 += np.prod(s) + 4 * s[-1]
    for s in (shapes["embed"]["tokens"], shapes["layers"]["attn_norm"],
              shapes["layers"]["mlp_norm"], shapes["final_norm"]):
        int8 += 2 * np.prod(s)
    for s in jax.tree_util.tree_leaves(shapes, is_leaf=lambda x:
                                       isinstance(x, tuple)):
        bf16 += 2 * np.prod(s)
    assert (int8, bf16) == (1_763_238_912, 2_996_965_376)


@pytest.mark.parametrize("seed", [0, 5])
def test_synth_quantized_params_bit_equal(seed):
    jcfg = jl.llama_presets()["tiny"]
    tcfg = tl.llama_presets()["tiny"]
    got = tqz.synth_quantized_params(tcfg, seed=seed, device="cpu")
    _assert_trees_equal(got, jqz.synth_quantized_params(jcfg, seed=seed))
    assert got["lm_head"].w_int8.stride(-2) == 1


def test_every_int8_product_of_the_forward_matches_jax(tiny, monkeypatch):
    """Each int8 product of a port forward, on the activations the port
    gave it, bit for bit against ``jq.int8_linear`` on the same ones."""
    _, tcfg, _, tp = tiny["bf16"]
    calls = []
    real = tq._int8_linear_fwd

    def spy(x, w_int8, scale, out_dtype):
        y = real(x, w_int8, scale, out_dtype)
        calls.append((x, w_int8, scale, out_dtype, y))
        return y

    monkeypatch.setattr(tq, "_int8_linear_fwd", spy)
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        0, 256, (2, 32))).long()
    with torch.no_grad():
        tl.llama_forward(tqz.fuse_llama_projections(
            tqz.quantize_llama_params(tp)), toks, tcfg)
    assert len(calls) == 4 * tcfg.n_layers + 1  # qkv, wo, gate|up, down; head
    for x, w_int8, scale, out_dtype, y in calls:
        jx = jnp.asarray(params_to_numpy(x)).astype(jnp.bfloat16)
        want = jq.int8_linear(jx, jq.QuantizedLinear(
            jnp.asarray(w_int8.numpy()), jnp.asarray(scale.numpy())),
            jnp.float32 if out_dtype == torch.float32 else None)
        np.testing.assert_array_equal(params_to_numpy(y), _np(want))


def test_quantized_forward_matches_jax(tiny):
    """Whole f32 forwards on the same int8 tree. The float parts (norms,
    rope, attention) sum in each framework's order (~1e-7 apart), and
    an activation within that of a rounding boundary quantizes one count
    apart: the logits then move by a few such quanta (observed: 0.046 at
    this seed, on logits of magnitude ~4; 7e-7 where no activation sits
    on a boundary). Held to 0.1 absolute and the same argmax on 95% of
    positions; each product alone is bit-equal (the test above)."""
    jcfg, tcfg, jp, tp = tiny["f32"]
    toks = np.random.default_rng(8).integers(0, 256, (2, 32)).astype(
        np.int32)
    want = np.asarray(jl.llama_forward(jqz.quantize_llama_params(jp),
                                       jnp.asarray(toks), jcfg))
    with torch.no_grad():
        got = tl.llama_forward(tqz.quantize_llama_params(tp),
                               torch.from_numpy(toks).long(), tcfg).numpy()
    assert np.abs(got - want).max() <= 0.1
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.95


def test_int8_logits_track_the_float_model(tiny):
    """tests/test_quant.py's bound: per-position cosine above 0.98."""
    _, tcfg, _, tp = tiny["bf16"]
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        0, 256, (2, 32))).long()
    with torch.no_grad():
        ref = tl.llama_forward(tp, toks, tcfg).reshape(-1, 256)
        got = tl.llama_forward(tqz.quantize_llama_params(tp), toks,
                               tcfg).reshape(-1, 256)
    cos = torch.nn.functional.cosine_similarity(ref, got, dim=-1)
    assert cos.min() > 0.98, cos.min()


def test_int8_greedy_generate_matches_jax(tiny):
    """``make_generate_fn`` greedy on the same int8 fused tree, f32."""
    jcfg, tcfg, jp, tp = tiny["f32"]
    jtree = jqz.fuse_llama_projections(jqz.quantize_llama_params(jp))
    ttree = tqz.fuse_llama_projections(tqz.quantize_llama_params(tp))
    prompt = np.random.default_rng(10).integers(0, 256, (2, 12)).astype(
        np.int32)
    want = jmake_generate(jcfg, JGenerateConfig(
        max_new_tokens=10, temperature=0.0, max_seq=64))(
        jtree, jnp.asarray(prompt), jax.random.PRNGKey(0))
    got = make_generate_fn(tcfg, GenerateConfig(
        max_new_tokens=10, temperature=0.0, max_seq=64))(
        ttree, torch.from_numpy(prompt).long(), torch.Generator())
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))


# ---------------------------------------------------------------- card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch._int_mm's CUDA path)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [1, 8, 16, 17, 100])
def test_int_mm_on_card_pads_rows_and_matches_cpu(cuda_device, rows):
    rng = np.random.default_rng(rows)
    a = torch.from_numpy(rng.integers(-127, 128, (rows, 256)).astype(
        np.int8))
    w = tq.quantize_weight(torch.from_numpy(rng.standard_normal(
        (256, 96)).astype(np.float32)))
    want = tq.int8_matmul(a, w.w_int8)
    got = tq.int8_matmul(a.to(cuda_device), w.w_int8.to(cuda_device))
    assert got.shape == (rows, 96) and got.dtype == torch.int32
    assert torch.equal(got.cpu(), want)
    x = torch.from_numpy(rng.standard_normal((rows, 256)).astype(
        np.float32)).bfloat16()
    wc = tq.QuantizedLinear(w.w_int8.to(cuda_device), w.scale.to(cuda_device))
    np.testing.assert_array_equal(
        tq.int8_linear(x.to(cuda_device), wc).float().cpu().numpy(),
        tq.int8_linear(x, w).float().numpy())
