"""The port's LoRA and QLoRA (train/lora.py, ``ops.quant.LoraLinear``, the
trainer and server flags) against the JAX package's, on the CPU at the
tiny preset.

JAX params and adapters cross as numpy arrays (models/convert.py).
Tolerances:

- The merge and the attached projection are held bit for bit where the
  arithmetic is the port's own: the scale, the casts and the order of
  the adds. Their products sum in each framework's order (XLA's f32 dot
  keeps two accumulators, torch's one), so those tests put the values on
  a grid where every product and partial sum is exact in f32; random
  values are held to one rounding of the base dtype.
- Losses and adapter gradients over an f32 base: ``TOL = 1e-4``, as
  tests/test_torch_train.py (f32 through two layers, two summation
  orders). Over an int8 base the two packages' activations agree to one
  quantum, not bit for bit (ROADMAP Queue 3): an activation on a rounding
  boundary quantizes one count apart, which moved a whole forward's
  logits by up to 0.046 in ~4 (tests/test_torch_quant.py). The loss
  averages 64 rows and is held to 1e-3 relative, the adapter gradients
  to 1e-2 relative L2 (this file's inputs hit no boundary: both agree
  to ~1e-7).
- Three steps: the tests/test_torch_train.py bounds (Adam normalises an
  element's gradient by its own size: at most ~lr a step for an element
  at the noise floor).

Identity at init (B = 0) is exact in the port: the merged tree equals
the base bit for bit and the attached forward adds an exact zero. The
``gpu`` cases need the card: adam8 at the adapters' shapes, and the
adapter gradients through the flash kernels against the dense path.
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_docker_api.infer import quantize as jqz
from tpu_docker_api.models import llama as jl
from tpu_docker_api.ops import quant as jq
from tpu_docker_api.parallel.mesh import single_device_mesh
from tpu_docker_api.train import lora as jlora
from tpu_docker_api.train import optim as jopt
from tpu_docker_api.train import trainer as jtrainer
from tpu_docker_api_torch.infer.quantize import (fuse_llama_projections,
                                                 quantized_bytes)
from tpu_docker_api_torch.infer.slots import SlotEngine
from tpu_docker_api_torch.models import llama as tl
from tpu_docker_api_torch.models.convert import (params_from_numpy,
                                                 params_to_numpy)
from tpu_docker_api_torch.ops import quant as tq
from tpu_docker_api_torch.train import checkpoint as ckpt
from tpu_docker_api_torch.train import lora as tlora
from tpu_docker_api_torch.train import optim, trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4
INT8_LOSS_TOL, INT8_GRAD_TOL = 1e-3, 1e-2
_DTYPES = {"f32": (jnp.float32, torch.float32),
           "bf16": (jnp.bfloat16, torch.bfloat16)}


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cfgs(dtype="f32", **kw):
    jdt, tdt = _DTYPES[dtype]
    return (dataclasses.replace(jl.llama_presets()["tiny"], dtype=jdt, **kw),
            dataclasses.replace(tl.llama_presets()["tiny"], dtype=tdt, **kw))


@pytest.fixture(scope="module")
def f32():
    """(jcfg, tcfg, JAX base, port base) at f32."""
    jcfg, tcfg = _cfgs()
    jbase = jl.llama_init(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jbase, params_from_numpy(_host(jbase), "cpu")


def _jax_adapters(jbase, rank=4, targets=jlora.DEFAULT_TARGETS, mass=0.05):
    """JAX adapters with B given mass, so the adapters change the model."""
    ad = jlora.lora_init(jbase, rank, jax.random.PRNGKey(1), targets)
    return jax.tree_util.tree_map(
        lambda x: x + mass * jax.random.normal(jax.random.PRNGKey(3),
                                               x.shape, x.dtype), ad)


def _grid(rng, shape, step, span):
    """Values ``k·step`` for integers |k| <= span: products and sums of a
    few of them are exact in f32 whatever order they run in."""
    return (rng.integers(-span, span + 1, shape) * step).astype(np.float32)


def _tokens(b, s, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (b, s)).astype(
        np.int32)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def _rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)


# ------------------------------------------------------ init and merge


def test_lora_init_shapes_and_purity(f32):
    _, tcfg, _, tbase = f32
    ad = tlora.lora_init(tbase, 4, torch.Generator().manual_seed(7))
    jad = jlora.lora_init(jl.llama_init(f32[0], jax.random.PRNGKey(0)), 4,
                          jax.random.PRNGKey(7))
    assert jax.tree_util.tree_structure(_host(jad)) == \
        jax.tree_util.tree_structure(params_to_numpy(ad))
    wq = ad["layers"]["attn"]["wq"]
    assert wq["a"].shape == (tcfg.n_layers, tcfg.dim, 4)
    assert wq["b"].shape == (tcfg.n_layers, 4, tcfg.n_heads * tcfg.head_dim)
    assert wq["a"].dtype == torch.float32 and not wq["b"].any()
    # fan-in truncated normal: |a| <= 2/sqrt(d_in), std ~ 0.88/sqrt(d_in)
    a = wq["a"]
    assert a.abs().max() <= 2 * tcfg.dim ** -0.5
    assert 0.6 < a.std().item() * tcfg.dim ** 0.5 < 1.0
    # a pure function of the seed: the generator's own stream is unused,
    # and another seed draws other adapters
    g = torch.Generator().manual_seed(7)
    torch.randn(5, generator=g)
    again = tlora.lora_init(tbase, 4, g)
    for k in ("wq", "wv"):
        assert torch.equal(again["layers"]["attn"][k]["a"],
                           ad["layers"]["attn"][k]["a"])
    other = tlora.lora_init(tbase, 4, torch.Generator().manual_seed(8))
    assert not torch.equal(other["layers"]["attn"]["wq"]["a"], a)
    # each pair draws from its own generator
    assert not torch.equal(ad["layers"]["attn"]["wv"]["a"], a)


@pytest.mark.parametrize("targets", [("wq",), ("w_gate", "lm_head"),
                                     ("wq", "wk", "wv", "wo")])
def test_custom_targets_match_jax(f32, targets):
    jcfg, _, jbase, tbase = f32
    jad = jlora.lora_init(jbase, 2, jax.random.PRNGKey(1), targets)
    tad = tlora.lora_init(tbase, 2, torch.Generator().manual_seed(1),
                          targets)
    want = {p: v.shape for p, v in _flat(_host(jad)).items()}
    assert {p: tuple(v.shape) for p, v in _flat(tad).items()} == want


@pytest.mark.parametrize("args,targets", [((0,), jlora.DEFAULT_TARGETS),
                                          ((2,), ("nope",))])
def test_init_errors_match_jax(f32, args, targets):
    _, _, jbase, tbase = f32
    with pytest.raises(ValueError) as jerr:
        jlora.lora_init(jbase, *args, jax.random.PRNGKey(1), targets)
    with pytest.raises(ValueError) as terr:
        tlora.lora_init(tbase, *args, torch.Generator().manual_seed(1),
                        targets)
    assert str(terr.value) == str(jerr.value)


def test_merge_over_int8_raises_as_jax(f32):
    _, _, jbase, tbase = f32
    jad = _jax_adapters(jbase)
    with pytest.raises(ValueError) as jerr:
        jlora.merge_lora(jqz.quantize_llama_params(jbase), jad)
    with pytest.raises(ValueError) as terr:
        tlora.merge_lora(tlora.quantize_base(tbase),
                         params_from_numpy(_host(jad), "cpu"))
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_merge_lora_bit_equal(dtype):
    """Base and adapters on a grid (A@B exact in f32 in any order): the
    merged tree is JAX's bit for bit, at every leaf, for two alphas."""
    jdt, tdt = _DTYPES[dtype]
    rng = np.random.default_rng(0)
    jcfg, _ = _cfgs(dtype)
    base = _host(jl.llama_init(jcfg, jax.random.PRNGKey(0)))
    ad = _host(jlora.lora_init(base, 4, jax.random.PRNGKey(1)))
    for leaf in _flat(ad):
        *parents, last = leaf.split("/")
        node = ad
        for p in parents:
            node = node[p]
        node[last] = _grid(rng, node[last].shape, 2.0**-5, 32)
    jbase = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jdt), base)
    jad = jax.tree_util.tree_map(jnp.asarray, ad)
    tbase = params_from_numpy(base, "cpu", tdt)
    tad = params_from_numpy(ad, "cpu")
    for alpha in (16.0, 3.0):
        got = params_to_numpy(tlora.merge_lora(tbase, tad, alpha))
        want = _host(jax.tree_util.tree_map(
            lambda x: x.astype(jnp.float32),
            jlora.merge_lora(jbase, jad, alpha)))
        for path, w in _flat(want).items():
            np.testing.assert_array_equal(_flat(got)[path], w, err_msg=path)
        # the targets changed, their dtype did not
        assert tlora.merge_lora(tbase, tad, alpha)["layers"]["attn"][
            "wq"].dtype == tdt
        assert not np.array_equal(got["layers"]["attn"]["wq"],
                                  params_to_numpy(tbase)["layers"]["attn"]
                                  ["wq"])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_merge_lora_random_adapters_within_one_rounding(dtype):
    jdt, tdt = _DTYPES[dtype]
    jcfg, _ = _cfgs(dtype)
    jbase = jl.llama_init(jcfg, jax.random.PRNGKey(0))
    jad = _jax_adapters(jbase)
    got = params_to_numpy(tlora.merge_lora(
        params_from_numpy(_host(jbase), "cpu"),
        params_from_numpy(_host(jad), "cpu")))
    want = _host(jax.tree_util.tree_map(lambda x: x.astype(jnp.float32),
                                        jlora.merge_lora(jbase, jad)))
    ulp = 2.0**-23 if dtype == "f32" else 2.0**-8
    for path, w in _flat(want).items():
        np.testing.assert_allclose(_flat(got)[path], w, rtol=ulp,
                                   atol=1e-7, err_msg=path)


def test_attached_projection_bit_equal_over_bf16():
    """``linear`` on a ``LoraLinear`` over a bf16 base, one layer's slice
    (``unbind``) against JAX's, values on a grid: y = x@W in bf16 plus
    s·((x@A)@B) in f32 cast at the add, bit for bit."""
    rng = np.random.default_rng(1)
    x = _grid(rng, (2, 5, 64), 2.0**-3, 8)
    w = _grid(rng, (2, 64, 32), 2.0**-6, 8)
    a = _grid(rng, (2, 64, 4), 2.0**-5, 8)
    b = _grid(rng, (2, 4, 32), 2.0**-5, 8)
    jleaf = jq.LoraLinear(jnp.asarray(w, jnp.bfloat16), jnp.asarray(a),
                          jnp.asarray(b), 16.0 / 4)
    tleaf = params_from_numpy({"w": jleaf}, "cpu")["w"]
    assert isinstance(tleaf, tq.LoraLinear) and tleaf.scale == 4.0
    assert tleaf.shape == (2, 64, 32)
    for layer in range(2):
        want = jq.linear(jnp.asarray(x, jnp.bfloat16), jax.tree_util.tree_map(
            lambda t: t[layer], jleaf))
        got = tq.linear(torch.from_numpy(x).bfloat16(),
                        tleaf.unbind(0)[layer])
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_identity_at_init_is_exact(dtype):
    """B = 0: the merged tree is the base bit for bit, and the attached
    forward's loss is the base's bit for bit (an exact zero added)."""
    _, tcfg = _cfgs("f32" if dtype == "f32" else "bf16")
    base = tlora.init_base_params(tcfg, torch.Generator().manual_seed(0))
    if dtype == "int8":
        base = tlora.quantize_base(base)
    ad = tlora.lora_init(base, 4, torch.Generator().manual_seed(1))
    tokens = torch.from_numpy(_tokens(2, 33)).long()
    with torch.no_grad():
        ref = tl.llama_loss(base, tokens, tcfg)
        if dtype != "int8":
            merged = tlora.merge_lora(base, ad)
            for path, t in _flat(merged).items():
                assert torch.equal(t, _flat(base)[path]), path
            assert torch.equal(tl.llama_loss(merged, tokens, tcfg), ref)
        assert torch.equal(tl.llama_loss(tlora.attach_lora(base, ad),
                                         tokens, tcfg), ref)


def test_param_count_and_bytes_count_lora_leaves(f32):
    jcfg, _, jbase, tbase = f32
    jad = _jax_adapters(jbase)
    tad = params_from_numpy(_host(jad), "cpu")
    for jb, tb in ((jbase, tbase), (jqz.quantize_llama_params(jbase),
                                    tlora.quantize_base(tbase))):
        jtree, ttree = jlora.attach_lora(jb, jad), tlora.attach_lora(tb, tad)
        assert tl.param_count(ttree) == jl.param_count(jtree)
        assert quantized_bytes(ttree) == jqz.quantized_bytes(jtree)
    n_adapter = sum(x.size for x in jax.tree_util.tree_leaves(jad))
    assert tl.param_count(tlora.attach_lora(tbase, tad)) == \
        tl.param_count(tbase) + n_adapter


# ------------------------------------------- losses, gradients, steps


def _jax_loss_grads(jcfg, jbase, jad, forward):
    combine = jlora.merge_lora if forward == "merged" else jlora.attach_lora
    tokens = jnp.asarray(_tokens(2, 33))
    return jax.value_and_grad(lambda a: jl.llama_loss(
        combine(jbase, a), tokens, jcfg))(jad)


def _port_loss_grads(tcfg, tbase, jad, forward):
    combine = tlora.merge_lora if forward == "merged" else tlora.attach_lora
    live = optim.tree_map(lambda t: t.requires_grad_(),
                          params_from_numpy(_host(jad), "cpu"))
    loss = tl.llama_loss(combine(tbase, live), torch.from_numpy(
        _tokens(2, 33)).long(), tcfg)
    loss.backward()
    return loss.item(), optim.tree_map(lambda t: t.grad.numpy(), live)


@pytest.mark.parametrize("forward", ["merged", "attached"])
@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_adapter_grads_match_jax(f32, forward, remat):
    jcfg, tcfg, jbase, tbase = f32
    tcfg = dataclasses.replace(tcfg, remat=remat)
    jad = _jax_adapters(jbase)
    ref_loss, ref_grads = _jax_loss_grads(jcfg, jbase, jad, forward)
    loss, grads = _port_loss_grads(tcfg, tbase, jad, forward)
    np.testing.assert_allclose(loss, float(ref_loss), rtol=TOL)
    for path, r in _flat(_host(ref_grads)).items():
        np.testing.assert_allclose(_flat(grads)[path], r, rtol=TOL,
                                   atol=TOL, err_msg=path)


@pytest.mark.parametrize("chunk", [0, 16])
def test_qlora_loss_and_grads_over_int8_match_jax(f32, chunk):
    """The attached forward over an int8 base (the chunked tail
    dequantizes the int8 head), to one activation quantum."""
    jcfg, tcfg, jbase, tbase = f32
    jcfg = dataclasses.replace(jcfg, loss_chunk_rows=chunk)
    tcfg = dataclasses.replace(tcfg, loss_chunk_rows=chunk)
    jad = _jax_adapters(jbase)
    ref_loss, ref_grads = _jax_loss_grads(
        jcfg, jqz.quantize_llama_params(jbase), jad, "attached")
    loss, grads = _port_loss_grads(tcfg, tlora.quantize_base(tbase), jad,
                                   "attached")
    np.testing.assert_allclose(loss, float(ref_loss), rtol=INT8_LOSS_TOL)
    for path, r in _flat(_host(ref_grads)).items():
        assert _rel_l2(_flat(grads)[path], r) <= INT8_GRAD_TOL, path


def test_chunked_ce_over_an_int8_head_matches_jax(f32):
    """JAX's ``test_qlora_with_chunked_ce`` shape: the int8 head
    dequantizes for the chunked loss. On ``synth_quantized_params``
    (bit-equal in both packages) the chunked loss is within TOL of
    JAX's and of the port's own dense int8 head."""
    jcfg, tcfg, _, _ = f32
    jcfg = dataclasses.replace(jcfg, loss_chunk_rows=32)
    tcfg = dataclasses.replace(tcfg, loss_chunk_rows=32)
    jbase = jqz.synth_quantized_params(jcfg)
    from tpu_docker_api_torch.infer.quantize import synth_quantized_params

    tbase = synth_quantized_params(tcfg, device="cpu")
    tokens = _tokens(4, 33)
    ref = float(jl.llama_loss(jbase, jnp.asarray(tokens), jcfg))
    with torch.no_grad():
        got = tl.llama_loss(tbase, torch.from_numpy(tokens).long(), tcfg)
        dense = tl.llama_loss(tbase, torch.from_numpy(tokens).long(),
                              dataclasses.replace(tcfg, loss_chunk_rows=0))
    np.testing.assert_allclose(got.item(), ref, rtol=TOL)
    np.testing.assert_allclose(got.item(), dense.item(), rtol=TOL)


@pytest.mark.parametrize("optim_name,forward", [
    ("adamw", "merged"), ("adamw", "attached"), ("adamw-int8", "merged")])
def test_three_lora_steps_match_jax(f32, optim_name, forward):
    jcfg, tcfg, jbase, tbase = f32
    mesh = single_device_mesh()
    if optim_name == "adamw":
        jtx, ttx = jtrainer.default_optimizer(), trainer.default_optimizer()
    else:
        jtx, ttx = jopt.adamw_int8(impl="xla"), optim.adamw_int8()
    jad = _jax_adapters(jbase, mass=0.0)  # B = 0, as training starts
    jstate = jtrainer.TrainState(jnp.zeros((), jnp.int32), jad,
                                 jtx.init(jad))
    tad = params_from_numpy(_host(jad), "cpu")
    tstate = trainer.TrainState(0, tad, ttx.init(tad))
    jstep = jlora.make_lora_train_step(jcfg, mesh, jtx, jbase,
                                       forward=forward)
    tstep = tlora.make_lora_train_step(tcfg, ttx, tbase, forward=forward)
    before = {p: t.clone() for p, t in _flat(tbase).items()}
    for i in range(3):
        tokens = _tokens(2, 17, seed=10 + i)
        jstate, jm = jstep(jstate, tokens)
        tstate, tm = tstep(tstate, torch.from_numpy(tokens).long())
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                                   rtol=TOL)
        np.testing.assert_allclose(tm["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=TOL)
    assert tstate.step == int(jstate.step) == 3
    got = _flat(params_to_numpy(tstate.params))
    for path, ref in _flat(_host(jstate.params)).items():
        diff = np.abs(got[path] - ref)
        assert diff.max() <= 6 * 3e-4, path
        assert (diff > 2e-6).mean() <= 1e-3, path
    # only the adapters trained: the base is untouched
    assert all(torch.equal(t, before[p]) for p, t in _flat(tbase).items())
    assert not any(t.requires_grad for t in _flat(tbase).values())


def test_qlora_steps_descend_with_the_base_frozen(f32):
    _, tcfg, _, tbase = f32
    qbase = tlora.quantize_base(tbase)
    state, tx = tlora.create_lora_state(
        tcfg, torch.Generator().manual_seed(1), 4,
        optimizer=optim.adamw_int8())
    step = tlora.make_lora_train_step(tcfg, tx, qbase, forward="attached")
    tokens = torch.from_numpy(_tokens(8, 33)).long()
    w8 = qbase["layers"]["attn"]["wq"].w_int8.clone()
    losses = []
    for _ in range(8):
        state, m = step(state, tokens)
        losses.append(m["loss"].item())
    assert losses[-1] < losses[0]
    assert state.params["layers"]["attn"]["wq"]["b"].abs().max() > 0
    assert torch.equal(qbase["layers"]["attn"]["wq"].w_int8, w8)
    # one adam8 leaf per adapter tensor, and the b = rank block of A
    assert state.opt_state[1].mu_scale["layers"]["attn"]["wq"]["a"].shape \
        == (tcfg.n_layers * tcfg.dim, 1)


def test_first_step_gives_a_zero_gradient_to_a(f32):
    """At init B = 0, so A's gradient is an exact zero tensor, not None:
    the step's "every parameter gets a gradient" rule holds."""
    _, tcfg, _, tbase = f32
    state, tx = tlora.create_lora_state(
        tcfg, torch.Generator().manual_seed(1), 4)
    live = optim.tree_map(lambda t: t.detach().requires_grad_(),
                          state.params)
    loss = tl.llama_loss(tlora.attach_lora(tbase, live),
                         torch.from_numpy(_tokens(2, 17)).long(), tcfg)
    grads = torch.autograd.grad(loss, optim.tree_leaves(live))
    flat = dict(zip(_flat(live), grads))
    assert not flat["layers/attn/wq/a"].any()
    assert flat["layers/attn/wq/b"].abs().max() > 0


def test_make_lora_train_step_refuses_another_forward(f32):
    with pytest.raises(ValueError, match="merged|attached"):
        tlora.make_lora_train_step(f32[1], trainer.default_optimizer(),
                                   f32[3], forward="fused")


# -------------------------------------------------------- checkpoints


def _lora_run(cfg, base, steps, state=None, tx=None, start=0):
    if state is None:
        state, tx = tlora.create_lora_state(
            cfg, torch.Generator().manual_seed(1), 4,
            optimizer=optim.adamw_int8())
    step = tlora.make_lora_train_step(cfg, tx, base, forward="attached")
    for i in range(start, steps):
        state, _ = step(state, torch.from_numpy(_tokens(2, 17, i)).long())
    return state, tx


def _assert_states_equal(a, b):
    assert a.step == b.step
    fa, fb, ia, ib = {}, {}, {}, {}
    ckpt._flatten((a.params, a.opt_state), "", fa, ia)
    ckpt._flatten((b.params, b.opt_state), "", fb, ib)
    assert fa.keys() == fb.keys() and ia == ib
    for k in fa:
        assert torch.equal(fa[k], fb[k]), k


def test_adapter_checkpoint_round_trip_and_bit_equal_resume(f32, tmp_path):
    _, tcfg, _, tbase = f32
    qbase = tlora.quantize_base(tbase)
    whole, _ = _lora_run(tcfg, qbase, 4)
    first, tx = _lora_run(tcfg, qbase, 2)
    with ckpt.CheckpointManager(tmp_path) as mgr:
        assert mgr.save(first)
    # the files hold the adapters and their moments, nothing of the base
    names = json.loads((tmp_path / "2" / ckpt.META_FILE).read_text())[
        "params"]
    assert names == ["layers/attn/wq/a", "layers/attn/wq/b",
                     "layers/attn/wv/a", "layers/attn/wv/b"]
    state, tx2, mgr = tlora.lora_resume_or_init(
        tmp_path, tcfg, "cpu", torch.Generator().manual_seed(99), 4,
        optimizer=optim.adamw_int8())
    with mgr:
        _assert_states_equal(state, first)
    resumed, _ = _lora_run(tcfg, qbase, 4, state, tx2, start=2)
    _assert_states_equal(resumed, whole)
    # params only, for serving: whichever optimizer wrote them
    got = tlora.restore_adapters(tmp_path, tcfg, "cpu", 4)
    for path, t in _flat(got).items():
        assert torch.equal(t, _flat(first.params)[path])
    # another rank or other targets are refused
    with pytest.raises(ValueError, match="expected|differ"):
        tlora.restore_adapters(tmp_path, tcfg, "cpu", 8)
    with pytest.raises(ValueError, match="differ"):
        tlora.restore_adapters(tmp_path, tcfg, "cpu", 4, ("wq",))


def test_restore_with_target_checks_the_optimizer(f32, tmp_path):
    _, tcfg, _, tbase = f32
    state, _ = _lora_run(tcfg, tbase, 1)
    with ckpt.CheckpointManager(tmp_path) as mgr:
        mgr.save(state)
        target = tlora.lora_abstract_state(tcfg, 4, ("wq", "wv"),
                                           trainer.default_optimizer())
        with pytest.raises(ValueError, match="another optimizer"):
            mgr.restore_with_target(target, device="cpu")


def test_base_from_a_full_adamw_int8_checkpoint(f32, tmp_path):
    _, tcfg, _, _ = f32
    state, tx = trainer.create_train_state(
        tcfg, "cpu", torch.Generator().manual_seed(0), optim.adamw_int8())
    state, _ = trainer.make_train_step(tcfg, tx)(
        state, torch.from_numpy(_tokens(2, 17)).long())
    with ckpt.CheckpointManager(tmp_path) as mgr:
        mgr.save(state)
    base = tlora.restore_base_params(tmp_path, tcfg, "cpu")
    for path, t in _flat(state.params).items():
        assert torch.equal(_flat(base)[path], t), path


def test_missing_base_or_adapter_directory_raises(f32, tmp_path):
    _, tcfg, _, _ = f32
    for fn in (lambda d: tlora.restore_base_params(d, tcfg, "cpu"),
               lambda d: tlora.restore_adapters(d, tcfg, "cpu", 4)):
        with pytest.raises(FileNotFoundError):
            fn(tmp_path / "none")
        os.makedirs(tmp_path / "empty", exist_ok=True)
        with pytest.raises(FileNotFoundError):
            fn(tmp_path / "empty")
    assert not (tmp_path / "none").exists()


# ---------------------------------------------------------- the CLIs


def _train_cli(*args, timeout=240):
    return subprocess.run(
        [sys.executable, "-m", "tpu_docker_api_torch.train", "--device",
         "cpu", "--preset", "tiny", "--batch", "2", "--seq", "16",
         "--log-every", "1", *args],
        cwd=ROOT, capture_output=True, text=True, timeout=timeout)


def _greedy_in_memory(cfg, tree, prompt, max_new, fuse):
    eng = SlotEngine(cfg, fuse_llama_projections(tree) if fuse else tree,
                     slots=4, max_seq=64, chunk=4, cache_dtype=cfg.dtype)
    h = eng.submit(prompt, max_new)
    while not h.done():
        eng.step()
    return h.result(0)["tokens"]


def _serve_greedy(argv, prompt, max_new):
    from tpu_docker_api_torch.serve.__main__ import Server, parse_args

    srv = Server(parse_args(["--device", "cpu", "--preset", "tiny",
                             "--host", "127.0.0.1", "--port", "0",
                             "--max-seq", "64", "--slots", "4", "--chunk",
                             "4", *argv]))
    t = threading.Thread(target=srv.httpd.serve_forever, daemon=True)
    t.start()
    try:
        import http.client

        conn = http.client.HTTPConnection(
            "127.0.0.1", srv.httpd.server_address[1], timeout=60)
        conn.request("POST", "/generate", body=json.dumps(
            {"tokens": [prompt], "maxNewTokens": max_new}))
        resp = conn.getresponse()
        assert resp.status == 200
        return srv, json.loads(resp.read())["tokens"][0]
    finally:
        srv.httpd.shutdown()
        srv.close()
        t.join(timeout=10)


@pytest.fixture(scope="module")
def qlora_ckpt(tmp_path_factory):
    """A --qlora CLI run (4 steps, saves at 2 and 4) and one resumed at
    step 2 from a 2-step run."""
    root = tmp_path_factory.mktemp("qlora")
    flags = ("--lora-rank", "4", "--qlora", "--optim", "adamw-int8",
             "--save-every", "2")
    runs = {}
    for name, steps in (("a", 4), ("b", 2), ("b2", 4)):
        d = root / name.rstrip("2")
        runs[name] = _train_cli(*flags, "--steps", str(steps),
                                "--ckpt-dir", str(d))
        assert runs[name].returncode == 0, runs[name].stderr
    return root, runs


def _lines(proc):
    return [json.loads(ln) for ln in proc.stdout.splitlines()]


def test_qlora_cli_writes_adapter_checkpoints_and_resumes(qlora_ckpt):
    root, runs = qlora_ckpt
    a = _lines(runs["a"])
    assert [ln["step"] for ln in a if "event" not in ln] == [1, 2, 3, 4]
    assert [ln["step"] for ln in a if ln.get("event") == "saved"] == [2, 4]
    b2 = _lines(runs["b2"])
    assert b2[0]["event"] == "resumed" and b2[0]["step"] == 2
    assert [ln["loss"] for ln in b2 if "event" not in ln] == \
        [ln["loss"] for ln in a if "event" not in ln][2:]
    for name in (ckpt.PARAMS_FILE, ckpt.OPT_FILE):
        assert (root / "a" / "4" / name).read_bytes() == \
            (root / "b" / "4" / name).read_bytes(), name
    # adapter-only: a few KB, the tiny base alone is ~0.4 MB
    assert sum(f.stat().st_size for f in (root / "a" / "4").iterdir()) \
        < 32_000


def test_qlora_cli_then_attached_server(qlora_ckpt):
    """The round trip of JAX's ``test_qlora_cli_then_attached_serving``:
    the attached int8 server's greedy tokens equal an in-memory engine's
    on the same tree."""
    root, _ = qlora_ckpt
    cfg = tl.llama_presets()["tiny"]
    prompt = [5, 9, 2, 7, 31]
    srv, got = _serve_greedy(["--quantize", "--lora-ckpt", str(root / "a"),
                              "--lora-rank", "4", "--lora-forward",
                              "attached"], prompt, 8)
    wq = srv.params["layers"]["attn"]["wq"]
    assert isinstance(wq, tq.LoraLinear)
    assert isinstance(wq.base, tq.QuantizedLinear)
    assert "w_qkv" not in srv.params["layers"]["attn"]  # not fused
    base = tlora.init_base_params(cfg, torch.Generator().manual_seed(0))
    tree = tlora.attach_lora(tlora.quantize_base(base),
                             tlora.restore_adapters(root / "a", cfg, "cpu",
                                                    4))
    assert got == _greedy_in_memory(cfg, tree, prompt, 8, fuse=False)
    # the adapters moved the model: the bare int8 base answers otherwise
    # or at least its logits differ
    with torch.no_grad():
        toks = torch.tensor([prompt])
        assert not torch.equal(
            tl.llama_forward(tree, toks, cfg),
            tl.llama_forward(tlora.quantize_base(base), toks, cfg))


@pytest.mark.parametrize("quantize", [False, True])
def test_merged_cli_then_merged_server(tmp_path, quantize):
    """A merged-LoRA CLI run, then a merged server (bf16 merge; with
    --quantize, merged before quantizing, then fused): its greedy tokens
    equal an in-memory engine's on the same tree."""
    cfg = tl.llama_presets()["tiny"]
    d = tmp_path / "merged"
    proc = _train_cli("--lora-rank", "4", "--lora-alpha", "8", "--steps",
                      "2", "--ckpt-dir", str(d))
    assert proc.returncode == 0, proc.stderr
    prompt = [3, 1, 4, 1, 5]
    srv, got = _serve_greedy(["--lora-ckpt", str(d), "--lora-rank", "4",
                              "--lora-alpha", "8",
                              *(["--quantize"] if quantize else [])],
                             prompt, 8)
    assert "w_qkv" in srv.params["layers"]["attn"]
    base = tlora.init_base_params(cfg, torch.Generator().manual_seed(0))
    tree = tlora.merge_lora(base, tlora.restore_adapters(d, cfg, "cpu", 4),
                            alpha=8.0)
    if quantize:
        tree = tlora.quantize_base(tree)
    assert got == _greedy_in_memory(cfg, tree, prompt, 8, fuse=True)


def test_qlora_cli_quiesces_and_a_restart_continues(tmp_path):
    """SIGTERM during a --qlora run saves the adapters' step before
    ``quiesced``; a restart resumes from it."""
    ck = str(tmp_path / "ck")
    flags = ["--device", "cpu", "--preset", "tiny", "--batch", "2",
             "--seq", "16", "--log-every", "1", "--lora-rank", "2",
             "--qlora", "--optim", "adamw-int8", "--ckpt-dir", ck]
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpu_docker_api_torch.train", *flags,
         "--steps", "100000", "--save-every", "1000"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        assert json.loads(proc.stdout.readline())["step"] == 1
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    assert proc.returncode == 0, err
    lines = [json.loads(ln) for ln in out.splitlines()]
    n = lines[-1]["step"]
    assert lines[-1]["event"] == "quiesced"
    assert [ln["step"] for ln in lines if ln.get("event") == "saved"] == [n]
    again = subprocess.run(
        [sys.executable, "-m", "tpu_docker_api_torch.train", *flags,
         "--steps", str(n + 1)], cwd=ROOT, capture_output=True, text=True,
        timeout=240)
    assert again.returncode == 0, again.stderr
    resumed = _lines(again)
    assert resumed[0] == {**resumed[0], "event": "resumed", "step": n}
    assert resumed[-1] == {"event": "done", "step": n + 1}


def test_lora_base_ckpt_and_a_missing_one(tmp_path):
    base_dir = tmp_path / "base"
    full = _train_cli("--steps", "1", "--optim", "adamw-int8",
                      "--ckpt-dir", str(base_dir))
    assert full.returncode == 0, full.stderr
    proc = _train_cli("--lora-rank", "2", "--steps", "1",
                      "--lora-base-ckpt", str(base_dir))
    assert proc.returncode == 0, proc.stderr
    assert _lines(proc)[-1] == {"event": "done", "step": 1}
    missing = _train_cli("--lora-rank", "2", "--steps", "1",
                         "--lora-base-ckpt", str(tmp_path / "none"))
    assert missing.returncode != 0
    assert "FileNotFoundError" in missing.stderr


# ----------------------------------------------------- card-only cases


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel, no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(16, 2048, 16), (16, 16, 2048),
                                   (16, 16, 512), (16, 2048, 4)])
def test_adam8_at_adapter_shapes_matches_plain_on_card(cuda_device, shape):
    """llama3-1b's adapters at rank 16 (A: b = 16, the vector path; B:
    b = 256) and A at rank 4 (b = 4, the scalar path), f32 leaves with
    their parameters, as the kernels phase checks them."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    grad = torch.randn(shape, generator=g, device=cuda_device) * 1e-3
    p = torch.randn(shape, generator=g, device=cuda_device) * 2e-2
    mq, ms = optim._quant_signed(
        torch.randn(shape, generator=g, device=cuda_device) * 1e-4, 256)
    vq, vs = optim._quant_sqrt(
        torch.rand(shape, generator=g, device=cuda_device) * 1e-8, 256)
    sc = optim.adam8_scalars(3, 0.9, 0.95, 1e-8, 3e-4, 0.1)
    before = optim.launch_count["adam8"]
    got = optim.adam8_update_leaf(grad, mq, ms, vq, vs, p, sc=sc)
    torch.cuda.synchronize()
    assert optim.launch_count["adam8"] == before + 1
    ref = optim.adam8_plain(grad, mq, ms, vq, vs, p, sc=sc)
    assert ((got[0] - ref[0]).abs() <= 1e-5 * ref[0].abs() + 1e-12).all()
    for i in (1, 3):
        assert (got[i].int() - ref[i].int()).abs().max().item() <= 1
    for i in (2, 4):
        torch.testing.assert_close(got[i], ref[i], rtol=1e-6, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("forward", ["merged", "attached"])
def test_adapter_grads_through_the_kernels_on_card(cuda_device, forward):
    """bf16 tiny model at head_dim 64 (the flash kernels' width): the
    adapter gradients through flash and the dense plain path agree to
    2e-2 relative L2, the train phase's bound."""
    from tpu_docker_api_torch.ops import flash

    cfg = dataclasses.replace(tl.llama_presets()["tiny"], dim=256,
                              n_heads=4, n_kv_heads=2, ffn_dim=512,
                              remat=True)
    base = tlora.init_base_params(
        cfg, torch.Generator(device=cuda_device).manual_seed(0))
    state, _ = tlora.create_lora_state(
        cfg, torch.Generator(device=cuda_device).manual_seed(1), 8)
    ad = optim.tree_map(lambda t: t + 0.01, state.params)
    tokens = torch.randint(0, cfg.vocab_size, (2, 129), device=cuda_device,
                           generator=torch.Generator(device=cuda_device)
                           .manual_seed(2))
    combine = tlora.merge_lora if forward == "merged" else tlora.attach_lora
    grads = {}
    for impl in ("flash", "dense"):
        live = optim.tree_map(lambda t: t.detach().requires_grad_(), ad)
        before = flash.launch_count["flash_fwd"]
        tl.llama_loss(combine(base, live), tokens,
                      dataclasses.replace(cfg, attention_impl=impl)
                      ).backward()
        if impl == "flash":
            # once a layer: remat keeps the forward's residuals
            assert flash.launch_count["flash_fwd"] - before == cfg.n_layers
        grads[impl] = _flat(optim.tree_map(lambda t: t.grad.float(), live))
    for path, ref in grads["dense"].items():
        rel = ((grads["flash"][path] - ref).norm() / ref.norm()).item()
        assert rel <= 2e-2, (path, rel)


def test_lora_phase_on_cpu(tmp_path, monkeypatch, capsys):
    """``chip_smoke.py``'s lora phase at the tiny preset on the CPU: its
    checks hold here as on the card (first loss bit-equal to the base's,
    base unchanged, a resumed --qlora run's adapter checkpoint bit-equal
    to an uninterrupted one's, both servers giving an in-memory engine's
    greedy tokens); the launch counts stay 0, since on the CPU the
    wrappers run the kernels' plain versions."""
    import chip_smoke

    monkeypatch.chdir(tmp_path)  # the phase writes under ./build
    res = chip_smoke.phase_lora(torch.device("cpu"), None, None, "tiny", 2,
                                32, big="tiny", big_seq=32, max_seq=128)
    assert [r["forward"] for r in res["runs"]] == ["merged", "attached"]
    assert all(r["first_loss_equals_base"] and r["base_unchanged"]
               for r in res["runs"])
    assert res["cli"]["R_vs_Q"]["bit_equal"]
    assert res["cli"]["losses"]["Q"] == res["cli"]["losses"]["R"]
    # rank-16 adapters on wq and wv of two layers, f32
    assert res["runs"][0]["adapter_params"] == 2 * 16 * (64 + 64 + 64 + 32)
    assert res["serve_attached"]["served_leaf"] == \
        "LoraLinear(QuantizedLinear)"
    assert not res["serve_attached"]["fused"]
    assert len(res["big"]["losses"]) == 3
    assert set(res["launches"].values()) == {0}
    assert not (tmp_path / "build" / "lora").exists()  # cleaned up
    assert '"phase": "lora"' in capsys.readouterr().out
