"""The port's ViT family (``models/vit.py``), ``ops/norms.py``
``layer_norm``, the MNIST MLP (``models/mlp.py``), the attention rule
(``ops/attention.py`` ``auto_impl``) and the trainer's tuple batches,
against the JAX package's, same weights.

The tiny preset on the CPU; weights are drawn with numpy from a seed and
cross into both packages through ``models/convert.py``. Tolerances: f32
forwards, losses and ``layer_norm`` 1e-5; gradients 1e-5 of each leaf's
largest; the bf16 tiny preset 2e-2 relative L2; three train steps the
losses at 1e-4 and the parameters as the Llama trainer's test holds them
(tests/test_torch_train.py); remat exactly no-remat; synthetic rows
exactly layout-invariant.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_docker_api.models import mlp as jmlp
from tpu_docker_api.models import vit as jv
from tpu_docker_api.ops import norms as jnorms
from tpu_docker_api.parallel.mesh import single_device_mesh
from tpu_docker_api.train import optim as jopt
from tpu_docker_api.train import trainer as jtrainer
from tpu_docker_api_torch import models as tmodels
from tpu_docker_api_torch.models import mlp as tmlp
from tpu_docker_api_torch.models import vit as tv
from tpu_docker_api_torch.models.convert import (opt_state_from_numpy,
                                                 params_from_numpy,
                                                 params_to_numpy)
from tpu_docker_api_torch.ops import norms as tnorms
from tpu_docker_api_torch.ops.attention import auto_impl
from tpu_docker_api_torch.train import optim, trainer

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5


def numpy_vit_params(cfg, seed: int) -> dict:
    """A ViT param tree of numpy f32 arrays from a numpy seed, in the
    layout both packages share. Norm scales and biases are drawn away
    from 1 and 0, so a wrong wiring of either shows."""
    rng = np.random.default_rng(seed)

    def make(spec):
        if isinstance(spec, dict):
            return {k: make(v) for k, v in spec.items()}
        shape, how = spec
        noise = rng.standard_normal(shape).astype(np.float32)
        if how == "ones":
            return 1.0 + 0.1 * noise
        if how == "zeros":
            return 0.1 * noise
        if how in ("pos", "head"):
            return 0.02 * noise
        return noise / np.float32(np.sqrt(how))

    return make(tv.vit_param_specs(cfg))


def _cfgs(dtype="f32", **kw):
    jd, td = ((jnp.float32, torch.float32) if dtype == "f32"
              else (jnp.bfloat16, torch.bfloat16))
    return (dataclasses.replace(jv.vit_presets()["tiny"], dtype=jd, **kw),
            dataclasses.replace(tv.vit_presets()["tiny"], dtype=td, **kw))


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = _cfgs()
    tree = numpy_vit_params(tcfg, seed=3)
    return (jcfg, tcfg, jax.tree_util.tree_map(jnp.asarray, tree),
            params_from_numpy(tree, "cpu"))


def _images(b, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random((b, 64, 64, 3)).astype(np.float32),
            rng.integers(0, 10, (b,)).astype(np.int32))


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# ----------------------------------------------------------------- ops

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_layer_norm_matches_jax(dtype):
    """f32 within 1e-5; bf16 within one bf16 rounding (both compute in
    f32 and cast back once)."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 5, 48)) * 3 + 1).astype(np.float32)
    w = rng.standard_normal(48).astype(np.float32)
    b = rng.standard_normal(48).astype(np.float32)
    jd, td = ((jnp.float32, torch.float32) if dtype == "f32"
              else (jnp.bfloat16, torch.bfloat16))
    ref = np.asarray(jnorms.layer_norm(jnp.asarray(x, jd), jnp.asarray(w, jd),
                                       jnp.asarray(b, jd)), np.float32)
    got = tnorms.layer_norm(torch.from_numpy(x).to(td),
                            torch.from_numpy(w).to(td),
                            torch.from_numpy(b).to(td))
    assert got.dtype == td
    tol = TOL if dtype == "f32" else 2**-7 * np.abs(ref).max()
    np.testing.assert_allclose(got.float().numpy(), ref, atol=tol)


def test_patchify_matches_jax():
    jcfg, tcfg = _cfgs()
    img, _ = _images(2)
    ref = np.asarray(jv._patchify(jnp.asarray(img), jcfg))
    got = tv._patchify(torch.from_numpy(img), tcfg).numpy()
    assert got.shape == (2, tcfg.n_patches, 16 * 16 * 3)
    np.testing.assert_array_equal(got, ref)


# ----------------------------------------------------- config and init

@pytest.mark.parametrize("name", ["vit-b16", "vit-s16", "tiny"])
def test_presets_fields_and_flops_as_jax(name):
    jcfg, tcfg = jv.vit_presets()[name], tv.vit_presets()[name]
    for f in dataclasses.fields(jv.ViTConfig):
        if f.name != "dtype":
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    assert tcfg.dtype == torch.bfloat16
    assert (tcfg.n_patches, tcfg.head_dim) == (jcfg.n_patches,
                                               jcfg.head_dim)
    assert tcfg.flops_per_image() == jcfg.flops_per_image()
    assert set(tv.vit_presets()) == set(jv.vit_presets())


@pytest.mark.parametrize("name", ["vit-b16", "tiny"])
def test_param_shapes_and_dtypes_match_jax_init(name):
    jcfg, tcfg = jv.vit_presets()[name], tv.vit_presets()[name]
    abstract = jax.eval_shape(lambda: jv.vit_init(jcfg,
                                                  jax.random.PRNGKey(0)))
    shapes, dtypes = tmodels.param_shapes(tcfg), tmodels.param_dtypes(tcfg)
    n = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(abstract):
        s, d = shapes, dtypes
        for p in path:
            s, d = s[p.key], d[p.key]
        assert tuple(s) == leaf.shape, path
        assert str(d).split(".")[-1] == str(leaf.dtype), path
        n += 1
    assert n == len(jax.tree_util.tree_leaves(shapes,
                                              is_leaf=lambda x: isinstance(
                                                  x, tuple)))


def test_init_tree_as_the_jax_init_draws_it():
    """Ones, zeros, the near-zero head and the fan-in matrices as in the
    JAX init (torch draws other numbers from a seed)."""
    cfg = tv.vit_presets()["tiny"]
    p = tv.vit_init(cfg, torch.Generator().manual_seed(0))
    assert all(t.dtype == torch.bfloat16 for t in optim.tree_leaves(p))
    assert bool((p["layers"]["ln1_w"] == 1).all())
    assert bool((p["patch_embed"]["b"] == 0).all())
    assert bool((p["layers"]["mlp"]["b1"] == 0).all())
    wq = p["layers"]["attn"]["wq"].float()
    assert wq.abs().max() <= 2 / cfg.dim**0.5 + 1e-3  # clipped at 2σ
    assert 0.5 < wq.std().item() * cfg.dim**0.5 < 1.0
    assert p["head"].float().abs().max() <= 0.02 * 2 / cfg.dim**0.5 + 1e-4
    assert 0.01 < p["pos_emb"].float().std().item() < 0.03
    # the two stacked layers are drawn apart
    assert not torch.equal(wq[0], wq[1])


def test_registry_dispatches_the_vit_family():
    cfg = tv.vit_presets()["tiny"]
    assert tmodels.model_fns(cfg)[:2] == (tv.vit_init, tv.vit_loss)
    assert tmodels.resolve_preset("vit:vit-b16") == (
        "vit", tv.vit_presets()["vit-b16"])
    with pytest.raises(KeyError):
        tmodels.resolve_preset("vit:nope")
    with pytest.raises(TypeError):
        tmodels.cached_forward_fn(cfg)  # no generative path, as in JAX


# ------------------------------------------------------------ forward

def test_vit_forward_matches_jax(setup):
    jcfg, tcfg, jp, tp = setup
    img, _ = _images(3)
    ref = np.asarray(jv.vit_forward(jp, jnp.asarray(img), jcfg))
    got = tv.vit_forward(tp, torch.from_numpy(img), tcfg)
    assert got.dtype == torch.float32 and got.shape == (3, 10)
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL, rtol=TOL)


def test_vit_forward_bf16_matches_jax():
    """The bf16 tiny preset: both round their products and activations
    to bf16, in other orders: 2e-2 relative L2."""
    jcfg, tcfg = _cfgs("bf16")
    tree = numpy_vit_params(tcfg, seed=4)
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), tree)
    tp = params_from_numpy(tree, "cpu", torch.bfloat16)
    img, lab = _images(4, seed=1)
    ref = jv.vit_forward(jp, jnp.asarray(img), jcfg)
    got = tv.vit_forward(tp, torch.from_numpy(img), tcfg)
    assert _rel_l2(got.numpy(), ref) < 2e-2
    ref_loss = float(jv.vit_loss(jp, (jnp.asarray(img), jnp.asarray(lab)),
                                 jcfg))
    got_loss = tv.vit_loss(tp, (torch.from_numpy(img),
                                torch.from_numpy(lab)), tcfg).item()
    assert abs(got_loss - ref_loss) < 2e-2 * abs(ref_loss)


@pytest.mark.parametrize("remat", [False, True])
def test_vit_loss_and_grads_match_jax(setup, remat):
    jcfg, tcfg, jp, tp = setup
    jcfg, tcfg = (dataclasses.replace(c, remat=remat) for c in (jcfg, tcfg))
    img, lab = _images(3, seed=2)
    jloss, jgrads = jax.value_and_grad(jv.vit_loss)(
        jp, (jnp.asarray(img), jnp.asarray(lab)), jcfg)
    live = optim.tree_map(lambda t: t.detach().requires_grad_(), tp)
    loss = tv.vit_loss(live, (torch.from_numpy(img),
                              torch.from_numpy(lab)), tcfg)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=TOL)
    got = dict(jax.tree_util.tree_leaves_with_path(
        params_to_numpy(optim.tree_map(lambda t: t.grad, live))))
    for path, ref in jax.tree_util.tree_leaves_with_path(jgrads):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got[path], ref,
                                   atol=TOL * np.abs(ref).max(), err_msg=str(
                                       path))


def test_remat_equals_no_remat(setup):
    """Checkpointing recomputes the same ops: loss and gradients exactly
    equal."""
    _, tcfg, _, tp = setup
    img, lab = _images(2, seed=5)
    batch = (torch.from_numpy(img), torch.from_numpy(lab))
    out = []
    for remat in (False, True):
        live = optim.tree_map(lambda t: t.detach().requires_grad_(), tp)
        loss = tv.vit_loss(live, batch, dataclasses.replace(tcfg,
                                                            remat=remat))
        loss.backward()
        out.append((loss.item(), [t.grad for t in optim.tree_leaves(live)]))
    assert out[0][0] == out[1][0]
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


def test_synthetic_batch_rows_are_layout_invariant():
    """Row r depends only on (seed, r): two halves made apart equal the
    whole batch; another seed or step draws other rows."""
    cfg = tv.vit_presets()["tiny"]
    whole = tv.vit_synthetic_batch((1, 7), 4, cfg)
    lo = tv.vit_synthetic_batch((1, 7), 2, cfg)
    hi = tv.vit_synthetic_batch((1, 7), 2, cfg, row_offset=2)
    for i in range(2):
        assert torch.equal(torch.cat([lo[i], hi[i]]), whole[i])
    images, labels = whole
    assert images.shape == (4, 64, 64, 3) and images.dtype == torch.float32
    assert 0 <= images.min() and images.max() < 1
    assert labels.dtype == torch.long and 0 <= labels.min() < 10
    assert not torch.equal(tv.vit_synthetic_batch((1, 8), 4, cfg)[0],
                           images)


# ------------------------------------------------------------ trainer

def test_trainer_takes_tuple_batches_and_the_loss_falls():
    cfg = dataclasses.replace(tv.vit_presets()["tiny"], dtype=torch.float32)
    state, tx = trainer.create_train_state(
        cfg, "cpu", torch.Generator().manual_seed(0))
    step = trainer.make_train_step(cfg, tx)
    batch = tv.vit_synthetic_batch(0, 8, cfg)
    losses = []
    for _ in range(4):
        state, metrics = step(state, batch)
        losses.append(metrics["loss"].item())
    assert state.step == 4 and metrics["step"] == 4
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("optim_name", ["adamw", "adamw-int8"])
def test_three_train_steps_match_jax(setup, optim_name):
    """Three steps of both trainers from the same params on tuple
    batches: losses and gradient norms at 1e-4; then the JAX state
    (params and optimizer state, carried by models/convert.py) steps
    once more in both."""
    jcfg, tcfg, _, _ = setup
    mesh = single_device_mesh()
    if optim_name == "adamw":
        jtx, ttx = jtrainer.default_optimizer(), trainer.default_optimizer()
    else:
        jtx, ttx = jopt.adamw_int8(impl="xla"), optim.adamw_int8()
    jstate, jtx = jtrainer.create_train_state(jcfg, mesh,
                                              jax.random.PRNGKey(0), jtx)
    host = jax.tree_util.tree_map(np.asarray, jstate.params)
    params = params_from_numpy(host, "cpu")
    tstate = trainer.TrainState(0, params, ttx.init(params))
    jstep = jtrainer.make_train_step(jcfg, mesh, jtx)
    tstep = trainer.make_train_step(tcfg, ttx)
    batches = [_images(2, seed=10 + i) for i in range(4)]
    for img, lab in batches[:3]:
        jstate, jmet = jstep(jstate, (jnp.asarray(img), jnp.asarray(lab)))
        tstate, tmet = tstep(tstate, (torch.from_numpy(img),
                                      torch.from_numpy(lab)))
        np.testing.assert_allclose(tmet["loss"].item(), float(jmet["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(tmet["grad_norm"].item(),
                                   float(jmet["grad_norm"]), rtol=1e-4)
    got = dict(jax.tree_util.tree_leaves_with_path(
        params_to_numpy(tstate.params)))
    for path, ref in jax.tree_util.tree_leaves_with_path(jstate.params):
        diff = np.abs(got[path] - np.asarray(ref))
        assert diff.max() <= 6 * 3e-4, path
        assert (diff > 2e-6).mean() <= 1e-3, path
    # the JAX state carried over whole, then one more step in both
    host = jax.tree_util.tree_map(np.asarray, jstate)
    carried = trainer.TrainState(int(host.step),
                                 params_from_numpy(host.params, "cpu"),
                                 opt_state_from_numpy(host.opt_state, "cpu"))
    img, lab = batches[3]
    jstate, jmet = jstep(jstate, (jnp.asarray(img), jnp.asarray(lab)))
    carried, tmet = tstep(carried, (torch.from_numpy(img),
                                    torch.from_numpy(lab)))
    np.testing.assert_allclose(tmet["loss"].item(), float(jmet["loss"]),
                               rtol=1e-4)
    got = dict(jax.tree_util.tree_leaves_with_path(
        params_to_numpy(carried.params)))
    for path, ref in jax.tree_util.tree_leaves_with_path(jstate.params):
        diff = np.abs(got[path] - np.asarray(ref))
        assert diff.max() <= 6 * 3e-4, path


def _cli(*args, timeout=240):
    return subprocess.run(
        [sys.executable, "-m", "tpu_docker_api_torch.train", *args],
        cwd=ROOT, capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("flags,msg", [
    (["--preset", "vit:tiny", "--seq", "16"],
     "--data/--seq do not apply to vit: presets"),
    (["--preset", "vit:tiny", "--data", "x.bin"],
     "--data/--seq do not apply to vit: presets"),
    (["--preset", "vit:tiny", "--moe-dispatch", "einsum"],
     "--moe-dispatch applies to moe: presets only"),
    (["--preset", "vit:tiny", "--qlora", "--lora-rank", "4"],
     "--qlora supports llama presets only")])
def test_trainer_cli_keeps_the_jax_vit_guards(flags, msg):
    proc = _cli("--device", "cpu", *flags, timeout=60)
    assert proc.returncode == 2 and msg in proc.stderr


def test_server_refuses_vit_as_jax_does():
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_docker_api_torch.serve", "--device",
         "cpu", "--preset", "vit:tiny"],
        cwd=ROOT, capture_output=True, text=True, timeout=60)
    assert proc.returncode == 2
    assert "vit presets have no generative serving path" in proc.stderr


# ---------------------------------------------------------------- MLP

def test_mlp_forward_loss_and_grads_match_jax():
    rng = np.random.default_rng(0)
    sizes = (784, 512, 256, 10)
    tree = {f"dense_{i}": {
        "w": (rng.standard_normal((a, b)) / np.sqrt(a)).astype(np.float32),
        "b": (0.1 * rng.standard_normal(b)).astype(np.float32)}
        for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:]))}
    x = rng.random((16, 784)).astype(np.float32)
    lab = rng.integers(0, 10, 16).astype(np.int32)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = optim.tree_map(lambda t: t.requires_grad_(),
                        params_from_numpy(tree, "cpu"))
    np.testing.assert_allclose(
        tmlp.mlp_forward(tp, torch.from_numpy(x)).detach().numpy(),
        np.asarray(jmlp.mlp_forward(jp, jnp.asarray(x))), atol=TOL)
    jloss, jgrads = jax.value_and_grad(jmlp.mlp_loss)(jp, jnp.asarray(x),
                                                      jnp.asarray(lab))
    loss = tmlp.mlp_loss(tp, torch.from_numpy(x), torch.from_numpy(lab))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=TOL)
    for name in tree:
        for leaf in ("w", "b"):
            ref = np.asarray(jgrads[name][leaf])
            np.testing.assert_allclose(tp[name][leaf].grad.numpy(), ref,
                                       atol=TOL * np.abs(ref).max())


def test_mlp_init_as_jax():
    """The JAX init's layout, dtype and N(0, 1/fan_in) scale."""
    p = tmlp.mlp_init(torch.Generator().manual_seed(0))
    jp = jax.eval_shape(lambda: jmlp.mlp_init(jax.random.PRNGKey(0)))
    assert set(p) == set(jp)
    for name in p:
        for leaf in ("w", "b"):
            assert tuple(p[name][leaf].shape) == jp[name][leaf].shape
            assert p[name][leaf].dtype == torch.float32
        fan_in = p[name]["w"].shape[0]
        assert 0.9 < p[name]["w"].std().item() * fan_in**0.5 < 1.1
        assert bool((p[name]["b"] == 0).all())
    half = tmlp.mlp_init(torch.Generator().manual_seed(0), dtype=torch.bfloat16)
    assert half["dense_0"]["w"].dtype == torch.bfloat16


# ----------------------------------------------------- attention rule

@pytest.mark.parametrize("q,k,causal,cuda,dtype,want", [
    # vit-b16 (256 patches) and the encdec encoder (512): non-causal
    # takes the kernel on the card; the JAX rule sent <= 256 to dense
    ((128, 256, 12, 64), (128, 256, 12, 64), False, True, torch.bfloat16,
     "flash"),
    ((32, 512, 12, 64), (32, 512, 12, 64), False, True, torch.bfloat16,
     "flash"),
    ((2, 16, 4, 64), (2, 16, 4, 64), False, True, torch.bfloat16, "flash"),
    ((2, 2048, 32, 64), (2, 2048, 8, 64), True, True, torch.bfloat16,
     "flash"),
    # cross-attention of another length, the CPU, a head_dim or dtype
    # the kernels do not take: dense
    ((32, 100, 12, 64), (32, 512, 12, 64), False, True, torch.bfloat16,
     "dense"),
    ((128, 256, 12, 64), (128, 256, 12, 64), False, False, torch.bfloat16,
     "dense"),
    ((2, 256, 4, 16), (2, 256, 4, 16), False, True, torch.bfloat16, "dense"),
    ((2, 256, 4, 64), (2, 256, 4, 64), False, True, torch.float16, "dense"),
])
def test_auto_impl_pins_the_attention_rule(q, k, causal, cuda, dtype, want):
    assert auto_impl(q, k, causal, cuda, dtype) == want


# --------------------------------------------------------------- card only

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def plain_bwd(rounded: bool, wrong: str | None = None):
    """A stand-in for ``flash.flash_attention_bwd``: the plain backward
    (``flash.flash_attention_bwd_plain``'s formulas), with P and dS
    rounded to the inputs' dtype before their products where
    csrc/flash_bwd.cu and flash_pallas.py round them (``rounded``), or
    in f32 throughout; ``wrong`` makes it a control, a backward with a
    known fault: "no_delta" drops D from dS = P∘(dP − D), "no_scale"
    drops the softmax scale from dQ and dK."""
    from tpu_docker_api_torch.ops import flash

    def bwd(q, k, v, out, lse, dout, causal=True):
        b, h, s, d = q.shape
        hk = k.shape[1]
        dt = q.dtype if rounded else torch.float32
        scale = 1.0 if wrong == "no_scale" else 1.0 / d**0.5
        probs = torch.exp(flash._plain_scores(q, k, causal)
                          - lse.float().reshape(b, hk, h // hk, s, 1))
        do = dout.to(q.dtype).float().reshape(b, hk, h // hk, s, d)
        delta = (do * out.float().reshape(b, hk, h // hk, s, d)).sum(-1)
        if wrong == "no_delta":
            delta = torch.zeros_like(delta)
        dv = torch.einsum("bhgqk,bhgqd->bhkd", probs.to(dt).float(), do)
        dp = torch.einsum("bhgqd,bhkd->bhgqk", do, v.float())
        ds = (probs * (dp - delta[..., None])).to(dt).float()
        dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, k.float()) * scale
        dk = torch.einsum("bhgqk,bhgqd->bhkd", ds,
                          q.float().reshape(b, hk, h // hk, s, d)) * scale
        return (dq.reshape(b, h, s, d).to(q.dtype), dk.to(k.dtype),
                dv.to(v.dtype))
    return bwd


#: the routes of ``_grads_by_route``: (the ``auto`` choice or dense, the
#: backward the flash forward's autograd calls; None = the kernels)
ROUTES = {"kernels": ("auto", None), "dense": ("dense", None),
          "plain_bwd_f32": ("auto", plain_bwd(False)),
          "plain_bwd_rounded": ("auto", plain_bwd(True)),
          "control_no_delta": ("auto", plain_bwd(True, "no_delta")),
          "control_no_scale": ("auto", plain_bwd(True, "no_scale"))}


def _grads_by_route(loss_fn, params, leaves, routes=("kernels", "dense")):
    """{route: (loss, {name: grad}, launches)} of ``loss_fn(params)``
    through each of ``routes`` (``ROUTES``); ``leaves`` maps a name to
    the leaf's path in the tree."""
    from tpu_docker_api_torch.ops import attention, flash

    res = {}
    auto, bwd = attention.auto_impl, flash.flash_attention_bwd
    for route in routes:
        impl, plain = ROUTES[route]
        if impl == "dense":
            attention.auto_impl = lambda *a: "dense"
        if plain is not None:
            flash.flash_attention_bwd = plain
        try:
            flash.reset_launch_count()
            live = optim.tree_map(lambda p: p.detach().requires_grad_(),
                                  params)
            loss = loss_fn(live)
            loss.backward()
            torch.cuda.synchronize()
        finally:
            attention.auto_impl, flash.flash_attention_bwd = auto, bwd
        grads = {}
        for name, path in leaves.items():
            leaf = live
            for k in path:
                leaf = leaf[k]
            grads[name] = leaf.grad.float()
        res[route] = (loss.item(), grads, dict(flash.launch_count))
    return res


def _rel_l2_dev(a, b) -> float:
    """Relative L2 of two tensors where they lie (the card)."""
    return float((a - b).norm() / b.norm())


#: bf16 gradients of the kernel route against the dense route, relative
#: L2: above the sound readings (2.3-2.5% on an H100 through two layers;
#: PERF.md §6) and below the controls, which must exceed it
BF16_GRAD_TOL = 5e-2
#: the kernel route against the plain backward that rounds P and dS
#: where the kernels do: accumulation order and exp2 against exp alone
BF16_ROUNDED_TOL = 1e-2


def check_bf16_grads(res, record) -> None:
    """The bf16 gradient checks of a ``_grads_by_route(..., ROUTES)``
    run: every leaf's kernel-route gradient within ``BF16_GRAD_TOL`` of
    the dense route's and within ``BF16_ROUNDED_TOL`` of the rounded
    plain backward's; each control farther than ``BF16_GRAD_TOL`` from
    the dense route on some leaf. Every reading goes to ``record``."""
    dense = res["dense"][1]
    readings = {route: {n: _rel_l2_dev(g, dense[n])
                        for n, g in res[route][1].items()}
                for route in res if route != "dense"}
    readings["kernels_vs_plain_bwd_rounded"] = {
        n: _rel_l2_dev(g, res["plain_bwd_rounded"][1][n])
        for n, g in res["kernels"][1].items()}
    record("bf16_grad_rel_l2_vs_dense", readings)
    for n, r in readings["kernels"].items():
        assert r < BF16_GRAD_TOL, (n, readings)
    for n, r in readings["kernels_vs_plain_bwd_rounded"].items():
        assert r < BF16_ROUNDED_TOL, (n, readings)
    for control in ("control_no_delta", "control_no_scale"):
        assert max(readings[control].values()) > BF16_GRAD_TOL, (
            control, readings)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vit_through_the_kernels_matches_the_plain_path(cuda, dtype,
                                                        record_property):
    """Two vit-b16-width blocks (12 heads, 256 patches, non-causal), remat
    on, on the card, through the flash kernels against the dense plain
    path; one forward and one backward launch a layer. f32 (the kernels'
    CUDA-core path): the loss and the wq/wk/wv gradients within 1e-4
    relative, summation order alone. bf16 (the tensor-core kernels): the
    loss within 2e-2, and the gradients as ``check_bf16_grads`` holds
    them (the kernel route against the dense route and against the
    plain backward with the kernels' rounding, and two controls)."""
    cfg = dataclasses.replace(tv.vit_presets()["vit-b16"], n_layers=2,
                              dtype=dtype)
    params = tv.vit_init(cfg, torch.Generator(device=cuda).manual_seed(0))
    batch = tv.vit_synthetic_batch(1, 4, cfg, device=cuda)
    res = _grads_by_route(lambda p: tv.vit_loss(p, batch, cfg), params,
                          {n: ("layers", "attn", n)
                           for n in ("wq", "wk", "wv")},
                          ROUTES if dtype == torch.bfloat16
                          else ("kernels", "dense"))
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert res["kernels"][2][name] == cfg.n_layers, name
        assert res["dense"][2][name] == 0, name
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert abs(res["kernels"][0] - res["dense"][0]) < tol * res["dense"][0]
    if dtype == torch.float32:
        for name, g in res["kernels"][1].items():
            assert _rel_l2_dev(g, res["dense"][1][name]) < tol, name
    else:
        check_bf16_grads(res, record_property)
