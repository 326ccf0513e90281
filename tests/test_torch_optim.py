"""The port's optimizers against optax and the JAX int8 AdamW.

Parameter trees of a few leaves (nested dicts, 1-D to 3-D, last dims that
the 256-element quantization block divides and ones it does not), inputs
from a numpy seed, three steps. Tolerances:

- ``default_optimizer`` in f32: params and moments at 1e-6 (the same ops
  in the same order; f32 sums of squares in another order).
- int8 AdamW: int8 moments at most one count apart (a requantization
  rounds ties of the f32 moment, which may differ in its last bit),
  scales rtol 1e-6, updates and params atol 1e-6 (one count of a moment
  moves an update by at most lr/127 of its block's largest step).

The CUDA kernel is held against the plain version by the ``gpu``-marked
tests, which skip without a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpu_docker_api.train import optim as jopt
from tpu_docker_api.train.trainer import default_optimizer as jax_default
from tpu_docker_api_torch.train import optim
from tpu_docker_api_torch.train.trainer import default_optimizer

SHAPES = {"a": (4, 32, 96), "b": {"c": (48,), "d": (16, 600)},
          "e": (3, 256)}
#: leaves whose quantization block is not a multiple of 8 (b = 100, 97):
#: the CUDA kernel's scalar path, held against the plain version on the
#: card, so the plain version is pinned to the reference here
ODD_SHAPES = {"a": (5, 100), "b": (7, 97)}


def _tree(rng, scale=1.0, dtype=np.float32, shapes=SHAPES):
    def make(spec):
        if isinstance(spec, dict):
            return {k: make(v) for k, v in spec.items()}
        return (rng.standard_normal(spec) * scale).astype(dtype)
    return make(shapes)


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


def _to_torch(tree):
    return jax.tree_util.tree_map(torch.from_numpy, tree)


def _to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _close(got_tree, ref_tree, atol, rtol=0.0):
    got = optim.tree_leaves(got_tree)
    ref = _leaves(ref_tree)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=rtol,
                                   atol=atol)


def _run_both(jax_tx, torch_tx, grad_scales, shapes=SHAPES):
    """Three steps of one gradient stream through both optimizers."""
    rng = np.random.default_rng(0)
    p0 = _tree(rng, shapes=shapes)
    jp, tp = _to_jax(p0), _to_torch(p0)
    js, ts = jax_tx.init(jp), torch_tx.init(tp)
    for scale in grad_scales:
        g = _tree(rng, scale, shapes=shapes)
        ju, js = jax_tx.update(_to_jax(g), js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = torch_tx.update(_to_torch(g), ts, tp)
        tp = optim.apply_updates(tp, tu)
    return (jp, js), (tp, ts)


def test_default_optimizer_matches_optax():
    # global norms ~150x, ~0.75x and ~15x the clip norm: the clip
    # triggers on the first and last steps only
    (jp, js), (tp, ts) = _run_both(jax_default(), default_optimizer(),
                                   [1.0, 5e-3, 0.1])
    _close(tp, jp, atol=1e-6)
    adam_j, adam_t = js[1][0], ts[1][0]
    assert adam_t.count == int(adam_j.count) == 3
    _close(adam_t.mu, adam_j.mu, atol=1e-6)
    _close(adam_t.nu, adam_j.nu, atol=1e-6)


def test_clip_and_global_norm_match_optax():
    rng = np.random.default_rng(1)
    g = _tree(rng, 0.5)
    ref = optax.global_norm(_to_jax(g))
    got = optim.global_norm(_to_torch(g))
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)
    ju, _ = optax.clip_by_global_norm(1.0).update(_to_jax(g), None)
    tu, _ = optim.clip_by_global_norm(1.0).update(_to_torch(g), None)
    _close(tu, ju, atol=1e-7)


@pytest.mark.parametrize("shapes", [SHAPES, ODD_SHAPES],
                         ids=["blocks", "odd-blocks"])
@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
def test_adamw_int8_plain_matches_jax(impl, shapes):
    (jp, js), (tp, ts) = _run_both(jopt.adamw_int8(impl=impl),
                                   optim.adamw_int8(), [1.0, 5e-3, 0.1],
                                   shapes)
    _close(tp, jp, atol=1e-6)
    j8, t8 = js[1], ts[1]
    assert t8.count == int(j8.count) == 3
    for tq, jq in ((t8.mu_q, j8.mu_q), (t8.nu_q, j8.nu_q)):
        _close(jax.tree_util.tree_map(lambda x: x.to(torch.int32), tq),
               jax.tree_util.tree_map(lambda x: x.astype(np.int32), jq),
               atol=1)
    for ts_, js_ in ((t8.mu_scale, j8.mu_scale), (t8.nu_scale, j8.nu_scale)):
        got = optim.tree_map(
            lambda s, shape: optim.scales_to_jax(s, shape[-1]), ts_, shapes)
        _close(got, js_, atol=0.0, rtol=1e-6)


@pytest.mark.parametrize("shape", [(4, 32, 96), (48,), (16, 600),
                                   (2, 3, 1024), (5, 7)])
def test_quant_and_scale_layouts_match_jax(shape):
    rng = np.random.default_rng(3)
    x = rng.standard_normal(shape).astype(np.float32)
    jq, js = jopt._quant_signed(jnp.asarray(x), 256)
    tq, ts = optim._quant_signed(torch.from_numpy(x), 256)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    back = optim.scales_to_jax(ts, shape[-1])
    np.testing.assert_array_equal(back.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        optim.scales_from_jax(back).numpy(), ts.numpy())
    np.testing.assert_array_equal(
        optim._dequant_signed(tq, ts).numpy(),
        np.asarray(jopt._dequant_signed(jq, js)))


def test_update_leaf_rejects_mismatched_scales():
    g = torch.zeros(4, 512)
    q = torch.zeros(4, 512, dtype=torch.int8)
    sc = optim.adam8_scalars(1, 0.9, 0.95, 1e-8)
    with pytest.raises(ValueError):
        optim.adam8_update_leaf(g, q, torch.zeros(4, 1), q,
                                torch.zeros(4, 1), sc=sc)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel, no CPU mode)")
    return torch.device("cuda")


def _at_offset(t: torch.Tensor, offset: int) -> torch.Tensor:
    """A contiguous copy of ``t`` that starts ``offset`` elements into a
    larger buffer: its base is not 16-byte aligned for an odd offset."""
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    out = buf[offset:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype,offset", [
    ((64, 256), torch.float32, 0), ((3, 512), torch.bfloat16, 0),
    ((100, 96), torch.bfloat16, 0), ((2048,), torch.bfloat16, 0),
    ((4, 2048, 600), torch.bfloat16, 0),
    # the scalar path: b = 100 and b = 97 are not multiples of 8, and a
    # leaf at an odd offset of a larger buffer is not 16-byte aligned
    ((5, 100), torch.bfloat16, 0), ((7, 97), torch.bfloat16, 0),
    ((8, 512), torch.bfloat16, 1)])
@pytest.mark.parametrize("with_p", [True, False])
def test_adam8_kernel_matches_plain_on_card(cuda_device, shape, dtype,
                                            offset, with_p):
    """int8 moments at most one count apart and scales rtol 1e-6, as on
    the CPU; the update within one rounding of its dtype (rtol 2^-7 in
    bf16, 1e-5 in f32): the kernel repeats the plain version's f32 ops,
    on either of its paths."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    grad = torch.randn(shape, generator=g, device=cuda_device).to(dtype)
    p = torch.randn(shape, generator=g, device=cuda_device).to(dtype) \
        if with_p else None
    mq, ms = optim._quant_signed(
        torch.randn(shape, generator=g, device=cuda_device) * 1e-2, 256)
    vq, vs = optim._quant_sqrt(
        torch.rand(shape, generator=g, device=cuda_device) * 1e-4, 256)
    if offset:
        grad, mq, vq = (_at_offset(t, offset) for t in (grad, mq, vq))
        p = _at_offset(p, offset) if with_p else None
        assert grad.data_ptr() % 16 and mq.data_ptr() % 8
    sc = optim.adam8_scalars(3, 0.9, 0.95, 1e-8, 3e-4, 0.1)
    before = optim.launch_count["adam8"]
    got = optim.adam8_update_leaf(grad, mq, ms, vq, vs, p, sc=sc)
    torch.cuda.synchronize()
    assert optim.launch_count["adam8"] == before + 1
    ref = optim.adam8_plain(grad, mq, ms, vq, vs, p, sc=sc)
    upd, ref_upd = got[0].float(), ref[0].float()
    rtol = 2**-7 if dtype == torch.bfloat16 else 1e-5
    assert ((upd - ref_upd).abs() <= rtol * ref_upd.abs() + 1e-12).all()
    for i in (1, 3):
        assert (got[i].int() - ref[i].int()).abs().max().item() <= 1
    for i in (2, 4):
        torch.testing.assert_close(got[i], ref[i], rtol=1e-6, atol=0)
