"""The port's differentiable flash attention against the JAX custom VJP.

On the CPU ``flash.flash_attention`` runs the plain forward and the plain
backward (``flash_attention_bwd_plain``) through the custom op's autograd;
both are held against ``jax.vjp`` of ``flash_attention(...,
interpret=True)`` — the Pallas kernels in interpret mode, as
tests/test_ops.py runs them — on the cases of tests/test_torch_flash.py,
at f32 tolerance 1e-4 (two frameworks' f32 summation orders over up to
256 keys). The CUDA kernels are held against the plain version, and the
model's gradients through ``impl="flash"`` against ``impl="dense"``, by
the ``gpu``-marked tests, which skip without a card.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_docker_api.ops.flash_pallas import flash_attention as jax_flash
from tpu_docker_api_torch.models import llama as tl
from tpu_docker_api_torch.ops import flash
from tpu_docker_api_torch.ops.attention import (dense_attention,
                                                multihead_attention)

TOL = 1e-4

# (heads, kv_heads, seq, head_dim, block, causal) — test_torch_flash.py's
CASES = {
    "mha": (4, 4, 128, 64, 128, True),
    "gqa2": (4, 2, 128, 64, 128, True),
    "gqa4-multiblock": (4, 1, 256, 64, 128, True),
    "d128-multiblock": (2, 1, 256, 128, 128, True),
    "noncausal-gqa2": (4, 2, 128, 128, 128, False),
    "noncausal-multiblock": (2, 2, 256, 64, 128, False),
}


def _inputs(seed, b, h, hk, s, d):
    rng = np.random.default_rng(seed)
    shapes = ((b, h, s, d), (b, hk, s, d), (b, hk, s, d), (b, h, s, d))
    return tuple(rng.standard_normal(sh).astype(np.float32) for sh in shapes)


def _torch_vjp(q, k, v, dout, causal):
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = flash.flash_attention(tq, tk, tv, causal)
    out.backward(torch.from_numpy(dout))
    return out.detach(), tq.grad, tk.grad, tv.grad


@pytest.mark.parametrize("case", list(CASES))
def test_plain_fwd_bwd_matches_pallas_vjp(case):
    h, hk, s, d, blk, causal = CASES[case]
    q, k, v, dout = _inputs(0, 1, h, hk, s, d)
    ref_out, vjp = jax.vjp(
        lambda a, b_, c: jax_flash(a, b_, c, causal, blk, blk, True),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = (ref_out, *vjp(jnp.asarray(dout)))
    before = dict(flash.launch_count)
    got = _torch_vjp(q, k, v, dout, causal)
    assert flash.launch_count == before  # CPU: the plain versions
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("seq,causal", [(100, True), (33, False)])
def test_plain_bwd_ragged_seq_matches_dense_autograd(seq, causal):
    """Lengths below the JAX kernel's multiple-of-128 contract: the plain
    backward against autograd through dense attention."""
    q, k, v, dout = _inputs(1, 2, 4, 2, seq, 64)
    got = _torch_vjp(q, k, v, dout, causal)
    tq, tk, tv = (torch.from_numpy(x).transpose(1, 2).requires_grad_()
                  for x in (q, k, v))
    out = dense_attention(tq, tk, tv, causal=causal)
    out.backward(torch.from_numpy(dout).transpose(1, 2))
    for g, r in zip(got, (out.transpose(1, 2), tq.grad.transpose(1, 2),
                          tk.grad.transpose(1, 2), tv.grad.transpose(1, 2))):
        np.testing.assert_allclose(g.numpy(), r.detach().numpy(), rtol=TOL,
                                   atol=TOL)


def test_bwd_takes_any_cotangent_layout():
    """The cotangent may be a strided view; the result does not depend on
    its layout."""
    q, k, v, dout = _inputs(2, 1, 4, 2, 64, 64)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out, lse = flash.flash_attention_fwd(tq, tk, tv)
    ref = flash.flash_attention_bwd(tq, tk, tv, out, lse,
                                    torch.from_numpy(dout))
    strided = torch.from_numpy(dout).transpose(1, 2).contiguous() \
        .transpose(1, 2)
    got = flash.flash_attention_bwd(tq, tk, tv, out, lse, strided)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=0, atol=0)


def test_bwd_rejects_mismatched_cotangent():
    q, k, v, _ = _inputs(3, 1, 4, 2, 16, 64)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out, lse = flash.flash_attention_fwd(tq, tk, tv)
    with pytest.raises(ValueError):
        flash.flash_attention_bwd(tq, tk, tv, out, lse, torch.zeros(1, 4, 8,
                                                                     64))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel, no CPU mode)")
    return torch.device("cuda")


def _rel(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


# the tile edges of the kernels (64-query tiles, dq's 64-key kv tiles,
# dk/dv's 64-key blocks), both GQA group sizes, d=128, full attention;
# the f32 cases run the CUDA-core kernels
BF, F32 = torch.bfloat16, torch.float32
CARD_CASES = [(100, 64, BF, 4, True), (256, 128, BF, 4, True),
              (200, 64, BF, 4, False), (64, 64, F32, 4, True)]
CARD_CASES += [(s, 64, BF, g, True) for s in (1, 63, 65, 127, 129)
               for g in (1, 4)]
CARD_CASES += [(s, 128, BF, 4, True) for s in (1, 65, 129)]
CARD_CASES += [(s, d, BF, 4, False) for s in (1, 65, 129) for d in (64, 128)]
CARD_CASES += [(65, 64, F32, 1, False), (129, 128, F32, 4, True)]
CARD_CASES += [(s, 64, BF, g, True) for s in (64, 128, 255, 257)
               for g in (1, 4)]
CARD_CASES += [(255, 128, BF, 1, True), (257, 64, BF, 4, False)]


@pytest.mark.gpu
@pytest.mark.parametrize("seq,d,dtype,group,causal", CARD_CASES)
def test_bwd_kernels_match_plain_on_card(cuda_device, seq, d, dtype, group,
                                         causal):
    """|kernel - plain| <= tol·max|plain| per gradient: bf16 2e-2 (both
    round the f32 result once, the kernel also P and dS before dk/dv's
    products; the sums run in another order), f32 1e-4. At seq=1 the one
    key gets P = 1, so dS = dO·v − rowsum(dO∘O) = 0: dq and dk are zero
    up to f32 rounding in both versions and are held to tol·max|dv|."""
    g = torch.Generator(device=cuda_device).manual_seed(0)

    def mk(n):  # the model's (b, s, h, d) layout, as (b, h, s, d) views
        return torch.randn(2, seq, n, d, generator=g,
                           device=cuda_device).to(dtype).transpose(1, 2)

    q, k, v, dout = mk(8), mk(8 // group), mk(8 // group), mk(8)
    out, lse = flash.flash_attention_fwd(q, k, v, causal)
    before = dict(flash.launch_count)
    got = flash.flash_attention_bwd(q, k, v, out, lse, dout, causal)
    torch.cuda.synchronize()
    assert flash.launch_count["flash_bwd_dq"] == before["flash_bwd_dq"] + 1
    assert flash.launch_count["flash_bwd_dkv"] == before["flash_bwd_dkv"] + 1
    ref = flash.flash_attention_bwd_plain(q, k, v, out, lse, dout, causal)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    scales = [rf.float().abs().max().item() for rf in ref]
    if seq == 1:
        scales[:2] = [scales[2]] * 2
    for gr, rf, scale in zip(got, ref, scales):
        assert gr.shape == rf.shape
        err = (gr.float() - rf.float()).abs().max().item()
        assert err <= tol * scale


@pytest.mark.gpu
def test_bwd_refuses_misaligned_rows_on_card(cuda_device):
    """The bf16 dq kernel reads out's rows 16 bytes at a time and q, k,
    v, dout by TMA: a tensor whose rows break ``rows_aligned`` is refused
    with a ValueError naming it, never read misaligned."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v, dout = (torch.randn(1, 4, 64, 64, generator=g,
                                 device=cuda_device).to(torch.bfloat16)
                     for _ in range(4))
    out, lse = flash.flash_attention_fwd(q, k, v)
    odd = torch.empty(out.numel() + 1, dtype=out.dtype,
                      device=cuda_device)[1:].view(out.shape)
    odd.copy_(out)
    assert not flash.rows_aligned(odd)
    with pytest.raises(ValueError, match=r"flash_bwd_dq.*\[3\]"):
        flash.flash_bwd_dq(q, k, v, odd, lse, dout)


@pytest.mark.gpu
def test_model_grads_through_flash_match_dense_on_card(cuda_device):
    """The gradients of wq/wk/wv through the kernel path match the dense
    path (relative L2 2e-2: bf16 rounding at different places in two
    attention implementations through one block)."""
    cfg = dataclasses.replace(tl.llama_presets()["tiny"], dim=256,
                              n_heads=4, n_kv_heads=2, n_layers=1,
                              remat=True)
    params = tl.llama_init(cfg, torch.Generator(device=cuda_device)
                           .manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (2, 129), device=cuda_device)
    grads = {}
    for impl in ("flash", "dense"):
        c = dataclasses.replace(cfg, attention_impl=impl)
        live = {k: v for k, v in params.items()}
        attn = {n: w.detach().requires_grad_()
                for n, w in params["layers"]["attn"].items()}
        live["layers"] = {**params["layers"], "attn": attn}
        flash.reset_launch_count()
        tl.llama_loss(live, tokens, c).backward()
        if impl == "flash":
            assert flash.launch_count["flash_bwd_dq"] == 1
        grads[impl] = {n: attn[n].grad for n in ("wq", "wk", "wv")}
    for n in ("wq", "wk", "wv"):
        assert grads["flash"][n] is not None
        assert _rel(grads["flash"][n], grads["dense"][n]) <= 2e-2


def test_multihead_flash_is_differentiable_on_cpu():
    """impl="flash" through the dispatcher keeps a graph on the CPU too."""
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.standard_normal((1, 40, 4, 64)).astype(
        np.float32)).requires_grad_()
    k = torch.from_numpy(rng.standard_normal((1, 40, 2, 64)).astype(
        np.float32)).requires_grad_()
    out = multihead_attention(q, k, k, causal=True, impl="flash")
    assert out.grad_fn is not None
    out.sum().backward()
    assert q.grad is not None and k.grad is not None
