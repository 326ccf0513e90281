"""The port's flash forward against the JAX Pallas kernel.

On the CPU the wrapper runs its plain version; it is held against
``_fwd_impl`` (the JAX kernel's launcher, which also returns lse) in
interpret mode, as tests/test_ops.py runs it, at f32 tolerance 1e-5 for
out and lse. The CUDA kernel itself is held against the plain version by
the ``gpu``-marked test below, which skips without a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_docker_api.ops.flash_pallas import _fwd_impl
from tpu_docker_api_torch.ops import flash
from tpu_docker_api_torch.ops.attention import dense_attention


def _qkv(seed, b, h, hk, s, d, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(dtype) for shape in
                 ((b, h, s, d), (b, hk, s, d), (b, hk, s, d)))


# (heads, kv_heads, seq, head_dim, block, causal)
CASES = {
    "mha": (4, 4, 128, 64, 128, True),
    "gqa2": (4, 2, 128, 64, 128, True),
    "gqa4-multiblock": (4, 1, 256, 64, 128, True),
    "d128-multiblock": (2, 1, 256, 128, 128, True),
    "noncausal-gqa2": (4, 2, 128, 128, 128, False),
    "noncausal-multiblock": (2, 2, 256, 64, 128, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_flash_matches_pallas_interpret(case):
    h, hk, s, d, blk, causal = CASES[case]
    q, k, v = _qkv(0, 1, h, hk, s, d)
    ref_out, ref_lse = _fwd_impl(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal, blk, blk, True)
    before = flash.launch_count["flash_fwd"]
    out, lse = flash.flash_attention_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal)
    assert flash.launch_count["flash_fwd"] == before  # CPU: no launch
    assert lse.shape == (1, h, s) and lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse)[:, :, 0],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seq", [32, 100])
def test_plain_flash_ragged_seq_matches_dense(seq):
    """Buckets below the JAX kernel's multiple-of-128 contract."""
    q, k, v = _qkv(1, 2, 4, 2, seq, 64)
    tq, tk, tv = (torch.from_numpy(x).transpose(1, 2) for x in (q, k, v))
    ref = dense_attention(tq, tk, tv, causal=True)
    got = flash.flash_attention(*(t.transpose(1, 2) for t in (tq, tk, tv)))
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), ref.numpy(),
                               rtol=1e-5, atol=1e-5)


def test_wrapper_rejects_bad_shapes():
    q = torch.randn(1, 4, 8, 64)
    with pytest.raises(ValueError):
        flash.flash_attention(q, torch.randn(1, 3, 8, 64),
                              torch.randn(1, 3, 8, 64))
    with pytest.raises(ValueError):
        flash.flash_attention(q, torch.randn(1, 2, 9, 64),
                              torch.randn(1, 2, 9, 64))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel, no CPU mode)")
    return torch.device("cuda")


# the tile edges of the kernels (64-query blocks, 64-key f32 and 128-key
# bf16 kv tiles), both GQA group sizes, d=128 and full attention
CARD_CASES = [(100, 64, "bf16", 4, True), (256, 128, "bf16", 4, True),
              (64, 64, "f32", 4, True)]
CARD_CASES += [(s, 64, "bf16", g, True) for s in (1, 63, 65, 127, 129)
               for g in (1, 4)]
CARD_CASES += [(s, 128, "bf16", 4, True) for s in (1, 65, 129)]
CARD_CASES += [(s, d, "bf16", 4, False) for s in (1, 65, 129)
               for d in (64, 128)]
CARD_CASES += [(65, 64, "f32", 1, False), (129, 128, "f32", 4, True)]


def _check_on_card(q, k, v, causal, dtype):
    before = flash.launch_count["flash_fwd"]
    out, lse = flash.flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash.launch_count["flash_fwd"] == before + 1
    ref_out, ref_lse = flash.flash_attention_fwd_plain(q, k, v, causal)
    tol = 2e-2 if dtype == "bf16" else 1e-4
    assert (out.float() - ref_out.float()).abs().max().item() <= tol
    assert (lse - ref_lse).abs().max().item() <= (1e-2 if dtype == "bf16"
                                                  else 1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("seq,d,dtype,group,causal", CARD_CASES)
def test_kernel_matches_plain_on_card(cuda_device, seq, d, dtype, group,
                                      causal):
    """bf16: |out - plain| <= 2e-2, |lse - plain| <= 1e-2 (the kernel
    rounds P and out to bf16 once each and sums in another order); f32:
    1e-4."""
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    g = torch.Generator(device=cuda_device).manual_seed(0)
    # model layout (b, s, h, d), handed over as (b, h, s, d) views
    q = torch.randn(2, seq, 8, d, generator=g, device=cuda_device).to(tdt)
    k = torch.randn(2, seq, 8 // group, d, generator=g,
                    device=cuda_device).to(tdt)
    v = torch.randn(2, seq, 8 // group, d, generator=g,
                    device=cuda_device).to(tdt)
    _check_on_card(*(t.transpose(1, 2) for t in (q, k, v)), causal, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("seq", [65, 300])
def test_kernel_reads_fused_qkv_views_on_card(cuda_device, seq):
    """q, k and v as the serving-fused projection hands them over: strided
    (b, s, h, d) slices of one (b, s, (h + 2 hk) d) buffer."""
    h, hk, d = 8, 2, 64
    g = torch.Generator(device=cuda_device).manual_seed(1)
    qkv = torch.randn(2, seq, (h + 2 * hk) * d, generator=g,
                      device=cuda_device).to(torch.bfloat16)
    q = qkv[..., :h * d].reshape(2, seq, h, d)
    k = qkv[..., h * d:(h + hk) * d].reshape(2, seq, hk, d)
    v = qkv[..., (h + hk) * d:].reshape(2, seq, hk, d)
    assert not q.is_contiguous()
    _check_on_card(*(t.transpose(1, 2) for t in (q, k, v)), True, "bf16")


@pytest.mark.gpu
@pytest.mark.parametrize("offset,row", [(4, 512), (0, 516)])
def test_kernel_refuses_rows_tma_cannot_load_on_card(cuda_device, offset,
                                                     row):
    """A bf16 q whose data or seq stride is not 16-byte aligned: the
    kernel's own check (csrc/hopper.cuh) refuses it, nothing launches, and
    the wrapper's error names the input."""
    buf = torch.zeros(2 * 65 * row + 8, dtype=torch.bfloat16,
                      device=cuda_device)
    q = buf.as_strided((2, 65, 8, 64), (65 * row, row, 64, 1),
                       offset).transpose(1, 2)
    k = torch.zeros(2, 2, 65, 64, dtype=torch.bfloat16, device=cuda_device)
    before = flash.launch_count["flash_fwd"]
    with pytest.raises(ValueError, match=r"16-byte rows.*\[0\]"):
        flash.flash_attention_fwd(q, k, k)
    assert flash.launch_count["flash_fwd"] == before


@pytest.mark.parametrize("shape,stride,offset,ok", [
    ((2, 8, 16, 64), None, 0, True),
    ((2, 8, 16, 64), (8192, 64, 512, 1), 8, True),
    ((2, 8, 16, 64), (8196, 64, 512, 1), 0, False),
    ((2, 8, 16, 64), (8192, 64, 516, 1), 0, False),
    ((2, 8, 16, 64), None, 4, False),
    ((2, 8, 16, 64), (8192, 0, 512, 1), 0, False),
    ((1, 8, 16, 64), (0, 64, 512, 1), 0, True)])
def test_rows_aligned(shape, stride, offset, ok):
    """The bf16 kernels' 16-byte row rule, as the wrapper reads it to name
    a refused input and to copy a cotangent; a broadcast (stride 0) dim is
    refused unless its extent is 1."""
    buf = torch.zeros(20000, dtype=torch.bfloat16)
    t = (buf[offset:offset + 16384].view(shape) if stride is None
         else buf.as_strided(shape, stride, offset))
    assert flash.rows_aligned(t) is ok
