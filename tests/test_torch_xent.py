"""The port's chunked cross-entropy against the JAX op, and against the
port's own dense loss tail.

f32 inputs from a numpy seed. The loss is held at rtol 1e-5 and the
gradients at 1e-5 absolute: the per-row math is the same, but the mean
gathers as per-chunk sums, in another order in each framework.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_docker_api.ops.xent import chunked_cross_entropy as jax_xent
from tpu_docker_api_torch.models.llama import cross_entropy
from tpu_docker_api_torch.ops.xent import chunked_cross_entropy

TOL = 1e-5


def _inputs(seed, b, s, d, vocab):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((b, s, d)).astype(np.float32)
    w = (rng.standard_normal((d, vocab)) / np.sqrt(d)).astype(np.float32)
    t = rng.integers(0, vocab, (b, s)).astype(np.int32)
    return h, w, t


def _torch_loss_grads(h, w, t, chunk):
    th, tw = (torch.from_numpy(x).requires_grad_() for x in (h, w))
    loss = chunked_cross_entropy(th, tw, torch.from_numpy(t), chunk)
    loss.backward()
    return loss.detach(), th.grad, tw.grad


# (batch, seq, d, vocab, row_chunk): chunk dividing the rows, not
# dividing them (a short last chunk; JAX pads instead), and one chunk
CASES = [(2, 16, 32, 64, 8), (2, 15, 32, 80, 8), (1, 12, 16, 50, 64)]


@pytest.mark.parametrize("b,s,d,vocab,chunk", CASES)
def test_chunked_xent_matches_jax(b, s, d, vocab, chunk):
    h, w, t = _inputs(0, b, s, d, vocab)
    ref_loss, ref_grads = jax.value_and_grad(
        lambda h_, w_: jax_xent(h_, w_, jnp.asarray(t), chunk),
        argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
    loss, dh, dw = _torch_loss_grads(h, w, t, chunk)
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=TOL)
    np.testing.assert_allclose(dh.numpy(), np.asarray(ref_grads[0]),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(ref_grads[1]),
                               rtol=TOL, atol=TOL)


def test_chunked_xent_matches_dense_tail():
    """The same function as logits → cross_entropy, loss and grads."""
    h, w, t = _inputs(1, 2, 10, 16, 40)
    loss, dh, dw = _torch_loss_grads(h, w, t, 6)
    th, tw = (torch.from_numpy(x).requires_grad_() for x in (h, w))
    ref = cross_entropy(th @ tw, torch.from_numpy(t))
    ref.backward()
    torch.testing.assert_close(loss, ref.detach(), rtol=TOL, atol=TOL)
    torch.testing.assert_close(dh, th.grad, rtol=TOL, atol=TOL)
    torch.testing.assert_close(dw, tw.grad, rtol=TOL, atol=TOL)


def test_cross_entropy_matches_jax():
    from tpu_docker_api.models.llama import cross_entropy as jax_ce

    rng = np.random.default_rng(2)
    logits = rng.standard_normal((2, 7, 33)).astype(np.float32) * 3
    t = rng.integers(0, 33, (2, 7)).astype(np.int32)
    ref = jax_ce(jnp.asarray(logits), jnp.asarray(t))
    got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(t))
    np.testing.assert_allclose(got.item(), float(ref), rtol=TOL)
