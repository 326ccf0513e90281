"""The encoder-decoder's sequence parallelism in the port (models/encdec.py
on an sp mesh) against the JAX package's, multi-rank.

JAX's ``encdec_loss`` on an sp mesh runs the encoder's self-attention on
the non-causal contiguous ring, the decoder's on the causal zigzag ring,
and gathers the encoder output over sp once for every decoder layer's
cross-attention (tpu_docker_api/models/encdec.py). The port does the
same with its own ring (parallel/ring.py) in gloo ranks
(tests/torch_ranks.py, one 4-rank spawn); the JAX reference runs on the
virtual CPU devices of tests/conftest.py on a mesh of the same shape,
the tiny preset in f32, from JAX's init carried over by
models/convert.py and (src, tgt) pairs from a numpy seed.

Held: the loss at sp 2 × tp 2 within 2e-3 (rtol and atol: JAX's bound
for its encoder-decoder) and at sp 4 against one device's; a train step
at sp 2 × tp 2 as tests/test_torch_parallel.py holds one (loss 1e-4
relative, the params after it within ``close_params``); the errors
JAX raises on an sp mesh (a ``kv_len`` mask on the encoder's ring, a
target whose local chunk is odd on the decoder's zigzag ring), word for
word; and the trainer CLI's ``encdec:tiny --sp 2`` step against its
one-device step (bf16, 1e-3 relative).
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_parallel import LOSS_TOL, _jmesh, close_params, host_init
from test_torch_parallel_train import _jax_family
from torch_ranks import Ranks
from tpu_docker_api.models import encdec as jencdec

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENCDEC = dataclasses.replace(jencdec.encdec_presets()["tiny"],
                             dtype=jnp.float32)
LOSS_BOUND = 2e-3   # JAX's encdec mesh tolerance
CLI_TOL = 1e-3


def _pairs(rows=4, src_len=16, tgt_len=16, seed=21):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (rows, src_len)).astype(np.int32),
            rng.integers(0, 256, (rows, tgt_len + 1)).astype(np.int32))


def _jax_errors(host, src, tgt):
    """The errors JAX's encoder-decoder raises on an sp 2 × tp 2 mesh."""
    mesh = _jmesh(sp=2, tp=2)
    params = jax.tree_util.tree_map(jnp.asarray, host)
    out = {}
    with mesh:
        try:
            jax.jit(lambda p, s, k: jencdec.encdec_encode(
                p, s, ENCDEC, mesh, kv_len=k))(
                params, jnp.asarray(src),
                jnp.full((src.shape[0],), 3, jnp.int32))
        except NotImplementedError as e:
            out["kv_len"] = str(e)
        try:
            jax.jit(lambda p, b: jencdec.encdec_loss(p, b, ENCDEC, mesh))(
                params, (jnp.asarray(src), jnp.asarray(tgt)))
        except ValueError as e:
            out["zigzag"] = str(e)
    return out


@pytest.fixture(scope="module")
def sp_ranks(tmp_path_factory):
    host = host_init(jencdec.encdec_init, ENCDEC)
    batch = _pairs()
    odd = _pairs(tgt_len=6, seed=22)
    ranks = Ranks(4, [
        ("loss_value", dict(plan=dict(sp=2, tp=2), host=host, tokens=batch,
                            preset="encdec:tiny")),
        ("loss_value", dict(plan=dict(sp=4), host=host, tokens=batch,
                            preset="encdec:tiny")),
        ("train_losses", dict(plan=dict(sp=2, tp=2), host=host,
                              batches=[batch], preset="encdec:tiny")),
        ("encdec_sp_errors", dict(plan=dict(sp=2, tp=2), host=host,
                                  src=odd[0], tgt=odd[1])),
    ], tmp_path_factory.mktemp("esp"))
    _, ref_losses, ref_params = _jax_family(ENCDEC, dict(sp=2, tp=2),
                                            [batch])
    one = float(jencdec.encdec_loss(
        jax.tree_util.tree_map(jnp.asarray, host),
        tuple(jnp.asarray(x) for x in batch), ENCDEC))
    errors = _jax_errors(host, *odd)
    got = ranks.join()
    return {"loss": got[0], "loss_sp4": got[1], "train": got[2],
            "errors": got[3], "ref_losses": ref_losses,
            "ref_params": ref_params, "one_device": one,
            "jax_errors": errors}


def test_encdec_loss_at_sp2_tp2_matches_jax(sp_ranks):
    """The loss on the rings, sharded over sp 2 × tp 2, against JAX's
    ``encdec_loss`` on the same mesh."""
    np.testing.assert_allclose(sp_ranks["loss"]["loss"],
                               sp_ranks["ref_losses"][0], rtol=LOSS_BOUND,
                               atol=LOSS_BOUND)


def test_encdec_loss_at_sp4_matches_one_device(sp_ranks):
    """Four chunks of the source and of the target (the zigzag ring's
    2·sp stripes of 2 tokens) give one device's loss."""
    np.testing.assert_allclose(sp_ranks["loss_sp4"]["loss"],
                               sp_ranks["one_device"], rtol=LOSS_BOUND,
                               atol=LOSS_BOUND)


def test_encdec_train_step_at_sp2_tp2_matches_jax(sp_ranks):
    """One train step at sp 2 × tp 2: the loss and the params after it
    (the gradients through both rings and the sp gather's
    reduce-scatter) equal JAX's step on the same mesh."""
    np.testing.assert_allclose(sp_ranks["train"]["losses"],
                               sp_ranks["ref_losses"], rtol=LOSS_TOL)
    close_params(sp_ranks["train"]["params"], sp_ranks["ref_params"])


@pytest.mark.parametrize("which", ["kv_len", "zigzag"])
def test_sp_errors_are_jax_errors(sp_ranks, which):
    """``kv_len`` on the encoder's ring raises JAX's NotImplementedError;
    a target of 6 tokens on sp 2 (odd chunks) raises the zigzag ring's
    ValueError. The texts are JAX's."""
    want = sp_ranks["jax_errors"][which]
    assert sp_ranks["errors"][which] == want


def _cli(*args):
    return subprocess.Popen(
        [sys.executable, "-m", "tpu_docker_api_torch.train", "--device",
         "cpu", "--preset", "encdec:tiny", "--steps", "2", "--batch", "2",
         "--seq", "16", "--log-every", "1", *args],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def test_cli_trains_encdec_at_sp2():
    """``--preset encdec:tiny --sp 2`` on two gloo ranks trains (the JAX
    line contract) with one device's losses: same seed, same pairs."""
    procs = [_cli("--sp", "2", "--nproc-per-node", "2"), _cli()]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, err
        outs.append([json.loads(ln) for ln in out.splitlines()])
    sp, one = outs
    assert sp[-1] == {"event": "done", "step": 2}
    got = [ln["loss"] for ln in sp if "loss" in ln]
    ref = [ln["loss"] for ln in one if "loss" in ln]
    assert len(got) == len(ref) == 2
    np.testing.assert_allclose(got, ref, rtol=CLI_TOL)
