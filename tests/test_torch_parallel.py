"""The port's parallelism layer against the JAX package's, multi-rank.

The port runs in gloo ranks on the CPU (tests/torch_ranks.py, one spawn
for each group of cases); the JAX functions run on the 8 virtual CPU
devices of tests/conftest.py, on a mesh of the same shape. Inputs and
weights come from numpy seeds (weights from the JAX init, carried over
by models/convert.py), everything in f32. Mirrors tests/test_parallel.py:
the mesh plan, the sharding rules, ring attention (contiguous and zigzag)
and Ulysses forward and gradients at sp 2 and 4, the chunked loss under
fsdp × tp, and the training loss of the tiny llama at dp 2, fsdp 2,
tp 2, fsdp 2 × tp 2 and sp 2 with ring, zigzag and Ulysses.

Tolerances: attention outputs and gradients 2e-5 (f32 online softmax
against the JAX one, two summation orders); losses 1e-4 relative (f32
through two layers, as tests/test_torch_train.py holds llama_loss). A
train step is held by its loss and by the params after it: every element
within 2·lr + 1e-6 of JAX's (Adam's first step moves an element by about
lr·sign(g), so one whose gradient sits at the f32 noise floor of the two
summation orders may step either way) and 99.9% of each leaf's within
2e-6. The JAX references are computed in threads (their compiles
overlap) while the ranks run: the ranks start from the single-device
JAX init, which equals every mesh's (threefry is partitionable).
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_docker_api.models import llama as jl
from tpu_docker_api.models.encdec import ENCDEC_RULES as J_ENCDEC_RULES
from tpu_docker_api.models.moe import MOE_RULES as J_MOE_RULES
from tpu_docker_api.models.vit import VIT_RULES as J_VIT_RULES
from tpu_docker_api.parallel import mesh as jmesh
from tpu_docker_api.parallel import sharding as jsh
from tpu_docker_api.parallel.ring import ring_attention as j_ring
from tpu_docker_api.parallel.ulysses import ulysses_attention as j_ulysses
from tpu_docker_api.train import trainer as jtrainer
from tpu_docker_api_torch.models import ENCDEC_RULES, MOE_RULES, VIT_RULES
from tpu_docker_api_torch.parallel import mesh as tmesh
from tpu_docker_api_torch.parallel import sharding as tsh
from torch_ranks import Ranks

ATTN_TOL = 2e-5
LOSS_TOL = 1e-4
JCFG = dataclasses.replace(jl.llama_presets()["tiny"], dtype=jnp.float32)
B, S = 4, 16


def _jmesh(**plan):
    plan = {"dp": 1, **plan}
    n = int(np.prod(list(plan.values())))
    return jmesh.build_mesh(jmesh.MeshPlan(**plan), devices=jax.devices()[:n])


LR = 3e-4  # the default optimizer's (trainer.default_optimizer)


def _batches(n=1, seed=0, vocab=256):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
            for _ in range(n)]


def jax_train(cfg, plan: dict, batches, key=0):
    """(initial host params, per-step losses, host params after) of the
    JAX trainer on a mesh of ``plan``."""
    mesh = _jmesh(**plan)
    state, opt = jtrainer.create_train_state(cfg, mesh,
                                             jax.random.PRNGKey(key))
    host = jax.tree_util.tree_map(np.asarray, state.params)
    step = jtrainer.make_train_step(cfg, mesh, opt)
    losses = []
    for b in batches:
        state, m = step(state, jnp.asarray(b))
        losses.append(float(m["loss"]))
    return host, losses, jax.tree_util.tree_map(np.asarray, state.params)


def in_threads(fn, args_list):
    with ThreadPoolExecutor(len(args_list)) as ex:
        return list(ex.map(lambda a: fn(*a), args_list))


def call(f, *args):
    return f(*args)


def host_init(init, cfg, key=0):
    """A family's JAX init on one device, as numpy."""
    return jax.tree_util.tree_map(np.asarray,
                                  init(cfg, jax.random.PRNGKey(key)))


def close_params(got: dict, ref: dict, lr: float = LR) -> None:
    """The params after a step: see the module docstring."""
    flat_got = tsh.flatten_paths(got)
    for path, r in tsh.flatten_paths(ref).items():
        g = np.asarray(flat_got[path])
        diff = np.abs(g - r)
        assert diff.max() <= 2 * lr + 1e-6, (path, diff.max())
        assert np.mean(diff <= 2e-6) >= 0.999, (path, np.mean(diff <= 2e-6))


def _spec_tuple(spec):
    return tuple(tuple(e) if isinstance(e, tuple) else e for e in spec)


# ------------------------------------------------------------------ mesh


class TestMesh:
    @pytest.mark.parametrize("plan,n", [
        (dict(), 8), (dict(fsdp=2, tp=2), 8), (dict(dp=2, tp=2, sp=2), 8),
        (dict(pp=2, ep=2), 8), (dict(fsdp=4, tp=2), 8)])
    def test_resolve_matches_jax(self, plan, n):
        assert tmesh.AXES == jmesh.AXES
        assert (tmesh.MeshPlan(**plan).resolve(n)
                == jmesh.MeshPlan(**plan).resolve(n))

    @pytest.mark.parametrize("plan,n", [
        (dict(fsdp=3), 8), (dict(dp=2, tp=2), 8), (dict(tp=0), 8)])
    def test_bad_plan_raises(self, plan, n):
        with pytest.raises(ValueError):
            jmesh.MeshPlan(**plan).resolve(n)
        with pytest.raises(ValueError):
            tmesh.MeshPlan(**plan).resolve(n)


# ----------------------------------------------------------------- rules


class TestShardingRules:
    @pytest.mark.parametrize("ours,theirs", [
        (tsh.LLAMA_RULES, jsh.LLAMA_RULES), (MOE_RULES, J_MOE_RULES),
        (VIT_RULES, J_VIT_RULES), (ENCDEC_RULES, J_ENCDEC_RULES)],
        ids=["llama", "moe", "vit", "encdec"])
    def test_rules_are_the_jax_rules(self, ours, theirs):
        assert [(p, _spec_tuple(s)) for p, s in ours] == [
            (p, _spec_tuple(s)) for p, s in theirs]

    def test_param_specs_cover_llama(self):
        params = jl.llama_init(JCFG, jax.random.PRNGKey(0))
        host = jax.tree_util.tree_map(np.asarray, params)
        ref = jax.tree_util.tree_leaves_with_path(
            jsh.param_specs(params),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        ours = tsh.flatten_paths(tsh.param_specs(host))
        assert len(ours) == len(ref)
        for path, spec in ref:
            key = "/".join(k.key for k in path)
            assert _spec_tuple(ours[key]) == _spec_tuple(spec), key

    def test_batch_spec(self):
        assert _spec_tuple(tsh.batch_spec()) == _spec_tuple(jsh.batch_spec())

    def test_local_slice_and_placements(self):
        from torch.distributed.tensor import Replicate, Shard

        class FakeMesh:  # rank (fsdp 1, tp 0) of an fsdp 2 × tp 2 mesh
            shape = {"pp": 1, "dp": 1, "fsdp": 2, "ep": 1, "tp": 2, "sp": 1}
            coords = {"pp": 0, "dp": 0, "fsdp": 1, "ep": 0, "tp": 0, "sp": 0}
            size_of = tmesh.Mesh.size_of
            index = tmesh.Mesh.index

        import torch

        full = torch.arange(2 * 8 * 6).reshape(2, 8, 6)
        spec = tsh.spec_for("layers/attn/wq")
        got = tsh.local_slice(full, spec, FakeMesh())
        assert torch.equal(got, full[:, 4:8, 0:3])
        pl = tsh.placements(spec, FakeMesh(), 3)
        assert pl == [Replicate(), Replicate(), Shard(1), Replicate(),
                      Shard(2), Replicate()]
        batch = tsh.placements(tsh.batch_spec(), FakeMesh(), 2)
        assert batch[1] == batch[2] == Shard(0) and batch[5] == Shard(1)


# ------------------------------------------------------------- attention


def _qkv(h, kv, seed, d=16, b=2, s=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kv, d)).astype(np.float32)
    cot = rng.standard_normal((b, s, h, d)).astype(np.float32)
    return q, k, v, cot


def _jax_attention(plan, q, k, v, cot, impl, causal=True):
    mesh = _jmesh(**plan)

    def f(q, k, v):
        if impl == "ulysses":
            return j_ulysses(q, k, v, mesh, causal=causal, impl="dense"), None
        return j_ring(q, k, v, mesh, causal=causal, with_block_counts=True,
                      placement=("zigzag" if impl == "ring-zigzag"
                                 else "contiguous"))

    out, counts = jax.jit(f)(q, k, v)
    grads = jax.jit(jax.grad(lambda *a: jnp.sum(f(*a)[0] * cot),
                             argnums=(0, 1, 2)))(q, k, v)
    res = {"out": np.asarray(out), "dq": np.asarray(grads[0]),
           "dk": np.asarray(grads[1]), "dv": np.asarray(grads[2])}
    if counts is not None:
        res["counts"] = np.asarray(counts)
    return res


ATTN_2 = [  # (plan, heads, kv heads, impl, causal)
    (dict(sp=2), 4, 2, "ring", True),
    (dict(sp=2), 4, 2, "ring", False),
    (dict(sp=2), 4, 2, "ring-zigzag", True),
    (dict(sp=2), 4, 2, "ulysses", True),
]
ATTN_4 = [
    (dict(sp=4), 4, 2, "ring", True),
    (dict(sp=4), 4, 2, "ring-zigzag", True),
    (dict(sp=4), 8, 4, "ulysses", True),
    (dict(sp=2, tp=2), 4, 2, "ring-zigzag", True),
    (dict(sp=2, tp=2), 8, 4, "ulysses", True),
]


def _attn_cases(table):
    """(rank cases, JAX reference calls) of an attention table."""
    cases, calls = [], []
    for i, (plan, h, kv, impl, causal) in enumerate(table):
        q, k, v, cot = _qkv(h, kv, seed=i)
        cases.append(("attention", dict(plan=plan, q=q, k=k, v=v, cot=cot,
                                        impl=impl, causal=causal)))
        calls.append((_jax_attention, plan, q, k, v, cot, impl, causal))
    return cases, calls


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Every 2-rank case of this file, in one spawn."""
    cases, calls = _attn_cases(ATTN_2)
    batches = _batches()
    host = host_init(jl.llama_init, JCFG)
    sp_impls = ["ring", "ring-zigzag", "ulysses"]
    runs = ([(JCFG, plan, {}) for plan in (dict(dp=2), dict(fsdp=2),
                                           dict(tp=2))]
            + [(dataclasses.replace(JCFG, attention_impl=impl), dict(sp=2),
                {"attention_impl": impl}) for impl in sp_impls]
            # flash at sp 2 against JAX's dense there: the same function
            # (the port's flash is its plain version on the CPU)
            + [(dataclasses.replace(JCFG, attention_impl="dense"),
                dict(sp=2), {"attention_impl": "flash"})])
    for _, plan, over in runs:
        cases.append(("train_losses", dict(plan=plan, host=host,
                                           batches=batches, over=over)))
    cases.append(("flash_route", dict(plan=dict(sp=2), host=host,
                                      tokens=batches[0])))
    ranks = Ranks(2, cases, tmp_path_factory.mktemp("par2"))
    refs = in_threads(call, calls + [(jax_train, c, p, batches)
                                     for c, p, _ in runs])
    got = ranks.join()
    n = len(ATTN_2)
    return {"attn": list(zip(got[:n], refs[:n])),
            "train": list(zip(got[n:-1], refs[n:])),
            "flash_route": got[-1]}


def _jax_chunked_loss(host, tokens):
    """(the JAX chunked loss on an fsdp 2 × tp 2 mesh, the dense one):
    tests/test_parallel.py TestChunkedLossOnMesh."""
    chunk = dataclasses.replace(JCFG, loss_chunk_rows=16)
    mesh = _jmesh(fsdp=2, tp=2)
    with mesh:
        on_mesh = float(jax.jit(
            lambda p, t: jl.llama_loss(p, t, chunk, mesh))(host, tokens))
    return on_mesh, float(jl.llama_loss(host, tokens, JCFG))


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """Every 4-rank case of this file, in one spawn."""
    cases, calls = _attn_cases(ATTN_4)
    batches = _batches()
    host = host_init(jl.llama_init, JCFG)
    tokens = np.random.default_rng(1).integers(0, 256, (4, 33)).astype(
        np.int32)
    cases += [("train_losses", dict(plan=dict(fsdp=2, tp=2), host=host,
                                    batches=batches)),
              ("loss_value", dict(plan=dict(fsdp=2, tp=2), host=host,
                                  tokens=tokens,
                                  over={"loss_chunk_rows": 16}))]
    ranks = Ranks(4, cases, tmp_path_factory.mktemp("par4"))
    refs = in_threads(call, calls + [
        (jax_train, JCFG, dict(fsdp=2, tp=2), batches),
        (_jax_chunked_loss, host, tokens)])
    got = ranks.join()
    n = len(ATTN_4)
    j_chunk, j_dense = refs[n + 1]
    return {"attn": list(zip(got[:n], refs[:n])),
            "train": (got[n], refs[n]),
            "chunk": (got[n + 1]["loss"], j_chunk, j_dense)}


def _check_attention(got, ref):
    for key in ("out", "dq", "dk", "dv"):
        np.testing.assert_allclose(got[key], ref[key], rtol=ATTN_TOL,
                                   atol=ATTN_TOL, err_msg=key)
    if "counts" in ref:
        np.testing.assert_array_equal(got["counts"], ref["counts"])


@pytest.mark.parametrize("i", range(len(ATTN_2)),
                         ids=[f"{c[3]}-causal{c[4]}" for c in ATTN_2])
def test_attention_sp2(two_ranks, i):
    """Ring (both placements, causal and not) and Ulysses at sp 2:
    outputs, the three gradients and the causal block counts."""
    _check_attention(*two_ranks["attn"][i])


@pytest.mark.parametrize("i", range(len(ATTN_4)),
                         ids=[f"{c[3]}-{'x'.join(map(str, c[0].values()))}"
                              for c in ATTN_4])
def test_attention_sp4_and_tp(two_ranks, four_ranks, i):
    """sp 4, and sp 2 composed with tp 2 (heads split too)."""
    _check_attention(*four_ranks["attn"][i])


def test_zigzag_block_work_is_uniform(four_ranks):
    """Zigzag: every rank computes 2n+1 half-stripe pairs; contiguous
    rank i computes i+1 blocks (the causal skip)."""
    ring, zig = four_ranks["attn"][0][0], four_ranks["attn"][1][0]
    assert list(ring["counts"]) == [1, 2, 3, 4]
    assert list(zig["counts"]) == [9, 9, 9, 9]


def test_ulysses_head_divisibility_guard():
    import torch

    from tpu_docker_api_torch.parallel.ulysses import ulysses_attention

    class SP2:
        shape = {"sp": 2, "tp": 1}

        def group(self, _):
            return None

    q = torch.zeros(1, 4, 4, 8)
    kv = torch.zeros(1, 4, 1, 8)
    with pytest.raises(ValueError, match="divisible by sp"):
        ulysses_attention(q, kv, kv, SP2())


def test_zigzag_rejects_non_causal():
    import torch

    from tpu_docker_api_torch.parallel.ring import ring_attention

    x = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="causal"):
        ring_attention(x, x, x, None, causal=False, placement="zigzag")


# -------------------------------------------------------------- training


@pytest.mark.parametrize("i", range(7), ids=["dp2", "fsdp2", "tp2",
                                             "sp2-ring", "sp2-zigzag",
                                             "sp2-ulysses", "sp2-flash"])
def test_train_loss_matches_jax_2_ranks(two_ranks, i):
    """A step of the tiny llama on a 2-rank mesh: the loss and the params
    after it of the JAX trainer on the same mesh shape, same weights and
    batch."""
    got, (_, losses, params) = two_ranks["train"][i]
    np.testing.assert_allclose(got["losses"], losses, rtol=LOSS_TOL)
    close_params(got["params"], params)


def test_flash_at_sp2_attends_over_the_whole_sequence(two_ranks):
    """``attention_impl="flash"`` on an sp 2 mesh reaches the flash op
    once a layer, on q, k and v gathered to the whole sequence (JAX's
    GSPMD gathers them for its Pallas kernel), never the dense path."""
    assert two_ranks["flash_route"]["seqs"] == [S] * JCFG.n_layers
    assert two_ranks["flash_route"]["dense_calls"] == 0


def test_train_loss_matches_jax_fsdp2_tp2(four_ranks):
    got, (_, losses, params) = four_ranks["train"]
    np.testing.assert_allclose(got["losses"], losses, rtol=LOSS_TOL)
    close_params(got["params"], params)


def test_chunked_loss_matches_dense_under_fsdp_tp(four_ranks):
    """The vocab-parallel chunked loss under fsdp 2 × tp 2 equals the
    JAX mesh value and the dense loss."""
    got, j_chunk, j_dense = four_ranks["chunk"]
    np.testing.assert_allclose(got, j_chunk, rtol=LOSS_TOL)
    np.testing.assert_allclose(got, j_dense, rtol=LOSS_TOL)
