"""The port's mesh path through the trainer, MoE expert parallelism,
LoRA, checkpoints and the slot server, against the JAX package's.

Multi-rank cases run in gloo ranks on the CPU (tests/torch_ranks.py: one
spawn for the 2-rank cases, one for the 4-rank ones); the JAX references
on the 8 virtual CPU devices of tests/conftest.py, on meshes of the same
shape, f32. Mirrors tests/test_trainer.py:33-45 (a sharded init, steps
on meshes, vit:tiny and encdec:tiny among them), tests/test_moe.py's ep
cases (a train step with ``sort`` at
ep 2 and dp 2 × ep 2; ``gather`` refused on a mesh), tests/test_lora.py
(the adapter specs; LoRA steps at tp 2, merged and attached),
tests/test_checkpoint.py:44-75 (written at fsdp 2, restored at tp 2 and
on one device) and tests/test_slots.py:451-467 with
tests/test_serve.py:348, 742 (the tp 2 slot engine's greedy streams,
dense and paged with a prefix, equal the one-device engine's; dp, sp,
pp and ep meshes are refused; the CLI server on tp 2 ranks answers, and
stops with an error when a rank dies).

Tolerances as tests/test_torch_parallel.py: losses 1e-4 relative, the
params after a step within 2·lr + 1e-6 everywhere and 2e-6 for 99.9% of
each leaf (LoRA: the adapters). A checkpoint restores bit-equal; the
resumed run's losses equal the uninterrupted run's to 1e-6 relative
(the same f32 arithmetic on another mesh: only the reduction order of
the tp products differs).
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parallel import (JCFG, LOSS_TOL, _batches, _jmesh,
                                 _spec_tuple, call, close_params, host_init,
                                 in_threads, jax_train)
from torch_ranks import Ranks
from tpu_docker_api.models import llama as jl
from tpu_docker_api.models import encdec as jencdec
from tpu_docker_api.models import moe as jmoe
from tpu_docker_api.models import vit as jvit
from tpu_docker_api.train import lora as jlora
from tpu_docker_api.train import trainer as jtrainer
from tpu_docker_api_torch.models import llama as tl
from tpu_docker_api_torch.models.convert import params_from_numpy
from tpu_docker_api_torch.parallel import sharding as tsh
from tpu_docker_api_torch.train import lora as tlora
from tpu_docker_api_torch.train.checkpoint import CheckpointManager
from tpu_docker_api_torch.train.optim import adamw_int8
from tpu_docker_api_torch.train.trainer import make_train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MOE = dataclasses.replace(jmoe.moe_presets()["moe-tiny"], dtype=jnp.float32,
                          dispatch_impl="sort")
VIT = dataclasses.replace(jvit.vit_presets()["tiny"], dtype=jnp.float32)
ENCDEC = dataclasses.replace(jencdec.encdec_presets()["tiny"],
                             dtype=jnp.float32)
PROMPTS = [[3, 1, 4, 1, 5], [9, 8], [2, 6, 4, 7]]
PREFIX = list(range(2, 20))
CKPT_BATCHES = _batches(4, seed=7)


def jax_lora(forward: str, batches):
    """(base, adapters, losses, adapters after) of JAX LoRA steps at
    tp 2, rank 4."""
    mesh = _jmesh(tp=2)
    base = jlora.init_base_params(JCFG, mesh, jax.random.PRNGKey(0))
    state, opt = jlora.create_lora_state(JCFG, mesh, jax.random.PRNGKey(1),
                                         rank=4)
    host_base = jax.tree_util.tree_map(np.asarray, base)
    host_ad = jax.tree_util.tree_map(np.asarray, state.params)
    step = jlora.make_lora_train_step(JCFG, mesh, opt, base, forward=forward)
    losses = []
    for b in batches:
        state, m = step(state, jnp.asarray(b))
        losses.append(float(m["loss"]))
    return (host_base, host_ad, losses,
            jax.tree_util.tree_map(np.asarray, state.params))


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Every 2-rank case of this file, in one spawn."""
    batches = _batches()
    lora_batches = _batches(2, seed=3)
    moe_host = host_init(jmoe.moe_init, MOE)
    # create_lora_state's draws: the base from key 0, the adapters from
    # key 1 (train/lora.py), one device
    base = host_init(jl.llama_init, JCFG)
    adapters = jax.tree_util.tree_map(np.asarray, jlora.lora_init(
        base, 4, jax.random.PRNGKey(1)))
    ckdir = str(tmp_path_factory.mktemp("ck"))
    tiny = host_init(jl.llama_init, JCFG, key=4)
    cases = [
        ("mesh_layout", dict(plan=dict(fsdp=2))),
        ("train_losses", dict(plan=dict(ep=2), host=moe_host,
                              batches=batches, preset="moe:moe-tiny",
                              over={"dispatch_impl": "sort"})),
        ("moe_dispatch_error", dict(plan=dict(ep=2))),
        ("lora_losses", dict(plan=dict(tp=2), base=base, adapters=adapters,
                             batches=lora_batches, forward="merged")),
        ("lora_losses", dict(plan=dict(tp=2), base=base, adapters=adapters,
                             batches=lora_batches, forward="attached")),
        ("ckpt_write", dict(plan=dict(fsdp=2), directory=ckdir,
                            batches=CKPT_BATCHES, save_at=2)),
        ("ckpt_resume", dict(plan=dict(tp=2), directory=ckdir,
                             batches=CKPT_BATCHES[2:])),
        ("slot_stream", dict(plan=dict(tp=2), host=tiny, prompts=PROMPTS,
                             max_new=9)),
        ("slot_stream", dict(plan=dict(tp=2), host=tiny,
                             prompts=[PREFIX + [21], PREFIX + [30, 31]],
                             max_new=6, page_size=16, prefix=PREFIX)),
    ]
    vit_b, encdec_b = _family_batches()
    cases += [("tp_weight_share", dict(plan=dict(tp=2), preset="vit:tiny",
                                       batch=vit_b[0])),
              ("tp_weight_share", dict(plan=dict(tp=2),
                                       preset="encdec:tiny",
                                       batch=encdec_b[0]))]
    ranks = Ranks(2, cases, tmp_path_factory.mktemp("pt2"))
    moe_ref, lora_merged, lora_attached = in_threads(call, [
        (jax_train, MOE, dict(ep=2), batches),
        (jax_lora, "merged", lora_batches),
        (jax_lora, "attached", lora_batches)])
    got = ranks.join()
    names = ["layout", "moe", "moe_error", "lora_merged", "lora_attached",
             "ckpt_write", "ckpt_resume", "slots", "slots_paged",
             "vit_tp_share", "encdec_tp_share"]
    out = dict(zip(names, got))
    out.update(moe_ref=moe_ref, lora_merged_ref=lora_merged,
               lora_attached_ref=lora_attached, ckdir=ckdir, tiny=tiny)
    return out


def _family_batches():
    """One (images, labels) ViT batch and one (src, tgt) encoder-decoder
    batch of 4 rows, from a numpy seed."""
    rng = np.random.default_rng(11)
    vit = (rng.random((4, 64, 64, 3), dtype=np.float32),
           rng.integers(0, 10, (4,)).astype(np.int32))
    encdec = (rng.integers(0, 256, (4, 16)).astype(np.int32),
              rng.integers(0, 256, (4, 17)).astype(np.int32))
    return [vit], [encdec]


def _jax_family(cfg, plan, batches):
    """``jax_train`` for a family whose batch is a tuple of arrays."""
    mesh = _jmesh(**plan)
    state, opt = jtrainer.create_train_state(cfg, mesh,
                                             jax.random.PRNGKey(0))
    host = jax.tree_util.tree_map(np.asarray, state.params)
    step = jtrainer.make_train_step(cfg, mesh, opt)
    losses = []
    for b in batches:
        state, m = step(state, tuple(jnp.asarray(x) for x in b))
        losses.append(float(m["loss"]))
    return host, losses, jax.tree_util.tree_map(np.asarray, state.params)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    batches = _batches()
    vit_b, encdec_b = _family_batches()
    cases = [
        ("mesh_layout", dict(plan=dict(fsdp=2, tp=2))),
        ("train_losses", dict(plan=dict(dp=2, ep=2),
                              host=host_init(jmoe.moe_init, MOE),
                              batches=batches, preset="moe:moe-tiny",
                              over={"dispatch_impl": "sort"})),
        ("train_losses", dict(plan=dict(fsdp=2, tp=2),
                              host=host_init(jvit.vit_init, VIT),
                              batches=vit_b, preset="vit:tiny")),
        ("train_losses", dict(plan=dict(dp=2, tp=2),
                              host=host_init(jencdec.encdec_init, ENCDEC),
                              batches=encdec_b, preset="encdec:tiny")),
    ]
    ranks = Ranks(4, cases, tmp_path_factory.mktemp("pt4"))
    moe_ref, vit_ref, encdec_ref = in_threads(call, [
        (jax_train, MOE, dict(dp=2, ep=2), batches),
        (_jax_family, VIT, dict(fsdp=2, tp=2), vit_b),
        (_jax_family, ENCDEC, dict(dp=2, tp=2), encdec_b)])
    got = ranks.join()
    return {"layout": got[0], "moe": (got[1], moe_ref),
            "vit": (got[2], vit_ref), "encdec": (got[3], encdec_ref)}


# --------------------------------------------------------------- trainer


def test_params_actually_sharded(two_ranks, four_ranks):
    """tests/test_trainer.py test_params_actually_sharded: wq (L, d,
    qh·hd) shards d on fsdp and its columns on tp, as DTensor
    placements; the sharded init is the single-device init bit for
    bit."""
    lay = two_ranks["layout"]
    assert lay["local_shape"] == (2, 32, 64)
    assert lay["placements"][2] == "S(1)" and lay["bit_equal_init"]
    assert lay["constrained_whole"]  # constrain(P()) gathers it whole
    lay = four_ranks["layout"]
    assert lay["local_shape"] == (2, 32, 32)
    assert lay["placements"][2] == "S(1)" and lay["placements"][4] == "S(2)"
    assert lay["bit_equal_init"]


# -------------------------------------------------------------------- MoE


@pytest.mark.parametrize("which", ["ep2", "dp2xep2"])
def test_moe_train_step_matches_jax(two_ranks, four_ranks, which):
    """moe-tiny with ``sort`` on an ep mesh: the JAX step's loss and
    params (routing over the global batch, experts split over ep)."""
    if which == "ep2":
        got, (_, losses, params) = two_ranks["moe"], two_ranks["moe_ref"]
    else:
        got, (_, losses, params) = four_ranks["moe"]
    np.testing.assert_allclose(got["losses"], losses, rtol=LOSS_TOL)
    close_params(got["params"], params)


@pytest.mark.parametrize("family", ["vit", "encdec"])
def test_vit_and_encdec_step_on_a_mesh_match_jax(four_ranks, family):
    """vit:tiny at fsdp 2 × tp 2 and encdec:tiny at dp 2 × tp 2: the JAX
    step's loss and params (their weights shard by VIT_RULES and
    ENCDEC_RULES; tp splits the products)."""
    got, (_, losses, params) = four_ranks[family]
    np.testing.assert_allclose(got["losses"], losses, rtol=LOSS_TOL)
    close_params(got["params"], params)


@pytest.mark.parametrize("family", ["vit", "encdec"])
def test_vit_and_encdec_split_their_products_over_tp(two_ranks, family):
    """At tp 2 a rank's products read about half the weights one device
    reads (heads, MLP columns and rows, the patch embedding's or the
    head's vocabulary columns split; ViT's small class head is
    replicated): the tp ranks do not repeat each other's work."""
    assert 0.45 <= two_ranks[f"{family}_tp_share"]["share"] <= 0.55


def test_moe_gather_refused_on_mesh(two_ranks):
    """tests/test_moe.py:265: gather is single-device only."""
    assert "single-device only" in two_ranks["moe_error"]["error"]


# ------------------------------------------------------------------- LoRA


def test_lora_specs_match_jax():
    """tests/test_lora.py:99: A keeps the base's input axis, B its
    output axis."""
    base = jax.tree_util.tree_map(
        np.asarray, jl.llama_init(JCFG, jax.random.PRNGKey(0)))
    targets = ("wq", "wo", "lm_head")
    jad = jlora.lora_init(base, rank=2, key=jax.random.PRNGKey(1),
                          targets=targets)
    ref = jlora.lora_specs(jad)
    got = tlora.lora_specs(jax.tree_util.tree_map(np.asarray, jad))
    flat_ref = jax.tree_util.tree_leaves_with_path(
        ref, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    pls = tlora.lora_shardings(jax.tree_util.tree_map(np.asarray, jad),
                               None)
    for path, spec in flat_ref:
        node, pl = got, pls
        for k in path:
            node, pl = node[k.key], pl[k.key]
        assert _spec_tuple(node) == _spec_tuple(spec), path
        assert pl == tsh.placements(node, None, len(node)), path


def test_render_distributed_env_as_jax():
    """workload/torchenv.py renders, for each process of a job, the
    torch.distributed counterparts of JAX's variables: the coordinator
    is process 0's host wherever it sits in the list; a one-GPU member
    is one rank, a k-GPU member a node of k ranks."""
    from tpu_docker_api.workload import jaxenv
    from tpu_docker_api_torch.workload import torchenv

    hosts = ["10.0.0.2", "10.0.0.1"]
    jjob = jaxenv.DistributedJob("j", [
        jaxenv.ProcessPlacement(process_id=i, host=h, chip_ids=[0],
                                tpu_process_port=8476)
        for i, h in zip((1, 0), hosts)], coordinator_port=8470)
    tjob = torchenv.DistributedJob("j", [
        torchenv.ProcessPlacement(process_id=i, host=h,
                                  gpu_uuids=[f"GPU-{i}"])
        for i, h in zip((1, 0), hosts)], master_port=8470)
    for jp, tp in zip(jjob.placements, tjob.placements):
        jenv = dict(e.split("=", 1) for e in jaxenv.render_distributed_env(
            jjob, jp))
        tenv = dict(e.split("=", 1) for e in torchenv.render_distributed_env(
            tjob, tp))
        assert (f"{tenv['MASTER_ADDR']}:{tenv['MASTER_PORT']}"
                == jenv["JAX_COORDINATOR_ADDRESS"])
        assert tenv["WORLD_SIZE"] == jenv["JAX_NUM_PROCESSES"]
        assert tenv["RANK"] == jenv["JAX_PROCESS_ID"]
        assert tenv["LOCAL_RANK"] == "0"
    # a member holding k > 1 GPUs runs k ranks (workload/torchenv.py
    # launch_workers): its node rank and k, the job's GPUs as the world,
    # and no RANK
    two = [torchenv.ProcessPlacement(process_id=i, host=h,
                                     gpu_uuids=[f"GPU-{i}a", f"GPU-{i}b"])
           for i, h in zip((1, 0), hosts)]
    job = torchenv.DistributedJob("k", two, 8470)
    for jp, tp in zip(jjob.placements, two):
        jenv = dict(e.split("=", 1) for e in jaxenv.render_distributed_env(
            jjob, jp))
        tenv = dict(e.split("=", 1) for e in torchenv.render_distributed_env(
            job, tp))
        assert (f"{tenv['MASTER_ADDR']}:{tenv['MASTER_PORT']}"
                == jenv["JAX_COORDINATOR_ADDRESS"])
        assert tenv["NODE_RANK"] == jenv["JAX_PROCESS_ID"]
        assert (tenv["WORLD_SIZE"], tenv["LOCAL_WORLD_SIZE"]) == ("4", "2")
        assert "RANK" not in tenv
    mixed = [two[0], torchenv.ProcessPlacement(process_id=0, host="h",
                                               gpu_uuids=["GPU-c"])]
    with pytest.raises(ValueError, match="every member must hold as many"):
        torchenv.render_distributed_env(
            torchenv.DistributedJob("m", mixed, 1), mixed[0])


@pytest.mark.parametrize("forward", ["merged", "attached"])
def test_lora_tp2_matches_jax(two_ranks, forward):
    got = two_ranks[f"lora_{forward}"]
    _, _, losses, adapters = two_ranks[f"lora_{forward}_ref"]
    np.testing.assert_allclose(got["losses"], losses, rtol=LOSS_TOL)
    close_params(got["adapters"], adapters)


# ------------------------------------------------------------ checkpoints


def _tree_equal(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], dict):
            _tree_equal(a[k], b[k])
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                          err_msg=k)


def test_checkpoint_fsdp2_restores_at_tp2(two_ranks):
    """Written at fsdp 2, restored at tp 2: params and the int8 moments
    (scales included) bit-equal, and the resumed steps give the
    uninterrupted run's losses."""
    w, r = two_ranks["ckpt_write"], two_ranks["ckpt_resume"]
    assert r["restored"]["step"] == 2
    _tree_equal(r["restored"]["params"], w["saved"]["params"])
    _tree_equal(r["restored"]["opt"], w["saved"]["opt"])
    np.testing.assert_allclose(r["losses"], w["losses"], rtol=1e-6)


def test_checkpoint_fsdp2_restores_on_one_device(two_ranks):
    """The same step on one device: bit-equal, and its steps give the
    uninterrupted run's losses."""
    w = two_ranks["ckpt_write"]
    cfg = dataclasses.replace(tl.llama_presets()["tiny"],
                              dtype=torch.float32)
    mgr = CheckpointManager(two_ranks["ckdir"])
    opt = adamw_int8()
    st = mgr.restore(cfg, opt, step=2, device="cpu")
    _tree_equal(jax.tree_util.tree_map(lambda t: t.numpy(), st.params),
                w["saved"]["params"])
    from tpu_docker_api_torch.train.checkpoint import _flatten

    flat: dict = {}
    _flatten(st.opt_state, "", flat, {})
    _tree_equal({k: v.numpy() for k, v in flat.items()}, w["saved"]["opt"])
    step = make_train_step(cfg, opt)
    losses = []
    for b in CKPT_BATCHES[2:]:
        st, m = step(st, torch.from_numpy(b).long())
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, w["losses"], rtol=1e-6)


# ------------------------------------------------------------- serving


def _one_device_streams(tiny, prompts, max_new, page_size=0, prefix=None):
    from tpu_docker_api_torch.infer.paged import PagedSlotEngine
    from tpu_docker_api_torch.infer.slots import SlotEngine

    cfg = dataclasses.replace(tl.llama_presets()["tiny"],
                              dtype=torch.float32)
    params = params_from_numpy(tiny, "cpu")
    kw = dict(slots=3, max_seq=64, chunk=4, cache_dtype=cfg.dtype)
    eng = (PagedSlotEngine(cfg, params, page_size=page_size, total_pages=12,
                           **kw) if page_size else SlotEngine(cfg, params,
                                                              **kw))
    if prefix:
        eng.register_prefix(prefix)
    hs = [eng.submit(p, max_new) for p in prompts]
    for _ in range(400):
        if all(h.done() for h in hs):
            break
        eng.step()
    return [h.result(0)["tokens"] for h in hs]


def test_tp2_slot_engine_token_exact(two_ranks):
    """tests/test_slots.py:451: the tp 2 engine (kv heads split, slots
    replicated, ranks in lockstep) streams the one-device tokens."""
    assert two_ranks["slots"]["tokens"] == _one_device_streams(
        two_ranks["tiny"], PROMPTS, 9)


def test_tp2_paged_engine_with_prefix_token_exact(two_ranks):
    """tests/test_serve.py:742: paged × tp with a registered prefix."""
    got = two_ranks["slots_paged"]
    assert got["stats"]["prefix_hits"] == 2
    assert got["tokens"] == _one_device_streams(
        two_ranks["tiny"], [PREFIX + [21], PREFIX + [30, 31]], 6,
        page_size=16, prefix=PREFIX)


def _post(port, path, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(body).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as r:
        return json.loads(r.read())


def _tp2_server(tmp_path, mesh=("--tp", "2")):
    """``serve --tp 2`` (or the ``mesh`` flags given) on two gloo ranks:
    (launcher process, HTTP port, stderr file). The server binds port 0
    and says which port it took, so no port is picked before the
    launcher picks its rendezvous one."""
    err = open(tmp_path / "serve.err", "w")
    p = subprocess.Popen(
        [sys.executable, "-m", "tpu_docker_api_torch.serve", "--device",
         "cpu", "--preset", "tiny", "--host", "127.0.0.1", "--port", "0",
         "--max-seq", "64", *mesh, "--nproc-per-node", "2"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=err, text=True)
    line = p.stdout.readline()
    if not line:
        p.wait(timeout=60)
        raise AssertionError((tmp_path / "serve.err").read_text()[-3000:])
    ready = json.loads(line)
    assert ready["event"] == "serving", line
    return p, ready["port"], err


def test_cli_server_on_tp2_ranks(tmp_path):
    """tests/test_serve.py:348: ``serve --tp 2`` starts two ranks, keeps
    the slot engine on the mesh and answers; SIGTERM stops every
    rank."""
    p, port, err = _tp2_server(tmp_path)
    try:
        h = _get(port, "/healthz")
        assert h["devices"] == 2 and h["slotEngine"]["slots"] == 8
        out = _post(port, "/generate", {"tokens": [[1, 2, 3], [4, 5]],
                                        "maxNewTokens": 4})
        assert [len(r) for r in out["tokens"]] == [4, 4]
    finally:
        p.terminate()
        assert p.wait(timeout=60) == 0, (tmp_path / "serve.err").read_text()
        err.close()


@pytest.fixture(scope="module")
def dp2_server(tmp_path_factory):
    """``serve --dp 2`` on two gloo ranks (the ``--slots 0`` path, as in
    JAX): one greedy request of two rows and ``/healthz``; then rank 1
    is killed, and the launcher's exit code is kept."""
    tmp = tmp_path_factory.mktemp("dp2")
    rows = [[1, 2, 3, 4], [9, 8, 7, 6]]
    p, port, err = _tp2_server(tmp, ("--dp", "2"))
    try:
        got = _post(port, "/generate", {"tokens": rows, "maxNewTokens": 5})
        health = _get(port, "/healthz")
        with open(f"/proc/{p.pid}/task/{p.pid}/children") as f:
            ranks = [int(x) for x in f.read().split()]
        os.kill(ranks[1], signal.SIGKILL)  # rank 1: started second
        code = p.wait(timeout=60)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
        err.close()
    return {"rows": rows, "got": got, "health": health, "ranks": ranks,
            "code": code}


def test_cli_server_on_dp2_ranks_splits_the_rows(dp2_server):
    """Each rank generates its block of a request's rows, and the greedy
    rows equal one device's generation of each row."""
    from tpu_docker_api_torch.serve.__main__ import Server, parse_args

    h = dp2_server["health"]
    assert h["devices"] == 2 and h["meshRows"] == [1, 1]
    one = Server(parse_args(["--device", "cpu", "--preset", "tiny",
                             "--max-seq", "64", "--slots", "0", "--port",
                             "0"]))
    try:
        want = [one.generate((5, 0.0, 0, 1.0, None), [r])["tokens"][0]
                for r in dp2_server["rows"]]
    finally:
        one.close()
    assert dp2_server["got"]["tokens"] == want


@pytest.mark.parametrize("preset,tp,gathered", [
    ("llama3-1b", 2, {"lm_head"}),
    ("llama3-1b", 4, {"layers/attn/wk", "layers/attn/wv", "lm_head"}),
    ("llama3-8b", 4, {"lm_head"}),
    ("llama3-8b", 8, {"layers/attn/wk", "layers/attn/wv", "lm_head"}),
    ("moe:mixtral-8x7b", 2, {"lm_head"}),
    ("moe:mixtral-8x7b", 8, {"layers/attn/wk", "layers/attn/wv",
                             "lm_head"})])
def test_adam8_route_of_each_leaf_at_published_widths(preset, tp, gathered):
    """adam8 on sharded leaves keeps JAX's blocks along the global last
    dim: a leaf whose tp shards (fsdp 8) cut a 256-wide block takes the
    gather route; the vocab of 128256 (501 blocks) and of 32000 (125)
    never splits evenly, wk/wv do past 2·kv_heads·hd/256 ranks."""
    from tpu_docker_api_torch.models import model_fns, param_shapes
    from tpu_docker_api_torch.models import resolve_preset
    from tpu_docker_api_torch.parallel import sharding
    from tpu_docker_api_torch.train.optim import adam8_route

    _, cfg = resolve_preset(preset)
    rules = model_fns(cfg)[2]
    sizes = {"tp": tp, "fsdp": 8}
    routes = {}
    for path, shape in sharding.flatten_paths(param_shapes(cfg)).items():
        spec = sharding.padded(sharding.spec_for(path, rules), len(shape))
        n = 1
        for a in sharding.entry_axes(spec[-1]):
            n *= sizes.get(a, 1)
        routes[path] = adam8_route(shape, n)
    assert {p for p, r in routes.items() if r == "gather"} == gathered


@pytest.mark.parametrize("plan", [dict(dp=2), dict(sp=2), dict(pp=2),
                                  dict(ep=2)])
def test_slot_engine_refuses_non_tp_meshes(plan):
    """tests/test_slots.py:462: the slot engine runs on tp/fsdp meshes
    only (slots stay replicated, decode's seq is 1)."""
    from tpu_docker_api_torch.infer.slots import SlotEngine
    from tpu_docker_api_torch.parallel.mesh import AXES

    class Plan:
        shape = {ax: plan.get(ax, 1) for ax in AXES}

    cfg = dataclasses.replace(tl.llama_presets()["tiny"],
                              dtype=torch.float32)
    params = tl.llama_init(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="tp/fsdp-only"):
        SlotEngine(cfg, params, slots=2, max_seq=64, mesh=Plan())


def test_cli_server_stops_when_a_rank_falls_out(dp2_server):
    """A rank that dies takes the job down with an error: the launcher
    stops rank 0 and exits non-zero, where rank 0 would otherwise serve
    on, its next request's collective waiting for the lost rank."""
    assert len(dp2_server["ranks"]) == 2
    assert dp2_server["code"] != 0
