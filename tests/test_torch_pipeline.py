"""The port's pipeline parallelism (parallel/pipeline.py) against the JAX
package's, multi-rank.

Mirrors tests/test_pipeline.py: the pp-aware rules, the GPipe loss
against the plain forward (pp 2 × tp 2 with 4 microbatches, pp 4 with
one), the hand-scheduled 1F1B against JAX's own ``pipeline_1f1b_grads``
on a mesh of the same shape (pp 2 × tp 2 with 4 microbatches, in f32
and bf16; pp 4 with 10, where the stash ring of 2S slots wraps), the
divisibility errors, and a train step through ``make_train_step(
grad_fn=...)``. Beyond it: ``global_norm`` and the gradient reduction
on pp-sharded leaves, adam8's route on them at llama3-1b's published
widths, checkpoints written at pp 2 and restored on one device and at
pp 2 × tp 2, and the trainer CLI's ``--pp 2`` against JAX's.

The port runs in gloo ranks (tests/torch_ranks.py: one 2-rank spawn,
then one 4-rank spawn, which restores the 2-rank one's checkpoint); the
JAX references run on the 8 virtual CPU devices of tests/conftest.py,
in threads while the ranks run. Weights are JAX's init (key 0) carried
over by models/convert.py, tokens from a numpy seed; the tiny preset
with 4 layers.

Tolerances: JAX's own. The GPipe loss 1e-4 (rtol and atol) of the plain
loss; 1F1B in f32 loss 1e-5 relative, gradients rtol 1e-4 and atol
1e-5; in bf16, gradients rtol 3e-2 and atol 2e-3, the loss 1e-4
relative. A train step as tests/test_torch_parallel.py holds one (loss
1e-4 relative, params after it ``close_params``); checkpoints restore
bit-equal; the CLIs' losses within 1e-3 relative (bf16, JAX's CLI runs
the plain loss on replicas where the port pipelines).
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
import torch

from test_torch_parallel import (LOSS_TOL, _jmesh, _spec_tuple, call,
                                 close_params, host_init, in_threads)
from torch_ranks import Ranks
from tpu_docker_api.models import llama as jl
from tpu_docker_api.parallel import pipeline as jpl
from tpu_docker_api.parallel import sharding as jsh
from tpu_docker_api.train import trainer as jtrainer
from tpu_docker_api_torch.parallel import pipeline as tpl
from tpu_docker_api_torch.parallel import sharding as tsh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_LOSS, F32_GRAD = 1e-5, (1e-4, 1e-5)
BF16_LOSS, BF16_GRAD = 1e-4, (3e-2, 2e-3)
CLI_TOL = 1e-3


def _jcfg(dtype=jnp.float32, **over):
    over.setdefault("n_layers", 4)
    return dataclasses.replace(jl.llama_presets()["tiny"], dtype=dtype,
                               **over)


def _tokens(rows, seed, seq=17):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (rows, seq)).astype(np.int32)


def _host(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


def jax_1f1b(cfg, plan, tokens, n_micro):
    """(loss, grads) of JAX's ``pipeline_1f1b_grads`` on ``plan``."""
    mesh = _jmesh(**plan)
    params = jl.llama_init(cfg, jax.random.PRNGKey(0))
    with mesh:
        loss, grads = jax.jit(lambda p, t: jpl.pipeline_1f1b_grads(
            p, t, cfg, mesh, n_micro))(params, jnp.asarray(tokens))
    return float(loss), _host(grads)


def jax_plain(cfg, tokens):
    """(loss, logits) of JAX's plain ``llama_loss`` and ``llama_forward``."""
    params = jl.llama_init(cfg, jax.random.PRNGKey(0))
    tokens = jnp.asarray(tokens)
    return (float(jl.llama_loss(params, tokens, cfg)),
            np.asarray(jl.llama_forward(params, tokens[:, :-1], cfg),
                       np.float32))


def jax_pipe_train(cfg, plan, tokens, n_micro, steps):
    """JAX's tests/test_pipeline.py train step through ``grad_fn``."""
    mesh = _jmesh(**plan)
    state, opt = jtrainer.create_train_state(
        cfg, mesh, jax.random.PRNGKey(0),
        rules=jpl.pipeline_rules(jsh.LLAMA_RULES))
    step = jtrainer.make_train_step(
        cfg, mesh, opt, grad_fn=lambda p, t: jpl.pipeline_1f1b_grads(
            p, t, cfg, mesh, n_micro))
    losses, norms, first = [], [], None
    for i in range(steps):
        state, m = step(state, jnp.asarray(tokens))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        if i == 0:
            first = _host(state.params)
    return losses, norms, first


TRAIN_TOKENS = _tokens(4, 1, seq=33)
CKPT_TOKENS = _tokens(4, 7)


@pytest.fixture(scope="module")
def pipe2(tmp_path_factory):
    """The 2-rank cases: a pp 2 train step, a pp 2 checkpoint."""
    host = host_init(jl.llama_init, _jcfg())
    ckdir = str(tmp_path_factory.mktemp("ppck"))
    ranks = Ranks(2, [
        ("pipe_train", dict(plan=dict(pp=2), host=host, tokens=TRAIN_TOKENS,
                            n_micro=2, steps=3)),
        ("pipe_ckpt_write", dict(plan=dict(pp=2), directory=ckdir,
                                 tokens=CKPT_TOKENS)),
    ], tmp_path_factory.mktemp("pp2"))
    ref = jax_pipe_train(_jcfg(), dict(pp=2), TRAIN_TOKENS, 2, 3)
    train, ck = ranks.join()
    return {"train": train, "train_ref": ref, "ckpt": ck, "ckdir": ckdir}


GRAD_CASES = {
    # id: (plan, rows, n_micro, dtype, the port's attention_impl); at
    # sp 2 "auto" gathers the sequence as JAX's stage does, the ring
    # keeps it sharded (JAX's reference is the same mesh's either way)
    "pp2tp2-f32": (dict(pp=2, tp=2), 8, 4, "float32", "auto"),
    "pp4-n10-f32": (dict(pp=4), 10, 10, "float32", "auto"),
    "pp2tp2-bf16": (dict(pp=2, tp=2), 8, 4, "bfloat16", "auto"),
    "pp2sp2-f32": (dict(pp=2, sp=2), 8, 4, "float32", "auto"),
    "pp2sp2-bf16": (dict(pp=2, sp=2), 8, 4, "bfloat16", "auto"),
    "pp2sp2-ring-f32": (dict(pp=2, sp=2), 8, 4, "float32", "ring-zigzag"),
}
GPIPE_CASES = {"pp2tp2-n4": (dict(pp=2, tp=2), 8, 4),
               "pp4-n1": (dict(pp=4), 2, 1),
               "pp2sp2-n4": (dict(pp=2, sp=2), 8, 4)}
#: the tokens of a case: the pp 2 × tp 2 ones share theirs, so the
#: port's GPipe and 1F1B gradients compare there
SEEDS = {8: 2, 10: 3, 2: 4}


@pytest.fixture(scope="module")
def pipe4(pipe2, tmp_path_factory):
    """The 4-rank cases, and their JAX references computed meanwhile."""
    f32 = host_init(jl.llama_init, _jcfg())
    bf16 = host_init(jl.llama_init, _jcfg(jnp.bfloat16))
    cases, refs = [], []
    for plan, rows, nm in GPIPE_CASES.values():
        tokens = _tokens(rows, SEEDS[rows])
        cases.append(("pipe_grads", dict(plan=plan, host=f32, tokens=tokens,
                                         n_micro=nm, schedule="gpipe")))
        refs.append((jax_plain, _jcfg(), tokens))
    for plan, rows, nm, dtype, impl in GRAD_CASES.values():
        tokens = _tokens(rows, SEEDS[rows])
        cases.append(("pipe_grads", dict(
            plan=plan, host=bf16 if dtype == "bfloat16" else f32,
            tokens=tokens, n_micro=nm, schedule="1f1b",
            over={"dtype": dtype, "attention_impl": impl})))
        refs.append((jax_1f1b, _jcfg(getattr(jnp, dtype)), plan, tokens,
                     nm))
    cases += [("pipe_global_norm", dict(plan=dict(pp=2, tp=2), host=f32)),
              ("pipe_ckpt_resume", dict(plan=dict(pp=2, tp=2),
                                        directory=pipe2["ckdir"],
                                        tokens=CKPT_TOKENS))]
    ranks = Ranks(4, cases, tmp_path_factory.mktemp("pp4"))
    ref = in_threads(call, refs)
    got = ranks.join()
    n, g = len(GPIPE_CASES), len(GRAD_CASES)
    return {"gpipe": dict(zip(GPIPE_CASES, zip(got[:n], ref[:n]))),
            "1f1b": dict(zip(GRAD_CASES, zip(got[n:n + g], ref[n:]))),
            "norm": got[n + g], "resume": got[n + g + 1], "f32": f32}


def _close_grads(got: dict, ref: dict, rtol: float, atol: float) -> None:
    flat = tsh.flatten_paths(got)
    for path, r in tsh.flatten_paths(ref).items():
        np.testing.assert_allclose(flat[path], r, rtol=rtol, atol=atol,
                                   err_msg=path)


# ----------------------------------------------------------------- rules


def test_pipeline_rules_are_the_jax_rules():
    """tests/test_pipeline.py TestPipelineRules: every layers/* rule
    gains pp on the stacked dim; the others, the stacked norms' P()
    among them, stay as they are. Pattern for pattern."""
    ours = tpl.pipeline_rules(tsh.LLAMA_RULES)
    theirs = jpl.pipeline_rules(jsh.LLAMA_RULES)
    assert [(p, _spec_tuple(s)) for p, s in ours] == [
        (p, _spec_tuple(s)) for p, s in theirs]
    by = dict(ours)
    assert tuple(by["layers/attn/wq"]) == ("pp", "fsdp", "tp")
    assert tuple(by["layers/mlp/w_down"]) == ("pp", "tp", "fsdp")
    assert tuple(by["embed/tokens"]) == ("tp", "fsdp")


def test_grad_reduce_axes_know_pp():
    """A leaf sharded on pp is not summed over it; a leaf replicated over
    pp (embed, head, the stacked norms) is: one stage touches it, or
    each stage its own rows."""
    rules = tpl.pipeline_rules(tsh.LLAMA_RULES)
    wq = tsh.grad_reduce_axes(tsh.spec_for("layers/attn/wq", rules))
    assert wq == ("dp", "sp")
    for path in ("embed/tokens", "lm_head", "layers/attn_norm"):
        assert "pp" in tsh.grad_reduce_axes(tsh.spec_for(path, rules)), path


# ----------------------------------------------------------------- GPipe


@pytest.mark.parametrize("case", list(GPIPE_CASES))
def test_gpipe_loss_matches_plain_llama_loss(pipe4, case):
    """TestPipelineEquivalence: the pipelined loss equals JAX's plain
    ``llama_loss`` (fill/drain routing errors would break it)."""
    got, (loss, _) = pipe4["gpipe"][case]
    np.testing.assert_allclose(got["loss"], loss, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("case", list(GPIPE_CASES))
def test_gpipe_forward_logits_on_the_last_stage(pipe4, case):
    """``pipeline_forward``: the last stage holds the logits of its rows,
    JAX's plain ``llama_forward``'s (1e-4); the other stages get None,
    where JAX's GSPMD array is whole on every device."""
    got, (_, logits) = pipe4["gpipe"][case]
    assert got["logits_here"] is False       # rank 0 is stage 0
    np.testing.assert_allclose(got["last_stage_logits"], logits,
                               rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------------ 1F1B


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_1f1b_matches_jax(pipe4, case):
    """Test1F1BSchedule: loss and every gradient of the port's
    ``pipeline_1f1b_grads`` against JAX's on the same mesh shape (pp 4
    with 10 microbatches wraps the 2S-slot stash)."""
    got, (loss, grads) = pipe4["1f1b"][case]
    bf16 = GRAD_CASES[case][3] == "bfloat16"
    np.testing.assert_allclose(got["loss"], loss,
                               rtol=BF16_LOSS if bf16 else F32_LOSS)
    _close_grads(got["grads"], grads, *(BF16_GRAD if bf16 else F32_GRAD))


def test_1f1b_matches_the_port_gpipe(pipe4):
    """Test1F1BSchedule's own check, in the port: the hand-scheduled
    backward against autograd through the sends, on pp 2 × tp 2, the
    same tokens, f32."""
    gpipe, _ = pipe4["gpipe"]["pp2tp2-n4"]
    one, _ = pipe4["1f1b"]["pp2tp2-f32"]
    np.testing.assert_allclose(one["loss"], gpipe["loss"], rtol=F32_LOSS)
    _close_grads(one["grads"], gpipe["grads"], *F32_GRAD)


@pytest.mark.parametrize("sp,impl,device,want", [
    (2, "auto", "cuda", "flash"), (2, "auto", "cpu", "dense"),
    (2, "ring-zigzag", "cuda", "ring-zigzag"), (1, "auto", "cuda", "auto"),
])
def test_stage_attention_is_jaxs_block_pick(sp, impl, device, want):
    """JAX's stage blocks run with ``mesh=None``, so at sp > 1 their
    ``auto`` attends over the gathered sequence (flash on the
    accelerator), not the sp rule's ring; an explicit impl, and any
    impl off sp, is kept. llama3-1b's head_dim 64 is one the kernels
    take. (The device is only named: nothing runs.)"""
    from tpu_docker_api_torch.models import llama as tl

    mesh = _FakeMesh()
    mesh.shape = {**mesh.shape, "sp": sp}
    cfg = dataclasses.replace(tl.llama_presets()["llama3-1b"],
                              attention_impl=impl)
    got = tpl._stage_cfg(cfg, mesh, torch.bfloat16, torch.device(device))
    assert got.attention_impl == want


class _FakeMesh:
    """A pp 2 mesh's shape and coordinates, no groups: the errors come
    before any communication."""
    shape = {"pp": 2, "dp": 1, "fsdp": 1, "ep": 1, "tp": 1, "sp": 1}
    coords = {a: 0 for a in shape}
    device_type = "cpu"

    def group(self, axis):
        return None


def test_divisibility_errors_match_jax():
    """JAX's two ValueErrors, word for word: layers not divisible by pp,
    the batch not divisible by n_micro."""
    from tpu_docker_api_torch.models import llama as tl
    from tpu_docker_api_torch.models.convert import params_from_numpy

    tokens = _tokens(4, 3, seq=9)
    mesh = _jmesh(pp=2)
    for n_layers, nm, fn in ((3, 2, "pipeline_loss"),
                             (4, 3, "pipeline_loss"),
                             (4, 3, "pipeline_1f1b_grads")):
        jcfg = _jcfg(n_layers=n_layers)
        with pytest.raises(ValueError) as jerr:
            getattr(jpl, fn)(jl.llama_init(jcfg, jax.random.PRNGKey(0)),
                             jnp.asarray(tokens), jcfg, mesh, nm)
        tcfg = dataclasses.replace(tl.llama_presets()["tiny"],
                                   dtype=torch.float32, n_layers=n_layers)
        params = params_from_numpy(host_init(jl.llama_init, jcfg), "cpu")
        with pytest.raises(ValueError) as terr:
            getattr(tpl, fn)(params, torch.from_numpy(tokens).long(), tcfg,
                             _FakeMesh(), nm)
        assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("plan,batch,n_micro", [
    (dict(pp=2), 8, 8), (dict(pp=2, dp=2), 8, 4),
    (dict(pp=2, dp=2, fsdp=2), 16, 4)])
def test_cli_derives_n_micro_from_the_batch(monkeypatch, plan, batch,
                                            n_micro):
    """The trainer CLI's ``--pp`` has no microbatch flag (JAX's has
    none): ``n_micro = batch / (dp·fsdp)``, one row a microbatch on
    each data rank."""
    from tpu_docker_api_torch.models import resolve_preset
    from tpu_docker_api_torch.parallel.mesh import Mesh
    from tpu_docker_api_torch.train.__main__ import pipeline_parts

    class M:
        shape = {**_FakeMesh.shape, **plan}
        size_of = Mesh.size_of

    seen = []
    monkeypatch.setattr(tpl, "pipeline_1f1b_grads",
                        lambda *a: seen.append(a[4]))
    _, cfg = resolve_preset("tiny")
    rules, grad_fn = pipeline_parts(cfg, M(), batch)
    grad_fn(None, None)
    assert seen == [n_micro]
    assert rules == tpl.pipeline_rules(tsh.LLAMA_RULES)


def test_loss_fn_and_grad_fn_mutually_exclusive():
    """JAX's exclusion, and the port's refusal of a pp mesh without the
    pipeline's loss: the family's loss would run every layer on every
    stage."""
    from tpu_docker_api_torch.models import llama as tl
    from tpu_docker_api_torch.train import trainer

    cfg = tl.llama_presets()["tiny"]
    with pytest.raises(ValueError, match="not both") as terr:
        trainer.make_train_step(cfg, None, loss_fn=lambda p, t: 0,
                                grad_fn=lambda p, t: (0, p))
    with pytest.raises(ValueError, match="not both") as jerr:
        jtrainer.make_train_step(_jcfg(), _jmesh(dp=8), None,
                                 loss_fn=lambda p, t: 0,
                                 grad_fn=lambda p, t: (0, p))
    assert str(terr.value) == str(jerr.value)

    with pytest.raises(ValueError, match="pipeline's loss_fn or grad_fn"):
        trainer.make_train_step(cfg, None, mesh=_FakeMesh())


# ----------------------------------------------------------------- train


def test_train_step_via_grad_fn_at_pp2(pipe2):
    """test_train_step_via_grad_fn: the pp-sharded state trains through
    ``make_train_step(grad_fn=pipeline_1f1b_grads)``; step 1's loss,
    grad norm and params equal JAX's step at pp 2; the loss falls."""
    got = pipe2["train"]
    losses, norms, first = pipe2["train_ref"]
    assert got["wq_shard_dims"][0] == 0   # pp, the mesh's first axis
    np.testing.assert_allclose(got["losses"][0], losses[0], rtol=LOSS_TOL)
    np.testing.assert_allclose(got["grad_norms"][0], norms[0], rtol=LOSS_TOL)
    close_params(got["params"], first)
    np.testing.assert_allclose(got["losses"], losses, rtol=LOSS_TOL)
    assert got["losses"][-1] < got["losses"][0]


def test_global_norm_counts_each_leaf_once(pipe4):
    """``global_norm`` of pp × tp DTensors: each pp shard once, each leaf
    replicated over pp once (the whole tree's norm)."""
    f32 = pipe4["f32"]
    want = np.sqrt(sum(float((np.asarray(x, np.float64) ** 2).sum())
                       for x in tsh.flatten_paths(f32).values()))
    np.testing.assert_allclose(pipe4["norm"]["norm"], want, rtol=1e-6)


@pytest.mark.parametrize("pp", [2, 4])
def test_adam8_route_of_pp_sharded_leaves_at_published_widths(pp):
    """adam8 on pp-sharded leaves: pp cuts the stacked layer dim (dim 0),
    never the last, so each shard keeps whole blocks of it and the
    kernel runs on the shard: ``"shard"`` for every layer leaf of
    llama3-1b under ``pipeline_rules`` at pp × tp 2 × fsdp 8."""
    from tpu_docker_api_torch.models import param_shapes, resolve_preset
    from tpu_docker_api_torch.train.optim import adam8_route

    _, cfg = resolve_preset("llama3-1b")
    rules = tpl.pipeline_rules(tsh.LLAMA_RULES)
    sizes = {"pp": pp, "tp": 2, "fsdp": 8}
    routes = {}
    for path, shape in tsh.flatten_paths(param_shapes(cfg)).items():
        spec = tsh.padded(tsh.spec_for(path, rules), len(shape))
        if "pp" not in tsh.sharded_axes(spec):
            continue
        assert tsh.entry_axes(spec[0]) == ("pp",) and shape[0] % pp == 0
        n = 1
        for a in tsh.entry_axes(spec[-1]):
            n *= sizes[a]
        routes[path] = adam8_route(shape, n)
    assert len(routes) == 7 and set(routes.values()) == {"shard"}, routes


# ------------------------------------------------------------ checkpoint


def _ckpt_equal(got: dict, want: dict) -> None:
    for part in ("params", "opt"):
        g, w = tsh.flatten_paths(got[part]), tsh.flatten_paths(want[part])
        assert set(g) == set(w)
        for k in w:
            assert np.array_equal(np.asarray(g[k]), np.asarray(w[k])), k


def test_checkpoint_pp2_restores_on_one_device(pipe2):
    """A pp 2 adamw-int8 state saves in the one format and restores on
    one device bit for bit."""
    from tpu_docker_api_torch.models import resolve_preset
    from tpu_docker_api_torch.train.checkpoint import (CheckpointManager,
                                                       _file_shape, _flatten)
    from tpu_docker_api_torch.train.optim import adamw_int8

    _, cfg = resolve_preset("tiny")
    cfg = dataclasses.replace(cfg, dtype=torch.float32)
    st = CheckpointManager(pipe2["ckdir"]).restore(cfg, adamw_int8(),
                                                   device="cpu")
    opt: dict = {}
    _flatten(st.opt_state, "", opt, {})
    got = {"params": {k: v.numpy()
                      for k, v in tsh.flatten_paths(st.params).items()},
           "opt": {k: t.reshape(_file_shape(k, t)).numpy()
                   for k, t in opt.items()}}
    _ckpt_equal(got, pipe2["ckpt"])
    assert st.step == 1


def test_checkpoint_pp2_restores_at_pp2_tp2(pipe2, pipe4):
    """The pp 2 checkpoint resumes on a pp 2 × tp 2 mesh bit for bit,
    and its next pipeline step's loss is one device's."""
    from tpu_docker_api_torch.models import resolve_preset
    from tpu_docker_api_torch.train.checkpoint import CheckpointManager
    from tpu_docker_api_torch.train.optim import adamw_int8
    from tpu_docker_api_torch.train.trainer import make_train_step

    res = pipe4["resume"]
    assert res["restored"]["step"] == 1
    _ckpt_equal(res["restored"], pipe2["ckpt"])
    _, cfg = resolve_preset("tiny")
    cfg = dataclasses.replace(cfg, dtype=torch.float32)
    opt = adamw_int8()
    st = CheckpointManager(pipe2["ckdir"]).restore(cfg, opt, device="cpu")
    _, m = make_train_step(cfg, opt)(st, torch.from_numpy(CKPT_TOKENS)
                                     .long())
    np.testing.assert_allclose(res["loss"], float(m["loss"]), rtol=LOSS_TOL)


# ------------------------------------------------------------------- CLI


def cli_against_jax(tmp_path, *mesh):
    """(the port's losses and last line, JAX's losses) of 3 steps of
    tiny on a token file under the mesh flags ``mesh`` (``--pp`` first):
    the port in gloo ranks, one a device of the mesh, through the 1F1B
    pipeline from JAX's init (key 0, carried over in a step-0
    checkpoint); JAX's CLI on as many virtual devices, running the plain
    loss from the same init and batches."""
    from tpu_docker_api_torch.data.loader import write_token_file
    from tpu_docker_api_torch.models import resolve_preset
    from tpu_docker_api_torch.models.convert import params_from_numpy
    from tpu_docker_api_torch.train.checkpoint import CheckpointManager
    from tpu_docker_api_torch.train.trainer import (TrainState,
                                                    default_optimizer)

    data = str(tmp_path / "tok.bin")
    write_token_file(np.random.default_rng(0).integers(0, 256, 4000), data)
    jcfg = jl.llama_presets()["tiny"]
    params = params_from_numpy(jax.tree_util.tree_map(
        np.asarray, jl.llama_init(jcfg, jax.random.PRNGKey(0))), "cpu")
    _, cfg = resolve_preset("tiny")
    assert params["layers"]["attn"]["wq"].dtype == cfg.dtype
    opt = default_optimizer()
    ck = str(tmp_path / "ck")
    with CheckpointManager(ck) as mgr:
        mgr.save(TrainState(0, params, opt.init(params)))
        mgr.wait()
    world = int(np.prod([int(v) for v in mesh[1::2]]))
    common = ["--preset", "tiny", "--data", data, "--steps", "3",
              "--batch", "2", "--seq", "16", "--log-every", "1", *mesh]
    ours = subprocess.Popen(
        [sys.executable, "-m", "tpu_docker_api_torch.train", *common,
         "--device", "cpu", "--nproc-per-node", str(world), "--ckpt-dir",
         ck, "--save-every", "1000"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    theirs = subprocess.run(
        [sys.executable, "-m", "tpu_docker_api.train", *common,
         "--platform", "cpu", "--virtual-devices", str(world)],
        cwd=ROOT, capture_output=True, text=True, timeout=240)
    out, err = ours.communicate(timeout=240)
    assert ours.returncode == 0, err
    assert theirs.returncode == 0, theirs.stderr

    def losses(text):
        return [ln["loss"] for ln in map(json.loads, text.splitlines())
                if "loss" in ln]

    return losses(out), json.loads(out.splitlines()[-1]), losses(
        theirs.stdout)


def test_cli_pp2_matches_jax_cli(tmp_path):
    """``--pp 2`` on two gloo ranks trains tiny through the 1F1B
    pipeline; JAX's CLI ``--pp 2`` on 2 virtual devices runs the plain
    loss on replicas (``cli_against_jax``). The losses agree within
    1e-3."""
    got, last, ref = cli_against_jax(tmp_path, "--pp", "2")
    assert len(got) == len(ref) == 3
    np.testing.assert_allclose(got, ref, rtol=CLI_TOL)
    assert last == {"event": "done", "step": 3}
