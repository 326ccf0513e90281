"""The port's training path against the JAX package's, same weights.

Tiny f32 config; the JAX params come from ``llama_init(cfg,
PRNGKey(0))`` and cross over through models/convert.py. ``llama_loss``
and its gradients are held at 1e-4 (f32 through two layers, two
frameworks' summation orders). Three ``make_train_step`` steps give the
same parameters: at least 99.9% of each leaf's elements within 2e-6, and
every element within 6·lr. Adam normalises each gradient by its own
running size, so an element whose gradient is at the f32 noise floor of
the two summation orders may step either way (at most ~lr a step, three
steps, either sign); every other element agrees to ~1e-6 of lr. The CLI
runs on the CPU in a subprocess: a run resumed from ``--ckpt-dir``
gives the losses and the checkpoint bytes of an uninterrupted one, a
quiesce saves before it says so, and ``--data`` feeds the loader's
batches.
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_docker_api.models import llama as jl
from tpu_docker_api.parallel.mesh import single_device_mesh
from tpu_docker_api.train import optim as jopt
from tpu_docker_api.train import trainer as jtrainer
from tpu_docker_api_torch.models import llama as tl
from tpu_docker_api_torch.models import model_fns
from tpu_docker_api_torch.models.convert import (params_from_numpy,
                                                 params_to_numpy)
from tpu_docker_api_torch.ops import flash
from tpu_docker_api_torch.train import optim
from tpu_docker_api_torch.train import trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jl.llama_presets()["tiny"], dtype=jnp.float32)
    tcfg = dataclasses.replace(tl.llama_presets()["tiny"],
                               dtype=torch.float32)
    jparams = jl.llama_init(jcfg, jax.random.PRNGKey(0))
    host = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, tcfg, jparams, host


def _tokens(b, s, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (b, s)).astype(
        np.int32)


def _loss_and_grads(tcfg, host, tokens):
    params = params_from_numpy(host, "cpu")
    live = optim.tree_map(lambda p: p.requires_grad_(), params)
    loss = tl.llama_loss(live, torch.from_numpy(tokens).long(), tcfg)
    loss.backward()
    return loss.item(), optim.tree_map(lambda p: p.grad.numpy(), live)


def _close_trees(got, ref, tol):
    flat_ref = jax.tree_util.tree_leaves_with_path(ref)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
    for path, r in flat_ref:
        np.testing.assert_allclose(np.asarray(flat_got[path]), np.asarray(r),
                                   rtol=tol, atol=tol, err_msg=str(path))


@pytest.mark.parametrize("remat,impl,chunk", [
    (False, "auto", 0), (True, "auto", 0), (True, "flash", 0),
    (False, "auto", 16), (True, "flash", 48)])
def test_llama_loss_and_grads_match_jax(setup, remat, impl, chunk):
    jcfg, tcfg, jparams, host = setup
    jcfg = dataclasses.replace(jcfg, remat=remat, loss_chunk_rows=chunk)
    tcfg = dataclasses.replace(tcfg, remat=remat, loss_chunk_rows=chunk,
                               attention_impl=impl)
    tokens = _tokens(2, 33)
    ref_loss, ref_grads = jax.value_and_grad(jl.llama_loss)(
        jparams, jnp.asarray(tokens), jcfg)
    loss, grads = _loss_and_grads(tcfg, host, tokens)
    np.testing.assert_allclose(loss, float(ref_loss), rtol=TOL)
    _close_trees(grads, ref_grads, TOL)


@pytest.mark.parametrize("remat", [True, False])
def test_remat_keeps_flash_residuals(setup, monkeypatch, remat):
    """Under the remat policy the backward reuses the flash forward's
    (out, lse): the forward runs once per layer, not twice, as without
    remat."""
    _, tcfg, _, host = setup
    tcfg = dataclasses.replace(tcfg, remat=remat, attention_impl="flash")
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = flash.flash_attention_fwd_plain, flash.flash_attention_bwd_plain

    def count_fwd(*a, **k):
        calls["fwd"] += 1
        return fwd(*a, **k)

    def count_bwd(*a, **k):
        calls["bwd"] += 1
        return bwd(*a, **k)

    monkeypatch.setattr(flash, "flash_attention_fwd_plain", count_fwd)
    monkeypatch.setattr(flash, "flash_attention_bwd_plain", count_bwd)
    _loss_and_grads(tcfg, host, _tokens(1, 17))
    assert calls == {"fwd": tcfg.n_layers, "bwd": tcfg.n_layers}


def test_model_fns_returns_the_loss():
    from tpu_docker_api_torch.parallel.sharding import LLAMA_RULES

    init, loss, rules = model_fns(tl.llama_presets()["tiny"])
    assert (init is tl.llama_init and loss is tl.llama_loss
            and rules is LLAMA_RULES)


def test_presets_carry_remat_and_chunk_fields():
    jp, tp = jl.llama_presets(), tl.llama_presets()
    assert set(jp) == set(tp)
    for name in jp:
        assert tp[name].remat == jp[name].remat, name
        assert tp[name].loss_chunk_rows == jp[name].loss_chunk_rows, name


@pytest.mark.parametrize("optim_name", ["adamw", "adamw-int8"])
def test_three_train_steps_match_jax(setup, optim_name):
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
    for i in range(3):
        tokens = _tokens(2, 17, seed=10 + i)
        jstate, jm = jstep(jstate, tokens)
        tstate, tm = tstep(tstate, torch.from_numpy(tokens).long())
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                                   rtol=TOL)
        np.testing.assert_allclose(tm["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=TOL)
        assert tm["step"] == int(jm["step"]) == i + 1
    assert tstate.step == 3
    got = dict(jax.tree_util.tree_leaves_with_path(
        params_to_numpy(tstate.params)))
    for path, ref in jax.tree_util.tree_leaves_with_path(jstate.params):
        diff = np.abs(got[path] - np.asarray(ref))
        assert diff.max() <= 6 * 3e-4, path
        assert (diff > 2e-6).mean() <= 1e-3, path


def test_train_step_raises_on_a_parameter_without_gradient(setup):
    _, tcfg, _, host = setup
    params = params_from_numpy(host, "cpu")
    tx = trainer.default_optimizer()
    step = trainer.make_train_step(
        tcfg, tx, loss_fn=lambda p, t: tl.llama_loss(
            {**p, "final_norm": p["final_norm"].detach()}, t, tcfg))
    with pytest.raises(RuntimeError):
        step(trainer.TrainState(0, params, tx.init(params)),
             torch.from_numpy(_tokens(1, 9)).long())


def test_create_state_and_synthetic_batch():
    cfg = tl.llama_presets()["tiny"]
    gen = torch.Generator().manual_seed(0)
    state, tx = trainer.create_train_state(cfg, "cpu", gen,
                                           optim.adamw_int8())
    assert state.step == 0 and state.opt_state[1].count == 0
    batch = trainer.synthetic_batch(torch.Generator().manual_seed(1), 3, 16,
                                    cfg.vocab_size)
    assert batch.shape == (3, 17)
    assert 0 <= int(batch.min()) and int(batch.max()) < cfg.vocab_size


def _cli(*args, timeout=240):
    return subprocess.run(
        [sys.executable, "-m", "tpu_docker_api_torch.train", *args],
        cwd=ROOT, capture_output=True, text=True, timeout=timeout)


def test_cli_runs_on_cpu_and_prints_json_lines():
    proc = _cli("--device", "cpu", "--preset", "tiny", "--steps", "3",
                "--batch", "2", "--seq", "32", "--log-every", "2")
    assert proc.returncode == 0, proc.stderr
    lines = [json.loads(ln) for ln in proc.stdout.splitlines()]
    assert [ln.get("step") for ln in lines] == [2, 3, 3]
    for ln in lines[:2]:
        assert set(ln) == {"step", "loss", "tokens_per_sec"}
        assert np.isfinite(ln["loss"]) and ln["tokens_per_sec"] > 0
    assert lines[-1] == {"event": "done", "step": 3}


@pytest.mark.parametrize("flag", [["--tp", "2"], ["--fsdp", "2"],
                                  ["--ep", "2"],
                                  ["--dp", "2"], ["--pp", "2"]])
def test_cli_refuses_unported_flags(flag):
    """The mesh flags run on two gloo ranks (``--nproc-per-node 2``;
    rank 0 alone prints the JAX line contract, tests/
    test_torch_parallel*.py and test_torch_pipeline.py hold their
    numbers against JAX); ``--pp 2`` trains tiny's two layers through
    the 1F1B pipeline, a layer a stage."""
    proc = _cli("--device", "cpu", "--preset", "tiny", "--steps", "1",
                "--batch", "2", "--seq", "8", "--log-every", "1",
                "--nproc-per-node", "2", *flag, timeout=180)
    assert proc.returncode == 0, proc.stderr
    lines = [json.loads(ln) for ln in proc.stdout.splitlines()]
    assert set(lines[0]) == {"step", "loss", "tokens_per_sec"}
    assert np.isfinite(lines[0]["loss"])
    assert lines[-1] == {"event": "done", "step": 1}


@pytest.mark.parametrize("flags,msg", [
    (["--qlora"], "require --lora-rank > 0"),
    (["--qlora", "--lora-rank", "4", "--lora-forward", "merged"],
     "--qlora requires the attached forward"),
    (["--lora-alpha", "8"], "require --lora-rank > 0"),
    (["--moe-dispatch", "gather"],
     "--moe-dispatch applies to moe: presets only"),
    (["--preset", "vit:tiny", "--sp", "2"],
     "--sp does not apply to vit: presets: JAX's ViT has no "
     "sequence-parallel path"),
    (["--preset", "vit:tiny", "--pp", "2"],
     "--pp does not apply to vit: presets: the pipeline is Llama's"),
    (["--pp", "2", "--lora-rank", "4"], "--pp does not compose with LoRA"),
    (["--pp", "2", "--ep", "2"], "--pp does not compose with --ep")])
def test_cli_keeps_the_jax_lora_guards(flags, msg):
    """The JAX entry point's guards: a LoRA flag without a rank, --qlora
    over the merged forward, and --moe-dispatch on a Llama preset are
    refused before any work; so are the port's mesh refusals, each with
    its reason: --sp on vit (JAX's sp axis only replicates there), --pp
    on a family other than Llama, with LoRA and with --ep (JAX's
    pipeline is Llama's only and has none of these compositions)."""
    proc = _cli("--device", "cpu", *flags, timeout=60)
    assert proc.returncode == 2 and msg in proc.stderr
    if "--pp" in flags:
        assert "JAX's pipeline is Llama's only" in proc.stderr
        assert "Queue 1" not in proc.stderr


def test_cli_pp2_sp2_matches_jax_cli(tmp_path):
    """``--pp 2 --sp 2`` on four gloo ranks trains tiny through the 1F1B
    pipeline, each stage's attention the ring over its two sequence
    chunks; JAX's CLI with the same flags on 4 virtual devices runs the
    plain loss on that mesh, from the same init and batches
    (tests/test_torch_pipeline.py ``cli_against_jax``). The losses agree
    within 1e-3."""
    from test_torch_pipeline import CLI_TOL, cli_against_jax

    got, last, ref = cli_against_jax(tmp_path, "--pp", "2", "--sp", "2")
    assert len(got) == len(ref) == 3
    np.testing.assert_allclose(got, ref, rtol=CLI_TOL)
    assert last == {"event": "done", "step": 3}


def test_cli_refuses_unported_family():
    """An unknown family prefix is still refused, by name."""
    proc = _cli("--device", "cpu", "--preset", "resnet:tiny", timeout=60)
    assert proc.returncode != 0 and "unknown model family" in proc.stderr


def test_trainer_cli_trains_vit_and_resumes(tmp_path):
    """``--preset vit:tiny``: image batches, ``n_patches`` tokens an image
    in ``tokens_per_sec``, adamw-int8 checkpoints that resume."""
    args = ("--device", "cpu", "--preset", "vit:tiny", "--batch", "2",
            "--log-every", "1", "--optim", "adamw-int8", "--ckpt-dir",
            str(tmp_path), "--save-every", "2")
    proc = _cli(*args, "--steps", "2")
    assert proc.returncode == 0, proc.stderr
    lines = [json.loads(ln) for ln in proc.stdout.splitlines()]
    steps = [ln for ln in lines if "loss" in ln]
    assert [ln["step"] for ln in steps] == [1, 2]
    assert all(np.isfinite(ln["loss"]) for ln in steps)
    assert lines[-1] == {"event": "done", "step": 2}
    proc = _cli(*args, "--steps", "3")
    assert proc.returncode == 0, proc.stderr
    lines = [json.loads(ln) for ln in proc.stdout.splitlines()]
    assert lines[0]["event"] == "resumed" and lines[0]["step"] == 2
    assert [ln["step"] for ln in lines if "loss" in ln] == [3]


def test_cli_quiesces_on_sigterm():
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpu_docker_api_torch.train", "--device",
         "cpu", "--preset", "tiny", "--steps", "100000", "--batch", "1",
         "--seq", "16", "--log-every", "1"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        first = json.loads(proc.stdout.readline())
        assert first["step"] == 1
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    assert proc.returncode == 0, err
    last = json.loads(out.splitlines()[-1])
    assert last["event"] == "quiesced" and last["step"] >= 1


def test_synthetic_batch_is_a_pure_function_of_seed_and_step():
    """The CLI's synthetic batch at step i depends on (seed, i) alone,
    as the JAX trainer's ``synthetic_batch(PRNGKey(i))``: drawing other
    steps first, or none, gives the same tokens."""
    def at(seed, step):
        return trainer.synthetic_batch(
            trainer.step_generator(seed, step, "cpu"), 2, 8, 256)

    first = [at(1, i) for i in range(4)]
    assert torch.equal(at(1, 3), first[3])
    assert torch.equal(at(1, 0), first[0])
    assert not torch.equal(first[0], first[1])
    assert not torch.equal(at(2, 0), first[0])


def _steps(out):
    lines = [json.loads(ln) for ln in out.splitlines()]
    return [ln for ln in lines if "event" not in ln], lines


_SMALL = ("--device", "cpu", "--preset", "tiny", "--batch", "2", "--seq",
          "16", "--log-every", "1")


@pytest.mark.parametrize("optim_name", ["adamw", "adamw-int8"])
def test_cli_resumes_from_its_checkpoint(tmp_path, optim_name):
    """Two steps, then a second run on the same --ckpt-dir: it resumes at
    step 2, and its steps 3-4 give the losses of an uninterrupted run."""
    flags = (*_SMALL, "--optim", optim_name)
    whole = _cli(*flags, "--steps", "4", "--ckpt-dir", str(tmp_path / "a"))
    assert whole.returncode == 0, whole.stderr
    first = _cli(*flags, "--steps", "2", "--ckpt-dir", str(tmp_path / "b"))
    assert first.returncode == 0, first.stderr
    steps, lines = _steps(first.stdout)
    assert [ln["step"] for ln in steps] == [1, 2]
    saved = [ln for ln in lines if ln.get("event") == "saved"]
    assert [ln["step"] for ln in saved] == [2] and saved[0]["bytes"] > 0
    second = _cli(*flags, "--steps", "4", "--ckpt-dir", str(tmp_path / "b"))
    assert second.returncode == 0, second.stderr
    resumed, lines = _steps(second.stdout)
    assert [ln["step"] for ln in resumed] == [3, 4]
    assert lines[-1] == {"event": "done", "step": 4}
    want = _steps(whole.stdout)[0]
    assert [ln["loss"] for ln in resumed] == [ln["loss"] for ln in want[2:]]
    for name in ("params.safetensors", "opt_state.safetensors"):
        assert (tmp_path / "a" / "4" / name).read_bytes() == \
            (tmp_path / "b" / "4" / name).read_bytes(), name


def test_cli_quiesce_saves_and_a_restart_continues(tmp_path):
    ck = str(tmp_path / "ck")
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpu_docker_api_torch.train", *_SMALL,
         "--steps", "100000", "--ckpt-dir", ck, "--save-every", "1000"],
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
    last = lines[-1]
    assert last["event"] == "quiesced"
    n = last["step"]
    # the quiesce saved the step it stopped at, before it said so
    assert [ln["step"] for ln in lines if ln.get("event") == "saved"] == [n]
    assert sorted(os.listdir(ck)) == [str(n)]
    again = _cli(*_SMALL, "--steps", str(n + 2), "--ckpt-dir", ck)
    assert again.returncode == 0, again.stderr
    steps, lines = _steps(again.stdout)
    assert [ln["step"] for ln in steps] == [n + 1, n + 2]
    assert lines[-1] == {"event": "done", "step": n + 2}


def test_cli_trains_on_a_token_file(tmp_path):
    """--data feeds the loader's batches: the first logged loss is the
    loss of the seed's weights on the loader's batch for step 0."""
    from tpu_docker_api_torch.data import (make_batch_fn, open_token_files)
    from tpu_docker_api_torch.data.loader import write_token_file

    path = tmp_path / "tok.bin"
    write_token_file(np.random.default_rng(0).integers(0, 256, 5000), path)
    proc = _cli(*_SMALL, "--steps", "3", "--data", str(path),
                "--data-seed", "4")
    assert proc.returncode == 0, proc.stderr
    steps, lines = _steps(proc.stdout)
    assert [ln["step"] for ln in steps] == [1, 2, 3]
    assert lines[-1] == {"event": "done", "step": 3}
    cfg = dataclasses.replace(tl.llama_presets()["tiny"], max_seq_len=16)
    state, _ = trainer.create_train_state(
        cfg, "cpu", torch.Generator().manual_seed(0))
    batch = make_batch_fn(open_token_files(path, 17), 2, seed=4)(0)
    with torch.no_grad():
        loss = tl.llama_loss(state.params, torch.from_numpy(batch).long(),
                             cfg).item()
    assert steps[0]["loss"] == round(loss, 4)
