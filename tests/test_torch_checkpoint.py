"""The port's training checkpoints (train/checkpoint.py).

- Against itself: 2 steps, a save, a restore into a fresh optimizer
  object, 2 more steps equal 4 uninterrupted steps bit for bit, under
  ``adamw`` and ``adamw-int8`` (the tiny preset, bf16).
- Against the JAX package: the JAX state after 2 steps goes through
  orbax save and restore and 1 more step; the same state carried across
  (models/convert.py ``opt_state_from_numpy``) goes through the port's
  save and restore and 1 step. Held at the tolerances of
  tests/test_torch_train.py: loss and grad norm at 1e-4 relative, every
  param within 6·lr and at least 99.9% of each leaf within 2e-6 (tiny
  preset in f32).
- Guarantees: params-only restores read no optimizer file; retention and
  the interval gate; a second save of a step is a no-op; a temporary or
  incomplete directory is never the latest step; a writer error is
  raised at ``wait``.
- On the card (``gpu``): a checkpoint crosses between cuda and the CPU;
  an asynchronous save overlapped with the next steps keeps the saved
  step's values.
"""

import dataclasses
import os

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
from tpu_docker_api_torch.models.convert import (opt_state_from_numpy,
                                                 params_from_numpy,
                                                 params_to_numpy)
from tpu_docker_api_torch.train import checkpoint as ckpt
from tpu_docker_api_torch.train import optim, trainer

TOL = 1e-4


def _optimizer(name):
    return optim.adamw_int8() if name == "adamw-int8" else \
        trainer.default_optimizer()


def _batch(step, device="cpu"):
    return trainer.synthetic_batch(trainer.step_generator(5, step, device),
                                   2, 16, 256)


def _train(state, step_fn, start, stop, device="cpu"):
    for i in range(start, stop):
        state, _ = step_fn(state, _batch(i, device))
    return state


def _leaves(tree):
    out = {}
    ckpt._flatten(tree, "", out, out)
    return out


def _assert_states_equal(a, b):
    assert a.step == b.step
    la, lb = _leaves(a.params), _leaves(b.params)
    oa, ob = _leaves(a.opt_state), _leaves(b.opt_state)
    # the same leaves in the same order: the optimizer and the global
    # norm walk the tree in its order
    assert list(la) == list(lb) and list(oa) == list(ob)
    for name in la:
        assert torch.equal(la[name].cpu(), lb[name].cpu()), name
    for name in oa:
        x, y = oa[name], ob[name]
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu()), name
        else:
            assert x == y, name


@pytest.fixture(scope="module")
def cfg():
    return tl.llama_presets()["tiny"]


@pytest.mark.parametrize("optim_name", ["adamw", "adamw-int8"])
def test_resume_equals_uninterrupted_bit_for_bit(tmp_path, cfg, optim_name):
    state, tx = trainer.create_train_state(
        cfg, "cpu", torch.Generator().manual_seed(0), _optimizer(optim_name))
    step_fn = trainer.make_train_step(cfg, tx)
    whole = _train(state, step_fn, 0, 4)

    first, tx1, mgr = ckpt.resume_or_init(
        tmp_path, cfg, "cpu", torch.Generator().manual_seed(0),
        _optimizer(optim_name))
    assert first.step == 0
    first = _train(first, trainer.make_train_step(cfg, tx1), 0, 2)
    assert mgr.save(first)
    mgr.close()

    # a restarted process: new optimizer object, new manager
    resumed, tx2, mgr = ckpt.resume_or_init(
        tmp_path, cfg, "cpu", torch.Generator().manual_seed(99),
        _optimizer(optim_name))
    with mgr:
        assert resumed.step == 2 and mgr.latest_step() == 2
        _assert_states_equal(resumed, first)
        resumed = _train(resumed, trainer.make_train_step(cfg, tx2), 2, 4)
    _assert_states_equal(resumed, whole)


@pytest.mark.parametrize("optim_name", ["adamw", "adamw-int8"])
def test_resume_matches_jax_resume(tmp_path, optim_name):
    # imported here: orbax is a dependency of this test alone, and the
    # module must collect for its card-only tests on GPU hosts without it
    from tpu_docker_api.train import checkpoint as jckpt

    jcfg = dataclasses.replace(jl.llama_presets()["tiny"], dtype=jnp.float32)
    tcfg = dataclasses.replace(tl.llama_presets()["tiny"],
                               dtype=torch.float32)
    mesh = single_device_mesh()
    jtx = (jopt.adamw_int8(impl="xla") if optim_name == "adamw-int8"
           else jtrainer.default_optimizer())
    jstate, jtx = jtrainer.create_train_state(jcfg, mesh,
                                              jax.random.PRNGKey(0), jtx)
    jstep = jtrainer.make_train_step(jcfg, mesh, jtx)
    tokens = [np.random.default_rng(20 + i).integers(0, 256, (2, 17))
              .astype(np.int32) for i in range(3)]
    for i in range(2):
        jstate, _ = jstep(jstate, tokens[i])

    # the port's side starts from the same state, carried across
    host = jax.tree_util.tree_map(np.asarray, jstate)
    tstate = trainer.TrainState(
        int(host.step), params_from_numpy(host.params, "cpu"),
        opt_state_from_numpy(host.opt_state, "cpu"))

    with jckpt.CheckpointManager(tmp_path / "jax") as jmgr:
        assert jmgr.save(jstate)
        jmgr.wait()
        jstate = jmgr.restore(jcfg, mesh, jtx)
    ttx = _optimizer(optim_name)
    with ckpt.CheckpointManager(tmp_path / "port") as mgr:
        assert mgr.save(tstate)
        mgr.wait()
        tstate = mgr.restore(tcfg, ttx, device="cpu")
    assert tstate.step == int(jstate.step) == 2

    jstate, jm = jstep(jstate, tokens[2])
    tstate, tm = trainer.make_train_step(tcfg, ttx)(
        tstate, torch.from_numpy(tokens[2]).long())
    np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                               rtol=TOL)
    np.testing.assert_allclose(tm["grad_norm"].item(),
                               float(jm["grad_norm"]), rtol=TOL)
    assert tstate.step == int(jstate.step) == 3
    got = dict(jax.tree_util.tree_leaves_with_path(
        params_to_numpy(tstate.params)))
    for path, ref in jax.tree_util.tree_leaves_with_path(jstate.params):
        diff = np.abs(got[path] - np.asarray(ref))
        assert diff.max() <= 6 * 3e-4, path
        assert (diff > 2e-6).mean() <= 1e-3, path


def _state(cfg, optim_name="adamw-int8", steps=1):
    state, tx = trainer.create_train_state(
        cfg, "cpu", torch.Generator().manual_seed(0), _optimizer(optim_name))
    return _train(state, trainer.make_train_step(cfg, tx), 0, steps), tx


def test_restore_params_reads_no_optimizer_file(tmp_path, cfg):
    state, _ = _state(cfg)
    with ckpt.CheckpointManager(tmp_path) as mgr:
        mgr.save(state)
    os.remove(tmp_path / "1" / ckpt.OPT_FILE)
    mgr = ckpt.CheckpointManager(tmp_path)
    params = mgr.restore_params(device="cpu")
    for name, leaf in _leaves(state.params).items():
        assert torch.equal(_leaves(params)[name], leaf), name
    got, step = ckpt.restore_model_params(tmp_path, cfg, "cpu")
    assert step == 1 and torch.equal(got["lm_head"], state.params["lm_head"])


def test_restore_refuses_another_config_or_optimizer(tmp_path, cfg):
    state, _ = _state(cfg, "adamw-int8")
    with ckpt.CheckpointManager(tmp_path) as mgr:
        mgr.save(state)
        wide = dataclasses.replace(cfg, ffn_dim=cfg.ffn_dim * 2)
        with pytest.raises(ValueError, match="layers/mlp/w_.*config wants"):
            mgr.restore(wide, _optimizer("adamw-int8"), device="cpu")
        with pytest.raises(ValueError, match="another optimizer"):
            mgr.restore(cfg, _optimizer("adamw"), device="cpu")
    with pytest.raises(FileNotFoundError):
        ckpt.restore_model_params(tmp_path / "missing", cfg, "cpu")
    with pytest.raises(FileNotFoundError):
        ckpt.CheckpointManager(tmp_path / "empty").restore_params(
            device="cpu")


def test_retention_and_the_interval_gate(tmp_path, cfg):
    state, _ = _state(cfg, "adamw", steps=0)
    os.makedirs(tmp_path / "1")  # incomplete: no meta.json
    with ckpt.CheckpointManager(tmp_path, max_to_keep=2,
                                save_interval_steps=3) as mgr:
        saved = [s for s in range(2, 10)
                 if mgr.save(dataclasses.replace(state, step=s))]
        mgr.wait()
        # the first save passes the gate, then multiples of 3
        assert saved == [2, 3, 6, 9]
        assert mgr.all_steps() == [6, 9]
        assert [r["step"] for r in mgr.history] == [2, 3, 6, 9]
        assert all(r["bytes"] > 0 for r in mgr.history)
    assert os.path.isdir(tmp_path / "1")  # retention keeps off it
    assert sorted(os.listdir(tmp_path)) == ["1", "6", "9"]


def test_second_save_of_a_step_is_a_noop(tmp_path, cfg):
    state, _ = _state(cfg)
    with ckpt.CheckpointManager(tmp_path) as mgr:
        assert mgr.save(state)
        assert not mgr.save(state)  # pending
        mgr.wait()
        assert not mgr.save(state)  # on disk
        assert not mgr.save(state, step=0)  # behind the latest
        assert mgr.all_steps() == [1] and len(mgr.history) == 1


def test_temporary_or_incomplete_dirs_are_never_latest(tmp_path, cfg):
    state, _ = _state(cfg)
    with ckpt.CheckpointManager(tmp_path) as mgr:
        mgr.save(state)
    tmp = tmp_path / ".tmp-7-123"
    os.makedirs(tmp)
    (tmp / ckpt.META_FILE).write_text('{"step": 7, "ints": {}}')
    os.makedirs(tmp_path / "9")  # a step directory without meta.json
    (tmp_path / "9" / ckpt.PARAMS_FILE).write_bytes(b"partial")
    mgr = ckpt.CheckpointManager(tmp_path)
    assert mgr.latest_step() == 1 and mgr.all_steps() == [1]
    assert mgr.restore(cfg, _optimizer("adamw-int8"), device="cpu").step == 1
    assert tmp.exists()  # reading leaves a live writer's files alone
    with mgr:
        assert mgr.save(dataclasses.replace(state, step=2))
    assert not tmp.exists()  # a writing manager clears a dead writer's
    assert mgr.all_steps() == [1, 2]


def test_writer_error_is_raised_at_wait(tmp_path, cfg, monkeypatch):
    state, _ = _state(cfg)

    def fail(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt, "save_file", fail)
    mgr = ckpt.CheckpointManager(tmp_path)
    assert mgr.save(state)
    with pytest.raises(RuntimeError, match="disk full"):
        mgr.wait()
    mgr.wait()  # raised once, not again
    assert mgr.all_steps() == [] and os.listdir(tmp_path) == []
    monkeypatch.undo()
    assert mgr.save(state)  # the manager goes on after the error
    mgr.close()
    assert mgr.all_steps() == [1]


def test_writer_error_is_raised_at_the_next_save(tmp_path, cfg, monkeypatch):
    state, _ = _state(cfg)
    monkeypatch.setattr(ckpt, "save_file",
                        lambda *a, **k: (_ for _ in ()).throw(OSError("eio")))
    mgr = ckpt.CheckpointManager(tmp_path)
    mgr.save(state)
    mgr._job.done.wait(timeout=60)
    with pytest.raises(RuntimeError, match="eio"):
        mgr.save(dataclasses.replace(state, step=2))
    mgr.close()


def test_save_gate_sees_a_job_that_finishes_while_it_looks(tmp_path):
    """A save of the step an in-flight job is writing is declined even
    when the job finishes between the gate's two reads (its state and
    the directory listing): the gate reads the job first, so a job it
    saw in flight counts, and one it saw done is on disk."""
    import threading
    import types

    mgr = ckpt.CheckpointManager(tmp_path)
    job = types.SimpleNamespace(step=4, done=threading.Event())
    mgr._job = job

    def listing_then_the_writer_finishes():
        job.done.set()
        return 2  # listed before the job's rename

    mgr.latest_step = listing_then_the_writer_finishes
    assert mgr._should_save(4) is False
    assert mgr._should_save(5) is True


# ------------------------------------------------------------- card only


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_checkpoint_crosses_between_card_and_cpu(tmp_path, cuda, cfg):
    state, tx = trainer.create_train_state(
        cfg, cuda, torch.Generator(device=cuda).manual_seed(0),
        optim.adamw_int8())
    state = _train(state, trainer.make_train_step(cfg, tx), 0, 2, cuda)
    with ckpt.CheckpointManager(tmp_path / "card") as mgr:
        mgr.save(state)
    on_cpu = ckpt.CheckpointManager(tmp_path / "card").restore(
        cfg, optim.adamw_int8(), device="cpu")
    _assert_states_equal(on_cpu, state)
    with ckpt.CheckpointManager(tmp_path / "host") as mgr:
        mgr.save(on_cpu)
    back = ckpt.CheckpointManager(tmp_path / "host").restore(
        cfg, optim.adamw_int8(), device=cuda)
    assert back.params["lm_head"].is_cuda
    _assert_states_equal(back, state)


@pytest.mark.gpu
def test_async_save_overlapping_the_next_steps_keeps_its_values(
        tmp_path, cuda):
    cfg = dataclasses.replace(tl.llama_presets()["tiny"], dim=256,
                              ffn_dim=1024, n_heads=4, n_kv_heads=2,
                              vocab_size=4096)
    state, tx = trainer.create_train_state(
        cfg, cuda, torch.Generator(device=cuda).manual_seed(0),
        optim.adamw_int8())
    step_fn = trainer.make_train_step(cfg, tx)
    state = _train(state, step_fn, 0, 1, cuda)
    mgr = ckpt.CheckpointManager(tmp_path)
    assert mgr.save(state)  # enqueued right after the step's kernels
    # the reference, read on the step's own stream after the save began
    want = {k: v.cpu() for k, v in _leaves(state.params).items()}
    saved_step = state.step
    for i in range(1, 6):  # the old state's memory is free to be reused
        state, _ = step_fn(state, _batch(i, cuda))
    mgr.close()
    got = ckpt.CheckpointManager(tmp_path).restore_params(saved_step, "cpu")
    for name, ref in want.items():
        assert torch.equal(_leaves(got)[name], ref), name
    assert mgr.history[0]["blocked_s"] < mgr.history[0]["write_s"]
