"""Rank-side cases of the port's multi-rank tests (test_torch_parallel*.py).

The test files compute the JAX references in the pytest process (8
virtual CPU devices, tests/conftest.py) and run the port here, in gloo
ranks started by :func:`run_ranks`. This module imports torch and the
port only, never JAX, so a rank starts in a second or two. Every case
takes a dict of numpy inputs and returns a dict of numpy results; rank
0's results come back to the test.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import sys
import traceback

import numpy as np


class Ranks:
    """``world`` gloo ranks running ``cases`` ([(case name, kwargs dict),
    ...]) in order, one spawn for all of them. The test computes its JAX
    references while they run; :meth:`join` returns rank 0's results."""

    def __init__(self, world: int, cases: list, tmp_path,
                 timeout: float = 240.0):
        import torch.multiprocessing as mp

        self.world, self.tmp, self.timeout = world, str(tmp_path), timeout
        with open(os.path.join(self.tmp, "cases.pkl"), "wb") as f:
            pickle.dump(cases, f)
        ctx = mp.get_context("spawn")
        self.procs = [ctx.Process(target=_entry, args=(r, world, self.tmp))
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def join(self) -> list:
        for p in self.procs:
            p.join(self.timeout)
        for p in self.procs:
            if p.is_alive():
                p.kill()
        for r in range(self.world):
            err = os.path.join(self.tmp, f"err{r}.txt")
            if os.path.exists(err):
                raise RuntimeError(open(err).read())
        codes = [p.exitcode for p in self.procs]
        if any(c != 0 for c in codes):
            raise RuntimeError(f"rank exit codes {codes}")
        with open(os.path.join(self.tmp, "out0.pkl"), "rb") as f:
            return pickle.load(f)


def run_ranks(world: int, cases: list, tmp_path) -> list:
    """Rank 0's results of ``cases`` in ``world`` gloo ranks."""
    return Ranks(world, cases, tmp_path).join()


def _entry(rank: int, world: int, tmp: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{os.path.join(tmp, 'rdv')}",
            rank=rank, world_size=world)
        with open(os.path.join(tmp, "cases.pkl"), "rb") as f:
            cases = pickle.load(f)
        out = [globals()[name](**kw) for name, kw in cases]
        if rank == 0:
            with open(os.path.join(tmp, "out0.pkl"), "wb") as f:
                pickle.dump(out, f)
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(tmp, f"err{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        sys.exit(1)


# ------------------------------------------------------------ helpers


def _mesh(**plan):
    from tpu_docker_api_torch.parallel.mesh import MeshPlan, build_mesh

    return build_mesh(MeshPlan(**plan), "cpu")


def _cfg(preset: str, **over):
    import torch

    from tpu_docker_api_torch.models import resolve_preset

    _, cfg = resolve_preset(preset)
    return dataclasses.replace(cfg, dtype=torch.float32, **over)


def _full(tree):
    from tpu_docker_api_torch.parallel.sharding import full_tensor

    if isinstance(tree, dict):
        return {k: _full(v) for k, v in tree.items()}
    return full_tensor(tree).detach().numpy()


def _seq_chunk(x, mesh, axis="sp"):
    n = mesh.shape[axis]
    size = x.shape[1] // n
    i = mesh.coords[axis]
    return x[:, i * size:(i + 1) * size]


# -------------------------------------------------------------- cases


def mesh_layout(plan: dict, preset: str = "tiny"):
    """The DTensor placements and local shapes of a sharded init."""
    import torch

    from tpu_docker_api_torch.train.trainer import create_train_state

    mesh = _mesh(**plan)
    st, _ = create_train_state(_cfg(preset), "cpu",
                               torch.Generator().manual_seed(0), mesh=mesh)
    wq = st.params["layers"]["attn"]["wq"]
    ref, _ = create_train_state(_cfg(preset), "cpu",
                                torch.Generator().manual_seed(0))
    same = all(np.array_equal(a, b) for a, b in zip(
        _leaves(_full(st.params)), _leaves(_full(ref.params))))
    from tpu_docker_api_torch.parallel.sharding import P, constrain

    whole = constrain(wq, mesh, P())
    return {"local_shape": tuple(wq.to_local().shape),
            "placements": [str(p) for p in wq.placements],
            "bit_equal_init": same,
            "constrained_whole": bool(torch.equal(
                whole.to_local(), ref.params["layers"]["attn"]["wq"]))}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def train_losses(plan: dict, host: dict, batches: list, preset: str = "tiny",
                 over: dict | None = None, optim: str = "adamw"):
    """Losses of ``len(batches)`` mesh-path train steps from ``host``
    (numpy params of the JAX tree), and the final params."""
    import torch

    from tpu_docker_api_torch.models import model_fns
    from tpu_docker_api_torch.models.convert import params_from_numpy
    from tpu_docker_api_torch.parallel.sharding import distribute_params
    from tpu_docker_api_torch.train import optim as topt
    from tpu_docker_api_torch.train.trainer import (TrainState,
                                                    make_train_step)

    cfg = _cfg(preset, **(over or {}))
    mesh = _mesh(**plan)
    params = distribute_params(params_from_numpy(host, "cpu"), mesh,
                               model_fns(cfg)[2])
    opt = topt.adamw_int8() if optim == "adamw-int8" else None
    from tpu_docker_api_torch.train.trainer import default_optimizer

    opt = opt or default_optimizer()
    state = TrainState(0, params, opt.init(params))
    step = make_train_step(cfg, opt, mesh=mesh)
    losses = []
    for b in batches:
        state, m = step(state, _batch(b))
        losses.append(float(m["loss"]))
    return {"losses": losses, "params": _full(state.params)}


def _batch(b):
    """A numpy batch (an array, or a tuple of them: ViT's images and
    labels, the encoder-decoder's pairs) as tensors: integers as int64."""
    import torch

    if isinstance(b, (tuple, list)):
        return tuple(_batch(x) for x in b)
    t = torch.from_numpy(np.ascontiguousarray(b))
    return t.long() if not t.is_floating_point() else t


def attention(plan: dict, q, k, v, cot, impl: str, causal: bool = True):
    """Ring or Ulysses attention on this rank's seq chunk (and heads
    over tp): the whole output and the gradients of sum(out * cot)."""
    import torch

    from tpu_docker_api_torch.parallel import comm
    from tpu_docker_api_torch.parallel.ring import ring_attention
    from tpu_docker_api_torch.parallel.ulysses import ulysses_attention

    mesh = _mesh(**plan)
    tp = mesh.shape["tp"]

    def mine(x):
        x = _seq_chunk(x, mesh)
        h = x.shape[2] // tp
        t = mesh.coords["tp"]
        return torch.from_numpy(np.ascontiguousarray(
            x[:, :, t * h:(t + 1) * h])).requires_grad_()

    ql, kl, vl = mine(q), mine(k), mine(v)
    counts = None
    if impl == "ulysses":
        out = ulysses_attention(ql, kl, vl, mesh, causal=causal,
                                impl="dense")
    else:
        out, counts = ring_attention(
            ql, kl, vl, mesh, causal=causal, with_block_counts=True,
            placement="zigzag" if impl == "ring-zigzag" else "contiguous")
    (out * mine(cot).detach()).sum().backward()

    def whole(x):
        x = comm.gather_nograd(x, 2, mesh.group("tp"))
        return comm.gather_nograd(x, 1, mesh.group("sp")).numpy()

    res = {"out": whole(out.detach()), "dq": whole(ql.grad),
           "dk": whole(kl.grad), "dv": whole(vl.grad)}
    if counts is not None:
        res["counts"] = counts.numpy()
    return res


def loss_value(plan: dict, host: dict, tokens, preset: str = "tiny",
               over: dict | None = None):
    """The family's mesh loss (summed over the ranks) on ``tokens`` (an
    array, or a tuple of them: the encoder-decoder's pairs)."""
    import torch
    import torch.distributed as dist

    from tpu_docker_api_torch.models import model_fns
    from tpu_docker_api_torch.models.convert import params_from_numpy
    from tpu_docker_api_torch.parallel.sharding import (distribute_params,
                                                        local, split_batch)

    cfg = _cfg(preset, **(over or {}))
    mesh = _mesh(**plan)
    _, loss_fn, rules = model_fns(cfg)
    params = distribute_params(params_from_numpy(host, "cpu"), mesh, rules)
    def walk(t):
        return ({k: walk(v) for k, v in t.items()} if isinstance(t, dict)
                else local(t))

    loc = walk(params)
    rows = _batch(tokens)
    rows = (tuple(split_batch(x, mesh) for x in rows)
            if isinstance(rows, tuple) else split_batch(rows, mesh))
    share = loss_fn(loc, rows, cfg, mesh=mesh).detach()
    for a in ("dp", "fsdp", "sp"):
        if mesh.group(a) is not None:
            dist.all_reduce(share, group=mesh.group(a))
    return {"loss": float(share)}


def flash_route(plan: dict, host: dict, tokens, preset: str = "tiny"):
    """One mesh forward of the loss with ``attention_impl="flash"``: the
    sequence length each call of ``ops.flash.flash_attention`` saw, and
    the calls of ``dense_attention``."""
    from tpu_docker_api_torch.ops import attention, flash

    seqs, dense = [], []
    real_flash, real_dense = flash.flash_attention, attention.dense_attention

    def flash_rec(q, *a, **kw):
        seqs.append(q.shape[2])                  # (b, h, s, d)
        return real_flash(q, *a, **kw)

    def dense_rec(*a, **kw):
        dense.append(1)
        return real_dense(*a, **kw)

    flash.flash_attention, attention.dense_attention = flash_rec, dense_rec
    try:
        loss_value(plan, host, tokens, preset,
                   over={"attention_impl": "flash"})
    finally:
        flash.flash_attention = real_flash
        attention.dense_attention = real_dense
    return {"seqs": seqs, "dense_calls": len(dense)}


def tp_weight_share(plan: dict, preset: str, batch):
    """The weight elements the family's ``linear`` products read in one
    loss on this rank of the mesh, over the same on one device."""
    import importlib

    import torch

    from tpu_docker_api_torch.models import model_fns
    from tpu_docker_api_torch.parallel.sharding import (distribute_params,
                                                        local)

    cfg = _cfg(preset)
    init, loss_fn, rules = model_fns(cfg)
    mod = importlib.import_module(loss_fn.__module__)
    read = []
    real = mod.linear

    def rec(x, w, *a, **kw):
        read.append(w.numel())
        return real(x, w, *a, **kw)

    whole = init(cfg, torch.Generator().manual_seed(0))
    mesh = _mesh(**plan)

    def walk(t):
        return ({k: walk(v) for k, v in t.items()} if isinstance(t, dict)
                else local(t))

    mine = walk(distribute_params(whole, mesh, rules))
    rows = _batch(batch)                 # a tp-only mesh: every row
    mod.linear = rec
    try:
        with torch.no_grad():
            loss_fn(mine, rows, cfg, mesh=mesh)
            on_mesh = sum(read)
            read.clear()
            loss_fn(whole, rows, cfg)
    finally:
        mod.linear = real
    return {"share": on_mesh / sum(read)}


def moe_dispatch_error(plan: dict):
    """The error the gather dispatch raises on a multi-rank mesh."""
    import torch

    from tpu_docker_api_torch.train.trainer import (create_train_state,
                                                    make_train_step)

    cfg = _cfg("moe:moe-tiny", dispatch_impl="gather")
    mesh = _mesh(**plan)
    st, opt = create_train_state(cfg, "cpu", torch.Generator().manual_seed(0),
                                 mesh=mesh)
    try:
        make_train_step(cfg, opt, mesh=mesh)(
            st, torch.zeros((2, 9), dtype=torch.long))
    except ValueError as e:
        return {"error": str(e)}
    return {"error": None}


def lora_losses(plan: dict, base: dict, adapters: dict, batches: list,
                forward: str, alpha: float = 16.0):
    """Losses of mesh-path LoRA steps from numpy base and adapters."""
    import torch

    from tpu_docker_api_torch.models import model_fns
    from tpu_docker_api_torch.models.convert import params_from_numpy
    from tpu_docker_api_torch.parallel.sharding import distribute_params
    from tpu_docker_api_torch.train import lora
    from tpu_docker_api_torch.train.trainer import (TrainState,
                                                    default_optimizer)

    cfg = _cfg("tiny")
    mesh = _mesh(**plan)
    rules = model_fns(cfg)[2]
    bparams = distribute_params(params_from_numpy(base, "cpu"), mesh, rules)
    ad = lora._distribute_adapters(params_from_numpy(adapters, "cpu"), mesh,
                                   rules)
    opt = default_optimizer()
    state = TrainState(0, ad, opt.init(ad))
    step = lora.make_lora_train_step(cfg, opt, bparams, alpha=alpha,
                                     forward=forward, mesh=mesh)
    losses = []
    for b in batches:
        state, m = step(state, torch.from_numpy(b).long())
        losses.append(float(m["loss"]))
    return {"losses": losses, "adapters": _full(state.params)}


def ckpt_write(plan: dict, directory: str, batches: list, save_at: int):
    """Train on a mesh with adamw-int8, save after ``save_at`` steps, go
    on: the saved state (whole) and the losses after it."""
    import torch

    from tpu_docker_api_torch.train.checkpoint import CheckpointManager
    from tpu_docker_api_torch.train.optim import adamw_int8
    from tpu_docker_api_torch.train.trainer import (create_train_state,
                                                    make_train_step)

    cfg = _cfg("tiny")
    mesh = _mesh(**plan)
    st, opt = create_train_state(cfg, "cpu", torch.Generator().manual_seed(5),
                                 optimizer=adamw_int8(), mesh=mesh)
    step = make_train_step(cfg, opt, mesh=mesh)
    mgr = CheckpointManager(directory)
    saved, losses = None, []
    for i, b in enumerate(batches):
        st, m = step(st, torch.from_numpy(b).long())
        if i + 1 == save_at:
            mgr.save(st)
            mgr.wait()
            saved = {"params": _full(st.params),
                     "opt": _opt_full(st.opt_state)}
        elif i + 1 > save_at:
            losses.append(float(m["loss"]))
    mgr.close()
    return {"saved": saved, "losses": losses}


def _opt_full(state):
    """Every tensor of an optimizer state, whole, by path; an int8
    moment's scales in the (rows, blocks) layout of one device."""
    from tpu_docker_api_torch.train.checkpoint import _file_shape, _flatten

    tensors: dict = {}
    _flatten(state, "", tensors, {})
    out = {}
    for k, t in tensors.items():
        from tpu_docker_api_torch.parallel.sharding import full_tensor

        out[k] = full_tensor(t).reshape(_file_shape(k, t)).numpy()
    return out


def ckpt_resume(plan: dict, directory: str, batches: list):
    """Resume on a mesh from ``directory``: the restored state (whole)
    and the losses of ``batches`` after it."""
    import torch

    from tpu_docker_api_torch.train.checkpoint import resume_or_init
    from tpu_docker_api_torch.train.optim import adamw_int8
    from tpu_docker_api_torch.train.trainer import make_train_step

    cfg = _cfg("tiny")
    mesh = _mesh(**plan)
    st, opt, mgr = resume_or_init(directory, cfg, "cpu",
                                  torch.Generator().manual_seed(9),
                                  optimizer=adamw_int8(), mesh=mesh)
    restored = {"step": st.step, "params": _full(st.params),
                "opt": _opt_full(st.opt_state)}
    step = make_train_step(cfg, opt, mesh=mesh)
    losses = []
    for b in batches:
        st, m = step(st, torch.from_numpy(b).long())
        losses.append(float(m["loss"]))
    mgr.close()
    return {"restored": restored, "losses": losses}


def slot_stream(plan: dict, host: dict, prompts: list, max_new: int,
                page_size: int = 0, prefix: list | None = None):
    """Greedy streams of a tp/fsdp mesh's slot engine: rank 0 submits
    and steps it, the other ranks follow (infer/mirror.py). With
    ``prefix``, it is registered first and every prompt extends it."""
    import torch.distributed as dist

    from tpu_docker_api_torch.infer.mirror import Mirror
    from tpu_docker_api_torch.infer.paged import PagedSlotEngine
    from tpu_docker_api_torch.infer.slots import SlotEngine
    from tpu_docker_api_torch.models import model_fns
    from tpu_docker_api_torch.models.convert import params_from_numpy
    from tpu_docker_api_torch.parallel.sharding import (distribute_params,
                                                        local)

    cfg = _cfg("tiny")
    mesh = _mesh(**plan)
    params = distribute_params(params_from_numpy(host, "cpu"), mesh,
                               model_fns(cfg)[2])

    def walk(t):
        return ({k: walk(v) for k, v in t.items()} if isinstance(t, dict)
                else local(t))

    mirror = Mirror()
    kw = dict(slots=3, max_seq=64, chunk=4, cache_dtype=cfg.dtype,
              mesh=mesh, mirror=mirror)
    eng = (PagedSlotEngine(cfg, walk(params), page_size=page_size,
                           total_pages=12, **kw) if page_size
           else SlotEngine(cfg, walk(params), **kw))
    if dist.get_rank() != 0:
        eng.follow()
        return {}
    eng.start()
    try:
        if prefix:
            eng.register_prefix(prefix)
        handles = [eng.submit(p, max_new) for p in prompts]
        tokens = [h.result(120)["tokens"] for h in handles]
        return {"tokens": tokens, "stats": dict(eng.stats)}
    finally:
        eng.close()


# ------------------------------------------------------ pipeline (pp)


def _pcfg(over: dict | None = None):
    """The tiny llama with ``over`` (``dtype`` by name, f32 default)."""
    import torch

    from tpu_docker_api_torch.models import resolve_preset

    over = dict(over or {})
    dtype = getattr(torch, over.pop("dtype", "float32"))
    _, cfg = resolve_preset("tiny")
    return dataclasses.replace(cfg, dtype=dtype, **over)


def _np32(t):
    from tpu_docker_api_torch.parallel.sharding import full_tensor

    return full_tensor(t).detach().float().numpy()


def _global_loss(share, mesh) -> float:
    """The train step's reading of a loss share: summed over the batch
    and sequence axes, the last pp stage's broadcast over pp."""
    import torch.distributed as dist

    share = share.detach().float().clone()
    for a in ("dp", "fsdp", "sp"):
        if mesh.group(a) is not None:
            dist.all_reduce(share, group=mesh.group(a))
    grp = mesh.group("pp")
    if grp is not None:
        dist.broadcast(share, src=dist.get_global_rank(
            grp, mesh.shape["pp"] - 1), group=grp)
    return float(share)


def _pipe_setup(plan: dict, host: dict, over):
    from tpu_docker_api_torch.models.convert import params_from_numpy
    from tpu_docker_api_torch.parallel import pipeline as pl
    from tpu_docker_api_torch.parallel import sharding as sh

    cfg, mesh = _pcfg(over), _mesh(**plan)
    rules = pl.pipeline_rules(sh.LLAMA_RULES)
    params = sh.distribute_params(params_from_numpy(host, "cpu"), mesh,
                                  rules)
    return cfg, mesh, rules, params


def pipe_grads(plan: dict, host: dict, tokens, n_micro: int, schedule: str,
               over: dict | None = None):
    """One call of ``pipeline_1f1b_grads`` ("1f1b") or autograd of
    ``pipeline_loss`` ("gpipe") under ``pipeline_rules``: the global
    loss and the whole gradients, reduced as the train step reduces
    them (f32); with "gpipe" also ``pipeline_forward``'s logits (this
    rank's rows: the mesh has no dp) from the last stage, gathered over
    sp, and whether rank 0 (stage 0) got any."""
    import torch
    import torch.distributed as dist

    from tpu_docker_api_torch.parallel import comm
    from tpu_docker_api_torch.parallel import pipeline as pl
    from tpu_docker_api_torch.parallel import sharding as sh
    from tpu_docker_api_torch.train.optim import tree_leaves, tree_map
    from tpu_docker_api_torch.train.trainer import mesh_specs

    cfg, mesh, rules, params = _pipe_setup(plan, host, over)
    rows = sh.split_batch(torch.from_numpy(tokens).long(), mesh)
    if schedule == "1f1b":
        loss, grads = pl.pipeline_1f1b_grads(tree_map(sh.local, params),
                                             rows, cfg, mesh, n_micro)
    else:
        live = tree_map(lambda p: sh.local(p).detach().requires_grad_(),
                        params)
        loss = pl.pipeline_loss(live, rows, cfg, mesh, n_micro)
        flat = iter(torch.autograd.grad(loss, tree_leaves(live)))
        grads = tree_map(lambda _: next(flat), live)
    whole = tree_map(lambda g, p, r: _np32(sh.to_dtensor(
        sh.reduce_grad(g.contiguous(), r[1], mesh), r[0], mesh, p.shape)),
        grads, params, mesh_specs(params, rules))
    out = {"loss": _global_loss(loss, mesh), "grads": whole}
    if schedule == "gpipe":
        # the forward's logits: the last stage's rows, None on the others
        with torch.no_grad():
            logits = pl.pipeline_forward(tree_map(sh.local, params),
                                         rows[:, :-1], cfg, mesh, n_micro)
        out["logits_here"] = logits is not None
        if logits is not None:
            logits = comm.gather_nograd(logits, 1, mesh.group("sp"))
        held = [None if logits is None else logits.numpy()]
        last = dist.get_global_rank(mesh.group("pp"), mesh.shape["pp"] - 1)
        dist.broadcast_object_list(held, src=last, group=mesh.group("pp"))
        out["last_stage_logits"] = held[0]
    return out


def pipe_train(plan: dict, host: dict, tokens, n_micro: int, steps: int):
    """``steps`` train steps on ``tokens`` through ``make_train_step(
    grad_fn=pipeline_1f1b_grads)``: the losses and grad norms, and the
    params after the first step."""
    import torch

    from tpu_docker_api_torch.parallel import pipeline as pl
    from tpu_docker_api_torch.train.trainer import (TrainState,
                                                    default_optimizer,
                                                    make_train_step)

    cfg, mesh, rules, params = _pipe_setup(plan, host, None)
    opt = default_optimizer()
    state = TrainState(0, params, opt.init(params))
    step = make_train_step(
        cfg, opt, mesh=mesh, rules=rules,
        grad_fn=lambda p, b: pl.pipeline_1f1b_grads(p, b, cfg, mesh,
                                                    n_micro))
    batch = torch.from_numpy(tokens).long()
    losses, norms, first = [], [], None
    for i in range(steps):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        if i == 0:
            first = _full(state.params)
    return {"losses": losses, "grad_norms": norms, "params": first,
            "wq_shard_dims": [p.dim if p.is_shard() else None for p in
                              state.params["layers"]["attn"]["wq"]
                              .placements]}


def pipe_global_norm(plan: dict, host: dict):
    """``global_norm`` of the params placed by ``pipeline_rules``."""
    from tpu_docker_api_torch.train.optim import global_norm

    _, _, _, params = _pipe_setup(plan, host, None)
    return {"norm": float(global_norm(params))}


def pipe_ckpt_write(plan: dict, directory: str, tokens):
    """One adamw-int8 pipeline step from a fresh pp-sharded state, saved:
    the saved state, whole."""
    import torch

    from tpu_docker_api_torch.parallel import pipeline as pl
    from tpu_docker_api_torch.parallel import sharding as sh
    from tpu_docker_api_torch.train.checkpoint import CheckpointManager
    from tpu_docker_api_torch.train.optim import adamw_int8
    from tpu_docker_api_torch.train.trainer import (create_train_state,
                                                    make_train_step)

    cfg, mesh = _pcfg(), _mesh(**plan)
    rules = pl.pipeline_rules(sh.LLAMA_RULES)
    st, opt = create_train_state(cfg, "cpu", torch.Generator().manual_seed(5),
                                 optimizer=adamw_int8(), mesh=mesh,
                                 rules=rules)
    step = make_train_step(
        cfg, opt, mesh=mesh, rules=rules,
        grad_fn=lambda p, b: pl.pipeline_1f1b_grads(
            p, b, cfg, mesh, b.shape[0]))
    st, _ = step(st, torch.from_numpy(tokens).long())
    mgr = CheckpointManager(directory)
    mgr.save(st)
    mgr.wait()
    mgr.close()
    return {"params": _full(st.params), "opt": _opt_full(st.opt_state)}


def pipe_ckpt_resume(plan: dict, directory: str, tokens):
    """Resume onto a pp mesh: the restored state (whole) and the loss of
    one more pipeline step on ``tokens``."""
    import torch

    from tpu_docker_api_torch.parallel import pipeline as pl
    from tpu_docker_api_torch.parallel import sharding as sh
    from tpu_docker_api_torch.train.checkpoint import resume_or_init
    from tpu_docker_api_torch.train.optim import adamw_int8
    from tpu_docker_api_torch.train.trainer import make_train_step

    cfg, mesh = _pcfg(), _mesh(**plan)
    rules = pl.pipeline_rules(sh.LLAMA_RULES)
    st, opt, mgr = resume_or_init(directory, cfg, "cpu",
                                  torch.Generator().manual_seed(9),
                                  optimizer=adamw_int8(), mesh=mesh,
                                  rules=rules)
    restored = {"step": st.step, "params": _full(st.params),
                "opt": _opt_full(st.opt_state)}
    step = make_train_step(
        cfg, opt, mesh=mesh, rules=rules,
        grad_fn=lambda p, b: pl.pipeline_1f1b_grads(
            p, b, cfg, mesh, b.shape[0]))
    _, m = step(st, torch.from_numpy(tokens).long())
    mgr.close()
    return {"restored": restored, "loss": float(m["loss"])}


# ------------------------------------------- encoder-decoder on sp


def encdec_sp_errors(plan: dict, host: dict, src, tgt):
    """The errors of an sp mesh's encoder-decoder: ``kv_len`` on the
    encoder's ring, and a target whose local chunk is odd on the
    decoder's zigzag ring."""
    import torch

    from tpu_docker_api_torch.models import encdec as te
    from tpu_docker_api_torch.models.convert import params_from_numpy
    from tpu_docker_api_torch.parallel import sharding as sh
    from tpu_docker_api_torch.train.optim import tree_map

    cfg, mesh = _cfg("encdec:tiny"), _mesh(**plan)
    params = tree_map(sh.local, sh.distribute_params(
        params_from_numpy(host, "cpu"), mesh, te.ENCDEC_RULES))
    src, tgt = _batch((src, tgt))
    out = {}
    try:
        te.encdec_encode(params, _seq_chunk(src, mesh), cfg,
                         kv_len=torch.full((src.shape[0],), 3), mesh=mesh)
    except NotImplementedError as e:
        out["kv_len"] = str(e)
    try:
        te.encdec_loss(params, (src, tgt), cfg, mesh)
    except ValueError as e:
        out["zigzag"] = str(e)
    return out
