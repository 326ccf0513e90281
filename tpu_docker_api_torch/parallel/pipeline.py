"""Pipeline parallelism: GPipe and 1F1B over point-to-point sends
(counterpart of ``tpu_docker_api/parallel/pipeline.py``).

The JAX module writes the pipeline as sharded-tensor algebra: the layer
stack reshaped to (stages, layers a stage, ...) with the stage dim on
``pp``, every stage applied at once by ``vmap``, ``jnp.roll`` over the
stage dim (a collective-permute) handing activations on, a ``lax.scan``
over ticks. The port runs one process a device, so a rank IS a stage:

- **Layers.** Stage ``s`` (the rank's ``pp`` coordinate) holds layers
  ``[s·L/S, (s+1)·L/S)``: the ``Shard(0)``-on-pp block of every stacked
  leaf that ``pipeline_rules`` puts ``pp`` first in. The stacked norms
  keep the JAX rule ``P()`` (whole on every stage); a stage slices its
  rows, and their gradient, zero elsewhere, sums over pp
  (parallel/sharding.py ``grad_reduce_axes``). Within a stage each
  layer's fsdp shards are gathered and tp splits its products as in
  ``llama_loss`` (models/llama.py ``run_layers``): a layer's slice of a
  ``pipeline_rules`` spec is its ``LLAMA_RULES`` one.
- **Hand-off.** ``jnp.roll`` becomes a send to stage s+1 and a receive
  from s-1 on the pp group; the cotangent goes the other way.
- **Bubbles.** On a fill or drain tick a stage with no microbatch
  computes nothing (JAX computes garbage there and masks it). Both ends
  of every send decide it from the static schedule alone.
- **Embedding** on stage 0, **final norm, head and loss** on the last
  stage, through ``llama_loss``'s own ``head_loss``.

``pipeline_forward``/``pipeline_loss`` are GPipe: autograd differentiates
through the sends (``comm.ppermute``), the reference 1F1B is held
against, as in JAX's tests. Every rank issues each tick's ``ppermute``,
and the buffers a stage does not consume join its loss at weight zero,
so every rank's backward runs each transpose, newest tick first.
``pipeline_1f1b_grads`` is the hand-scheduled 1F1B (module docstring of
the JAX function): one forward and one backward microbatch a stage a
tick, stage inputs stashed in a ring of 2S slots, the stage backward a
recompute under ``torch.enable_grad`` with ``torch.autograd.grad`` on the
received cotangent, weight gradients accumulated in f32 and cast to the
parameter dtype at the end, the embedding's backward once after the
ring on stage 0's accumulated ``dx``; both directions of a tick travel
in one ``batch_isend_irecv`` (``comm.exchange``).

**Sequence parallelism.** On ``sp > 1`` JAX shards each stage's buffer
over the sequence (``P("pp", ("dp", "fsdp"), "sp", None)``) and GSPMD
gathers it for attention. Here a rank is a (stage, sp chunk) pair: each
function cuts its rows' inputs and targets to the rank's chunk
(models/llama.py ``seq_slice``, as ``llama_loss`` does), rope takes the
chunk's positions. JAX runs a stage's blocks with ``mesh=None``, so
its ``auto`` there attends over the whole gathered sequence (flash on
the accelerator), not the sp rule's ring: ``_stage_cfg`` resolves
``auto`` to that pick, which ``_self_attention`` runs on q, k and v
gathered along sp (an explicit ring or Ulysses stays as asked). Every
buffer, stash and cotangent is (microbatch rows, seq/sp, d), and a pp
send goes from (s, c) to (s+1, c) on the pp group of sp coordinate c.
The loss share's denominator already counts sp (``loss_denominator``).

Each function takes this rank's local params and rows (off a mesh, the
whole tree and batch: one stage), and returns this rank's share of the
global mean loss: the last stage's, zero on the others. The pipeline is
Llama's, as in JAX, which has no pp × ep: an ep axis is refused.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from tpu_docker_api_torch.models.llama import (LlamaConfig, embed_lookup,
                                               head_loss, lm_head,
                                               rope_slice, run_layers,
                                               seq_slice)
from tpu_docker_api_torch.ops.attention import auto_impl
from tpu_docker_api_torch.parallel import comm
from tpu_docker_api_torch.parallel.sharding import P
from tpu_docker_api_torch.train.optim import tree_leaves, tree_map


def pipeline_rules(rules: list[tuple[str, P]]) -> list[tuple[str, P]]:
    """Make param sharding rules pipeline-aware: the stacked-layer dim
    (leading ``None`` in every ``layers/*`` rule) shards on ``pp``, so
    stage ``s`` owns the contiguous block of layers it executes."""
    out = []
    for pattern, spec in rules:
        if pattern.startswith("layers/") and len(spec) and spec[0] is None:
            out.append((pattern, P("pp", *spec[1:])))
        else:
            out.append((pattern, spec))
    return out


def _stage_layers(params: dict, n_stages: int, stage: int = 0) -> dict:
    """Stage ``stage``'s block of the stacked layer tree: a leaf already
    cut to L/n_stages rows on pp is kept, a whole one (L rows: the
    norms, or every leaf off a mesh) is sliced."""
    L = params["layers"]["attn_norm"].shape[0]
    if L % n_stages:
        raise ValueError(f"n_layers={L} not divisible by pp={n_stages}")
    per = L // n_stages
    return tree_map(lambda p: p if p.shape[0] == per
                    else p.narrow(0, stage * per, per), params["layers"])


def _stages(cfg, mesh, device) -> tuple[int, int, object]:
    """(stages S, this rank's stage s, the pp group or None)."""
    if not isinstance(cfg, LlamaConfig):
        raise TypeError(f"the pipeline runs llama configs, not "
                        f"{type(cfg).__name__}")
    if mesh is None:
        return 1, 0, None
    if mesh.shape["ep"] > 1:
        raise ValueError("pp x ep does not apply: JAX's pipeline is "
                         "Llama's only and has no such composition")
    for ax in ("sp", "pp"):
        if mesh.group(ax) is not None:
            # NCCL's rule for batch_isend_irecv (the pp hand-off, the sp
            # ring): the group's first operation involves all its ranks
            dist.all_reduce(torch.zeros(1, device=device),
                            group=mesh.group(ax))
    return mesh.shape["pp"], mesh.coords["pp"], mesh.group("pp")


def _stage_cfg(cfg, mesh, dtype, device):
    """The config a stage's blocks run under: on sp > 1 ``auto`` becomes
    the whole sequence's pick (``auto_impl``: flash on CUDA, else
    dense), JAX's ``mesh=None`` block; otherwise ``cfg`` as it is."""
    if cfg.attention_impl != "auto" or mesh is None or mesh.shape["sp"] == 1:
        return cfg
    shape = (1, 1, cfg.n_heads, cfg.head_dim)
    return dataclasses.replace(cfg, attention_impl=auto_impl(
        shape, shape, True, device.type == "cuda", dtype))


def _micro(batch: int, n_micro: int) -> int:
    if batch % n_micro:
        raise ValueError(f"batch={batch} not divisible by "
                         f"n_micro={n_micro}")
    return batch // n_micro


def _gpipe(params, inputs, cfg, mesh, n_micro):
    """The GPipe forward of ``inputs`` (this rank's rows, the whole
    sequence): (the last stage's final hidden (rows, seq/sp, d) of this
    rank's sp chunk, None elsewhere; a zero joining every buffer and leaf
    this rank's loss does not otherwise reach, so its backward runs every
    transpose)."""
    S, s, grp = _stages(cfg, mesh, inputs.device)
    inputs = seq_slice(inputs, mesh)
    batch, seq = inputs.shape
    mb = _micro(batch, n_micro)
    stage = _stage_layers(params, S, s)
    per = stage["attn_norm"].shape[0]
    table = params["embed"]["tokens"]
    cfg = _stage_cfg(cfg, mesh, table.dtype, inputs.device)
    rope_cos, rope_sin = rope_slice(cfg, seq, inputs.device, mesh)
    remat = cfg.remat and torch.is_grad_enabled()
    dead = (([] if s == 0 else [table])
            + ([] if s == S - 1 else [params["final_norm"],
                                      params["lm_head"]]))
    # what a rank sends on a tick it has nothing for: zeros on the
    # stage's leaves, so autograd.grad never prunes the transpose
    idle = torch.zeros((mb, seq, cfg.dim), dtype=table.dtype,
                       device=inputs.device) + stage["attn_norm"].sum() * 0
    x_mb = None
    if s == 0:
        x_mb = embed_lookup(table, inputs, mesh).reshape(
            n_micro, mb, seq, -1)
    outs, recv = [], None
    for t in range(n_micro + S - 1):
        m = t - s
        out = None
        if 0 <= m < n_micro:
            h = x_mb[m] if s == 0 else recv
            out = run_layers(h, stage, per, cfg, rope_cos, rope_sin, mesh,
                             remat=remat)
            if s == S - 1:
                outs.append(out)
        perm = [(j, j + 1) for j in range(S - 1) if 0 <= t - j < n_micro]
        if perm:
            got = comm.ppermute(out if s < S - 1 and out is not None
                                else idle, perm, grp)
            if s > 0 and 0 <= t + 1 - s < n_micro:
                recv = got
            else:
                dead.append(got)
    keep = sum(x.sum() for x in dead) * 0 if dead else 0
    if s != S - 1:
        return None, keep
    return torch.cat(outs, dim=0), keep


def pipeline_forward(params: dict, tokens: torch.Tensor, cfg, mesh,
                     n_micro: int):
    """Next-token logits (rows, seq/sp, vocab) f32 of ``tokens`` (this
    rank's rows, the whole sequence) on this rank's sp chunk, through
    the GPipe schedule: on the last stage; None on the others."""
    h, _ = _gpipe(params, tokens, cfg, mesh, n_micro)
    return None if h is None else lm_head(params, h, cfg, mesh)


def pipeline_loss(params: dict, tokens: torch.Tensor, cfg, mesh,
                  n_micro: int) -> torch.Tensor:
    """Causal LM loss through the pipeline (GPipe: autograd reverses the
    forward, so every microbatch's activations stay live until the
    backward; ``pipeline_1f1b_grads`` keeps O(S)). This rank's share of
    the global mean: nonzero on the last stage only; every leaf gets a
    gradient, zero where the stage does not use it."""
    h, keep = _gpipe(params, tokens[:, :-1], cfg, mesh, n_micro)
    if h is None:
        return keep
    return head_loss(params, h, seq_slice(tokens[:, 1:], mesh), cfg,
                     mesh) + keep


def pipeline_1f1b_grads(params: dict, tokens: torch.Tensor, cfg, mesh,
                        n_micro: int) -> tuple[torch.Tensor, dict]:
    """(loss, grads) through the interleaved 1F1B schedule, loss- and
    gradient-equal to autograd of ``pipeline_loss`` up to reduction
    order. Forward of microbatch m runs at stage s on tick m+s (its loss
    and cotangent seed on the last stage the same tick); its backward on
    tick m+2S-1-s. ``tokens`` is (rows, seq+1), ``params`` this rank's
    local tree; the grads are in its structure, the loss the mean of
    the microbatch means (this rank's share; zero off the last stage).
    Feed it to ``make_train_step(grad_fn=...)``."""
    S, s, grp = _stages(cfg, mesh, tokens.device)
    M = n_micro
    inputs = seq_slice(tokens[:, :-1], mesh)
    targets = seq_slice(tokens[:, 1:], mesh)
    batch, seq = inputs.shape
    mb = _micro(batch, M)
    layers = tree_map(lambda p: p.detach().requires_grad_(),
                      params["layers"])
    per = _stage_layers({"layers": layers}, S, s)["attn_norm"].shape[0]
    rope_cos, rope_sin = rope_slice(cfg, seq, tokens.device, mesh)
    targets_mb = targets.reshape(M, mb, seq)
    table = params["embed"]["tokens"]
    cfg = _stage_cfg(cfg, mesh, table.dtype, tokens.device)
    like = torch.empty((mb, seq, cfg.dim), dtype=table.dtype,
                       device=tokens.device)
    head = {k: params[k].detach().requires_grad_()
            for k in ("final_norm", "lm_head")}

    def run(h):
        return run_layers(h, _stage_layers({"layers": layers}, S, s), per,
                          cfg, rope_cos, rope_sin, mesh)

    x_mb = None
    if s == 0:
        with torch.no_grad():
            x_mb = embed_lookup(table, inputs, mesh).reshape(M, mb, seq, -1)
        dx = torch.empty_like(x_mb)
    # f32 accumulators: M adds in bf16 would drift (JAX's choice)
    g_layers = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), layers)
    g_head = {k: torch.zeros(v.shape, dtype=torch.float32, device=v.device)
              for k, v in head.items()}
    loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
    stash: list = [None] * (2 * S)
    f_in = c_in = seed = None
    for t in range(M + 2 * S - 1):
        # ---- forward half-tick: microbatch t - s
        m_f, f_out, new_seed = t - s, None, None
        if 0 <= m_f < M:
            h = x_mb[m_f] if s == 0 else f_in
            stash[m_f % (2 * S)] = h
            with torch.no_grad():
                out = run(h)
            if s < S - 1:
                f_out = out
            else:
                # the head and its seed only where a microbatch exits
                # the ring (JAX's lax.cond)
                with torch.enable_grad():
                    hl = out.detach().requires_grad_()
                    loss_m = head_loss(head, hl, targets_mb[m_f], cfg, mesh)
                    new_seed, *dh = torch.autograd.grad(
                        loss_m, [hl, *head.values()])
                loss += loss_m.detach()
                for acc, g in zip(g_head.values(), dh):
                    acc += g
        # ---- backward half-tick: microbatch t - (2S-1) + s
        m_b, c_out = t - (2 * S - 1) + s, None
        if 0 <= m_b < M:
            cot = seed if s == S - 1 else c_in
            with torch.enable_grad():
                h = stash[m_b % (2 * S)].detach().requires_grad_()
                stash[m_b % (2 * S)] = None
                d_in, *dw = torch.autograd.grad(
                    run(h), [h, *tree_leaves(layers)], grad_outputs=cot)
            for acc, g in zip(tree_leaves(g_layers), dw):
                acc += g
            if s == 0:
                dx[m_b] = d_in
            else:
                c_out = d_in
        seed = new_seed
        # ---- both directions of the tick, decided alike at both ends
        sends, recvs = [], []
        if f_out is not None:
            sends.append((f_out, s + 1))
        if c_out is not None:
            sends.append((c_out, s - 1))
        want_f = s > 0 and 0 <= t - (s - 1) < M
        want_c = s < S - 1 and 0 <= t - (2 * S - 1) + (s + 1) < M
        if want_f:
            recvs.append((like, s - 1))
        if want_c:
            recvs.append((like, s + 1))
        got = comm.exchange(sends, recvs, grp)
        f_in = got.pop(0) if want_f else None
        c_in = got.pop(0) if want_c else None

    inv_m = 1.0 / M
    if s == 0:
        # the embedding's backward, deferred (JAX's embed_vjp)
        with torch.enable_grad():
            live = table.detach().requires_grad_()
            (d_embed,) = torch.autograd.grad(
                embed_lookup(live, inputs, mesh),
                [live], grad_outputs=dx.reshape(batch, seq, -1) * inv_m)
    else:
        d_embed = torch.zeros_like(table)
    grads = {
        "embed": {"tokens": d_embed},
        "layers": tree_map(lambda g, p: (g * inv_m).to(p.dtype), g_layers,
                           params["layers"]),
        **{k: (g * inv_m).to(params[k].dtype) for k, g in g_head.items()},
    }
    return loss * inv_m, grads
