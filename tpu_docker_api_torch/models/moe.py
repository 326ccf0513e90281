"""Mixtral-family sparse Mixture-of-Experts decoder (counterpart of
``tpu_docker_api/models/moe.py``).

Routing is GShard/Switch-style with static shapes, as in the JAX module:
top-k gating, a per-expert capacity ``C``, each (token, choice) placed in
its expert's queue by a cumsum over the flat batch, choices over capacity
dropped (the residual stream carries them unchanged). Attention, norms,
rope, the selective remat and the KV-cached skeleton are the Llama
module's (models/llama.py), so the whole-prompt prefill and the training
forward run the flash kernel.

The router's product is plain f32 (routing decisions are
precision-sensitive; the port enables no TF32), and the top-k puts the
lower expert index first on ties, as ``lax.top_k`` does. The scatter and
gather of the dispatch never index out of range: a dropped choice writes
into one trash row past the expert buffers and reads a zero.

On one device ``sort`` is the ``gather`` path, as the JAX function is
with ``mesh=None``. On a mesh (``MOE_RULES``) the experts shard on
``ep`` and, within an expert, the ffn dim on ``tp`` and the model dim on
``fsdp``. Tokens are not split over ep: every ep rank routes the same
tokens, runs its own experts on its slots of the dispatch, and the
expert outputs are summed over tp and gathered over ep before the
combine. Routing is over the GLOBAL flat batch, as under GSPMD: a batch
split over dp/fsdp/sp is gathered for it, so every capacity and drop
matches the JAX function on the same mesh.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from tpu_docker_api_torch.models.common import (draw_stacked, init_tree,
                                                remat_call)
from tpu_docker_api_torch.models.llama import (_attention,
                                               decoder_forward_cached,
                                               embed_lookup, gather_layer,
                                               layer_specs, lm_head,
                                               loss_denominator, rope_slice,
                                               seq_slice, unstack_layers,
                                               vocab_parallel_xent)
from tpu_docker_api_torch.ops.norms import rms_norm
from tpu_docker_api_torch.parallel import comm
from tpu_docker_api_torch.parallel.sharding import LLAMA_RULES, P

#: param-path sharding rules, first match wins (the JAX MOE_RULES): the
#: MoE rows, then LLAMA_RULES for everything shared with Llama
MOE_RULES: list = [
    ("layers/moe/router",    P(None, "fsdp", None)),
    ("layers/moe/w_gate",    P(None, "ep", "fsdp", "tp")),
    ("layers/moe/w_up",      P(None, "ep", "fsdp", "tp")),
    ("layers/moe/w_down",    P(None, "ep", "tp", "fsdp")),
    *LLAMA_RULES,
]

DISPATCH_IMPLS = ("auto", "gather", "einsum", "sort")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    ffn_dim: int = 14336
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    max_seq_len: int = 8192
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16
    remat: bool = True
    attention_impl: str = "auto"
    # "auto" | "gather" | "einsum" | "sort" (_moe_mlp); auto is gather on
    # one device
    dispatch_impl: str = "auto"

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    def capacity(self, n_tokens: int) -> int:
        """Per-expert token capacity for a flat batch of ``n_tokens``."""
        c = math.ceil(self.top_k * n_tokens * self.capacity_factor
                      / self.n_experts)
        return max(int(c), 1)

    def flops_per_token(self, seq_len: int | None = None) -> float:
        """Training FLOPs/token: only ``top_k`` experts fire a token."""
        seq = seq_len or self.max_seq_len
        d, h = self.dim, self.head_dim
        per_layer = (
            2 * d * (self.n_heads * h)
            + 2 * 2 * d * (self.n_kv_heads * h)
            + 2 * (self.n_heads * h) * d
            + 2 * d * self.n_experts                       # router
            + self.top_k * 3 * 2 * d * self.ffn_dim        # active experts
        )
        embed = 2 * d * self.vocab_size
        fwd = self.n_layers * per_layer + embed
        attn = self.n_layers * 2 * 2 * seq * (self.n_heads * h) / 2
        return 3.0 * (fwd + attn)


def moe_presets() -> dict[str, MoEConfig]:
    return {
        # Mixtral-8x7B geometry
        "mixtral-8x7b": MoEConfig(
            vocab_size=32000, dim=4096, n_layers=32, n_heads=32,
            n_kv_heads=8, ffn_dim=14336, n_experts=8, top_k=2,
            max_seq_len=32768, rope_theta=1e6,
        ),
        # ~0.5B parameters with 8 experts; head_dim 128
        "bench-moe": MoEConfig(
            vocab_size=32000, dim=1024, n_layers=8, n_heads=8,
            n_kv_heads=8, ffn_dim=2048, n_experts=8, top_k=2,
            max_seq_len=2048, rope_theta=10000.0,
        ),
        # CPU-fast config for tests
        "moe-tiny": MoEConfig(
            vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
            ffn_dim=128, n_experts=4, top_k=2, max_seq_len=128,
            rope_theta=10000.0, remat=False,
        ),
    }


def moe_param_specs(cfg: MoEConfig) -> dict:
    """The param tree's leaves as ``(shape, fan_in, dtype)``, in the order
    ``moe_init`` draws them; ``fan_in`` None is a norm scale of ones. The
    router is f32, every other leaf ``cfg.dtype``."""
    d, hd, L, E = cfg.dim, cfg.head_dim, cfg.n_layers, cfg.n_experts
    dt, f = cfg.dtype, cfg.ffn_dim
    return {
        "embed": {"tokens": ((cfg.vocab_size, d), d, dt)},
        "layers": {
            "attn_norm": ((L, d), None, dt),
            "mlp_norm": ((L, d), None, dt),
            "attn": {
                "wq": ((L, d, cfg.n_heads * hd), d, dt),
                "wk": ((L, d, cfg.n_kv_heads * hd), d, dt),
                "wv": ((L, d, cfg.n_kv_heads * hd), d, dt),
                "wo": ((L, cfg.n_heads * hd, d), cfg.n_heads * hd, dt),
            },
            "moe": {
                "router": ((L, d, E), d, torch.float32),
                "w_gate": ((L, E, d, f), d, dt),
                "w_up": ((L, E, d, f), d, dt),
                "w_down": ((L, E, f, d), f, dt),
            },
        },
        "final_norm": ((d,), None, dt),
        "lm_head": ((d, cfg.vocab_size), d, dt),
    }


def moe_init(cfg: MoEConfig, generator: torch.Generator,
             place=None) -> dict:
    """Random parameters on the generator's device in the JAX package's
    pytree; expert weights carry (n_layers, n_experts, …), the router
    stays f32. ``place``: models/common.py ``init_tree``."""
    def draw(spec):
        shape, fan_in, dtype = spec
        if fan_in is None:
            return torch.ones(shape, dtype=dtype, device=generator.device)
        return draw_stacked(generator, shape, fan_in, dtype)

    return init_tree(moe_param_specs(cfg), draw, place)


def _topk_lower_index_first(probs: torch.Tensor, k: int):
    """(values, indices) of the ``k`` largest entries of the last axis,
    ties broken toward the lower index (``lax.top_k``'s order): a stable
    descending sort, whose order ``torch.topk`` does not promise."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


#: what ``_route_topk`` picks its experts with in place of
#: ``_topk_lower_index_first``: None, or a ``RouteTape``'s for the span of
#: its ``with``
_route_picks = None


class RouteTape:
    """Records the expert picks of every routing call, or replays recorded
    ones in the same order: the gate values are then the replaying run's
    own probabilities of the replayed experts, so the gates and their
    gradients follow its inputs.

    Two attention routes (the flash kernel, the dense product) differ in
    the last bf16 bit, and a near-tie of two experts' probabilities then
    picks another expert; replaying one route's picks in the other holds
    the rest of the computation to a tolerance. After either ``with``,
    ``picks`` holds the picks each call made (or would have made). A
    replay fails unless it made exactly as many routing calls as were
    recorded."""

    def __init__(self):
        self.picks: list = []

    @contextlib.contextmanager
    def _routing(self, fn):
        global _route_picks
        if _route_picks is not None:
            raise RuntimeError("route tapes do not nest")
        _route_picks = fn
        try:
            yield self
        finally:
            _route_picks = None

    def record(self):
        self.picks = []

        def record(probs, k):
            vals, idx = _topk_lower_index_first(probs, k)
            self.picks.append(idx.detach().clone())
            return vals, idx

        return self._routing(record)

    @contextlib.contextmanager
    def replay(self, picks):
        recorded, self.picks = list(picks), []

        def replayed(probs, k):
            n = len(self.picks)
            if n == len(recorded):
                raise AssertionError(f"routing call {n + 1} with only {n} "
                                     f"recorded picks")
            idx = recorded[n]
            if idx.shape != (*probs.shape[:-1], k):
                raise AssertionError(f"recorded picks {tuple(idx.shape)} "
                                     f"for probabilities "
                                     f"{tuple(probs.shape)}, k = {k}")
            self.picks.append(_topk_lower_index_first(probs, k)[1]
                              .detach().clone())
            return probs.gather(-1, idx), idx

        with self._routing(replayed):
            yield self
        if len(self.picks) != len(recorded):
            raise AssertionError(f"{len(self.picks)} routing calls replayed "
                                 f"{len(recorded)} recorded picks")


def _route_topk(x_flat: torch.Tensor, router: torch.Tensor, cfg: MoEConfig,
                drop_free: bool = False):
    """Top-k routing decisions: (gate_vals (t,K) f32, gate_idx (t,K),
    pos (t,K) capacity slot, keep (t,K) mask, aux_loss, C).

    Capacity is ``cfg.capacity(t)`` over the whole flat batch (pad tokens
    compete too), or ``t`` with ``drop_free``: then no choice drops, the
    decode mode, where drops would couple co-batched requests. Every k = 0
    pick ranks ahead of every k = 1 pick in its expert's queue."""
    t = x_flat.shape[0]
    E, K = cfg.n_experts, cfg.top_k
    C = t if drop_free else cfg.capacity(t)
    logits = x_flat.float() @ router.float()                 # (t, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = (_route_picks or _topk_lower_index_first)(
        probs, K)                                            # (t, K)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    onehots = F.one_hot(gate_idx, E)                         # (t, K, E)
    # each (token, choice)'s place in its expert's queue: a cumsum over
    # the flat (K, t) order, so the k = 0 picks rank first
    ranked = onehots.transpose(0, 1).reshape(K * t, E)
    pos_ranked = ranked.cumsum(0) - ranked                   # 0-based
    pos = pos_ranked.reshape(K, t, E).transpose(0, 1)        # (t, K, E)
    pos = (pos * onehots).sum(-1)                            # (t, K)
    keep = pos < C

    # load-balance aux loss (Switch eq. 4): E * sum_e f_e * P_e
    top1 = F.one_hot(gate_idx[:, 0], E).float()
    aux = E * (top1.mean(0) * probs.mean(0)).sum()
    return gate_vals, gate_idx, pos, keep, aux, C


def _route(x_flat: torch.Tensor, router: torch.Tensor, cfg: MoEConfig,
           drop_free: bool = False):
    """Top-k routing → (dispatch (t,E,C), combine (t,E,C), aux_loss): the
    einsum-dispatch form, in the storage dtype. A choice at ``pos >= C``
    gets a zero slot row (``jax.nn.one_hot``'s value out of range, where
    ``F.one_hot`` would raise)."""
    gate_vals, gate_idx, pos, keep, aux, C = _route_topk(
        x_flat, router, cfg, drop_free)
    dt = x_flat.dtype
    onehots = F.one_hot(gate_idx, cfg.n_experts).to(dt)     # (t, K, E)
    slots = torch.arange(C, device=pos.device)
    slot_onehot = (pos[..., None] == slots).to(dt)           # (t, K, C)
    disp_k = onehots[..., None] * slot_onehot[:, :, None, :]
    disp_k = disp_k * keep[:, :, None, None].to(dt)
    dispatch = disp_k.sum(1)
    combine = (disp_k * gate_vals.to(dt)[:, :, None, None]).sum(1)
    return dispatch, combine, aux


def _expert_swiglu(xe: torch.Tensor, layer_moe: dict) -> torch.Tensor:
    """(E, C, d) → (E, C, d) batched expert SwiGLU (every dispatch)."""
    gate = F.silu(torch.bmm(xe, layer_moe["w_gate"]))
    up = torch.bmm(xe, layer_moe["w_up"])
    return torch.bmm(gate * up, layer_moe["w_down"])


def _experts_on_mesh(xe: torch.Tensor, layer_moe: dict, mesh):
    """(E, C, d) dispatched tokens, replicated → (E, C, d) expert outputs,
    replicated: this rank's experts on its slots (its tp part of the ffn
    dim), summed over tp and gathered over ep. The tokens enter through
    ``copy_to`` over both axes: each rank's backward is partial."""
    ep, tp = mesh.group("ep"), mesh.group("tp")
    xe = comm.copy_to(comm.copy_to(xe, tp), ep)
    e_loc = layer_moe["w_gate"].shape[0]
    xe = xe[mesh.index("ep") * e_loc:(mesh.index("ep") + 1) * e_loc]
    ye = comm.reduce_from(_expert_swiglu(xe, layer_moe), tp)
    return comm.all_gather(ye, 0, ep, bwd="slice")


def _gather_tokens(x: torch.Tensor, mesh) -> torch.Tensor:
    """The global (batch, seq, d) from this rank's rows and sp chunk."""
    x = comm.all_gather(x, 1, mesh.group("sp"), bwd="sum")
    for a in ("fsdp", "dp"):
        x = comm.all_gather(x, 0, mesh.group(a), bwd="sum")
    return x


def _own_tokens(x: torch.Tensor, b: int, s: int, mesh) -> torch.Tensor:
    """This rank's rows and sp chunk of a global (batch, seq, d)."""
    r0 = mesh.index(("dp", "fsdp")) * b
    s0 = mesh.coords["sp"] * s
    return x[r0:r0 + b, s0:s0 + s]


def _moe_mlp(x: torch.Tensor, layer_moe: dict, cfg: MoEConfig,
             drop_free: bool = False, mesh=None):
    """Sparse FFN: route → dispatch → batched expert SwiGLU → combine.
    Returns (out, aux_loss).

    - ``gather`` (and ``auto`` and ``sort``, which are gather on one
      device): tokens scatter into the (E·C, d) expert buffers by flat
      slot id and the expert outputs gather back; a dropped choice writes
      the trash row E·C (sliced off) and reads a zero.
    - ``einsum``: the one-hot (t, E, C) dispatch and combine products.

    On a mesh with more than one rank ``auto`` is ``sort`` and
    ``gather`` raises, as in JAX; ``sort`` is the gather path with the
    expert compute split over ep and tp (:func:`_experts_on_mesh`).
    """
    if cfg.dispatch_impl not in DISPATCH_IMPLS:
        raise ValueError(f"unknown dispatch impl {cfg.dispatch_impl!r}")
    if (mesh is not None and mesh.size > 1
            and cfg.dispatch_impl == "gather"):
        raise ValueError(
            "dispatch_impl='gather' is single-device only; use 'auto', "
            "'einsum', or 'sort' on a multi-device mesh")
    b_own, s_own = x.shape[:2]
    split = mesh is not None and mesh.size_of(("dp", "fsdp", "sp")) > 1
    if split:
        x = _gather_tokens(x, mesh)
    b, s, d = x.shape
    x_flat = x.reshape(b * s, d)

    def experts(xe):
        if mesh is None:
            return _expert_swiglu(xe, layer_moe)
        return _experts_on_mesh(xe, layer_moe, mesh)

    def own(out, aux):
        out = out.reshape(b, s, d)
        if split:
            out = _own_tokens(out, b_own, s_own, mesh)
        return out, aux

    if cfg.dispatch_impl == "einsum":
        dispatch, combine, aux = _route(x_flat, layer_moe["router"], cfg,
                                        drop_free=drop_free)
        xe = torch.einsum("tec,td->ecd", dispatch, x_flat)
        ye = experts(xe)
        out = torch.einsum("tec,ecd->td", combine, ye)
        return own(out, aux)

    gate_vals, gate_idx, pos, keep, aux, C = _route_topk(
        x_flat, layer_moe["router"], cfg, drop_free=drop_free)
    t = b * s
    E, K = cfg.n_experts, cfg.top_k
    slot = torch.where(keep, gate_idx * C + pos, E * C).reshape(-1)
    src = x_flat[:, None, :].expand(t, K, d).reshape(t * K, d)
    xe = x_flat.new_zeros((E * C + 1, d)).index_copy(0, slot, src)
    ye = experts(xe[:E * C].reshape(E, C, d))
    picked = ye.reshape(E * C, d).index_select(0, slot.clamp_max(E * C - 1))
    picked = torch.where(keep.reshape(-1, 1), picked, 0).reshape(t, K, d)
    w = (gate_vals * keep).to(x.dtype)                       # (t, K)
    out = torch.einsum("tk,tkd->td", w, picked)
    return own(out, aux)


def _moe_block(x, layer, cfg: MoEConfig, rope_cos, rope_sin, cache=None,
               start_pos=None, kv_limit=None, mesh=None):
    """Transformer block: Llama attention (shared code) + sparse FFN.
    Returns (x, aux_loss), or (x, aux_loss, new_cache) on the KV-cached
    path (``cache=(k_all, v_all, layer_idx)``, llama's ``_attention``
    contract). A cached call of one token a row (decode) routes
    drop-free; prefill and training keep the capacity."""
    if mesh is not None:
        layer = gather_layer(layer, layer_specs(layer, MOE_RULES), mesh)
    attn_out = _attention(
        rms_norm(x, layer["attn_norm"], cfg.norm_eps), layer, cfg,
        rope_cos, rope_sin, cache=cache, start_pos=start_pos,
        kv_limit=kv_limit, mesh=mesh)
    new_cache = None
    if cache is not None:
        attn_out, new_cache = attn_out
    x = x + attn_out
    moe_out, aux = _moe_mlp(
        rms_norm(x, layer["mlp_norm"], cfg.norm_eps), layer["moe"], cfg,
        drop_free=(cache is not None and x.shape[1] == 1), mesh=mesh)
    x = x + moe_out
    return (x, aux) if cache is None else (x, aux, new_cache)


def moe_forward(params: dict, tokens: torch.Tensor, cfg: MoEConfig,
                mesh=None, whole: bool = True
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(logits (b, s, vocab) f32, mean router aux loss over layers). With
    ``cfg.remat`` and autograd on, each block is checkpointed under the
    shared selective policy of models/common.py (the flash ``(out,
    lse)`` kept, the rest recomputed). On a ``mesh`` the params are
    local shards and ``tokens`` this rank's rows and sp chunk
    (models/llama.py ``llama_hidden``); ``whole=False`` keeps the logits'
    tp columns."""
    seq = tokens.shape[1]
    x = embed_lookup(params["embed"]["tokens"], tokens, mesh)
    rope_cos, rope_sin = rope_slice(cfg, seq, x.device, mesh)
    remat = cfg.remat and torch.is_grad_enabled()
    auxes = []
    for layer in unstack_layers(params["layers"], cfg.n_layers):
        if remat:
            x, aux = remat_call(_moe_block, x, layer, cfg, rope_cos,
                                rope_sin, None, None, None, mesh)
        else:
            x, aux = _moe_block(x, layer, cfg, rope_cos, rope_sin,
                                mesh=mesh)
        auxes.append(aux)
    return (lm_head(params, x, cfg, mesh, whole=whole),
            torch.stack(auxes).mean())


def moe_forward_cached(
    params: dict,
    tokens: torch.Tensor,     # (batch, seq) — the NEW tokens only
    cfg: MoEConfig,
    k_cache: torch.Tensor,    # (n_layers, batch, max_seq, n_kv_heads, hd)
    v_cache: torch.Tensor,
    start_pos,
    last_only=False,
    kv_limit: int | None = None,
    mesh=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """KV-cached forward for serving: the shared decoder skeleton
    (models/llama.py ``decoder_forward_cached``, caches updated in place)
    with the sparse-FFN block. The router's aux loss is dropped."""
    def block_fn(x, layer, cache, rope_cos, rope_sin):
        x, _aux, new_cache = _moe_block(
            x, layer, cfg, rope_cos, rope_sin, cache=cache,
            start_pos=start_pos, kv_limit=kv_limit, mesh=mesh)
        return x, new_cache

    return decoder_forward_cached(params, tokens, cfg, k_cache, v_cache,
                                  last_only, block_fn, mesh=mesh)


def moe_loss(params: dict, tokens: torch.Tensor, cfg: MoEConfig,
             mesh=None) -> torch.Tensor:
    """Causal LM loss + the router's load-balance penalty. On a mesh,
    this rank's share (models/llama.py ``llama_loss``): the aux loss is
    computed whole on every rank that splits the batch, so each carries
    its 1/n part."""
    inputs = seq_slice(tokens[:, :-1], mesh)
    targets = seq_slice(tokens[:, 1:], mesh)
    logits, aux = moe_forward(params, inputs, cfg, mesh, whole=False)
    ce = vocab_parallel_xent(logits, targets, mesh,
                             loss_denominator(targets, mesh))
    n = 1 if mesh is None else mesh.size_of(("dp", "fsdp", "sp"))
    return ce + cfg.router_aux_coef * aux / n
