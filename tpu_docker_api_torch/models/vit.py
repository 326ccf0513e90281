"""Vision Transformer, the non-causal model family (counterpart of
``tpu_docker_api/models/vit.py``).

The parameters keep the JAX package's pytree (stacked ``(n_layers, …)``
leaves, named as there), so weights cross over 1:1 (models/convert.py).
As in JAX: a mean-pooled head with no CLS token (``(image/patch)²``
tokens, 256 for vit-b16), the patch embedding as one (P²·C, D) matmul
on re-laid-out pixels, pre-LN blocks with non-causal attention through
``multihead_attention`` (ops/attention.py picks the flash kernel or the
dense path), bf16 storage with f32 norms and f32 logits. A Python loop
over layers takes the place of ``lax.scan``; with ``cfg.remat`` each
block is checkpointed under the shared selective policy
(models/common.py), which keeps only the flash forward's ``(out, lse)``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from tpu_docker_api_torch.models.common import (draw_stacked, init_tree,
                                                remat_call,
                                                seeded_generator,
                                                trunc_normal_init)
from tpu_docker_api_torch.models.llama import (gather_layer, layer_specs,
                                               unstack_layers)
from tpu_docker_api_torch.ops.attention import multihead_attention
from tpu_docker_api_torch.ops.norms import layer_norm
from tpu_docker_api_torch.ops.quant import linear
from tpu_docker_api_torch.parallel import comm
from tpu_docker_api_torch.parallel.sharding import P, spec_for, unshard


#: param-path sharding rules, first match wins (the JAX VIT_RULES). On
#: a mesh the batch splits over dp and fsdp, the weights gather over fsdp
#: a layer at a time, and tp splits the products as the rules lay them
#: out: the patch embedding's and the blocks' column-parallel products
#: make this rank's columns, the row-parallel ones sum over tp
VIT_RULES: list = [
    ("patch_embed/w",   P("fsdp", "tp")),           # (P²C, d) column
    ("layers/attn/wq",  P(None, "fsdp", "tp")),     # (L, d, d) column
    ("layers/attn/wk",  P(None, "fsdp", "tp")),
    ("layers/attn/wv",  P(None, "fsdp", "tp")),
    ("layers/attn/wo",  P(None, "tp", "fsdp")),     # row
    ("layers/mlp/w1",   P(None, "fsdp", "tp")),     # (L, d, ff) column
    ("layers/mlp/w2",   P(None, "tp", "fsdp")),     # (L, ff, d) row
    ("head",            P("fsdp", None)),           # (d, classes)
    ("pos_emb",         P()),
    ("*",               P()),                       # biases, norms
]


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 256
    patch_size: int = 16
    channels: int = 3
    dim: int = 768
    n_layers: int = 12
    n_heads: int = 12
    ffn_dim: int = 3072
    n_classes: int = 1000
    norm_eps: float = 1e-6
    dtype: Any = torch.bfloat16
    remat: bool = True

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    def flops_per_image(self) -> float:
        """Training FLOPs per image (fwd+bwd ≈ 3× forward matmul FLOPs)."""
        n, d = self.n_patches, self.dim
        per_layer = (4 * 2 * d * d            # wq wk wv wo
                     + 2 * 2 * d * self.ffn_dim)
        attn = 2 * 2 * n * d                  # scores + values per token
        patch = 2 * (self.patch_size ** 2 * self.channels) * d
        head = 2 * d * self.n_classes
        return 3.0 * (n * (self.n_layers * (per_layer + attn))
                      + n * patch + head)


def vit_presets() -> dict[str, ViTConfig]:
    return {
        # ViT-Base/16 at 256px → 256 patches
        "vit-b16": ViTConfig(),
        "vit-s16": ViTConfig(dim=384, n_layers=12, n_heads=6, ffn_dim=1536),
        # CPU-fast config for tests (64px/16 → 16 patches)
        "tiny": ViTConfig(image_size=64, patch_size=16, dim=64, n_layers=2,
                          n_heads=4, ffn_dim=128, n_classes=10, remat=False),
    }


def vit_param_specs(cfg: ViTConfig) -> dict:
    """The param tree's leaves as ``(shape, init)``: ``init`` a fan-in
    (truncated normal), "ones", "zeros", "pos" (N(0, 0.02²)) or "head"
    (truncated normal times 0.02: near-uniform first logits that still
    pass trunk gradients)."""
    d, pd, L, f = cfg.dim, cfg.patch_size ** 2 * cfg.channels, \
        cfg.n_layers, cfg.ffn_dim
    return {
        "patch_embed": {"w": ((pd, d), pd), "b": ((d,), "zeros")},
        "pos_emb": ((cfg.n_patches, d), "pos"),
        "layers": {
            "ln1_w": ((L, d), "ones"),
            "ln1_b": ((L, d), "zeros"),
            "ln2_w": ((L, d), "ones"),
            "ln2_b": ((L, d), "zeros"),
            "attn": {"wq": ((L, d, d), d), "wk": ((L, d, d), d),
                     "wv": ((L, d, d), d), "wo": ((L, d, d), d)},
            "mlp": {"w1": ((L, d, f), d), "b1": ((L, f), "zeros"),
                    "w2": ((L, f, d), f), "b2": ((L, d), "zeros")},
        },
        "final_ln_w": ((d,), "ones"),
        "final_ln_b": ((d,), "zeros"),
        "head": ((d, cfg.n_classes), "head"),
    }


def vit_init(cfg: ViTConfig, generator: torch.Generator,
             place=None) -> dict:
    """Random parameters on the generator's device, stacked leaves drawn
    matrix by matrix. ``place``: models/common.py ``init_tree``."""
    dev, dt = generator.device, cfg.dtype

    def init(spec):
        shape, how = spec
        if how == "ones":
            return torch.ones(shape, dtype=dt, device=dev)
        if how == "zeros":
            return torch.zeros(shape, dtype=dt, device=dev)
        if how == "pos":
            return (torch.randn(shape, generator=generator, device=dev)
                    * 0.02).to(dt)
        if how == "head":
            return trunc_normal_init(generator, shape, shape[0], dt) \
                * torch.tensor(0.02, dtype=dt)
        return draw_stacked(generator, shape, how, dt)

    return init_tree(vit_param_specs(cfg), init, place)


def _patchify(images: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
    """(B, H, W, C) → (B, n_patches, P²·C)."""
    b, h, w, c = images.shape
    p = cfg.patch_size
    x = images.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // p) * (w // p), p * p * c)


def _block(x, layer, cfg: ViTConfig, mesh=None):
    """Pre-LN transformer encoder block (non-causal attention). On a
    ``mesh`` the layer's local shards are gathered over fsdp here (inside
    the remat region, as llama's) and the attention heads and MLP columns
    are this rank's tp part (``copy_to`` in, ``reduce_from`` out)."""
    tp = None if mesh is None else mesh.group("tp")
    if mesh is not None:
        layer = gather_layer(layer, layer_specs(layer, VIT_RULES), mesh)
    b, n, _ = x.shape
    hd = cfg.head_dim
    y = comm.copy_to(layer_norm(x, layer["ln1_w"], layer["ln1_b"],
                                cfg.norm_eps), tp)
    q = linear(y, layer["attn"]["wq"]).reshape(b, n, -1, hd)
    k = linear(y, layer["attn"]["wk"]).reshape(b, n, -1, hd)
    v = linear(y, layer["attn"]["wv"]).reshape(b, n, -1, hd)
    attn = multihead_attention(q, k, v, causal=False, probs_dtype=cfg.dtype)
    x = x + comm.reduce_from(linear(attn.reshape(b, n, -1),
                                    layer["attn"]["wo"]), tp)
    y = comm.copy_to(layer_norm(x, layer["ln2_w"], layer["ln2_b"],
                                cfg.norm_eps), tp)
    b1 = comm.scatter_to(layer["mlp"]["b1"], 0, tp)
    y = F.gelu(linear(y, layer["mlp"]["w1"]) + b1,
               approximate="tanh")  # jax.nn.gelu's default
    return x + (comm.reduce_from(linear(y, layer["mlp"]["w2"]), tp)
                + layer["mlp"]["b2"])


def vit_forward(params: dict, images: torch.Tensor,
                cfg: ViTConfig, mesh=None) -> torch.Tensor:
    """Class logits (B, n_classes) in f32 (mean-pooled, no CLS token)
    from (B, H, W, C) images of any float dtype. On a ``mesh`` the params
    are this rank's local shards and ``images`` its rows."""
    if mesh is not None:
        tp = mesh.shape["tp"]
        if cfg.n_heads % tp or cfg.ffn_dim % tp:
            raise ValueError(f"tp = {tp} must divide n_heads {cfg.n_heads} "
                             f"and ffn_dim {cfg.ffn_dim}")
    x = _patchify(images.to(cfg.dtype), cfg)
    w = params["patch_embed"]["w"]
    if mesh is None:
        x = linear(x, w)
    else:
        # this rank's columns of the embedding, then the whole width
        x = linear(x, unshard(w, spec_for("patch_embed/w", VIT_RULES),
                              mesh))
        x = comm.all_gather(x, x.ndim - 1, mesh.group("tp"), bwd="slice")
    x = x + params["patch_embed"]["b"]
    x = x + params["pos_emb"][None]
    remat = cfg.remat and torch.is_grad_enabled()
    for layer in unstack_layers(params["layers"], cfg.n_layers):
        x = remat_call(_block, x, layer, cfg, mesh) if remat else \
            _block(x, layer, cfg, mesh)
    x = layer_norm(x, params["final_ln_w"], params["final_ln_b"],
                   cfg.norm_eps)
    pooled = x.float().mean(dim=1)   # (B, d)
    head = unshard(params["head"], spec_for("head", VIT_RULES), mesh)
    return linear(pooled.to(cfg.dtype), head, out_dtype=torch.float32)


def vit_loss(params: dict, batch, cfg: ViTConfig,
             mesh=None) -> torch.Tensor:
    """Mean softmax cross-entropy over classes; ``batch`` is (images
    (B, H, W, C), labels (B,)). On a ``mesh``: this rank's share of the
    global mean from its rows (``vit_forward``'s mesh path)."""
    if mesh is not None and mesh.shape["sp"] > 1:
        raise ValueError("sp does not apply to vit: presets yet")
    images, labels = batch
    logits = vit_forward(params, images, cfg, mesh)
    lse = torch.logsumexp(logits, dim=-1)
    target = logits.gather(-1, labels[:, None].long())[:, 0]
    loss = (lse - target).mean()
    return loss if mesh is None else loss / mesh.size_of(("dp", "fsdp"))


def vit_synthetic_batch(seed, batch: int, cfg: ViTConfig,
                        row_offset: int = 0, device="cpu"):
    """(images (B, H, W, C) f32 in [0, 1), labels (B,) int64) on
    ``device``. ``seed`` is an int or a tuple of ints (the trainer passes
    its seed and the step). Each GLOBAL row r is drawn from ``(*seed,
    r)`` alone, so a process that makes rows ``[row_offset, row_offset +
    batch)`` gets exactly the rows any other layout would, the JAX
    function's ``fold_in(key, r)`` contract (torch cannot reproduce its
    draws)."""
    key = (seed,) if isinstance(seed, int) else tuple(seed)
    shape = (cfg.image_size, cfg.image_size, cfg.channels)
    images = torch.empty((batch, *shape), device=device)
    labels = torch.empty((batch,), dtype=torch.long, device=device)
    for i in range(batch):
        g = seeded_generator(device, *key, row_offset + i)
        images[i] = torch.rand(shape, generator=g, device=device)
        labels[i] = torch.randint(0, cfg.n_classes, (), generator=g,
                                  device=device)
    return images, labels
