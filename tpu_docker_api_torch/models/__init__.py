"""Model families of the port (counterpart of
``tpu_docker_api/models/__init__.py``): the Llama decoder, the
Mixtral-style MoE, the ViT (non-causal encoder, image batches), the
encoder-decoder (cross-attention, seq2seq pairs) and the MNIST MLP
(models/mlp.py, BASELINE config #2, outside the registry as in JAX).

``model_fns(cfg)`` is the trainer's dispatch seam: a config maps to its
(init, loss, sharding rules); a family's ``batch`` is a token tensor for
the decoders, an (images, labels) pair for ViT and a (src, tgt) pair for
the encoder-decoder.
"""

from tpu_docker_api_torch.models.llama import (  # noqa: F401
    LlamaConfig,
    llama_forward,
    llama_forward_cached,
    llama_init,
    llama_loss,
    llama_param_specs,
    llama_presets,
)
from tpu_docker_api_torch.models.mlp import mlp_forward, mlp_init  # noqa: F401
from tpu_docker_api_torch.models.moe import (  # noqa: F401
    MOE_RULES,
    MoEConfig,
    moe_forward,
    moe_forward_cached,
    moe_init,
    moe_loss,
    moe_param_specs,
    moe_presets,
)
from tpu_docker_api_torch.models.vit import (  # noqa: F401
    VIT_RULES,
    ViTConfig,
    vit_forward,
    vit_init,
    vit_loss,
    vit_param_specs,
    vit_presets,
)
from tpu_docker_api_torch.models.encdec import (  # noqa: F401
    ENCDEC_RULES,
    EncDecConfig,
    encdec_forward,
    encdec_init,
    encdec_loss,
    encdec_param_specs,
    encdec_presets,
)


from tpu_docker_api_torch.parallel.sharding import LLAMA_RULES  # noqa: E402

# every dispatch below checks MoEConfig before LlamaConfig, as the JAX
# registry does: should it ever subclass LlamaConfig, it keeps its own

def model_fns(cfg):
    """(init_fn(cfg, generator, place=None), loss_fn(params, batch, cfg,
    mesh=None), sharding_rules): the family's rules of
    parallel/sharding.py (the JAX package's, row for row)."""
    if isinstance(cfg, MoEConfig):
        return moe_init, moe_loss, MOE_RULES
    if isinstance(cfg, LlamaConfig):
        return llama_init, llama_loss, LLAMA_RULES
    if isinstance(cfg, ViTConfig):
        return vit_init, vit_loss, VIT_RULES
    if isinstance(cfg, EncDecConfig):
        return encdec_init, encdec_loss, ENCDEC_RULES
    raise TypeError(f"no model registered for config type {type(cfg)!r}")


def _param_specs(cfg) -> dict:
    if isinstance(cfg, MoEConfig):
        return moe_param_specs(cfg)
    if isinstance(cfg, LlamaConfig):
        return llama_param_specs(cfg)
    if isinstance(cfg, ViTConfig):
        return vit_param_specs(cfg)
    if isinstance(cfg, EncDecConfig):
        return encdec_param_specs(cfg)
    raise TypeError(f"no model registered for config type {type(cfg)!r}")


def _map_specs(fn, spec):
    if isinstance(spec, dict):
        return {k: _map_specs(fn, v) for k, v in spec.items()}
    return fn(spec)


def param_shapes(cfg) -> dict:
    """The param tree of ``cfg`` with each leaf's shape in its place
    (nothing is allocated)."""
    return _map_specs(lambda spec: spec[0], _param_specs(cfg))


def param_dtypes(cfg) -> dict:
    """The param tree of ``cfg`` with each leaf's storage dtype in its
    place: ``cfg.dtype``, except where the family keeps a leaf in another
    (the MoE router is f32: its specs carry a third field)."""
    return _map_specs(lambda spec: spec[2] if len(spec) > 2 else cfg.dtype,
                      _param_specs(cfg))


def cached_forward_fn(cfg):
    """The serving dispatch seam (infer/engine.py, infer/slots.py) of the
    decoder families (the encoder-decoder decodes through
    infer/encdec_slots.py): the KV-cached forward with signature
    ``(params, tokens, cfg, k_cache, v_cache, start_pos, last_only=False,
    kv_limit=None)``."""
    if isinstance(cfg, MoEConfig):
        return moe_forward_cached
    if isinstance(cfg, LlamaConfig):
        return llama_forward_cached
    raise TypeError(f"no cached forward for config type {type(cfg)!r}")


def resolve_preset(spec: str):
    """(family, cfg) from a family-prefixed preset spec, the one parser
    behind the trainer and serve CLIs: "NAME" → llama, "moe:NAME" /
    "vit:NAME" / "encdec:NAME" → that family. An unknown name raises
    KeyError, an unknown family ValueError."""
    family, sep, name = spec.partition(":")
    if not sep:
        return "llama", llama_presets()[spec]
    presets = {"moe": moe_presets, "vit": vit_presets,
               "encdec": encdec_presets}.get(family)
    if presets is None:
        raise ValueError(f"unknown model family {family!r} (llama, moe:, "
                         f"vit:, encdec:)")
    return family, presets()[name]
