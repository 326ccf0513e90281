"""Model families of the port (counterpart of
``tpu_docker_api/models/__init__.py``): Llama and the Mixtral-style MoE
so far; the other families' presets raise "not yet ported"."""

from tpu_docker_api_torch.models.llama import (  # noqa: F401
    LlamaConfig,
    llama_forward,
    llama_forward_cached,
    llama_init,
    llama_loss,
    llama_param_specs,
    llama_presets,
)
from tpu_docker_api_torch.models.moe import (  # noqa: F401
    MoEConfig,
    moe_forward,
    moe_forward_cached,
    moe_init,
    moe_loss,
    moe_param_specs,
    moe_presets,
)

_NOT_PORTED = ("vit", "encdec")


# every dispatch below checks MoEConfig before LlamaConfig, as the JAX
# registry does: should it ever subclass LlamaConfig, it keeps its own

def model_fns(cfg):
    """(init_fn(cfg, generator), loss_fn(params, tokens, cfg),
    sharding_rules). The port has no sharding rules yet: None."""
    if isinstance(cfg, MoEConfig):
        return moe_init, moe_loss, None
    if isinstance(cfg, LlamaConfig):
        return llama_init, llama_loss, None
    raise TypeError(f"no model registered for config type {type(cfg)!r}")


def _param_specs(cfg) -> dict:
    if isinstance(cfg, MoEConfig):
        return moe_param_specs(cfg)
    if isinstance(cfg, LlamaConfig):
        return llama_param_specs(cfg)
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
    (the MoE router is f32)."""
    return _map_specs(lambda spec: spec[2] if len(spec) > 2 else cfg.dtype,
                      _param_specs(cfg))


def cached_forward_fn(cfg):
    """The serving dispatch seam (infer/engine.py, infer/slots.py): the
    KV-cached forward with signature ``(params, tokens, cfg, k_cache,
    v_cache, start_pos, last_only=False, kv_limit=None)``."""
    if isinstance(cfg, MoEConfig):
        return moe_forward_cached
    if isinstance(cfg, LlamaConfig):
        return llama_forward_cached
    raise TypeError(f"no cached forward for config type {type(cfg)!r}")


def resolve_preset(spec: str):
    """(family, cfg) from a family-prefixed preset spec: "NAME" → llama,
    "moe:NAME" → moe; "vit:NAME" / "encdec:NAME" are not yet ported."""
    family, sep, name = spec.partition(":")
    if sep and family in _NOT_PORTED:
        raise ValueError(f"{family} presets are not yet ported to the "
                         f"PyTorch package")
    if sep and family == "moe":
        return "moe", moe_presets()[name]
    return "llama", llama_presets()[spec]
