"""Model families of the port (counterpart of
``tpu_docker_api/models/__init__.py``). Only the Llama family is ported
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

_NOT_PORTED = ("moe", "vit", "encdec")


def model_fns(cfg):
    """(init_fn(cfg, generator), loss_fn(params, tokens, cfg),
    sharding_rules). The port has no sharding rules yet: None."""
    if isinstance(cfg, LlamaConfig):
        return llama_init, llama_loss, None
    raise TypeError(f"no model registered for config type {type(cfg)!r}")


def param_shapes(cfg) -> dict:
    """The param tree of ``cfg`` with each leaf's shape in its place
    (nothing is allocated)."""
    if isinstance(cfg, LlamaConfig):
        def shapes(spec):
            if isinstance(spec, dict):
                return {k: shapes(v) for k, v in spec.items()}
            return spec[0]

        return shapes(llama_param_specs(cfg))
    raise TypeError(f"no model registered for config type {type(cfg)!r}")


def cached_forward_fn(cfg):
    """The serving dispatch seam (infer/engine.py, infer/slots.py): the
    KV-cached forward with signature ``(params, tokens, cfg, k_cache,
    v_cache, start_pos, last_only=False, kv_limit=None)``."""
    if isinstance(cfg, LlamaConfig):
        return llama_forward_cached
    raise TypeError(f"no cached forward for config type {type(cfg)!r}")


def resolve_preset(spec: str):
    """(family, cfg) from a family-prefixed preset spec: "NAME" → llama;
    "moe:NAME" / "vit:NAME" / "encdec:NAME" are not yet ported."""
    family, sep, _ = spec.partition(":")
    if sep and family in _NOT_PORTED:
        raise ValueError(f"{family} presets are not yet ported to the "
                         f"PyTorch package")
    return "llama", llama_presets()[spec]
