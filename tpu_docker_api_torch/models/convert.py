"""Weights carried across between the JAX package and the port.

torch cannot reproduce ``jax.random`` initialisation, so parameters
cross as numpy arrays: the JAX param pytree of any family (Llama, MoE,
ViT, the encoder-decoder, the MLP: stacked ``(n_layers, …)`` leaves,
named as in ``tpu_docker_api/models/``) maps onto the port's param dict
1:1, leaf for leaf, and so does its optimizer state. An int8 leaf (the JAX
``QuantizedLinear``, its children as numpy arrays) becomes the port's
``QuantizedLinear`` of the same int8 weights and f32 scales, and a LoRA
leaf (the JAX ``LoraLinear``) the port's ``LoraLinear``.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_docker_api_torch.ops.quant import LoraLinear, QuantizedLinear


def _to_tensor(arr, device, dtype):
    arr = np.array(arr)  # a writable copy: JAX hands out read-only views
    if arr.dtype.name == "bfloat16":
        # numpy's bfloat16 (ml_dtypes) has no torch counterpart in
        # from_numpy: move the raw 16-bit words and reinterpret them
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(tree, device, dtype: torch.dtype | None = None):
    """Map a nested dict of numpy arrays (e.g. a JAX param pytree after
    ``np.asarray`` on each leaf) to torch tensors on ``device``.
    ``dtype`` casts the floating-point leaves; None keeps each leaf's.
    An int8 leaf (anything with ``w_int8`` and ``scale``, such as the
    JAX ``QuantizedLinear``) keeps its int8 weights and f32 scales; a
    LoRA leaf (``base``, ``a``, ``b``, ``scale``) maps its base as any
    leaf and keeps its adapters' dtype and its scale."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype)
                for k, v in tree.items()}
    if all(hasattr(tree, f) for f in ("base", "a", "b", "scale")):
        return LoraLinear(params_from_numpy(tree.base, device, dtype),
                          _to_tensor(tree.a, device, None),
                          _to_tensor(tree.b, device, None),
                          float(tree.scale))
    if hasattr(tree, "w_int8") and hasattr(tree, "scale"):
        return QuantizedLinear(_to_tensor(tree.w_int8, device, None),
                               _to_tensor(tree.scale, device, None))
    return _to_tensor(tree, device, dtype)


def opt_state_from_numpy(state, device):
    """Map a JAX optimizer state (its leaves as numpy arrays; the tuples
    and named tuples as optax and the JAX package build them) onto the
    port's: optax's ``ScaleByAdamState`` (count, mu, nu) and the JAX
    ``ScaleByAdamInt8State``, whose scales go from the JAX layout to the
    port's (``optim.scales_from_jax``); field-less states (the clip's,
    the weight decay's, the learning rate's) become ``EmptyState``.
    ``count`` becomes a host int; every leaf keeps its dtype."""
    from tpu_docker_api_torch.train import optim

    kind = type(state).__name__
    fields = getattr(state, "_fields", None)
    if kind == "ScaleByAdamState":
        return optim.ScaleByAdamState(
            int(state.count), params_from_numpy(state.mu, device),
            params_from_numpy(state.nu, device))
    if kind == "ScaleByAdamInt8State":
        def scales(tree):
            if isinstance(tree, dict):
                return {k: scales(v) for k, v in tree.items()}
            return optim.scales_from_jax(
                _to_tensor(tree, "cpu", None)).contiguous().to(device)

        return optim.ScaleByAdamInt8State(
            int(state.count), params_from_numpy(state.mu_q, device),
            scales(state.mu_scale), params_from_numpy(state.nu_q, device),
            scales(state.nu_scale))
    if fields is not None and not fields:
        return optim.EmptyState()
    if isinstance(state, tuple) and fields is None:
        return tuple(opt_state_from_numpy(s, device) for s in state)
    raise TypeError(f"no port counterpart for optimizer state {kind}")


def params_to_numpy(params):
    """The inverse map: a nested dict of numpy arrays on the host.
    bf16 leaves come back as float32 (exact: every bf16 is an f32), since
    numpy has no bfloat16 of its own. An int8 leaf comes back as a
    ``QuantizedLinear`` of numpy arrays."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    if isinstance(params, QuantizedLinear):
        return QuantizedLinear(params_to_numpy(params.w_int8),
                               params_to_numpy(params.scale))
    t = params.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()
