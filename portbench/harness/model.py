"""A configuration file as the port's model config, and its weights.

The configuration files keep the published ``config.json`` keys
(``hidden_size``, ``num_hidden_layers``, …). ``port_config`` maps them
onto the port's model config: the keys every family shares here, the
rest by the family's own file (``portbench/families/<family>.py``, with
``port_config(conf, common)`` and ``ROWS_COUPLED``); ``make_params`` draws the weights from the seed on the device,
one generator a leaf, in the dtype they are served in. The reference
(``portbench/reference``) is handed the same tensors, or draws them
again from the same seed.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.harness import spec
from tpu_docker_api_torch.models import param_dtypes, param_shapes

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def family(conf: dict, portbench=spec.PORTBENCH):
    """The module of the configuration's ``family``."""
    return spec.load_module("families", conf["family"], portbench)


def port_config(conf: dict, *, remat: bool = True,
                portbench=spec.PORTBENCH):
    """The port's config for a configuration file."""
    common = dict(
        vocab_size=conf["vocab_size"], dim=conf["hidden_size"],
        n_layers=conf["num_hidden_layers"],
        n_heads=conf["num_attention_heads"],
        n_kv_heads=conf["num_key_value_heads"],
        ffn_dim=conf["intermediate_size"],
        max_seq_len=conf["max_position_embeddings"],
        rope_theta=float(conf["rope_theta"]),
        norm_eps=float(conf["rms_norm_eps"]),
        dtype=DTYPES[conf["torch_dtype"]], remat=remat)
    if conf["hidden_size"] // conf["num_attention_heads"] != conf["head_dim"]:
        raise ValueError("head_dim must be hidden_size / heads in the port")
    if conf.get("sliding_window") is not None:
        raise ValueError("the port has no sliding window")
    return family(conf, portbench).port_config(conf, common)


def leaf_seed(seed: int, index: int) -> int:
    """A leaf's generator seed from the run's seed and the leaf's place
    in the tree (numpy's SeedSequence mixes them)."""
    state = np.random.SeedSequence([seed & (2**64 - 1), index])
    return int(state.generate_state(1, np.uint64)[0]) & (2**63 - 1)


def _walk(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _walk(v, path)
        else:
            yield path, v


def leaf_paths(cfg) -> list[tuple[str, tuple, torch.dtype]]:
    """(path, shape, dtype) of every leaf, in the tree's order."""
    dtypes = dict(_walk(param_dtypes(cfg)))
    return [(p, tuple(s), dtypes[p]) for p, s in _walk(param_shapes(cfg))]


def draw_leaf(path: str, shape, dtype, seed: int, index: int,
              device) -> torch.Tensor:
    """One leaf: a norm scale 1 + N(0, 0.1²); a matrix N(0, 1/fan_in),
    fan_in its second-to-last dim (the embedding's: the hidden size).
    One call of ``normal_`` on the device, in the leaf's dtype."""
    g = torch.Generator(device=device).manual_seed(leaf_seed(seed, index))
    t = torch.empty(shape, dtype=dtype, device=device)
    name = path.rsplit("/", 1)[-1]
    if "norm" in name:
        return t.normal_(1.0, 0.1, generator=g)
    fan_in = shape[-1] if path.startswith("embed") else shape[-2]
    std = fan_in ** -0.5
    return t.normal_(0.0, std, generator=g)


def make_params(cfg, seed: int, device) -> dict:
    """The port's parameter tree, every leaf drawn by ``draw_leaf``."""
    out: dict = {}
    for i, (path, shape, dtype) in enumerate(leaf_paths(cfg)):
        node = out
        *parents, name = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = draw_leaf(path, shape, dtype, seed, i, device)
    return out


def flat(params: dict) -> dict[str, torch.Tensor]:
    """``{path: leaf}`` of a parameter tree."""
    return dict(_walk(params))


def free(device) -> None:
    """Let go of what the program held on the device."""
    import gc

    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
