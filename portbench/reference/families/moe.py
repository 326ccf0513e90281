"""Mixtral's sparse block: softmax over the router's logits, the top
``num_experts_per_tok`` experts, their probabilities renormalised to sum
to 1, each expert a SwiGLU.

With ``capacity`` (the rule the configuration file states for a
prompt's forward: ``assumed.capacity_rule``) an expert takes at most
``C = ceil(top_k · t · capacity_factor / E)`` of the ``t`` tokens of
one forward, pad tokens included; places are given in order of the
choice (every first choice before any second), then of the token
(row-major), and a choice without a place adds nothing. Without it
(decode) every choice counts.
"""

import math

import torch


def ffn(dec, x, w, capacity: bool):
    """``x`` (t, d) → (t, d) under the rule."""
    t = x.shape[0]
    E, K = dec.c["num_local_experts"], dec.c["num_experts_per_tok"]
    probs = torch.softmax(dec.mm(x, w("layers/moe/router")), dim=-1)
    vals, idx = torch.topk(probs, K, dim=-1)
    gates = vals / vals.sum(-1, keepdim=True)
    keep = torch.ones_like(gates, dtype=torch.bool)
    if capacity:
        cf = float(dec.c["assumed"]["capacity_factor"])
        cap = max(1, math.ceil(K * t * cf / E))
        order = idx.transpose(0, 1).reshape(-1)           # choice-major
        place = torch.zeros_like(order)
        for e in range(E):
            sel = order == e
            place[sel] = torch.arange(int(sel.sum()), device=x.device)
        keep = (place < cap).reshape(K, t).transpose(0, 1)
    out = torch.zeros_like(x)
    for e in range(E):
        tok, choice = torch.nonzero((idx == e) & keep, as_tuple=True)
        if tok.numel() == 0:
            continue
        y = dec.swiglu(x[tok], w("layers/moe/w_gate", e),
                       w("layers/moe/w_up", e), w("layers/moe/w_down", e))
        out.index_add_(0, tok, y * gates[tok, choice, None])
    return out
