"""Speculative decoding: a cheap draft model proposes, the target verifies
(counterpart of ``tpu_docker_api/infer/speculative.py``).

Greedy speculative decoding with exact verification: each round the
draft proposes ``k`` tokens by single-token cached steps, then the target
runs ONE cached forward over ``[last, p_0 .. p_{k-1}]``. Proposals are
accepted while they equal the target's own argmax; the first disagreement
is replaced by the target's choice (or, when all ``k`` agree, the target's
bonus token is emitted), so the output is the target's greedy decode
whatever the draft proposes: the draft changes speed, never text.

The JAX version is one jitted ``while_loop``; here the rounds are a
Python loop with the same outputs. The host reads one number a round
(the accepted count), which both the loop's end and the next round's
positions need. Rollback is free as there: rejected tokens leave stale
k/v past the accepted position, the causal mask hides every slot past a
query's position, and the next round's writes start at the rewound
position, overwriting the stale range before it can become visible.

Both prefills run through ``prefill_and_first_token`` (the whole-prompt
flash path) into bf16 caches (``init_kv_cache``'s default, as in JAX);
the draft steps and the verify block attend at an offset through
``dense_attention``. Batch 1 and a fixed token budget (no eos), as in
JAX.

Exactness: on the CPU in f32 the tokens equal plain greedy decoding
(tests/test_torch_speculative.py). In bf16 on the card a (k+1)-token
verify and a one-token step round differently, so near-ties of random
weights can resolve differently.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from tpu_docker_api_torch.infer.engine import (init_kv_cache,
                                               prefill_and_first_token)
from tpu_docker_api_torch.models import cached_forward_fn
from tpu_docker_api_torch.models.llama import LlamaConfig


@dataclasses.dataclass(frozen=True)
class SpeculativeConfig:
    max_new_tokens: int = 64
    n_speculative: int = 4        # draft proposals per round (k)
    max_seq: int | None = None    # cache capacity (both models)
    pad_id: int = 0


def make_speculative_generate_fn(
    target_cfg: LlamaConfig,
    draft_cfg: LlamaConfig,
    spec: SpeculativeConfig,
) -> Callable:
    """Build ``(target_params, draft_params, prompt (1, s)) → dict`` with
    {"tokens": (1, max_new_tokens), "rounds": rounds run, "accepted":
    total proposals accepted}. Greedy only — exact argmax verification;
    runs on the prompt's device."""
    k = spec.n_speculative
    if k < 1:
        raise ValueError(f"n_speculative must be >= 1, got {k}")
    budget = spec.max_new_tokens
    if budget < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {budget}")
    tfwd, dfwd = cached_forward_fn(target_cfg), cached_forward_fn(draft_cfg)

    @torch.no_grad()
    def generate(target_params: dict, draft_params: dict,
                 prompt: torch.Tensor) -> dict:
        b, prompt_len = prompt.shape
        if b != 1:
            raise ValueError("speculative decoding runs batch 1")
        max_seq = spec.max_seq or min(target_cfg.max_seq_len,
                                      draft_cfg.max_seq_len)
        # worst-case cache high-water mark: a fully-accepted round ends
        # with the verify block's last slot at prompt_len + budget + k
        if prompt_len + budget + k > max_seq:
            raise ValueError(
                f"prompt ({prompt_len}) + max_new_tokens ({budget}) + "
                f"n_speculative ({k}) exceeds cache capacity {max_seq}")
        dev = prompt.device

        # prefill both; the target's greedy first token is emitted token 0
        t_tok, t_cache = prefill_and_first_token(
            target_params, prompt, target_cfg,
            init_kv_cache(target_cfg, 1, max_seq, device=dev))
        _, d_cache = prefill_and_first_token(
            draft_params, prompt, draft_cfg,
            init_kv_cache(draft_cfg, 1, max_seq, device=dev))
        tk, tv, dk, dv = t_cache.k, t_cache.v, d_cache.k, d_cache.v

        # one slot past the budget: rejected writes land there and drop
        out = torch.full((budget + 1,), spec.pad_id, dtype=torch.long,
                         device=dev)
        out[0] = t_tok[0]
        steps = torch.arange(k + 1, device=dev)
        last = t_tok[0]
        n_out, t_pos, d_pos, rounds, acc = 1, prompt_len, prompt_len, 0, 0
        while n_out < budget:
            # ---- draft: k+1 cached single-token steps from ``last``; k+1
            # (not k) so every proposal lands in the draft cache too; the
            # final output is discarded
            tok, drafted = last, []
            for i in range(k + 1):
                logits, dk, dv = dfwd(draft_params, tok.view(1, 1),
                                      draft_cfg, dk, dv, d_pos + i)
                tok = torch.argmax(logits[0, -1])
                drafted.append(tok)
            d_end = d_pos + k + 1
            proposals = torch.stack(drafted[:k])

            # ---- the target verifies all k in one (k+1)-token step: row
            # = [last, p_0 .. p_{k-1}]; position i's argmax is the
            # target's choice after proposals 0..i-1
            block = torch.cat([last.view(1), proposals]).view(1, k + 1)
            logits, tk, tv = tfwd(target_params, block, target_cfg, tk, tv,
                                  t_pos)
            choices = torch.argmax(logits[0], dim=-1)

            # accept while the target agrees; position n_acc emits the
            # target's correction (the bonus token when all agreed)
            agree = torch.cumprod((proposals == choices[:k]).long(), dim=0)
            n_acc = int(agree.sum())                  # 0..k accepted
            padded = torch.cat([proposals, proposals.new_zeros(1)])
            emitted = torch.where(steps < n_acc, padded, 0)
            emitted = torch.where(steps == n_acc, choices, emitted)
            n_new = min(n_acc + 1, budget - n_out)

            # kept slots are in range and unique; rejected ones scatter to
            # index ``budget``, which is dropped (a clip would make
            # duplicates race a stale read-back at the last slot)
            idx = torch.where(steps < n_new, n_out + steps, budget)
            out[idx] = emitted

            last = emitted[n_new - 1]
            # positions advance by what the caches verifiably hold: the
            # target's gained [last, p_0..p_{n_acc-1}] as history (stale
            # slots above are overwritten next round before they become
            # visible); the draft's the same (it wrote all k+1 inputs)
            t_pos += n_acc + 1
            d_pos = d_end - (k - n_acc)
            n_out += n_new
            rounds += 1
            acc += n_acc
        return {"tokens": out[None, :budget], "rounds": rounds,
                "accepted": acc}

    return generate
