"""The yardstick's counts against PERF.md §6's "Bound ms" column (H100
80GB HBM3 at 700 W; the column's shapes: s = 2048, 32/8 heads, d = 64,
bf16, causal; adam8 the mean of llama3-1b's 12 leaves, and the MoE
leaves), and the frozen operation counts against the shapes' own."""

import math

import pytest

from portbench.harness import roofline as rf

PEAK = rf.H100["bf16_flops"]


def ms(flops, nbytes, peak=PEAK):
    return rf.bound_s(flops, nbytes, peak)[0] * 1e3


@pytest.mark.parametrize("R,want", [(1, 0.01738), (4, 0.06952)])
def test_flash_fwd_bound(R, want):
    flops, nbytes = rf.flash_fwd_work(R, 2048, 32, 8, 64)
    assert rf.bound_s(flops, nbytes, PEAK)[1] == "operations"
    assert ms(flops, nbytes) == pytest.approx(want, rel=5e-4)


@pytest.mark.parametrize("fn,want", [(rf.flash_dq_work, 0.1043),
                                     (rf.flash_dkv_work, 0.1390)])
def test_flash_bwd_bounds(fn, want):
    assert ms(*fn(4, 2048, 32, 8, 64)) == pytest.approx(want, rel=5e-4)


LLAMA3_1B = [(128256, 2048), (16, 2048), (16, 2048), (16, 2048, 2048),
             (16, 2048, 512), (16, 2048, 512), (16, 2048, 2048),
             (16, 2048, 8192), (16, 2048, 8192), (16, 8192, 2048), (2048,),
             (2048, 128256)]


def adam8_ms(shape, esize=2):
    n = math.prod(shape)
    return rf.adam8_bytes(n, rf.adam8_block(shape[-1]), esize) \
        / rf.H100["hbm_bytes_per_s"] * 1e3


def test_adam8_bound_mean_of_llama3_1b():
    mean = sum(adam8_ms(s) for s in LLAMA3_1B) / len(LLAMA3_1B)
    assert mean == pytest.approx(0.3751, rel=5e-4)


@pytest.mark.parametrize("shape,esize,want", [
    ((4, 4096, 8), 4, 0.000704),            # the f32 router, b = 8
    ((8, 4096, 14336), 2, 1.4110),          # one layer's w_gate
])
def test_adam8_bound_moe_leaves(shape, esize, want):
    assert adam8_ms(shape, esize) == pytest.approx(want, rel=2e-3)


MISTRAL = {"vocab_size": 32768, "hidden_size": 4096,
           "intermediate_size": 14336, "num_hidden_layers": 32,
           "num_attention_heads": 32, "num_key_value_heads": 8,
           "head_dim": 128}
MIXTRAL = {**MISTRAL, "vocab_size": 32000, "num_hidden_layers": 16,
           "num_local_experts": 8, "num_experts_per_tok": 2}


def test_train_flops_per_token_is_the_ports():
    from tpu_docker_api_torch.models import LlamaConfig, MoEConfig

    dense = LlamaConfig(vocab_size=32768, dim=4096, n_layers=32, n_heads=32,
                        n_kv_heads=8, ffn_dim=14336)
    moe = MoEConfig(vocab_size=32000, dim=4096, n_layers=16, n_heads=32,
                    n_kv_heads=8, ffn_dim=14336)
    assert rf.train_flops_per_token(MISTRAL, 4096) == pytest.approx(
        dense.flops_per_token(4096), rel=1e-12)
    assert rf.train_flops_per_token(MIXTRAL, 2048) == pytest.approx(
        moe.flops_per_token(2048), rel=1e-12)
    # 45.9 GFLOP a token at s = 4096
    assert rf.train_flops_per_token(MISTRAL, 4096) == pytest.approx(
        45.9e9, rel=5e-3)


def test_prefill_is_the_sum_of_its_tokens():
    n = 37
    per_token = sum(rf.forward_flops(MISTRAL, i) for i in range(1, n + 1))
    head = 2 * MISTRAL["hidden_size"] * MISTRAL["vocab_size"]
    assert rf.prefill_flops(MISTRAL, n) == pytest.approx(
        per_token - (n - 1) * head, rel=1e-12)


def test_decode_step_reads_all_experts():
    w = rf.decode_step_bytes(MIXTRAL, [])
    params = 16 * (4096 * 4096 * 2 + 4096 * 1024 * 2 + 8 * 3 * 4096 * 14336
                   + 4096 * 8) + 4096 * 32000
    assert w == 2 * params
    assert w / 1e9 == pytest.approx(46.7, abs=0.1)
    kv = rf.decode_step_bytes(MIXTRAL, [1000]) - w
    assert kv == 2 * 1000 * 2 * 16 * 8 * 128 + 2 * 4096


def test_shares_cannot_pass_100_percent_by_construction():
    flops, nbytes = rf.flash_fwd_work(4, 4096, 32, 8, 128)
    t, by = rf.bound_s(flops, nbytes, PEAK)
    assert by == "operations" and t > 0
