"""The arithmetic behind the metric readers (``portbench/metrics``): each
reader file names one metric and calls one function here with the run.
A function returns None where the run has nothing to read: the metric
is then left out of the result line."""

from __future__ import annotations

import math

import numpy as np

from portbench.harness import roofline as rf
from portbench.harness import serve

#: a failed or refused request's latency: it misses every limit
MISS_MS = 1e9


def _pct(values, q: float):
    if not values:
        return None
    v = np.asarray([MISS_MS if not math.isfinite(x) else x for x in values])
    return float(np.percentile(v, q))


def setup_s(run):
    return run.setup_s


def out_tok_s(run):
    """Output tokens that reached the clients in the window, a second."""
    return run.serve["delivered"] / run.serve["window_s"]


def ttft_ms(run, q: float):
    return _pct(run.serve["ttft_ms"], q)


def tpot_ms(run, q: float):
    return _pct(run.serve["tpot_ms"], q)


def train_tok_s(run):
    rec = run.rec
    return rec["steps"] * rec["tokens_per_step"] / (rec["t_end"] - rec["t0"])


def device_idle(run):
    """Share of the traced window with no device operation, in %."""
    if not run.trace:
        return None
    return 100.0 * run.trace["idle_share"]


def flash_train_roofline(run):
    """The three flash kernels of the train step: the sum of their least
    times over the sum of their traced times, in %."""
    t = run.trace
    if not t:
        return None
    conf, mix = run.conf, run.mix
    shape = (int(mix["batch"]), int(mix["seq"]), conf["num_attention_heads"],
             conf["num_key_value_heads"], conf["head_dim"])
    works = {"flash_fwd": rf.flash_fwd_work(*shape),
             "flash_bwd_dq": rf.flash_dq_work(*shape),
             "flash_bwd_dkv": rf.flash_dkv_work(*shape)}
    bound = spent = 0.0
    for cls, (flops, nbytes) in works.items():
        n = t["count_by_class"].get(cls, 0)
        if n == 0 or n != run.launches.get(cls):
            return None
        bound += n * rf.bound_s(flops, nbytes, rf.H100["bf16_flops"])[0]
        spent += t["s_by_class"][cls]
    return 100.0 * bound / spent


def adam8_roofline(run):
    """The adam8 kernel: every leaf's bytes read and written once, over
    its traced time, in %."""
    from portbench.harness.model import leaf_paths, port_config

    t = run.trace
    if not t or not t["count_by_class"].get("adam8"):
        return None
    leaves = leaf_paths(port_config(run.conf, portbench=run.portbench))
    if t["count_by_class"]["adam8"] != run.launches.get("adam8"):
        return None
    steps = run.launches["adam8"] / len(leaves)
    nbytes = sum(rf.adam8_bytes(math.prod(shape), rf.adam8_block(shape[-1]),
                                2 if "bfloat16" in str(dtype) else 4)
                 for _, shape, dtype in leaves)
    bound = steps * nbytes / rf.H100["hbm_bytes_per_s"]
    return 100.0 * bound / t["s_by_class"]["adam8"]


def flash_fwd_roofline(run):
    """The flash forward calls of the traced window, each sized by its
    recorded input shapes: least times over traced time, in %."""
    t = run.trace
    if not t or not t["count_by_class"].get("flash_fwd"):
        return None
    shapes = t["flash_fwd_shapes"]
    if len(shapes) != t["count_by_class"]["flash_fwd"]:
        return None
    bound = 0.0
    for q, k, *_ in shapes:
        b, h, s, d = q
        flops, nbytes = rf.flash_fwd_work(b, s, h, k[1], d)
        bound += rf.bound_s(flops, nbytes, rf.H100["bf16_flops"])[0]
    return 100.0 * bound / t["s_by_class"]["flash_fwd"]


def step_mfu(run):
    """Model operations of every step of the window over the window, as
    a share of the bf16 peak, in %."""
    rec = run.rec
    flops = (rec["steps"] * rec["tokens_per_step"]
             * rf.train_flops_per_token(run.conf, int(run.mix["seq"])))
    return 100.0 * flops / (rec["t_end"] - rec["t0"]) / rf.H100["bf16_flops"]


def serve_mfu(run):
    flops = serve.flops_in_window(run.conf, run.rec)
    return 100.0 * flops / run.serve["window_s"] / rf.H100["bf16_flops"]


def decode_hbm_share(run):
    """Bytes the window's decode steps must read (every weight each
    step, the K/V each delivered token attends) over the window at the
    HBM rate, in %."""
    rec = run.rec
    chunks = rec["stats1"]["decode_chunks"] - rec["stats0"]["decode_chunks"]
    if chunks <= 0:
        return None
    steps = chunks * rec["chunk"]
    ctx = serve.decode_contexts(rec)
    weights = rf.decode_step_bytes(run.conf, [])
    kv = rf.decode_step_bytes(run.conf, [1]) - weights
    nbytes = steps * weights + kv * float(ctx.sum())
    return 100.0 * nbytes / run.serve["window_s"] / rf.H100["hbm_bytes_per_s"]


def rows_per_step(run):
    """Decode tokens delivered in the window over the decode steps run
    in it: the rows a step serves."""
    rec = run.rec
    chunks = rec["stats1"]["decode_chunks"] - rec["stats0"]["decode_chunks"]
    if chunks <= 0:
        return None
    decode_tokens = len(serve.decode_contexts(rec))
    return decode_tokens / (chunks * rec["chunk"])


def batch_wait_ms(run):
    """Host time waiting for the loader's batch, a step, in ms."""
    waits = run.rec["batch_wait_s"]
    return 1e3 * sum(waits) / len(waits) if waits else None
