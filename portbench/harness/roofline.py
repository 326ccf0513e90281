"""The yardstick: the card's peaks, and the operations and bytes that a
kernel call, a model token or a decode step needs, counted from shapes.

Peaks are NVIDIA's H100 SXM data sheet's dense rates at the 700 W limit
(989 TFLOP/s in bf16, 67 TFLOP/s in f32 outside the tensor cores,
3.35 TB/s of HBM3). A share of a roofline is the least time the card
could take, the larger of operations over peak and bytes over bandwidth,
over the time the trace measured. Bytes count each input read once and
each output written once; causal attention counts the ``s(s+1)/2``
visible pairs of its input.
"""

from __future__ import annotations

#: every share is taken against these, with the card's power limit
#: written beside it
H100 = {"bf16_flops": 989e12, "f32_flops": 67e12, "hbm_bytes_per_s": 3.35e12}


def bound_s(flops: float, nbytes: float, flops_peak: float,
            bytes_peak: float = H100["hbm_bytes_per_s"]) -> tuple[float, str]:
    """(least seconds, "operations" or "bytes")."""
    t_ops, t_bytes = flops / flops_peak, nbytes / bytes_peak
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _pairs(s: int, causal: bool) -> int:
    return s * (s + 1) // 2 if causal else s * s


def flash_fwd_work(b: int, s: int, h: int, hk: int, d: int, esize: int = 2,
                   causal: bool = True) -> tuple[float, float]:
    """(operations, bytes) of one forward call: QKᵀ and PV, 4d a visible
    pair; q, k, v read, out written, lse (f32) written."""
    flops = 4 * d * b * h * _pairs(s, causal)
    nbytes = esize * b * s * d * (2 * h + 2 * hk) + 4 * b * h * s
    return float(flops), float(nbytes)


def flash_dq_work(b, s, h, hk, d, esize=2, causal=True):
    """(operations, bytes) of the dq kernel: scores, dP, dQ (6d a pair);
    reads q, k, v, out, dout, lse; writes dq and D (f32)."""
    q_bytes, kv_bytes, stat = b * h * s * d * esize, b * hk * s * d * esize, \
        b * h * s * 4
    return (float(6 * d * b * h * _pairs(s, causal)),
            float(4 * q_bytes + 2 * kv_bytes + 2 * stat))


def flash_dkv_work(b, s, h, hk, d, esize=2, causal=True):
    """(operations, bytes) of the dk/dv kernel: scores, dP, dV, dK (8d a
    pair); reads q, k, v, dout, lse, D; writes dk and dv."""
    q_bytes, kv_bytes, stat = b * h * s * d * esize, b * hk * s * d * esize, \
        b * h * s * 4
    return (float(8 * d * b * h * _pairs(s, causal)),
            float(2 * q_bytes + 4 * kv_bytes + 2 * stat))


def adam8_bytes(n: int, block: int, esize: int = 2) -> float:
    """Bytes of one adam8 call on a leaf of ``n`` elements: g, p read
    and the update written in the leaf's dtype; both int8 moments read
    and written; four f32 scales a block (two read, two written)."""
    return float((3 * esize + 4) * n + 16 * (n // block))


def adam8_block(last_dim: int, block: int = 256) -> int:
    """The quantization block of a leaf: the largest ``b <= block`` that
    divides its last dim (the optimizer's rule)."""
    b = min(block, last_dim)
    while last_dim % b:
        b -= 1
    return b


def matmul_params(conf: dict) -> dict:
    """Parameters a token multiplies by, from a configuration file:
    ``attn`` (q, k, v, o) and ``ffn`` a layer (all experts' for MoE,
    ``ffn_active`` the ones a token fires), ``router`` a layer, ``head``."""
    d, f = conf["hidden_size"], conf["intermediate_size"]
    h, hk, hd = (conf["num_attention_heads"], conf["num_key_value_heads"],
                 conf["head_dim"])
    attn = d * h * hd * 2 + d * hk * hd * 2
    e = conf.get("num_local_experts", 1)
    k = conf.get("num_experts_per_tok", 1)
    return {"attn": attn, "ffn": 3 * d * f * e, "ffn_active": 3 * d * f * k,
            "router": d * e if "num_local_experts" in conf else 0,
            "head": d * conf["vocab_size"]}


def forward_flops(conf: dict, context: float) -> float:
    """Forward operations of one token that attends ``context`` earlier
    positions and itself: 2 a multiply-add of every matrix it fires, and
    QKᵀ and PV over the attended positions."""
    p = matmul_params(conf)
    layer = 2 * (p["attn"] + p["ffn_active"] + p["router"])
    attn = 4 * conf["num_attention_heads"] * conf["head_dim"] * context
    return conf["num_hidden_layers"] * (layer + attn) + 2 * p["head"]


def train_flops_per_token(conf: dict, seq: int) -> float:
    """Training operations a token (forward and backward, 3x the
    forward's matrix products), causal attention over half the sequence:
    a frozen copy of the port's ``flops_per_token``."""
    p = matmul_params(conf)
    d, h, hd = conf["hidden_size"], conf["num_attention_heads"], \
        conf["head_dim"]
    del d
    per_layer = 2 * (p["attn"] + p["ffn_active"] + p["router"])
    fwd = conf["num_hidden_layers"] * per_layer + 2 * p["head"]
    attn = conf["num_hidden_layers"] * 2 * 2 * seq * (h * hd) / 2
    return 3.0 * (fwd + attn)


def prefill_flops(conf: dict, n: int) -> float:
    """Forward operations of a prompt of ``n`` tokens (causal)."""
    p = matmul_params(conf)
    layer = 2 * (p["attn"] + p["ffn_active"] + p["router"])
    attn = 4 * conf["num_attention_heads"] * conf["head_dim"] * n * (n + 1) / 2
    return conf["num_hidden_layers"] * (n * layer + attn) + 2 * p["head"]


def decode_step_bytes(conf: dict, contexts, esize: int = 2) -> float:
    """Bytes one decode step over ``contexts`` (each row's attended
    length) must read: every layer's weights (a batch of 128 rows reaches
    every expert), the K/V the rows attend, one embedding row and the
    head."""
    p = matmul_params(conf)
    L = conf["num_hidden_layers"]
    weights = L * (p["attn"] + p["ffn"] + p["router"]) + p["head"]
    kv = 2 * L * conf["num_key_value_heads"] * conf["head_dim"]
    rows = len(contexts)
    return float(esize * (weights + kv * sum(contexts)
                          + rows * conf["hidden_size"]))
