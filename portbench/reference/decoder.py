"""Plain float32 reference of the Mistral / Mixtral decoder.

The published equations (Mistral-7B, Mixtral-8x7B; Hugging Face's
``modeling_mistral`` / ``modeling_mixtral``), written out with plain
``torch`` operations, with no kernel, cache manager or batching of the
program under test:

- RMSNorm ``x · rsqrt(mean(x²) + eps) · w``;
- rotary embedding on split halves (``rotate_half``), θ from the config;
- grouped-query attention, head ``j`` reading kv head ``j // (h / hk)``,
  scores scaled by ``1/sqrt(head_dim)``, causal over absolute positions;
- SwiGLU ``(silu(x W_gate) ∘ x W_up) W_down``;
- the feed-forward block of the configuration's ``family``, from
  ``families/<family>.py`` (``ffn(dec, x, w, capacity)``): the dense
  SwiGLU (``llama``) or Mixtral's sparse block (``moe``).

Weights are the benchmark's own tensors, in the port's layout
(``x @ W``: a matrix is (in, out), stacked over layers), upcast a layer
at a time. TF32 is off. ``precision="fp8"`` is the control: every matrix
product's operands are rounded to float8 e4m3 (per-column scale for the
weight, per-row for the activation) before an f32 product.
"""

from __future__ import annotations

import importlib.util
import math
from pathlib import Path

import torch
import torch.nn.functional as F

FAMILIES = Path(__file__).resolve().parent / "families"


def load_family(name: str, directory: Path = FAMILIES):
    """The reference module of a configuration's ``family``, by path."""
    path = Path(directory) / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reference for family {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(
        f"portbench_reference_family_{name.replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def tf32_off() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale along ``dim`` (the
    gradient passes the rounding unchanged)."""
    with torch.no_grad():
        amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30)
        scale = amax / 448.0
        low = (x / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (low - x).detach()


class Decoder:
    """The reference over a flat ``{path: tensor}`` of weights (the
    harness's, in the port's tree layout) and a configuration file."""

    def __init__(self, conf: dict, weights: dict, precision: str = "f32",
                 q_chunk: int = 1024, families: Path = FAMILIES):
        tf32_off()
        self.c = conf
        self.w = weights
        self.precision = precision
        self.q_chunk = q_chunk
        self.L = conf["num_hidden_layers"]
        self.h = conf["num_attention_heads"]
        self.hk = conf["num_key_value_heads"]
        self.hd = conf["head_dim"]
        self.eps = float(conf["rms_norm_eps"])
        self.family = load_family(conf["family"], families)

    # ---- pieces ----------------------------------------------------------

    def _get(self, path: str, *index: int) -> torch.Tensor:
        t = self.w[path]
        for i in index:
            t = t[i]
        return t.float()

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.precision == "fp8":
            return _fp8(x, -1) @ _fp8(w, -2)
        return x @ w

    def norm(self, x, w):
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + self.eps) * w

    def rope(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """x (b, s, heads, hd), pos (b, s) absolute positions."""
        half = self.hd // 2
        inv = 1.0 / (float(self.c["rope_theta"]) ** (
            torch.arange(0, self.hd, 2, device=x.device,
                         dtype=torch.float64) / self.hd))
        ang = (pos.double()[..., None] * inv).float()[:, :, None, :]
        cos, sin = torch.cos(ang), torch.sin(ang)
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    def attend(self, q, k, v, q_pos, k_pos):
        """q (b, s, h, hd); k, v (b, t, hk, hd); q_pos (s,), k_pos (t,):
        causal softmax attention, computed a query chunk at a time."""
        b, s = q.shape[:2]
        g = self.h // self.hk
        out = torch.empty_like(q)
        scale = 1.0 / math.sqrt(self.hd)
        for i in range(b):
            kk = k[i].transpose(0, 1)                     # (hk, t, hd)
            vv = v[i].transpose(0, 1)
            for s0 in range(0, s, self.q_chunk):
                qq = q[i, s0:s0 + self.q_chunk].transpose(0, 1)
                qq = qq.reshape(self.hk, g, -1, self.hd)   # (hk, g, c, hd)
                sc = torch.einsum("hgcd,htd->hgct", qq, kk) * scale
                mask = k_pos[None, :] <= q_pos[s0:s0 + self.q_chunk, None]
                sc = sc.masked_fill(~mask, float("-inf"))
                p = torch.softmax(sc, dim=-1)
                o = torch.einsum("hgct,htd->hgcd", p, vv)
                out[i, s0:s0 + self.q_chunk] = o.reshape(
                    self.h, -1, self.hd).transpose(0, 1)
        return out

    def swiglu(self, x, wg, wu, wd):
        return self.mm(F.silu(self.mm(x, wg)) * self.mm(x, wu), wd)

    def ffn(self, x: torch.Tensor, w, capacity: bool) -> torch.Tensor:
        """The family's feed-forward block over ``x`` (t, d); ``w(path,
        *index)`` gives one layer's weight (f32)."""
        return self.family.ffn(self, x, w, capacity)

    # ---- forward ----------------------------------------------------------

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor, past=None, start: int = 0,
                capacity: bool = False, rows=None, logits_at=None):
        """``tokens`` (b, s) at positions ``start..start+s-1`` after the
        K/V ``past`` (a list of per-layer (k, v), each (b, start, hk,
        hd), or None). Returns (logits (b, len(logits_at), vocab) at the
        positions ``logits_at`` (indices into ``s``, default all), the
        K/V of ``rows`` (default all) for positions ``0..start+s-1``)."""
        b, s = tokens.shape
        dev = tokens.device
        x = self.w["embed/tokens"][tokens].float()
        pos = torch.arange(start, start + s, device=dev)
        k_pos = torch.arange(start + s, device=dev)
        rows = list(range(b)) if rows is None else rows
        kv_out = []
        for i in range(self.L):
            h = self.norm(x, self._get("layers/attn_norm", i))
            q = self.mm(h, self._get("layers/attn/wq", i)).reshape(
                b, s, self.h, self.hd)
            k = self.mm(h, self._get("layers/attn/wk", i)).reshape(
                b, s, self.hk, self.hd)
            v = self.mm(h, self._get("layers/attn/wv", i)).reshape(
                b, s, self.hk, self.hd)
            q = self.rope(q, pos.expand(b, s))
            k = self.rope(k, pos.expand(b, s))
            if past is not None:
                k = torch.cat([past[i][0], k], dim=1)
                v = torch.cat([past[i][1], v], dim=1)
            kv_out.append((k[rows], v[rows]))
            o = self.attend(q, k, v, pos, k_pos)
            x = x + self.mm(o.reshape(b, s, -1), self._get("layers/attn/wo", i))
            h = self.norm(x, self._get("layers/mlp_norm", i))
            x = x + self.ffn(h.reshape(b * s, -1),
                             lambda path, *ix, i=i: self._get(path, i, *ix),
                             capacity).reshape(b, s, -1)
        if logits_at is not None:
            x = x[:, logits_at]
        x = self.norm(x, self._get("final_norm"))
        return self.mm(x, self._get("lm_head")), kv_out


def served_logits(dec: Decoder, prompt, served, group=None, row=0,
                  device="cpu") -> torch.Tensor:
    """Reference logits (n, vocab) at the positions that produced each of
    the ``n`` served tokens of one request: the prompt's last position,
    then each served token but the last fed back. ``group`` (R, S): the
    padded rows of the prompt's prefill forward, this request's at
    ``row``, for the capacity rule (MoE); None: the prompt alone."""
    L = len(prompt)
    if group is None:
        group, row = torch.tensor([prompt], device=device), 0
    logit0, kv = dec.forward(group, capacity=True, rows=[row],
                             logits_at=[L - 1])
    past = [(k[:, :L], v[:, :L]) for k, v in kv]
    out = [logit0[row]]
    if len(served) > 1:
        cont = torch.tensor([served[:-1]], device=device)
        more, _ = dec.forward(cont, past=past, start=L, capacity=False)
        out.append(more[0])
    return torch.cat(out, dim=0)
