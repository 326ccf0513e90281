"""Plain float32 reference of a Mistral training step under AdamW with
int8 moments, and of the batches the loader feeds it.

- The loss: the mean next-token cross-entropy of the decoder
  (``decoder.py``'s equations) over ``tokens[:, 1:]`` from
  ``tokens[:, :-1]``, with autograd, each layer checkpointed and the
  attention computed a query block at a time (its backward recomputes
  each block's probabilities from the saved log-sum-exp).
- The update (``adamw_int8``'s semantics, frozen here): the gradients
  clipped to a global norm (``g · c/‖g‖`` where ``‖g‖ >= c``); each
  moment kept as int8 with one f32 scale per block of ``b <= 256``
  elements along the leaf's last dim (``b`` the largest such divisor),
  ``m`` linear and ``v`` in the square-root domain; ``m = b1·m + (1-b1)·g``,
  ``v = b2·v + (1-b2)·g²`` from the dequantized moments;
  ``p += -lr·(m/(1-b1^t) / (sqrt(v/(1-b2^t)) + eps) + wd·p)``, computed
  in f32 and stored in the parameters' dtype as the configuration
  states it (``torch_dtype``): an update under half a unit in the last
  place of a bf16 weight leaves it where it was.
- The batches: window ``w = (a·pos + seed + epoch) mod n`` of the token
  file for position ``p = step·B + row`` (``epoch, pos = divmod(p, n)``,
  ``a`` the first odd number coprime to ``n`` from
  ``0x9E3779B1·(seed + 1) mod n``): the loader's documented order.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference.decoder import FAMILIES, Decoder, tf32_off


def _coprime_stride(n: int, seed: int) -> int:
    if n == 1:
        return 1
    a = ((0x9E3779B1 * (seed + 1)) % n) | 1
    while math.gcd(a, n) != 1:
        a = (a + 2) % n or 1
    return a


def batch(tokens: np.ndarray, window: int, global_batch: int, seed: int,
          step: int) -> np.ndarray:
    """The (B, window) int64 rows of ``step`` from a flat token array."""
    n = tokens.size // window
    a = _coprime_stride(n, seed)
    out = np.empty((global_batch, window), np.int64)
    for row in range(global_batch):
        epoch, pos = divmod(step * global_batch + row, n)
        w = (a * pos + seed + epoch) % n
        out[row] = tokens[w * window:(w + 1) * window]
    return out


class _Attention(torch.autograd.Function):
    """Causal GQA attention, a query block at a time, f32."""

    @staticmethod
    def forward(ctx, q, k, v, block):
        b, s, h, d = q.shape
        hk = k.shape[2]
        g = h // hk
        scale = 1.0 / math.sqrt(d)
        out = torch.empty_like(q)
        lse = torch.empty((b, h, s), device=q.device)
        for i in range(b):
            kk, vv = k[i].transpose(0, 1), v[i].transpose(0, 1)
            for s0 in range(0, s, block):
                qq = q[i, s0:s0 + block].transpose(0, 1).reshape(hk, g, -1, d)
                sc = torch.einsum("hgcd,htd->hgct", qq, kk[:, :s0 + block])
                sc = sc * scale
                qpos = torch.arange(s0, s0 + qq.shape[2], device=q.device)
                kpos = torch.arange(sc.shape[-1], device=q.device)
                sc = sc.masked_fill(kpos[None, :] > qpos[:, None],
                                    float("-inf"))
                m = torch.logsumexp(sc, dim=-1)
                p = torch.exp(sc - m[..., None])
                o = torch.einsum("hgct,htd->hgcd", p, vv[:, :s0 + block])
                out[i, s0:s0 + block] = o.reshape(h, -1, d).transpose(0, 1)
                lse[i, :, s0:s0 + block] = m.reshape(h, -1)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.block = block
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        block = ctx.block
        b, s, h, d = q.shape
        hk = k.shape[2]
        g = h // hk
        scale = 1.0 / math.sqrt(d)
        dq, dk, dv = (torch.zeros_like(t) for t in (q, k, v))
        for i in range(b):
            kk, vv = k[i].transpose(0, 1), v[i].transpose(0, 1)
            for s0 in range(0, s, block):
                c = min(block, s - s0)
                t = s0 + c
                qq = q[i, s0:t].transpose(0, 1).reshape(hk, g, c, d)
                do = dout[i, s0:t].transpose(0, 1).reshape(hk, g, c, d)
                oo = out[i, s0:t].transpose(0, 1).reshape(hk, g, c, d)
                m = lse[i, :, s0:t].reshape(hk, g, c)
                sc = torch.einsum("hgcd,htd->hgct", qq, kk[:, :t]) * scale
                qpos = torch.arange(s0, t, device=q.device)
                kpos = torch.arange(t, device=q.device)
                p = torch.exp(sc - m[..., None]).masked_fill(
                    kpos[None, :] > qpos[:, None], 0.0)
                dv[i, :t] += torch.einsum("hgct,hgcd->htd", p,
                                          do).transpose(0, 1)
                dp = torch.einsum("hgcd,htd->hgct", do, vv[:, :t])
                delta = (do * oo).sum(-1, keepdim=True)
                ds = p * (dp - delta) * scale
                dq[i, s0:t] = torch.einsum("hgct,htd->hgcd", ds, kk[:, :t]
                                           ).reshape(h, c, d).transpose(0, 1)
                dk[i, :t] += torch.einsum("hgct,hgcd->htd", ds,
                                          qq).transpose(0, 1)
        return dq, dk, dv, None


class TrainReference(Decoder):
    """The decoder's loss with autograd, over f32 parameters."""

    def __init__(self, conf: dict, params: dict, block: int = 1024,
                 precision: str = "f32", families: Path = FAMILIES):
        super().__init__(conf, params, precision=precision,
                         families=families)
        self.block = block

    def _layer(self, x, i, p):
        b, s, _ = x.shape
        pos = torch.arange(s, device=x.device).expand(b, s)
        h = self.norm(x, p["layers/attn_norm"][i])
        q = self.mm(h, p["layers/attn/wq"][i]).reshape(b, s, self.h, self.hd)
        k = self.mm(h, p["layers/attn/wk"][i]).reshape(b, s, self.hk, self.hd)
        v = self.mm(h, p["layers/attn/wv"][i]).reshape(b, s, self.hk, self.hd)
        o = _Attention.apply(self.rope(q, pos), self.rope(k, pos), v,
                             self.block)
        x = x + self.mm(o.reshape(b, s, -1), p["layers/attn/wo"][i])
        h = self.norm(x, p["layers/mlp_norm"][i])
        return x + self.ffn(h.reshape(b * s, -1),
                            lambda path, *ix: p[path][(i, *ix)],
                            True).reshape(b, s, -1)

    def loss(self, p: dict, tokens: torch.Tensor) -> torch.Tensor:
        inp, tgt = tokens[:, :-1], tokens[:, 1:]
        x = F.embedding(inp, p["embed/tokens"])
        for i in range(self.L):
            x = checkpoint(self._layer, x, i, p, use_reentrant=False)
        x = self.norm(x, p["final_norm"])
        logits = self.mm(x, p["lm_head"])
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               tgt.reshape(-1))


def _block(last: int, block: int = 256) -> int:
    b = min(block, last)
    while last % b:
        b -= 1
    return b


def _quant(x: torch.Tensor, b: int):
    """(int8 (..., nb, b), f32 scales (..., nb)) of ``x`` in blocks of
    ``b`` along its last dim."""
    xb = x.reshape(*x.shape[:-1], x.shape[-1] // b, b)
    s = xb.abs().amax(-1) / 127.0 + 1e-30
    return torch.round(xb / s[..., None]).to(torch.int8), s


def _dequant(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return (q.float() * s[..., None]).flatten(-2)


def _slices(shape, max_elems: int = 2**26):
    """Slices along dim 0 of at most ``max_elems`` elements each (the
    blocks lie along the last dim, so a slice holds whole blocks)."""
    if len(shape) < 2:
        yield slice(None)
        return
    inner = math.prod(shape[1:])
    step = max(1, max_elems // inner)
    for i in range(0, shape[0], step):
        yield slice(i, i + step)


class AdamInt8:
    """The update above on a ``{path: f32 tensor}`` of parameters, a
    slice of each leaf at a time."""

    def __init__(self, params: dict, lr: float, b1: float, b2: float,
                 eps: float, weight_decay: float, clip_norm: float,
                 block: int = 256, store=torch.float32):
        self.store = store
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.wd, self.clip, self.block, self.count = (weight_decay,
                                                      clip_norm, block, 0)
        self.m, self.v = {}, {}
        for k, p in params.items():
            b = _block(p.shape[-1], block)
            shape = (*p.shape[:-1], p.shape[-1] // b)
            self.m[k] = (torch.zeros((*shape, b), dtype=torch.int8,
                                     device=p.device),
                         torch.full(shape, 1e-30, device=p.device))
            self.v[k] = (self.m[k][0].clone(), self.m[k][1].clone())

    def clip_factor(self, grads: dict) -> float:
        """The factor the global-norm clip scales every gradient by."""
        norm = float(torch.sqrt(sum((g * g).sum() for g in grads.values())))
        return 1.0 if norm < self.clip else self.clip / norm

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> None:
        """One update; takes the gradients out of ``grads`` as it goes."""
        factor = self.clip_factor(grads)
        self.count += 1
        bc1 = 1.0 - self.b1 ** self.count
        bc2 = 1.0 - self.b2 ** self.count
        for k in list(grads):
            g_all = grads.pop(k)
            p_all = params[k]
            b = _block(p_all.shape[-1], self.block)
            (mq, ms), (vq, vs) = self.m[k], self.v[k]
            for sl in _slices(p_all.shape):
                g = g_all[sl] * factor
                p = p_all[sl]
                m = self.b1 * _dequant(mq[sl], ms[sl]) + (1 - self.b1) * g
                r = _dequant(vq[sl], vs[sl])
                v = self.b2 * r * r + (1 - self.b2) * g * g
                upd = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
                p.copy_((p - self.lr * (upd + self.wd * p))
                        .to(self.store).float())
                mq[sl], ms[sl] = _quant(m, b)
                vq[sl], vs[sl] = _quant(torch.sqrt(v), b)
            del g_all


def train_steps(conf: dict, params: dict, batches, opt_conf: dict,
                initial, precision: str = "f32",
                families: Path = FAMILIES) -> dict:
    """Run ``len(batches)`` steps from ``params`` (a ``{path: tensor}``,
    emptied as each leaf is upcast to f32). ``initial(path)`` gives a
    leaf's starting value again (drawn anew from the seed). Returns each
    step's loss, each leaf's clipped-gradient norm at step 1 and each
    leaf's change norm after the last step, and the first moment after
    step 1 (``m1``: int8 and a scale a block of each row, on the host),
    from which the program's gradient is read too."""
    tf32_off()
    p = {}
    for k in list(params):
        p[k] = params.pop(k).float().requires_grad_()
    ref = TrainReference(conf, p, precision=precision, families=families)
    store = {"bfloat16": torch.bfloat16,
             "float32": torch.float32}[conf["torch_dtype"]]
    opt = AdamInt8(p, lr=opt_conf["lr"], b1=opt_conf["b1"], b2=opt_conf["b2"],
                   eps=opt_conf["eps"], weight_decay=opt_conf["weight_decay"],
                   clip_norm=opt_conf["clip_norm"], store=store)
    losses, m1 = [], None
    for tokens in batches:
        loss = ref.loss(p, tokens)
        grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
        losses.append(float(loss.detach()))
        del loss
        opt.step({k: t.data for k, t in p.items()}, grads)
        if m1 is None:
            # as the program's is read: the first moment after one step,
            # m = (1 - b1)·g, as int8 and a scale a block of each row
            m1 = {k: (q.flatten(-2).to("cpu", copy=True),
                      s.reshape(-1, s.shape[-1]).to("cpu", copy=True))
                  for k, (q, s) in opt.m.items()}
    change = {}
    for k in p:
        p0 = initial(k).float()
        change[k] = float(torch.linalg.vector_norm(p[k].detach() - p0))
        del p0
    return {"losses": losses, "m1": m1, "change": change}
