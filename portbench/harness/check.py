"""How ``correct`` is decided: the program's outputs against the plain
reference (``portbench/reference``), once the window has closed and the
program's state is freed.

Serving: for a sample of finished requests (the longest and some drawn
by the seed), the reference runs once over each prompt and its served
tokens. A served token's gap is how far its reference logit lies below
the reference's best at that position; the numbers a cell may compare
are the widest gap, the mean gap and the share of tokens whose gap is
over 0.5 (``SERVED``).

Training: the reference follows the first steps from the same weights
on the same rows; the numbers compared are each step's loss gap, and by
the worst leaf the gap of the gradient's norm at step 1 and of the
parameters' change after the steps, each against the reference's norm
of that leaf or of the median leaf, whichever is larger. Leaves whose
reference gradient is under a thousandth of the median leaf's move by
round-off alone and are left out of the change.
"""

from __future__ import annotations

import statistics

import numpy as np
import torch

from portbench.harness import model as hm
from portbench.reference.decoder import FAMILIES, Decoder, served_logits
from portbench.reference.train import batch as ref_batch
from portbench.reference.train import train_steps


#: the serving numbers: the widest gap, the mean gap, the share of
#: tokens with a gap over 0.5
SERVED = ("served_gap", "served_gap_mean", "served_share_over_half")


def _served(g: torch.Tensor) -> dict:
    return {"served_gap": float(g.max()), "served_gap_mean": float(g.mean()),
            "served_share_over_half": float((g > 0.5).float().mean())}


def served_gaps(conf: dict, weights: dict, picks, log, device,
                control: bool = False, families=FAMILIES) -> dict:
    """The ``SERVED`` numbers of the served tokens and "tokens": n and,
    with ``control``, "control": the same numbers for the tokens that
    the float8 control puts first at the same positions, and "spread":
    how the gaps of each spread."""
    ref = Decoder(conf, weights, families=families)
    low = (Decoder(conf, weights, precision="fp8", families=families)
           if control else None)
    n = 0
    gaps, gaps_c = [], []
    for s in picks:
        group, row = (None, 0)
        if log is not None:
            found = log.group_of(s.req.prompt)
            if found is None:
                raise RuntimeError("no prefill forward holds a sampled "
                                   "prompt")
            group, row = found
        served = list(s.tokens)
        logits = served_logits(ref, s.req.prompt, served, group, row, device)
        best = logits.max(dim=-1).values
        tok = torch.tensor(served, device=logits.device)
        gap = best - logits.gather(1, tok[:, None])[:, 0]
        gaps.append(gap.float().cpu())
        n += len(served)
        if low is not None:
            lg = served_logits(low, s.req.prompt, served, group, row, device)
            pick = lg.argmax(dim=-1)
            gc = best - logits.gather(1, pick[:, None])[:, 0]
            gaps_c.append(gc.float().cpu())
        del logits
    allg = torch.cat(gaps)
    out = {**_served(allg), "tokens": n}
    if control:
        allc = torch.cat(gaps_c)
        out["control"] = _served(allc)
        out["spread"] = {"program": gap_stats(allg),
                         "control": gap_stats(allc)}
    return out


def gap_stats(g: torch.Tensor) -> dict:
    """How a run's per-token gaps spread (calibration's record)."""
    q = torch.quantile(g, torch.tensor([0.5, 0.9, 0.99]))
    return {"mean": float(g.mean()), "p50": float(q[0]), "p90": float(q[1]),
            "p99": float(q[2]), "max": float(g.max()),
            "share_over_0.1": float((g > 0.1).float().mean()),
            "share_over_0.5": float((g > 0.5).float().mean()),
            "n": int(g.numel())}


def relative_gap(prog: dict, ref: dict, leaves) -> float:
    """Worst leaf's ``|prog - ref| / max(ref, median of ref)``."""
    med = statistics.median(ref[k] for k in leaves)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
               for k in leaves)


def reference_steps(conf: dict, cfg, mix: dict, corpus, seed: int, device,
                    precision: str = "f32", rows=None,
                    families=FAMILIES) -> dict:
    """The reference's losses, step-1 gradient norms and change norms
    over the first ``check_steps`` batches of the feed (``rows``: only
    those rows of each batch, a fault's reading)."""
    S, B = int(mix["seq"]), int(mix["batch"])
    batches = []
    for i in range(int(mix["check_steps"])):
        rows_i = ref_batch(corpus, S + 1, B, seed, i)
        if rows is not None:
            rows_i = rows_i[rows]
        batches.append(torch.from_numpy(rows_i).to(device))
    paths = {path: (i, shape, dtype) for i, (path, shape, dtype)
             in enumerate(hm.leaf_paths(cfg))}

    def initial(path):
        i, shape, dtype = paths[path]
        return hm.draw_leaf(path, shape, dtype, seed, i, device)

    return train_steps(conf, hm.flat(hm.make_params(cfg, seed, device)),
                       batches, mix["optimizer"], initial,
                       precision=precision, families=families)


def _moment(q: torch.Tensor, s: torch.Tensor, device) -> torch.Tensor:
    """An int8 first moment (q like the leaf, scales (rows, blocks)) as
    f32 on ``device``."""
    qf = q.to(device).float()
    return (qf.reshape(s.shape[0], s.shape[1], -1)
            * s.to(device)[..., None]).reshape(q.shape)


def compare_steps(prog: dict, ref: dict, device, b1: float) -> dict:
    """A train cell's numbers for ``prog`` (the program's readings, or a
    control's) against ``ref``. ``loss_gap``: the largest absolute gap of
    a step's loss. From the first moment after step 1, the gradient as
    each optimizer got it: ``grad_gap``, the worst leaf's gap of its
    norm, and ``grad_diff``, the worst leaf's norm of the difference
    (each against the reference's norm of that leaf or of the median
    leaf). ``change_gap``: the worst leaf's gap of the norm of the
    parameters' change after the steps."""
    norms, diffs = {}, {}
    mine = {}
    for k, (q, s) in ref["m1"].items():
        r = _moment(q, s, device)
        p = _moment(*prog["m1"][k], device)
        norms[k] = float(torch.linalg.vector_norm(r)) / (1.0 - b1)
        mine[k] = float(torch.linalg.vector_norm(p)) / (1.0 - b1)
        diffs[k] = float(torch.linalg.vector_norm(p - r)) / (1.0 - b1)
        del r, p
    leaves = list(norms)
    med = statistics.median(norms.values())
    moving = [k for k in leaves if norms[k] >= 1e-3 * med]
    return {
        "loss_gap": max(abs(a - b) for a, b in zip(prog["losses"],
                                                  ref["losses"])),
        "grad_gap": relative_gap(mine, norms, leaves),
        "grad_diff": max(diffs[k] / max(norms[k], med, 1e-30)
                         for k in moving),
        "change_gap": relative_gap(prog["change"], ref["change"], moving),
        "left_out": sorted(set(leaves) - set(moving)),
    }


def judge(readings: dict, limits: dict) -> tuple[bool, dict]:
    """(every compared number within its limit, {name: {value, limit}})."""
    shown = {k: {"value": readings[k], "limit": limits[k]} for k in limits}
    ok = all(np.isfinite(v["value"]) and v["value"] <= v["limit"]
             for v in shown.values())
    return ok, shown
