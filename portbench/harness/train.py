"""The training driver: the port's train step under ``adamw_int8``, fed
by the port's loader from a token file written at set-up.

Set-up builds one step object and one state, and drives them through
the first ``check_steps`` steps of the feed (which also builds and warms
every kernel); the program's readings are taken there. The window then
runs the same object on the next steps of the same feed until its
seconds are up; a host read of each step's loss one step behind keeps
the host at most a step ahead and closes the window.
"""

from __future__ import annotations

import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from portbench.harness import check
from portbench.harness import model as hm
from portbench.harness import traffic as tr
from portbench.harness.trace import Window


def write_corpus(directory: str, n_tokens: int, vocab: int,
                 seed: int) -> Path:
    """A flat uint16 token file drawn from the seed."""
    path = Path(directory) / "corpus.bin"
    tr.rng(seed, 6).integers(0, vocab, n_tokens, dtype=np.uint16).tofile(path)
    return path


def optimizer(mix: dict):
    from tpu_docker_api_torch.train.optim import adamw_int8

    o = mix["optimizer"]
    if o["name"] != "adamw_int8":
        raise ValueError(f"unknown optimizer {o['name']!r}")
    return adamw_int8(lr=o["lr"], b1=o["b1"], b2=o["b2"], eps=o["eps"],
                      weight_decay=o["weight_decay"], clip_norm=o["clip_norm"])


def _adam_state(opt_state):
    """The int8 Adam state inside the chain's (clip, adam) state."""
    return next(s for s in opt_state if hasattr(s, "mu_q"))


def first_moment(opt_state) -> dict:
    """``{path: (int8 q, f32 scales (rows, blocks))}`` of the optimizer's
    first moment, on the host: after step 1 it is ``(1 - b1)·g``, the
    gradient as the optimizer got it."""
    st = _adam_state(opt_state)
    scales = hm.flat(st.mu_scale)
    return {path: (q.to("cpu", copy=True), scales[path].to("cpu", copy=True))
            for path, q in hm.flat(st.mu_q).items()}


def change_norms(cfg, params, seed: int) -> dict:
    """Each leaf's ``‖p - p0‖``, ``p0`` drawn again from the seed a leaf
    at a time."""
    out = {}
    flat = hm.flat(params)
    for i, (path, shape, dtype) in enumerate(hm.leaf_paths(cfg)):
        p0 = hm.draw_leaf(path, shape, dtype, seed, i, flat[path].device)
        out[path] = float(torch.linalg.vector_norm(
            flat[path].float() - p0.float()))
        del p0
    return out


def window(cfg, conf: dict, mix: dict, seed: int, seconds: float,
           trace: bool, device) -> dict:
    from tpu_docker_api_torch.data.loader import (make_batch_fn,
                                                  open_token_files)
    from tpu_docker_api_torch.ops import flash
    from tpu_docker_api_torch.train import optim as optim_mod
    from tpu_docker_api_torch.train.trainer import TrainState, make_train_step

    B, S = int(mix["batch"]), int(mix["seq"])
    tmp = tempfile.TemporaryDirectory(prefix="portbench-")
    corpus = write_corpus(tmp.name, int(mix["corpus_tokens"]),
                          conf["vocab_size"], seed)
    batch_fn = make_batch_fn(open_token_files(corpus, window=S + 1), B,
                             seed=seed)
    opt = optimizer(mix)
    params = hm.make_params(cfg, seed, device)
    state = TrainState(0, params, opt.init(params))
    del params
    step = make_train_step(cfg, opt)

    def feed(i):
        return torch.from_numpy(batch_fn(i)).long()

    # set-up: the first steps, through the window's own call and feed
    losses, m1 = [], None
    n_check = int(mix["check_steps"])
    t_s = time.perf_counter()
    for i in range(n_check):
        state, metrics = step(state, feed(i))
        losses.append(float(metrics["loss"]))
        if i == 0:
            m1 = first_moment(state.opt_state)
    change = change_norms(cfg, state.params, seed)
    sync(device)
    print(f"set-up: first {n_check} steps {time.perf_counter() - t_s:.2f} s,"
          f" losses {losses}", file=sys.stderr)

    # the window
    waits, nsteps = [], 0
    i = n_check
    pending = None
    t0 = time.perf_counter()
    end = t0 + seconds
    while True:
        w0 = time.perf_counter()
        batch = feed(i)
        waits.append(time.perf_counter() - w0)
        state, metrics = step(state, batch)
        i += 1
        nsteps += 1
        if pending is not None:
            float(pending)
        pending = metrics["loss"]
        if time.perf_counter() >= end:
            break
    float(pending)
    t_end = time.perf_counter()

    window, launches = None, {}
    if trace:
        before = dict(flash.launch_count)
        adam_before = optim_mod.launch_count["adam8"]
        with Window() as window:
            for _ in range(int(mix["trace_steps"])):
                state, metrics = step(state, feed(i))
                i += 1
        launches = {k: flash.launch_count[k] - before[k] for k in before}
        launches["adam8"] = optim_mod.launch_count["adam8"] - adam_before
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    del state, metrics, step, opt, batch_fn
    tokens = np.fromfile(corpus, dtype=np.uint16)
    tmp.cleanup()
    return {"steps": nsteps, "tokens_per_step": B * S, "t0": t0,
            "t_end": t_end, "batch_wait_s": waits, "losses": losses,
            "m1": m1, "change": change, "window": window,
            "launches": launches, "memory_peak_bytes": peak,
            "corpus": tokens}


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def drive(run, controls: bool = False) -> dict:
    """A training cell's run (``drivers/train.py``): set-up and window,
    then the reference's first steps once the program's state is freed;
    with ``controls``, the float8 control's and half a batch's too."""
    conf, mix, device = run.conf, run.mix, run.device
    cfg = hm.port_config(conf, remat=True, portbench=run.portbench)
    rec = window(cfg, conf, mix, run.seed, run.seconds, run.traced, device)
    run.setup_s = rec["t0"] - run.t_start
    run.rec = rec
    run.trace = rec["window"].summary if rec["window"] else None
    run.launches = rec["launches"]
    hm.free(device)
    families = run.portbench / "reference" / "families"

    def reference(**kw):
        return check.reference_steps(conf, cfg, mix, rec["corpus"], run.seed,
                                     device, families=families, **kw)
    ref = reference()
    b1 = mix["optimizer"]["b1"]
    readings = check.compare_steps(rec, ref, device, b1)
    extra = {"left_out": readings.pop("left_out"),
             "losses": rec["losses"], "ref_losses": ref["losses"]}
    if controls:
        hm.free(device)
        extra["control"] = check.compare_steps(reference(precision="fp8"),
                                               ref, device, b1)
        hm.free(device)
        half = reference(rows=slice(0, int(mix["batch"]) // 2))
        extra["half_batch"] = check.compare_steps(half, ref, device, b1)
    return {"readings": readings, "attempted": rec["steps"], "failed": 0,
            "peak": rec["memory_peak_bytes"], "extra": extra}
