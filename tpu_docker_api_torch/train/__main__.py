"""Training entry point of the port (counterpart of
``tpu_docker_api/train/__main__.py``, Llama presets, one device).

    python -m tpu_docker_api_torch.train --preset llama3-1b --steps 20 \
        --batch 4 --seq 2048 --optim adamw-int8
    python -m tpu_docker_api_torch.train --device cpu --preset tiny --steps 3

Trains on synthetic tokens from random weights (``--seed``). Runs on
``cuda`` unless ``--device cpu`` is given; without a card the default
raises. Contracts kept from the JAX entry point:

- **Quiesce**: SIGTERM/SIGINT stops after the current step with
  ``{"event": "quiesced", "step": N}`` and exit 0.
- One JSON line per log interval, ``{"step", "loss", "tokens_per_sec"}``,
  then ``{"event": "done", "step": N}``. The loss is read from the
  device only at those lines, so steps are not synchronised one by one.
- ``--profile-dir`` traces ``--profile-steps`` steps after the first
  with ``torch.profiler``, writes ``trace.json`` there and prints
  ``{"event": "profile_written", ...}`` with the window's device time by
  kernel class and its idle share (telemetry/profile.py).

Flags of the JAX entry point that the port does not have yet are refused
with a message naming the work that brings them, never ignored.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import signal
import sys
import time

import torch

#: JAX-CLI flags the port does not take yet → why, and what brings them
_NOT_PORTED = {
    "it comes with checkpoints (ROADMAP Queue 1)": ("ckpt_dir",
                                                     "save_every"),
    "it comes with the --data token loader (ROADMAP Queue 1)": (
        "data", "data_seed", "data_dtype"),
    "it comes with LoRA/QLoRA (ROADMAP Queue 1)": (
        "lora_rank", "lora_alpha", "lora_targets", "lora_base_ckpt",
        "lora_forward", "qlora"),
    "it comes with the other model families (ROADMAP Queue 1)": (
        "moe_dispatch",),
    "it comes with parallelism (ROADMAP Queue 1)": ("dp", "fsdp", "tp",
                                                    "sp", "pp", "ep"),
    "it selects a JAX platform; use --device": ("platform",
                                                "virtual_devices"),
}


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m tpu_docker_api_torch.train")
    p.add_argument("--preset", default="tiny",
                   help="llama preset (tiny, bench-350m, llama3-1b, ...)")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=0, help="0 = preset default")
    p.add_argument("--optim", default="adamw", choices=["adamw", "adamw-int8"],
                   help="adamw-int8 stores both Adam moments as blockwise "
                        "int8 (csrc/adam8.cu on the card)")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights and tokens")
    p.add_argument("--device", default="cuda",
                   help="torch device; cuda (the default) raises without "
                        "a card")
    p.add_argument("--profile-dir", default="",
                   help="write a torch.profiler trace of --profile-steps "
                        "steps after the first")
    p.add_argument("--profile-steps", type=int, default=5)
    for names in _NOT_PORTED.values():
        for name in names:
            flag = "--" + name.replace("_", "-")
            if name == "qlora":
                p.add_argument(flag, action="store_true",
                               default=argparse.SUPPRESS,
                               help=argparse.SUPPRESS)
            else:
                p.add_argument(flag, default=argparse.SUPPRESS,
                               help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    for why, names in _NOT_PORTED.items():
        given = ["--" + n.replace("_", "-") for n in names if hasattr(args, n)]
        if given:
            p.error(f"{', '.join(given)}: not in the PyTorch package yet; "
                    f"{why}")
    return args


def main(argv: list[str] | None = None) -> int:
    args = parse_args(argv)

    from tpu_docker_api_torch import resolve_device
    from tpu_docker_api_torch.models import resolve_preset
    from tpu_docker_api_torch.telemetry.profile import device_time_summary
    from tpu_docker_api_torch.train.trainer import (create_train_state,
                                                    make_train_step,
                                                    synthetic_batch)

    device = resolve_device(args.device)
    try:
        _, cfg = resolve_preset(args.preset)
    except (KeyError, ValueError) as e:
        raise SystemExit(f"unknown or unported preset {args.preset!r}: {e}")
    if args.seq:
        cfg = dataclasses.replace(cfg, max_seq_len=args.seq)
    seq = args.seq or min(cfg.max_seq_len, 512)

    opt = None
    if args.optim == "adamw-int8":
        from tpu_docker_api_torch.train.optim import adamw_int8

        opt = adamw_int8()
    gen = torch.Generator(device=device).manual_seed(args.seed)
    state, optimizer = create_train_state(cfg, device, gen, optimizer=opt)
    step_fn = make_train_step(cfg, optimizer)
    data_gen = torch.Generator(device=device).manual_seed(args.seed + 1)

    # quiesce contract: graceful stop ⇒ exit 0 after the current step
    stop = {"now": False}

    def _quiesce(signum, _frame):
        stop["now"] = True

    signal.signal(signal.SIGTERM, _quiesce)
    signal.signal(signal.SIGINT, _quiesce)

    def _sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    # trace a window of steps after the first (cuBLAS handles, allocator
    # pools and kernel builds land in the first)
    profile_at = min(1, args.steps - 1) if args.profile_dir else -1
    prof, prof_t0 = None, 0.0

    def _stop_profile():
        nonlocal prof
        _sync()
        wall = time.perf_counter() - prof_t0
        prof.stop()
        os.makedirs(args.profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.profile_dir,
                                              "trace.json"))
        print(json.dumps({"event": "profile_written",
                          "dir": args.profile_dir,
                          **device_time_summary(prof, wall)}), flush=True)
        prof = None

    tokens_per_step = args.batch * seq
    t0 = time.monotonic()
    for i in range(args.steps):
        if i == profile_at:
            _sync()
            activities = [torch.profiler.ProfilerActivity.CPU]
            if device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=activities)
            prof.start()
            prof_t0 = time.perf_counter()
        tokens = synthetic_batch(data_gen, args.batch, seq, cfg.vocab_size)
        state, metrics = step_fn(state, tokens)
        if prof is not None and i >= profile_at + args.profile_steps - 1:
            _stop_profile()
        done = i + 1  # host counter: no device read per step
        if stop["now"]:
            if prof is not None:
                _stop_profile()
            print(json.dumps({"event": "quiesced", "step": done}),
                  flush=True)
            return 0
        if done % args.log_every == 0 or done == args.steps:
            loss = float(metrics["loss"])
            dt = time.monotonic() - t0
            print(json.dumps({
                "step": done,
                "loss": round(loss, 4),
                "tokens_per_sec": round(done * tokens_per_step / dt, 1),
            }), flush=True)
    if prof is not None:  # the window outran the step budget
        _stop_profile()
    print(json.dumps({"event": "done", "step": state.step}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
