"""Training entry point of the port (counterpart of
``tpu_docker_api/train/__main__.py``): Llama presets and the ``moe:``,
``vit:`` and ``encdec:`` families, on one device or on a mesh.

    python -m tpu_docker_api_torch.train --preset llama3-1b --steps 20 \
        --batch 4 --seq 2048 --optim adamw-int8 --ckpt-dir CKPT \
        --save-every 10 [--data TOKENS.bin]
    python -m tpu_docker_api_torch.train --device cpu --preset tiny --steps 3
    python -m tpu_docker_api_torch.train --preset llama3-8b --qlora \
        --lora-rank 16 --batch 1 --seq 2048 --optim adamw-int8
    python -m tpu_docker_api_torch.train --preset moe:bench-moe \
        --moe-dispatch einsum --batch 4 --seq 2048
    python -m tpu_docker_api_torch.train --preset vit:vit-b16 --batch 128
    python -m tpu_docker_api_torch.train --preset encdec:encdec-base \
        --batch 32 --seq 512
    python -m tpu_docker_api_torch.train --preset llama3-8b --fsdp 2 --tp 4
    python -m tpu_docker_api_torch.train --device cpu --preset tiny \
        --tp 2 --nproc-per-node 2 --steps 3
    python -m tpu_docker_api_torch.train --device cpu --preset tiny \
        --pp 2 --nproc-per-node 2 --steps 3
    python -m tpu_docker_api_torch.train --device cpu --preset \
        encdec:tiny --sp 2 --nproc-per-node 2 --steps 3

Trains on a token file (``--data``, data/loader.py) or on synthetic
tokens, from random weights (``--seed``) or from the latest checkpoint in
``--ckpt-dir``. Runs on ``cuda`` unless ``--device cpu`` is given;
without a card the default raises. Contracts kept from the JAX entry
point:

- **Resume**: boots through ``resume_or_init``: a fresh ``--ckpt-dir``
  trains from step 0, one with checkpoints from its latest step (after
  ``{"event": "resumed", "step": N, "restore_s": ...}``), and the loop
  runs ``range(start_step, steps)``. A batch is a pure function of
  the step (``make_batch_fn`` for ``--data``, ``step_generator`` for
  synthetic tokens), so a resumed run reads the batches the stopped run
  would have read.
- **Quiesce**: SIGTERM/SIGINT stops after the current step, saves it,
  waits for the save to be on disk, prints ``{"event": "quiesced",
  "step": N}`` and exits 0.
- One JSON line per log interval, ``{"step", "loss", "tokens_per_sec"}``
  (tokens/s over this run's steps), one ``{"event": "saved", ...}``
  line for each checkpoint written (step, bytes, the step loop's
  blocked seconds and the writer's), then ``{"event": "done", "step":
  N}`` after a final save. The loss is read from the device only at
  log lines, so steps are not synchronised one by one.
- ``--profile-dir`` traces ``--profile-steps`` steps from
  ``start_step + 1`` with ``torch.profiler``, writes ``trace.json``
  there and prints ``{"event": "profile_written", ...}`` with the
  window's device time by kernel class and its idle share, and the
  device time launched inside each of the train step's ranges (forward,
  backward, optimizer) and the int8 straight-through backward's
  (``ms_by_range``; telemetry/profile.py).
- **LoRA** (``--lora-rank R > 0``, train/lora.py): the base is frozen
  (random from ``--seed``, or the params of ``--lora-base-ckpt``) and
  only rank-R adapters on ``--lora-targets`` train, merged into the base
  every step (``--lora-forward merged``, the default) or evaluated
  unmerged (``attached``). ``--qlora`` quantizes the base to int8 and
  takes the attached forward. ``--ckpt-dir`` then holds adapter-only
  checkpoints; resume and quiesce work as above. The JAX entry point's
  guards hold: a LoRA flag without ``--lora-rank``, and ``--qlora
  --lora-forward merged``, are refused.
- **MoE** (``--preset moe:NAME``, models/moe.py): ``--moe-dispatch``
  picks the expert dispatch (auto, gather, einsum, sort; on one device
  auto and sort are gather). As in JAX, it is refused on a Llama preset,
  and ``--qlora`` on a ``moe:`` preset (the int8 quantizer is
  Llama-shaped).
- **ViT** (``--preset vit:NAME``, models/vit.py: vit-b16, vit-s16,
  tiny) trains on synthetic (images, labels) batches; ``--data`` and
  ``--seq`` are refused, and ``tokens_per_sec`` counts ``n_patches``
  tokens an image. **Encoder-decoder** (``--preset encdec:NAME``,
  models/encdec.py: encdec-base, tiny) trains on synthetic (src, tgt)
  pairs with ``src_len == tgt_len == --seq`` (default ``min(max_tgt_len,
  128)``); ``--data`` is refused. Their rows are drawn one by one from
  the seed, the step and the row, as the JAX trainer's are.

- **Meshes** (``--dp --fsdp --tp --sp --ep --pp``, parallel/): one
  process a device. Given any of them, or started as one rank of a larger job
  (``WORLD_SIZE`` > 1, workload/torchenv.py), the trainer runs on a
  (pp, dp, fsdp, ep, tp, sp) mesh; ``--dp`` -1 (the default) takes the
  ranks the others leave. One command started without ``RANK`` starts
  a rank for every visible GPU itself, or ``--nproc-per-node N`` gloo
  ranks with ``--device cpu`` (JAX's ``--virtual-devices``). Each rank
  takes its rows of the same global batch; only rank 0 prints.
  Checkpoints keep the one format: a run on any mesh resumes from a
  step any other mesh (or one device) wrote. ``--sp`` takes llama, moe
  and encdec presets (the encoder's contiguous ring, the decoder's
  zigzag ring); on vit it is refused: JAX's ViT has no sequence-parallel
  path, so its sp axis would only replicate. ``--qlora`` is refused on
  a mesh.
- **Pipeline** (``--pp N``, parallel/pipeline.py): a llama preset
  trains through the 1F1B schedule, each rank a stage of
  ``n_layers/N`` layers (``pipeline_rules``, ``make_train_step``'s
  ``grad_fn=pipeline_1f1b_grads``), composing with ``--dp``, ``--fsdp``,
  ``--tp`` and ``--sp`` (each stage's blocks run the sp attention on
  the rank's chunk of the sequence). The JAX CLI takes ``--pp`` but never reaches its
  pipeline (its ``pp`` axis holds replicas of the same work); the loss
  is the same, the pipeline being exact. There is no microbatch flag,
  as in JAX: ``n_micro = batch / (dp·fsdp)``, one row a microbatch on
  each data rank, which keeps the 1F1B bubble (N-1)/(n_micro+N-1) as
  small as the batch allows. ``--pp`` is refused on moe, vit and
  encdec presets, with LoRA, and with ``--ep`` above 1: JAX's pipeline
  is Llama's only and has none of these compositions.

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

#: JAX-CLI flags the port does not take yet → why, and what brings them
_NOT_PORTED = {
    "it selects a JAX platform; use --device": ("platform",),
    "it makes JAX CPU devices; use --device cpu --nproc-per-node N":
        ("virtual_devices",),
}

#: the mesh axes the trainer takes (parallel/mesh.py MeshPlan)
MESH_FLAGS = ("dp", "fsdp", "tp", "sp", "ep", "pp")


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m tpu_docker_api_torch.train")
    p.add_argument("--preset", default="tiny",
                   help="llama preset (tiny, bench-350m, llama3-1b, ...), "
                        "moe:NAME (moe-tiny, bench-moe, mixtral-8x7b), "
                        "vit:NAME (tiny, vit-s16, vit-b16: image batches; "
                        "no --data or --seq) or encdec:NAME (tiny, "
                        "encdec-base: seq2seq pairs of --seq tokens a "
                        "side; no --data)")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=0, help="0 = preset default")
    p.add_argument("--optim", default="adamw", choices=["adamw", "adamw-int8"],
                   help="adamw-int8 stores both Adam moments as blockwise "
                        "int8 (csrc/adam8.cu on the card)")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights and synthetic tokens")
    p.add_argument("--data", default="",
                   help="token file or directory (.bin/.npy, "
                        "data/loader.py); '' trains on synthetic tokens")
    p.add_argument("--data-seed", type=int, default=0)
    p.add_argument("--data-dtype", default="",
                   help=".bin token width; '' picks by vocab size "
                        "(uint16 below 65536, else int32)")
    p.add_argument("--ckpt-dir", default="",
                   help="checkpoint directory to resume from and save to; "
                        "'' disables checkpointing")
    p.add_argument("--save-every", type=int, default=50)
    p.add_argument("--device", default="cuda",
                   help="torch device; cuda (the default) raises without "
                        "a card")
    p.add_argument("--profile-dir", default="",
                   help="write a torch.profiler trace of --profile-steps "
                        "steps after the first")
    p.add_argument("--profile-steps", type=int, default=5)
    p.add_argument("--lora-rank", type=int, default=0,
                   help="> 0: LoRA fine-tuning: freeze the base, train "
                        "rank-R adapters on --lora-targets; --ckpt-dir "
                        "then holds adapter-only checkpoints")
    p.add_argument("--lora-alpha", type=float, default=16.0)
    p.add_argument("--lora-targets", default="wq,wv",
                   help="comma-separated projection leaf names to adapt")
    p.add_argument("--lora-base-ckpt", default="",
                   help="full-train checkpoint dir to load the frozen base "
                        "from ('' = random weights from --seed)")
    p.add_argument("--lora-forward", default=None,
                   choices=["merged", "attached"],
                   help="merged: merge every step (a transient "
                        "weight-sized copy); attached: the unmerged "
                        "Wx + s·B(Ax) forward, no merged tree")
    p.add_argument("--qlora", action="store_true",
                   help="int8-quantize the frozen base at load and use the "
                        "attached forward")
    p.add_argument("--moe-dispatch", default="auto",
                   choices=["auto", "gather", "einsum", "sort"],
                   help="moe: presets: expert dispatch (models/moe.py "
                        "_moe_mlp; auto and sort are gather on one device, "
                        "auto is sort on a mesh)")
    for name in MESH_FLAGS:
        p.add_argument("--" + name, type=int, default=None,
                       help="mesh axis size (default: dp -1 = the ranks "
                            "left, the others 1); any of them runs the "
                            "mesh path")
    p.add_argument("--nproc-per-node", type=int, default=1,
                   help="with --device cpu: start N gloo ranks")
    for names in _NOT_PORTED.values():
        for name in names:
            p.add_argument("--" + name.replace("_", "-"),
                           default=argparse.SUPPRESS, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    for why, names in _NOT_PORTED.items():
        given = ["--" + n.replace("_", "-") for n in names if hasattr(args, n)]
        if given:
            p.error(f"{', '.join(given)}: not in the PyTorch package yet; "
                    f"{why}")
    if args.lora_rank <= 0 and (
            args.lora_base_ckpt or args.lora_alpha != 16.0
            or args.lora_targets != "wq,wv" or args.qlora
            or args.lora_forward is not None):
        # a LoRA flag without --lora-rank would otherwise be ignored, and
        # a full pretrain from random weights would run with exit 0
        p.error("--lora-base-ckpt/--lora-alpha/--lora-targets/--qlora/"
                "--lora-forward require --lora-rank > 0")
    family = args.preset.partition(":")[0] if ":" in args.preset else "llama"
    if args.moe_dispatch != "auto" and family != "moe":
        p.error("--moe-dispatch applies to moe: presets only")
    if family == "vit" and (args.data or args.seq):
        p.error("--data/--seq do not apply to vit: presets (image batches "
                "are synthetic)")
    if family == "encdec" and args.data:
        p.error("--data does not apply to encdec: presets (seq2seq pairs "
                "are synthetic)")
    if args.qlora and family != "llama":
        p.error("--qlora supports llama presets only (the int8 quantizer "
                "is llama-shaped)")
    if family == "vit" and args.sp not in (None, 1):
        p.error("--sp does not apply to vit: presets: JAX's ViT has no "
                "sequence-parallel path (its sp axis only replicates)")
    if args.pp is not None:
        if family != "llama":
            p.error(f"--pp does not apply to {family}: presets: the "
                    f"pipeline is Llama's; JAX's pipeline is Llama's only "
                    f"and has no such composition")
        if args.lora_rank > 0:
            p.error("--pp does not compose with LoRA: JAX's pipeline is "
                    "Llama's only and has no such composition")
        if args.ep not in (None, 1):
            p.error("--pp does not compose with --ep: JAX's pipeline is "
                    "Llama's only and has no such composition")
    if args.nproc_per_node > 1 and args.device != "cpu":
        p.error("--nproc-per-node is for --device cpu (on cuda one rank "
                "starts for every visible GPU)")
    if args.qlora and mesh_wanted(args):
        p.error("--qlora does not run on a mesh in the PyTorch package yet")
    if args.qlora and args.lora_forward == "merged":
        # merging onto an int8 base would quantize the delta away
        p.error("--qlora requires the attached forward; drop "
                "--lora-forward merged")
    if args.lora_forward is None:
        args.lora_forward = "attached" if args.qlora else "merged"
    return args


def mesh_wanted(args) -> bool:
    """The mesh path: a mesh flag given, or more than one rank."""
    from tpu_docker_api_torch.workload.torchenv import world_size

    return (any(getattr(args, a) is not None for a in MESH_FLAGS)
            or args.nproc_per_node > 1 or world_size() > 1)


def mesh_plan(args):
    from tpu_docker_api_torch.parallel.mesh import MeshPlan

    return MeshPlan(**{a: getattr(args, a) for a in MESH_FLAGS
                       if getattr(args, a) is not None})


def pipeline_parts(cfg, mesh, batch: int):
    """(rules, grad_fn) of ``--pp``: ``pipeline_rules(LLAMA_RULES)`` and
    the 1F1B schedule at ``n_micro = batch / (dp·fsdp)``, one row a
    microbatch on each data rank (module docstring)."""
    from tpu_docker_api_torch.parallel.pipeline import (pipeline_1f1b_grads,
                                                        pipeline_rules)
    from tpu_docker_api_torch.parallel.sharding import LLAMA_RULES

    rules = pipeline_rules(LLAMA_RULES)
    n_micro = batch // mesh.size_of(("dp", "fsdp"))

    def grad_fn(params, rows):
        return pipeline_1f1b_grads(params, rows, cfg, mesh, n_micro)

    return rules, grad_fn


def _lora_base(args, cfg, device, gen, mesh=None) -> dict:
    """The frozen base of a LoRA run: random from ``gen``, or the params of
    ``--lora-base-ckpt``; int8 under ``--qlora``."""
    from tpu_docker_api_torch.train import lora

    if args.lora_base_ckpt:
        # params only, whatever optimizer wrote them; a missing or empty
        # directory raises: fine-tuning a random base would be garbage
        # with exit 0
        base = lora.restore_base_params(args.lora_base_ckpt, cfg, device,
                                        mesh=mesh)
    else:
        base = lora.init_base_params(cfg, gen, mesh=mesh)
    if args.qlora:
        # the serving quantizer: adapters train against the numerics of
        # serve --quantize --lora-forward attached
        base = lora.quantize_base(base)
    return base


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    on_mesh = mesh_wanted(args)
    if on_mesh:
        from tpu_docker_api_torch.workload.torchenv import (launch_workers,
                                                            without_flag,
                                                            workers_wanted)

        n = workers_wanted(args.device, args.nproc_per_node)
        if n > 1:
            return launch_workers("tpu_docker_api_torch.train",
                                  without_flag(argv, "--nproc-per-node"), n,
                                  "cpu" if args.device == "cpu" else "cuda")
    try:
        return _run(args, on_mesh)
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


def _run(args, on_mesh: bool) -> int:
    # torch is imported here, not with the module: the launcher and a
    # refused command line never pay its import
    import torch

    from tpu_docker_api_torch.models import resolve_preset
    from tpu_docker_api_torch.ops.quant import STE_BACKWARD_RANGE
    from tpu_docker_api_torch.telemetry.profile import device_time_summary
    from tpu_docker_api_torch.train.checkpoint import resume_or_init
    from tpu_docker_api_torch.train.trainer import (STEP_RANGES,
                                                    create_train_state,
                                                    make_train_step,
                                                    step_generator,
                                                    synthetic_batch)

    mesh, rank, stop_group = None, 0, None
    if on_mesh:
        import torch.distributed as dist

        from tpu_docker_api_torch.parallel.mesh import build_mesh
        from tpu_docker_api_torch.workload.torchenv import bootstrap_torch

        device, rank, ws = bootstrap_torch(args.device, force=True)
        mesh = build_mesh(mesh_plan(args))
        if ws > 1:
            # the ranks agree on a quiesce through a host-side group, so
            # no step reads a device value to decide it
            stop_group = dist.new_group(backend="gloo")
    else:
        from tpu_docker_api_torch import resolve_device

        device = resolve_device(args.device)

    def emit(obj) -> None:
        if rank == 0:
            print(json.dumps(obj), flush=True)

    try:
        family, cfg = resolve_preset(args.preset)
    except (KeyError, ValueError) as e:
        raise SystemExit(f"unknown or unported preset {args.preset!r}: {e}")
    if family == "moe":
        cfg = dataclasses.replace(cfg, dispatch_impl=args.moe_dispatch)
    if family == "vit":
        seq = cfg.n_patches  # tokens an image, for the throughput metric
    elif family == "encdec":
        seq = args.seq or min(cfg.max_tgt_len, 128)  # src_len == tgt_len
    else:
        if args.seq:
            cfg = dataclasses.replace(cfg, max_seq_len=args.seq)
        seq = args.seq or min(cfg.max_seq_len, 512)

    opt = None
    if args.optim == "adamw-int8":
        from tpu_docker_api_torch.train.optim import adamw_int8

        opt = adamw_int8()
    gen = torch.Generator(device=device).manual_seed(args.seed)
    rules = grad_fn = None
    if args.pp is not None:
        rules, grad_fn = pipeline_parts(cfg, mesh, args.batch)
    if args.lora_rank > 0:
        from tpu_docker_api_torch.train import lora

        targets = tuple(t.strip() for t in args.lora_targets.split(",")
                        if t.strip())
        base = _lora_base(args, cfg, device, gen, mesh)
    mgr = None
    if args.ckpt_dir:
        # under LoRA the directory holds adapter-only checkpoints
        t_boot = time.perf_counter()
        if args.lora_rank > 0:
            state, optimizer, mgr = lora.lora_resume_or_init(
                args.ckpt_dir, cfg, device, gen, args.lora_rank, targets,
                opt, mesh=mesh)
        else:
            state, optimizer, mgr = resume_or_init(args.ckpt_dir, cfg,
                                                   device, gen, optimizer=opt,
                                                   mesh=mesh, rules=rules)
        if state.step:
            emit({"event": "resumed", "step": state.step,
                  "restore_s": time.perf_counter() - t_boot})
    elif args.lora_rank > 0:
        state, optimizer = lora.create_lora_state(cfg, gen, args.lora_rank,
                                                  targets, opt, mesh=mesh)
    else:
        state, optimizer = create_train_state(cfg, device, gen,
                                              optimizer=opt, mesh=mesh,
                                              rules=rules)
    if args.lora_rank > 0:
        step_fn = lora.make_lora_train_step(cfg, optimizer, base,
                                            alpha=args.lora_alpha,
                                            forward=args.lora_forward,
                                            mesh=mesh)
    else:
        step_fn = make_train_step(cfg, optimizer, mesh=mesh,
                                  grad_fn=grad_fn, rules=rules)
    start_step = state.step

    if args.data:
        from tpu_docker_api_torch.data import make_batch_fn, open_token_files

        bin_dtype = args.data_dtype or (
            "int32" if cfg.vocab_size > 65535 else "uint16")
        source = open_token_files(args.data, window=seq + 1,
                                  bin_dtype=bin_dtype)
        batch_at = make_batch_fn(source, args.batch, seed=args.data_seed)

        def get_batch(i):
            return torch.from_numpy(batch_at(i)).long()
    elif family == "vit":
        from tpu_docker_api_torch.models.vit import vit_synthetic_batch

        def get_batch(i):
            return vit_synthetic_batch((args.seed + 1, i), args.batch, cfg,
                                       device=device)
    elif family == "encdec":
        from tpu_docker_api_torch.models.encdec import encdec_synthetic_batch

        def get_batch(i):
            return encdec_synthetic_batch((args.seed + 1, i), args.batch,
                                          seq, seq, cfg, device=device)
    else:
        def get_batch(i):
            return synthetic_batch(step_generator(args.seed + 1, i, device),
                                   args.batch, seq, cfg.vocab_size)

    # quiesce contract: graceful stop ⇒ checkpoint ⇒ exit 0
    stop = {"now": False}

    def _quiesce(signum, _frame):
        stop["now"] = True

    signal.signal(signal.SIGTERM, _quiesce)
    signal.signal(signal.SIGINT, _quiesce)

    def _save(final: bool = False) -> None:
        if mgr is None:
            return
        mgr.save(state)
        if final:
            mgr.wait()
            for rec in mgr.history:
                emit({"event": "saved", **rec})

    def _sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    # trace a window of steps after the first of this run (cuBLAS
    # handles, allocator pools and kernel builds land in the first)
    profile_at = (min(start_step + 1, args.steps - 1)
                  if args.profile_dir and rank == 0 else -1)
    prof, prof_t0 = None, 0.0

    def _stop_profile():
        nonlocal prof
        _sync()
        wall = time.perf_counter() - prof_t0
        prof.stop()
        os.makedirs(args.profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.profile_dir,
                                              "trace.json"))
        emit({"event": "profile_written", "dir": args.profile_dir,
              **device_time_summary(prof, wall,
                                    ranges=(*STEP_RANGES,
                                            STE_BACKWARD_RANGE))})
        prof = None

    tokens_per_step = args.batch * seq
    t0 = time.monotonic()
    try:
        for i in range(start_step, args.steps):
            if i == profile_at:
                _sync()
                activities = [torch.profiler.ProfilerActivity.CPU]
                if device.type == "cuda":
                    activities.append(torch.profiler.ProfilerActivity.CUDA)
                prof = torch.profiler.profile(activities=activities)
                prof.start()
                prof_t0 = time.perf_counter()
            state, metrics = step_fn(state, get_batch(i))
            if prof is not None and i >= profile_at + args.profile_steps - 1:
                _stop_profile()
            done = i + 1  # host counter: no device read per step
            if stop_group is not None:
                flag = torch.tensor([int(stop["now"])])
                torch.distributed.all_reduce(
                    flag, op=torch.distributed.ReduceOp.MAX,
                    group=stop_group)
                stop["now"] = bool(flag.item())
            if stop["now"]:
                if prof is not None:
                    _stop_profile()
                _save(final=True)
                emit({"event": "quiesced", "step": done})
                return 0
            if done % args.log_every == 0 or done == args.steps:
                loss = float(metrics["loss"])
                dt = time.monotonic() - t0
                emit({"step": done, "loss": round(loss, 4),
                      "tokens_per_sec": round(
                          (done - start_step) * tokens_per_step / dt, 1)})
            if done % args.save_every == 0:
                _save()
        if prof is not None:  # the window outran the step budget
            _stop_profile()
        _save(final=True)
    finally:
        if mgr is not None:
            mgr.close()
    emit({"event": "done", "step": state.step})
    return 0


if __name__ == "__main__":
    sys.exit(main())
