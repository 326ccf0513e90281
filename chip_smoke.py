#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, one JSON line each; any failure exits non-zero:

1. env      — card name and power limit (nvidia-smi), torch/CUDA versions.
2. build    — nvcc builds every kernel from csrc/ (in parallel), with the
              ``-Xptxas -v`` register and shared-memory lines and the
              count of tensor-core instructions (HGMMA, HMMA) in each
              library's SASS; fails if a flash library has none.
2b. devices — the control plane's GPU seams (``phase_devices``), cheap,
              so a fault shows before the long phases: the gpu-detect
              sidecar (``telemetry/sidecar.py``, real probe over NVML)
              held against ``nvidia-smi`` (UUID, name, driver version and
              index equal; memory within 1 MiB, power limit within 1 W;
              ``nvml.h``'s structs against the binding's where the
              toolkit has the header), the probe's and a GET's times; a
              ``ChipScheduler`` on a ``SqliteKV`` under ``build/devices``
              seeded from the reply grants the GPU, refuses a second
              (ChipNotEnough), restores the grant after a restart;
              ``render_gpu_attachment`` on a spec that
              ``FakeRuntime(allow_exec=True)`` runs a child under: it
              sees one GPU, the granted UUID, holds 4 GiB and runs the
              flash kernel (R=4, s=2048, 32/8 heads, d 64) for ~3 s while
              the sidecar is polled (hbm_used must rise >= 4 GiB and the
              duty cycle be > 0 on a poll; the peak and whether the
              child's pid showed are printed); a zero-GPU spec carries
              no CUDA_VISIBLE_DEVICES; ``DockerRuntime`` against
              ``runtime/fake_engine.py`` sends the reference's nvidia
              ``DeviceRequests`` and reads the UUID back.
2c. control_plane — the port's daemon through its entry point
              (``phase_control_plane``): ``python -m tpu_docker_api_torch``
              on the sqlite store and the fake runtime, the topology from
              NVML. ``/resources/gpus`` lists nvidia-smi's one UUID; a
              ``gpuCount: 1`` run makes ``g-0`` and a second is refused
              (ChipNotEnough); an exec in ``g-0`` runs a child that sees
              one GPU, the granted UUID, and holds flash_fwd at the
              devices shape against its plain version; ``PATCH .../gpu``
              to 0 frees the GPU (``g-1``'s child sees no device) and back
              to 1 grants it again (``g-2``). Then 200 families (one
              port each, replaced twice, 3 versions, the list paged) and
              50 volumes with a 16 MiB seeded file, resized; SIGKILL
              right after the second half's resizes are acknowledged,
              a restart on the same file: every write reads back, the
              journal replays every copy bit for bit, the grant and its
              refusal hold; a teardown frees every port and the GPU.
              Boot and restart-to-ready s, run/replace/delete p50 and p99,
              a list page, the queue's drain times, the child's first
              flash call.
2d. reconcile — the port's reconciler (``phase_reconcile``): JAX's 13
              container crash cases (tests/test_chaos.py, grow gpuCount 0
              -> 1, shrink 1 -> 0, a bind swap) in this process on the
              sqlite store and a persisting fake runtime under
              ``build/reconcile``, the NVML topology: the flow dies at its
              crash point, a fresh Program boots on the same file and
              root, and its startup reconcile leaves ``check_invariants``
              empty, one running version, the H100 owned by exactly the
              latest spec or free, the data in place. Then the daemon by
              its entry point with ``reconcile_on_start``, a 1 s periodic
              pass, the watch-fed dirty mode and ``fanout_workers = 4``
              (a pool nothing on the container path submits to yet): 200
              families and ``g`` holding the H100, a SIGKILL, ``g-0``
              removed from the fake runtime while the daemon is down, a
              restart whose startup repair (``/api/v1/reconcile/events``)
              frees the H100; ``h`` is granted it by UUID and its exec
              runs flash_fwd against the plain version; a dry run finds
              no drift. Medians of 5 of a full pass's ``durationMs``, of
              a dirty pass's over 20 families stopped through the API
              just before it (each pass visits exactly those 20), and of
              restart-to-ready.
3. kernels  — each kernel against its plain PyTorch version on the card,
              at the shapes the serving, training and LoRA paths give it
              (adam8 on the adapters' f32 leaves at b = 16, 256 and 4,
              on the moe phase's f32 router at b = 8 and bf16 expert
              leaves, and on the vit and encdec phases' leaves; flash
              non-causal at the vit and encdec shapes, 128 x 256 and 32
              x 512 with 12/12 heads, and at 257 tokens, causal at the
              encdec decoder's 32 x 512, and non-causal at batch 1 with
              100, 128 and 500 tokens, the encoder of encdec_generate)
              and at the edges of the kernels' tiles, with stated
              tolerances;
              times of the kernel (device time, its wrapper's host time
              a call, and back-to-back calls with the host's time in),
              the plain version, one PyTorch library call as a yardstick
              where one computes the same function, and the card's bound
              (flash_fwd at the serve path's R=1 and the training shape
              R=4).
4. serve    — ``tpu_docker_api_torch.serve`` in process at llama3-1b full
              width (random weights from a seed): 8 concurrent greedy
              requests of 17-1900 prompt tokens, a streamed one and a
              sampled one. Every kernel's launch count is zeroed just
              before and read just after; each kernel of the path must
              have launched. The first-token logits of one prompt through
              the kernel path are held against a plain-path forward.
5. serve_int8_text — the server with ``--quantize --tokenizer`` at
              llama3-1b full width and depth (``phase_serve_int8_text``):
              int8 projections quantized after the load, a Llama-3-shaped
              ``tokenizer.json`` this script writes, the serve phase's
              burst as ids, a text request and a streamed one; int8
              bytes, /healthz, flash launches, ``torch._int_mm`` exact on
              the card, the tokenizer's round trip, and the int8 logits'
              cosine to the bf16 model's; launches and device time of one
              decode step on each tree.
5b. serve_depth — the KV cache's serving depth through the server's HTTP
              entry point at llama3-1b full width and depth
              (``phase_serve_depth``): a 1,024-token prefix registered by
              POST /prefixes (its K/V bytes, GET, DELETE), 8 prompts of
              prefix + 17-512 tokens with it and without it; the
              first-token logits of the prefix, segment and paged routes
              against the whole-prompt flash path (2e-2 relative L2);
              seven streams decoding beside one 1,900-token admission with
              --prefill-chunk 256 and 0 (gaps between tokens, the long
              request's TTFT); the paged cache (--page-size 32) on the
              serve burst (256 pages, half the dense cache's bytes), with
              the prefix's pages shared, and a 48-page pool that must
              preempt; every page back after each drain; flash_fwd on
              every prefix build and paged prefill; the device time of a
              decode step through pages against the dense cache and of a
              256-token segment's offset attention; peak memory of dense
              and paged at 64 slots x 8192.
5c. speculative — speculative decoding (``phase_speculative``): the
              batch-1 generator at llama3-1b full width and depth, the
              target its own draft (128-token prompt, 128 new, k = 4,
              against plain greedy; fewer than 64 rounds); the
              ``SpeculativeSlotEngine`` on the serve burst (8 slots,
              2,048 positions, 32 new) with a self-draft (at least half of
              the proposals accepted) and with a llama3-8b target and a
              llama3-1b draft, each against a plain ``SlotEngine`` on the
              same burst (TTFT/ITL p50, rounds, accepted tokens, peak
              memory, flash launches of both models' prefills); the
              server's ``--draft-preset llama3-1b --n-spec 4`` (/healthz,
              greedy burst, a sampled request on the --slots 0 path).
              Every emitted token lies within 2ε of the target's
              teacher-forced argmax (one flash prefill of prompt +
              output), ε being the largest logit difference between
              routes on the same positions of the same streams: the
              verify route against the one-token route, and the
              one-token route against the flash prefill.
5d. servebench — ``infer/servebench.py`` at the JAX defaults:
              ``bench_concurrent_serving`` (llama3-1b, 8 streams,
              128/64), ``bench_decode_roofline`` (llama3-8b int8, batch
              64; % of the 3.35 TB/s roof beside the card's name and
              power limit), ``bench_int8_serving`` (llama3-8b, batch 64),
              ``bench_tail_latency`` and ``bench_moe_serving`` (bench-moe,
              batch 8, 128/64); one JSON line each, each ok (the MoE one:
              a positive decode rate).
6. train    — the trainer's entry points at llama3-1b full width and depth,
              batch 4 x 2048, random weights from a seed: 4 steps under
              ``adamw`` and 4 under ``adamw-int8`` on one repeated batch,
              the counts zeroed just before and read just after each run.
              Checks: finite losses, the first near ln(vocab), the loss
              falls, each kernel launched its expected count per step,
              the gradients of wq/wk/wv of one full-width block through
              the kernels match the dense plain path, and the chunked
              loss matches the dense one. Then the command-line trainer
              in process with ``--profile-dir`` for where a step's time
              goes.
7. lifecycle — train → checkpoint → resume → export → serve at llama3-1b
              full width and depth through the command-line entry points
              (``phase_lifecycle``): a resumed run and a SIGTERM-quiesced
              one must equal an uninterrupted run, and ``--hf-ckpt`` and
              ``--ckpt-dir`` servers must give the greedy tokens of the
              restored params in memory; checkpoint bytes, the step
              loop's blocked time and the writer's time of each save,
              restore, export, import and serve-ready seconds. Under
              ``build/lifecycle``, deleted at the end; it checks the free
              disk first.
8. lora     — LoRA and QLoRA at llama3-1b full width and depth, rank 16
              on wq and wv (``phase_lora``): 4 merged steps under adamw
              over the bf16 base and 4 QLoRA steps under adamw-int8 over
              the int8 base, in process (first loss bit-equal to the base
              model's, base bit-unchanged, launches, adapter gradients
              through the kernels against the dense path, the chunked
              loss over the int8 head); the trainer CLI's --qlora run
              and a resumed one (bit-equal adapter checkpoints), a merged
              run, an attached ``--quantize`` server and a merged one
              (greedy tokens of an in-memory engine), the attached
              server's burst latency and decode-step kernels; then
              llama3-8b QLoRA at batch 1 x 2048 through the trainer CLI
              (base unchanged, peak memory, device time by kernel class
              with the int8 straight-through backward's range). Under
              ``build/lora``, deleted at the end.
9. moe      — the Mixtral-style MoE family (``phase_moe``): mixtral-8x7b
              at its published width with 16 layers (47.0 GB of bf16
              weights) in a ``SlotEngine`` of 8 slots x 2048 on the serve
              phase's burst, 32 greedy tokens (TTFT/ITL p50, peak memory,
              flash_fwd 16 a prefill group, one decode step's device time
              and kernels against the bytes it reads at 3.35 TB/s, the
              burst's longest prompt's first-token logits in its 2048
              bucket through the kernel route against the plain one with
              the expert picks replayed, and the share of picks that
              differ when they are not); 4 layers trained under
              adamw-int8 at batch 2 x 2048 on a repeated batch (losses,
              launches a step, one block's wq/router/w_gate gradients at
              2 x 2048 through the kernels against the dense path, picks
              replayed); the trainer CLI on moe:bench-moe at full depth
              under --moe-dispatch gather (with --profile-dir) and einsum
              (equal first loss), and the server on it (a burst, a
              stream, /healthz).
10. vit     — vit-b16 at its published width and depth (``phase_vit``):
              the short-encoder attention rule (flash ``causal=False``
              against dense, forward and forward + backward, at vit-b16's
              128 x 256 and encdec-base's 32 x 512 encoder shape); 4
              steps under adamw-int8 on a repeated batch of 128 (losses
              falling, launches a step: flash 12 each, adam8 one a leaf),
              ``time_train_steps`` under adamw and adamw-int8 (images/s,
              MFU by ``flops_per_image``, peak memory) and under adamw
              with the dense attention forced; one block's wq/wk/wv
              gradients through the kernels against the dense path
              (2e-2 relative L2); the trainer CLI on vit:vit-b16 at
              batch 128 with --profile-dir; the MNIST MLP's loss and
              gradients on the card against the CPU (1e-5, f32).
11. encdec  — encdec-base at its published width and full depth
              (``phase_encdec``): 4 steps under adamw-int8 at 32 x (512,
              512) on a repeated batch (flash 36 a step each: encoder,
              decoder and equal-length cross-attention), then
              ``time_train_steps`` under adamw (pairs/s, MFU by
              ``flops_per_pair``); the trainer CLI on
              encdec:encdec-base with --profile-dir; the server on it: a
              burst of 8 srcTokens requests of 17-500 tokens through
              the slot engine, /healthz, the share of streams
              token-exact against isolated greedy ``encdec_generate``
              (reported), the first-step logits of the slot route
              (the server's own engine on a reused slot, its sampler
              wrapped) against ``encdec_generate``'s on the burst's
              500-token source (2e-2 relative L2), one
              ``--slots 0`` request (its tokens those of
              ``encdec_generate``, flash once an encoder layer);
              ``bench_encdec_slot_serving`` at the JAX defaults, ``ok``.

- parallel: the mesh path (parallel/, one process a device) at world
              size 1 over NCCL, full width: llama3-1b trained 3 steps of
              4 x 2048 under adamw-int8 twice from one seed, on a
              ``--dp 1 --fsdp 1 --tp 1`` mesh (DTensor leaves) and on
              the single-device path: the sharded init bit-equal, the
              losses within 1e-3 relative, step 1's gradients within
              2e-2 (relative L2 per leaf), the launches of the four
              kernels in a step equal; step ms and peak memory of both.
              Then ``attention_impl`` forced to ring, ring-zigzag and
              ulysses at sp 1: logits within 2e-2 of the flash path,
              ulysses through flash_fwd; one moe:bench-moe step on an
              ``--ep 1`` mesh with ``sort`` against the single-device
              sort step (1e-3 relative); ``serve --tp 1`` (the slot
              engine mirrored over the mesh) against the one-device
              server on a 1,900-token greedy request of 32 tokens:
              tokens equal, TTFT and ITL p50 of both (the engine's,
              over 3 requests one after another); the mesh state's
              checkpoint restored on the single-device path bit-equal.
              Multi-rank speed is not measured on one card.
- pipeline: ``--pp``'s path at pp 1 (``phase_pipeline``): llama3-1b, 3
              steps of 4 x 2048 under adamw-int8 through the trainer
              CLI's ``pipeline_parts`` (``pipeline_rules`` and
              ``make_train_step(grad_fn=pipeline_1f1b_grads)``, 4
              microbatches of a row: every forward, stash, recompute,
              autograd backward, f32 accumulation and the deferred
              embedding backward of the schedule, no send) against the
              parallel phase's single-device run of the same batch:
              losses within 1e-3 relative, step 1's gradients within 2e-2
              (relative L2 per leaf), each step's launches those the
              schedule implies (flash_fwd 2·L·M, dq and dk/dv L·M, adam8
              once a leaf); step ms and peak memory of both. The bubble
              and the sends of pp > 1 are not measured on one card.
- mesh:       only where more than one card is visible, or alone with
              ``python3 chip_smoke.py --mesh`` (``phase_mesh``): one rank
              a card (``python -m chip_smoke --mesh-rank``, NCCL)
              trains llama3-1b at a global 8 x 2048 on dp, fsdp, tp,
              fsdp x tp, tp x sp and sp (zigzag ring, Ulysses), and
              through the 1F1B pipeline on pp, pp 2 x tp and pp 2 x dp,
              bench-moe at ep, vit-b16 (128) and encdec-base (32 x 512)
              at tp, encdec-base on sp and sp 2 x tp (its rings), 3
              steps each, against the same runs on one card
              (losses within 1e-3 relative); ``serve --tp N`` against
              one card's stream, ``serve --dp N --slots 0`` on N rows
              (one a rank, each equal to one card's row). Step ms,
              peaks, launches a step, TTFT and ITL of each.

Then a ``{"kernels": [...]}`` summary line, the nvidia-smi line, and as
the last line ``{"ok": true, "device": {...}}``. Without a CUDA card, or
outside a checkout of the repository, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import faulthandler
import gc
import http.client
import io
import json
import math
import os
import shutil
import signal
import socket
import subprocess
import sys
import threading
import time
import traceback

import torch

#: the card's dense peaks: bf16 on the tensor cores and HBM bytes/s are
#: filled by ``read_card_peaks`` from ``scheduler/topology.py``, the seam
#: ``infer/servebench.py`` reads too; f32 outside the tensor cores is the
#: H100 SXM data sheet's
PEAK_FLOPS = {torch.float32: 67e12}
PEAK_BYTES = 0.0

LLAMA_HEADS, LLAMA_KV, LLAMA_HD = 32, 8, 64
TRAIN_STEPS = 4
TRAIN_BATCH, TRAIN_SEQ = 4, 2048
FLASH_TOL = {torch.bfloat16: (2e-2, 1e-2), torch.float32: (1e-4, 1e-4)}
#: the serving phases' burst: one prompt of each length at max_seq 2048
SERVE_LENGTHS = [17, 40, 100, 250, 511, 700, 1300, 1900]
#: the vit and encdec phases' non-causal attention, (R, s, heads, d):
#: vit-b16 at batch 128 (256 patches), encdec-base's encoder and
#: equal-length cross-attention at batch 32 x 512, and an odd length
FAMILY_SHAPES = [(128, 256, 12, 64), (32, 512, 12, 64), (2, 257, 12, 64)]
#: the encdec phase's other flash calls, (R, s, heads, d, causal): the
#: decoder's causal self-attention at 32 x 512, and the batch-1 encoder
#: of ``encdec_generate`` (the ``--slots 0`` request's 100-token source,
#: ``bench_encdec_slot_serving``'s 128, the first-logits check's 500)
FAMILY_OTHER_SHAPES = [(32, 512, 12, 64, True), (1, 100, 12, 64, False),
                       (1, 128, 12, 64, False), (1, 500, 12, 64, False)]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def read_card_peaks(dev) -> None:
    """Set ``PEAK_FLOPS[bf16]`` and ``PEAK_BYTES`` from
    ``generation_for(dev)``; the card must be a part it knows."""
    global PEAK_BYTES
    from tpu_docker_api_torch.scheduler.topology import generation_for

    gen = generation_for(dev)
    if gen is None:
        raise AssertionError(f"{torch.cuda.get_device_name(dev)}: no part "
                             f"of scheduler/topology.py GENERATIONS")
    PEAK_FLOPS[torch.bfloat16] = gen.peak_bf16_flops
    PEAK_BYTES = gen.hbm_bytes_per_s


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


#: card cycles to sleep for each timed call (~1 ms at the H100's clocks)
SLEEP_CYCLES_PER_CALL = 2_000_000


def _timed(fn, iters: int, warmup: int, sleep: bool) -> tuple[float, float]:
    """(ms per call by CUDA events around ``iters`` back-to-back calls,
    host us per call to enqueue them). With ``sleep`` the card sleeps
    while the host enqueues, so the calls run back to back on the card
    and the events read device time only; without it, a call whose host
    side is slower than its kernel reads as its host time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if sleep:
        torch.cuda._sleep(SLEEP_CYCLES_PER_CALL * iters)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, host_s / iters * 1e6


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device milliseconds per call (a wrapper's host time is not
    counted)."""
    return _timed(fn, iters, warmup, sleep=True)[0]


def kernel_times(fn, iters: int, warmup: int = 3) -> dict:
    """A kernel wrapper's three readings: ``ms``, device time per call;
    ``host_us``, the host's time per call to enqueue it (the wrapper's
    checks, allocations, TMA map encoding and the launch); and
    ``ms_back_to_back``, events around back-to-back calls with no sleep,
    which count the host's time where it exceeds the kernel's."""
    ms, host_us = _timed(fn, iters, warmup, sleep=True)
    return {"ms": ms, "host_us": host_us,
            "ms_back_to_back": _timed(fn, iters, warmup, sleep=False)[0]}


def flash_bound_ms(R, s, h, hk, d, dtype, causal=True) -> tuple[float, str]:
    """Least time on the card: the larger of the operations at peak and
    the bytes (q, k, v, out read/written once, lse f32) at HBM rate.
    Causal work counts the s(s+1)/2 visible pairs this input has."""
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 4 * R * h * d * pairs
    esize = torch.finfo(dtype).bits // 8
    nbytes = esize * R * s * d * (2 * h + 2 * hk) + 4 * R * h * s
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_kernels(dev) -> dict:
    from tpu_docker_api_torch.ops import flash

    g = torch.Generator(device=dev).manual_seed(0)

    def qkv(R, s, h, hk, d, dtype):
        # the model's (R, s, heads, d) layout, handed over as views
        mk = [torch.randn(R, s, n, d, generator=g, device=dev).to(dtype)
              for n in (h, hk, hk)]
        return [t.transpose(1, 2) for t in mk]

    bf = torch.bfloat16
    shapes = [(R, s, LLAMA_HEADS, LLAMA_KV, LLAMA_HD, bf, True)
              for s in (32, 64, 100, 512, 2048) for R in (1, 8)]
    # the edges of the tiles (64 queries a block, 128 keys a kv tile);
    # GQA groups of 1 and 4, d=128, full attention
    shapes += [(2, s, 8, hk, d, bf, causal) for s in (1, 65, 129)
               for hk, d, causal in ((8, 64, True), (2, 128, True),
                                     (2, 64, False))]
    # mixtral's heads (GQA R = 4, d 128): a serve prefill group of one and
    # two rows, and the moe training forward, at 2048
    shapes += [(1, 1024, 32, 8, 128, bf, True),
               (1, 2048, 32, 8, 128, bf, True),
               (2, 2048, 32, 8, 128, bf, True),
               (1, 512, LLAMA_HEADS, LLAMA_KV, LLAMA_HD, torch.float32, True)]
    shapes += [(R, s, h, h, d, bf, False) for R, s, h, d in FAMILY_SHAPES]
    shapes += [(R, s, h, h, d, bf, causal)
               for R, s, h, d, causal in FAMILY_OTHER_SHAPES]
    cases, max_err = [], 0.0
    for R, s, h, hk, d, dtype, causal in shapes:
        q, k, v = qkv(R, s, h, hk, d, dtype)
        out, lse = flash.flash_attention_fwd(q, k, v, causal=causal)
        torch.cuda.synchronize()
        ref_out, ref_lse = flash.flash_attention_fwd_plain(q, k, v, causal)
        err = (out.float() - ref_out.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        tol, lse_tol = FLASH_TOL[dtype]
        ok = err <= tol and lse_err <= lse_tol
        cases.append({"R": R, "s": s, "heads": h, "kv_heads": hk, "d": d,
                      "dtype": str(dtype).split(".")[-1], "causal": causal,
                      "max_abs_err": err, "lse_err": lse_err, "tol": tol,
                      "lse_tol": lse_tol, "ok": ok})
        if not ok:
            raise AssertionError(f"flash_fwd disagrees with plain: "
                                 f"{cases[-1]}")
        if dtype == torch.bfloat16:
            max_err = max(max_err, err)
        del q, k, v, out, lse, ref_out, ref_lse
        torch.cuda.empty_cache()

    # times at the serve path's largest prefill (R=1) and at the training
    # shape (R=4), s=2048, llama3-1b heads
    sdpa = torch.nn.functional.scaled_dot_product_attention
    timing = {}
    for R in (1, TRAIN_BATCH):
        s = TRAIN_SEQ
        q, k, v = qkv(R, s, LLAMA_HEADS, LLAMA_KV, LLAMA_HD, bf)
        kt = kernel_times(lambda: flash.flash_attention_fwd(q, k, v), 50)
        plain_ms = cuda_ms(
            lambda: flash.flash_attention_fwd_plain(q, k, v, True), 5)
        # yardstick only: the port never calls it
        library_ms = cuda_ms(
            lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True), 50)
        bound_ms, bound_by = flash_bound_ms(R, s, LLAMA_HEADS, LLAMA_KV,
                                            LLAMA_HD, bf)
        timing[f"R{R}"] = {
            "R": R, "s": s, **kt, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "roofline_share": bound_ms / kt["ms"]}
        del q, k, v
        torch.cuda.empty_cache()
    # and non-causal at the vit and encdec families' shapes
    for R, s, h, d in FAMILY_SHAPES[:2]:
        q, k, v = qkv(R, s, h, h, d, bf)
        kt = kernel_times(lambda: flash.flash_attention_fwd(q, k, v, False),
                          50)
        bound_ms, bound_by = flash_bound_ms(R, s, h, h, d, bf, causal=False)
        timing[f"noncausal_R{R}_s{s}"] = {
            "R": R, "s": s, "heads": h, **kt,
            "plain_ms": cuda_ms(lambda: flash.flash_attention_fwd_plain(
                q, k, v, False), 5),
            "library_ms": cuda_ms(lambda: sdpa(q, k, v), 50),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "roofline_share": bound_ms / kt["ms"]}
        del q, k, v
        torch.cuda.empty_cache()
    emit({"phase": "kernels", "kernel": "flash_fwd", "cases": cases,
          "timing": timing})
    return {"max_abs_err": max_err, **timing["R1"],
            "at_train_shape": timing[f"R{TRAIN_BATCH}"]}


def _bound(flops: float, nbytes: float, dtype) -> tuple[float, str]:
    """Least time on the card in ms, and what bounds it."""
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def flash_bwd_bounds(R, s, h, hk, d, dtype, causal=True) -> dict:
    """Bounds of the two backward kernels. Per visible (query, key) pair
    dq does 6d FLOPs (scores, dP, dQ) and dk/dv 8d (scores, dP, dV, dK).
    dq reads q, k, v, out, dout, lse and writes dq and D; dk/dv reads q,
    k, v, dout, lse, D and writes dk and dv."""
    pairs = s * (s + 1) // 2 if causal else s * s
    esize = torch.finfo(dtype).bits // 8
    q_bytes, kv_bytes, stat = R * h * s * d * esize, R * hk * s * d * esize, \
        R * h * s * 4
    dq = _bound(6 * d * R * h * pairs,
                4 * q_bytes + 2 * kv_bytes + 2 * stat, dtype)
    dkv = _bound(8 * d * R * h * pairs,
                 2 * q_bytes + 4 * kv_bytes + 2 * stat, dtype)
    return {"flash_bwd_dq": dq, "flash_bwd_dkv": dkv}


def phase_flash_bwd(dev) -> dict:
    """The two backward kernels against the plain backward: the training
    shape (R=4, s=2048, llama3-1b heads, causal), the moe training shape
    (R=2, s=2048, mixtral's 32/8 heads, d=128), ragged and small
    lengths, the edges of the tiles (64-query tiles, dq's 64-key kv
    tiles and dk/dv's 64-key blocks: seq 1, 65, 127, 128, 129, 255, 257;
    GQA groups of 1 and 4), d=128, non-causal cases, the vit and encdec
    phases' shapes (``FAMILY_SHAPES``, ``FAMILY_OTHER_SHAPES``) and an
    f32 case."""
    from tpu_docker_api_torch.ops import flash

    g = torch.Generator(device=dev).manual_seed(1)

    def mk(R, s, n, d, dtype):
        return torch.randn(R, s, n, d, generator=g, device=dev).to(
            dtype).transpose(1, 2)

    shapes = [(4, 2048, LLAMA_HEADS, LLAMA_KV, LLAMA_HD, torch.bfloat16,
               True),
              (1, 100, LLAMA_HEADS, LLAMA_KV, LLAMA_HD, torch.bfloat16, True),
              (2, 300, LLAMA_HEADS, LLAMA_KV, LLAMA_HD, torch.bfloat16, True),
              (1, 64, LLAMA_HEADS, LLAMA_KV, LLAMA_HD, torch.bfloat16, True),
              (1, 1000, 8, 2, 128, torch.bfloat16, True),
              # the moe training shape: mixtral's heads, GQA R = 4, d 128
              (2, 2048, 32, 8, 128, torch.bfloat16, True),
              (1, 384, 8, 2, LLAMA_HD, torch.bfloat16, False),
              (1, 512, LLAMA_HEADS, LLAMA_KV, LLAMA_HD, torch.float32, True)]
    shapes += [(2, s, 8, hk, d, torch.bfloat16, causal) for s in (1, 65, 129)
               for hk, d, causal in ((8, 64, True), (2, 128, True),
                                     (2, 64, False))]
    shapes += [(2, s, 8, hk, 64, torch.bfloat16, True)
               for s in (127, 128, 255, 257) for hk in (8, 2)]
    shapes += [(2, 255, 8, 8, 128, torch.bfloat16, True)]
    shapes += [(R, s, h, h, d, torch.bfloat16, False)
               for R, s, h, d in FAMILY_SHAPES]
    shapes += [(R, s, h, h, d, torch.bfloat16, causal)
               for R, s, h, d, causal in FAMILY_OTHER_SHAPES]
    cases = []
    max_err = {"flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    for R, s, h, hk, d, dtype, causal in shapes:
        q, k, v, do = mk(R, s, h, d, dtype), mk(R, s, hk, d, dtype), \
            mk(R, s, hk, d, dtype), mk(R, s, h, d, dtype)
        out, lse = flash.flash_attention_fwd(q, k, v, causal)
        got = flash.flash_attention_bwd(q, k, v, out, lse, do, causal)
        torch.cuda.synchronize()
        ref = flash.flash_attention_bwd_plain(q, k, v, out, lse, do, causal)
        # bf16: both round the f32 result once, the kernels also P and
        # dS before dk/dv's products, the f32 sums run in another order;
        # 2e-2 of the largest |grad| leaves room for all three. f32: only
        # the order differs. At s=1 the one key has P = 1, so dS = 0 and
        # dq, dk are f32 rounding noise in both: held to 2e-2 of max|dv|.
        rtol = 2e-2 if dtype == torch.bfloat16 else 1e-4
        errs = [(a.float() - b.float()).abs().max().item()
                for a, b in zip(got, ref)]
        scales = [b.float().abs().max().item() for b in ref]
        if s == 1:
            scales[:2] = [scales[2]] * 2
        tols = [rtol * x for x in scales]
        ok = all(e <= t for e, t in zip(errs, tols))
        cases.append({"R": R, "s": s, "heads": h, "kv_heads": hk, "d": d,
                      "dtype": str(dtype).split(".")[-1], "causal": causal,
                      "err_dq_dk_dv": errs, "tol_dq_dk_dv": tols,
                      "ok": ok})
        if not ok:
            raise AssertionError(f"flash backward disagrees with plain: "
                                 f"{cases[-1]}")
        if dtype == torch.bfloat16:
            max_err["flash_bwd_dq"] = max(max_err["flash_bwd_dq"], errs[0])
            max_err["flash_bwd_dkv"] = max(max_err["flash_bwd_dkv"],
                                           *errs[1:])
        del q, k, v, do, out, lse, got, ref
        torch.cuda.empty_cache()

    # times at the training shape
    R, s, h, hk, d = 4, 2048, LLAMA_HEADS, LLAMA_KV, LLAMA_HD
    dt = torch.bfloat16
    q, k, v, do = mk(R, s, h, d, dt), mk(R, s, hk, d, dt), \
        mk(R, s, hk, d, dt), mk(R, s, h, d, dt)
    out, lse = flash.flash_attention_fwd(q, k, v, True)
    _, delta = flash.flash_bwd_dq(q, k, v, out, lse, do, True)
    kt = {"flash_bwd_dq": kernel_times(
              lambda: flash.flash_bwd_dq(q, k, v, out, lse, do, True), 20),
          "flash_bwd_dkv": kernel_times(
              lambda: flash.flash_bwd_dkv(q, k, v, lse, delta, do, True),
              20)}
    # the plain version computes dq, dk and dv together: one time for both
    plain_ms = cuda_ms(lambda: flash.flash_attention_bwd_plain(
        q, k, v, out, lse, do, True), 3, warmup=1)
    # yardstick only, the port never calls it: SDPA's backward, timed as
    # forward + backward less forward (it computes dq, dk and dv at once)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))

    def fwd_bwd():
        o = sdpa(qr, kr, vr, is_causal=True, enable_gqa=True)
        torch.autograd.grad(o, (qr, kr, vr), do)

    with torch.no_grad():
        sdpa_fwd = cuda_ms(lambda: sdpa(q, k, v, is_causal=True,
                                        enable_gqa=True), 20)
    library_ms = cuda_ms(fwd_bwd, 20) - sdpa_fwd
    bounds = flash_bwd_bounds(R, s, h, hk, d, dt)
    result = {}
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        result[name] = {"max_abs_err": max_err[name], **kt[name],
                        "plain_ms": plain_ms, "library_ms": library_ms,
                        "bound_ms": bounds[name][0],
                        "bound_by": bounds[name][1],
                        "roofline_share": bounds[name][0] / kt[name]["ms"]}
    del q, k, v, do, out, lse, delta, qr, kr, vr
    torch.cuda.empty_cache()
    # and non-causal at the vit and encdec families' shapes
    family = {}
    for fR, fs, h, d in FAMILY_SHAPES[:2]:
        q, k, v, do = (mk(fR, fs, h, d, dt) for _ in range(4))
        out, lse = flash.flash_attention_fwd(q, k, v, False)
        _, delta = flash.flash_bwd_dq(q, k, v, out, lse, do, False)
        bounds = flash_bwd_bounds(fR, fs, h, h, d, dt, causal=False)
        row = {"R": fR, "s": fs, "heads": h, "plain_ms": cuda_ms(
            lambda: flash.flash_attention_bwd_plain(q, k, v, out, lse, do,
                                                    False), 3, warmup=1)}
        for name, fn in (
                ("flash_bwd_dq", lambda: flash.flash_bwd_dq(
                    q, k, v, out, lse, do, False)),
                ("flash_bwd_dkv", lambda: flash.flash_bwd_dkv(
                    q, k, v, lse, delta, do, False))):
            kt = kernel_times(fn, 20)
            row[name] = {**kt, "bound_ms": bounds[name][0],
                         "bound_by": bounds[name][1],
                         "roofline_share": bounds[name][0] / kt["ms"]}
        # SDPA's backward at this shape, as above: forward + backward
        # less forward (yardstick only)
        qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))

        def fam_fwd_bwd():
            o = sdpa(qr, kr, vr)
            torch.autograd.grad(o, (qr, kr, vr), do)

        with torch.no_grad():
            fam_fwd = cuda_ms(lambda: sdpa(q, k, v), 20)
        row["library_ms"] = cuda_ms(fam_fwd_bwd, 20) - fam_fwd
        row["sdpa_fwd_ms"] = fam_fwd
        family[f"noncausal_R{fR}_s{fs}"] = row
        del q, k, v, do, out, lse, delta, qr, kr, vr
        torch.cuda.empty_cache()
    emit({"phase": "kernels", "kernel": "flash_bwd", "cases": cases,
          "timing": {"R": R, "s": s, **result,
                     "library": "sdpa fwd+bwd - fwd",
                     "sdpa_fwd_ms": sdpa_fwd, "family_shapes": family}})
    return result


#: llama3-1b's parameter leaves: (name, shape) — one step's adam8 launches
LLAMA3_1B_LEAVES = [
    ("embed.tokens", (128256, 2048)), ("attn_norm", (16, 2048)),
    ("mlp_norm", (16, 2048)), ("wq", (16, 2048, 2048)),
    ("wk", (16, 2048, 512)), ("wv", (16, 2048, 512)),
    ("wo", (16, 2048, 2048)), ("w_gate", (16, 2048, 8192)),
    ("w_up", (16, 2048, 8192)), ("w_down", (16, 8192, 2048)),
    ("final_norm", (2048,)), ("lm_head", (2048, 128256))]


def _adam8_leaf(dev, g, shape, block=256, dtype=torch.bfloat16):
    """grad and param in ``dtype``, int8 moments from small random f32
    ones."""
    from tpu_docker_api_torch.train import optim

    grad = (torch.randn(shape, generator=g, device=dev) * 1e-3).to(dtype)
    p = (torch.randn(shape, generator=g, device=dev) * 2e-2).to(dtype)
    mq, ms = optim._quant_signed(
        torch.randn(shape, generator=g, device=dev) * 1e-4, block)
    vq, vs = optim._quant_sqrt(
        torch.rand(shape, generator=g, device=dev) * 1e-8, block)
    return grad, mq, ms, vq, vs, p


#: a leaf whose quantization block (b = 100) is not a multiple of 8: the
#: kernel's scalar path
SCALAR_PATH_LEAF = ("scalar-path b=100", (4096, 100))
#: llama3-1b's f32 LoRA adapters on wq and wv at rank 16 (A: b = 16, the
#: vector path with 2 of a warp's lanes per block; B: b = 256) and A at
#: rank 4 (b = 4, the scalar path): the lora phase's adam8 leaves
ADAPTER_LEAVES = [("lora A rank 16", (16, 2048, 16)),
                  ("lora B wq rank 16", (16, 16, 2048)),
                  ("lora B wv rank 16", (16, 16, 512)),
                  ("lora A rank 4", (16, 2048, 4))]


#: the moe phase's leaves at Mixtral width (its training runs 4 layers;
#: one layer's expert leaves here, 470 M elements each): the f32 router
#: (b = 8: the vector path, one lane a block) and the bf16 expert
#: matrices (b = 256)
MOE_LEAVES = [("moe router", (4, 4096, 8), torch.float32),
              ("moe w_gate", (1, 8, 4096, 14336), torch.bfloat16),
              ("moe w_down", (1, 8, 14336, 4096), torch.bfloat16)]


#: the vit and encdec phases' bf16 leaves that no other phase runs:
#: vit-b16's vectors and stacked norms, biases and b1, pos_emb, its head,
#: a 10-class head, the stacked projections and MLP matrices both
#: families share, and encdec-base's embedding and lm_head (its norms
#: are the vit's (768,) and (12, 768))
FAMILY_LEAVES = [("vit final_ln / patch bias", (768,)),
                 ("vit stacked ln / b2", (12, 768)),
                 ("vit stacked b1", (12, 3072)),
                 ("vit pos_emb", (256, 768)),
                 ("vit head", (768, 1000)),
                 ("10-class head", (768, 10)),
                 ("vit / encdec attn wq wk wv wo", (12, 768, 768)),
                 ("vit w1 / encdec w_gate w_up", (12, 768, 3072)),
                 ("vit w2 / encdec w_down", (12, 3072, 768)),
                 ("encdec embed", (32000, 768)),
                 ("encdec lm_head", (768, 32000))]


def _adam8_bound(shape, dtype) -> tuple[float, str]:
    """g, p, update in ``dtype``; mq, vq read and written in int8; four
    f32 scales per block; ~30 f32 operations an element."""
    from tpu_docker_api_torch.train import optim

    n = math.prod(shape)
    b = optim._block_of(shape[-1], 256)
    esize = torch.finfo(dtype).bits // 8
    return _bound(30 * n, (3 * esize + 4) * n + 16 * (n // b),
                  torch.float32)


def phase_adam8(dev) -> dict:
    """The int8-moment AdamW kernel against the plain version (one_xla) on
    leaves of llama3-1b's own shapes (the vector path), on one leaf with
    b = 100 (the scalar path), on the LoRA adapters' f32 leaves
    (``ADAPTER_LEAVES``) and on the moe phase's router and expert leaves
    (``MOE_LEAVES``) and on the vit and encdec phases' leaves
    (``FAMILY_LEAVES``); times over one step's 12 leaves, and of each
    adapter, moe and family leaf."""
    from tpu_docker_api_torch.train import optim

    g = torch.Generator(device=dev).manual_seed(2)
    sc = optim.adam8_scalars(3, 0.9, 0.95, 1e-8, 3e-4, 0.1)
    checked = [leaf for leaf in LLAMA3_1B_LEAVES if leaf[0] in (
        "wq", "w_gate", "lm_head", "final_norm", "wk")] + [SCALAR_PATH_LEAF]
    checked = [(name, shape, torch.bfloat16) for name, shape in checked] \
        + [(name, shape, torch.float32) for name, shape in ADAPTER_LEAVES] \
        + MOE_LEAVES \
        + [(name, shape, torch.bfloat16) for name, shape in FAMILY_LEAVES]
    cases, max_err = [], 0.0
    for name, shape, dtype in checked:
        args = _adam8_leaf(dev, g, shape, dtype=dtype)
        got = optim.adam8_update_leaf(*args, sc=sc)
        torch.cuda.synchronize()
        ref = optim.adam8_plain(*args, sc=sc)
        # the kernel repeats the plain version's f32 ops: the update
        # within one rounding of its dtype (2^-7 relative in bf16, 1e-5
        # in f32), the int8 moments at most one count apart (a tie of the
        # f32 moment may round either way), the scales within 1e-6
        # relative (IEEE division by 127 here, a reciprocal multiply in
        # torch's plain version)
        rtol = 2**-7 if dtype == torch.bfloat16 else 1e-5
        upd_err = (got[0].float() - ref[0].float()).abs()
        ok_upd = bool((upd_err <= rtol * ref[0].float().abs()
                       + 1e-12).all())
        q_err = max((got[i].int() - ref[i].int()).abs().max().item()
                    for i in (1, 3))
        s_err = max(((got[i] - ref[i]).abs() / ref[i]).max().item()
                    for i in (2, 4))
        ok = ok_upd and q_err <= 1 and s_err <= 1e-6
        cases.append({"leaf": name, "shape": list(shape),
                      "dtype": str(dtype).split(".")[-1],
                      "block": optim._block_of(shape[-1], 256),
                      "update_max_abs_err": upd_err.max().item(),
                      "moment_max_count_diff": q_err,
                      "scale_max_rel_err": s_err, "ok": ok})
        if not ok:
            raise AssertionError(f"adam8 disagrees with plain: {cases[-1]}")
        max_err = max(max_err, upd_err.max().item())
        del args, got, ref, upd_err
        torch.cuda.empty_cache()

    # one optimizer step's worth: every leaf of llama3-1b, kernel and
    # plain; the row reports the mean per launch
    kernel_ms = plain_ms = bound_ms = host_us = b2b_ms = 0.0
    per_leaf = []
    for name, shape in LLAMA3_1B_LEAVES:
        args = _adam8_leaf(dev, g, shape)
        kt = kernel_times(lambda: optim.adam8_update_leaf(*args, sc=sc), 10)
        k = kt["ms"]
        host_us, b2b_ms = host_us + kt["host_us"], \
            b2b_ms + kt["ms_back_to_back"]
        pl = cuda_ms(lambda: optim.adam8_plain(*args, sc=sc), 2, warmup=1)
        bd, by = _adam8_bound(shape, torch.bfloat16)
        kernel_ms, plain_ms, bound_ms = kernel_ms + k, plain_ms + pl, \
            bound_ms + bd
        per_leaf.append({"leaf": name, **kt, "plain_ms": pl,
                         "bound_ms": bd, "bound_by": by})
        del args
        torch.cuda.empty_cache()
    # the adapters' leaves, one by one (the lora phase's launches)
    adapter_leaves = []
    for name, shape in ADAPTER_LEAVES:
        args = _adam8_leaf(dev, g, shape, dtype=torch.float32)
        kt = kernel_times(lambda: optim.adam8_update_leaf(*args, sc=sc), 50)
        pl = cuda_ms(lambda: optim.adam8_plain(*args, sc=sc), 5, warmup=1)
        bd, by = _adam8_bound(shape, torch.float32)
        adapter_leaves.append({
            "leaf": name, "shape": list(shape),
            "block": optim._block_of(shape[-1], 256), **kt,
            "plain_ms": pl, "bound_ms": bd, "bound_by": by,
            "roofline_share": bd / kt["ms"]})
        del args
    # the moe phase's leaves, one by one
    moe_leaves = []
    for name, shape, dtype in MOE_LEAVES:
        args = _adam8_leaf(dev, g, shape, dtype=dtype)
        kt = kernel_times(lambda: optim.adam8_update_leaf(*args, sc=sc),
                          50 if dtype == torch.float32 else 10)
        pl = cuda_ms(lambda: optim.adam8_plain(*args, sc=sc), 2, warmup=1)
        bd, by = _adam8_bound(shape, dtype)
        moe_leaves.append({
            "leaf": name, "shape": list(shape),
            "dtype": str(dtype).split(".")[-1],
            "block": optim._block_of(shape[-1], 256), **kt,
            "plain_ms": pl, "bound_ms": bd, "bound_by": by,
            "roofline_share": bd / kt["ms"]})
        del args
        torch.cuda.empty_cache()
    # the vit and encdec phases' leaves, one by one
    family_leaves = []
    for name, shape in FAMILY_LEAVES:
        args = _adam8_leaf(dev, g, shape)
        kt = kernel_times(lambda: optim.adam8_update_leaf(*args, sc=sc), 50)
        pl = cuda_ms(lambda: optim.adam8_plain(*args, sc=sc), 5, warmup=1)
        bd, by = _adam8_bound(shape, torch.bfloat16)
        family_leaves.append({
            "leaf": name, "shape": list(shape),
            "block": optim._block_of(shape[-1], 256), **kt,
            "plain_ms": pl, "bound_ms": bd, "bound_by": by,
            "roofline_share": bd / kt["ms"]})
        del args
    n_leaves = len(LLAMA3_1B_LEAVES)
    bound_by = ("bytes" if all(leaf["bound_by"] == "bytes"
                               for leaf in per_leaf) else "operations")
    result = {"max_abs_err": max_err, "ms": kernel_ms / n_leaves,
              "host_us": host_us / n_leaves,
              "ms_back_to_back": b2b_ms / n_leaves,
              "plain_ms": plain_ms / n_leaves,
              "bound_ms": bound_ms / n_leaves, "bound_by": bound_by,
              "library_ms": None}
    emit({"phase": "kernels", "kernel": "adam8", "cases": cases,
          "timing": {"step_ms": kernel_ms, "step_plain_ms": plain_ms,
                     "step_bound_ms": bound_ms, "per_leaf": per_leaf,
                     "adapter_leaves": adapter_leaves,
                     "moe_leaves": moe_leaves,
                     "family_leaves": family_leaves,
                     "library": "none: no single PyTorch call computes "
                                "the int8-moment AdamW step",
                     **result}})
    return result


def _train_run(dev, cfg, optim_name: str, tokens) -> dict:
    """TRAIN_STEPS steps through the trainer's entry points on one
    repeated batch; every launch count zeroed just before, read just
    after. Returns losses, step times, counts and peak memory."""
    from tpu_docker_api_torch.models.llama import param_count
    from tpu_docker_api_torch.ops import flash
    from tpu_docker_api_torch.train import optim
    from tpu_docker_api_torch.train.trainer import (create_train_state,
                                                    make_train_step)

    opt = optim.adamw_int8() if optim_name == "adamw-int8" else None
    gen = torch.Generator(device=dev).manual_seed(0)
    state, opt = create_train_state(cfg, dev, gen, optimizer=opt)
    step_fn = make_train_step(cfg, opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    losses, grad_norms, step_ms = [], [], []

    # ---- the main path: counts zeroed just before, read just after
    flash.reset_launch_count()
    optim.reset_launch_count()
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, metrics = step_fn(state, tokens)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(metrics["loss"])
        grad_norms.append(metrics["grad_norm"])
    launches = {**flash.launch_count, **optim.launch_count}
    # ---- end of the main path

    peak = torch.cuda.max_memory_allocated(dev)
    return {"optim": optim_name, "params": param_count(state.params),
            "losses": [x.item() for x in losses],
            "grad_norms": [x.float().item() for x in grad_norms],
            "step_ms": step_ms, "launches": launches,
            "max_memory_allocated": peak, "state": state}


def _block_grads_rel_l2(dev, cfg) -> dict:
    """Gradients of wq/wk/wv of ONE full-width block (the loss through the
    lm_head) through the flash kernels against the dense plain path."""
    from tpu_docker_api_torch.models.llama import llama_init, llama_loss

    cfg1 = dataclasses.replace(cfg, n_layers=1)
    params = llama_init(cfg1, torch.Generator(device=dev).manual_seed(3))
    tokens = torch.randint(0, cfg.vocab_size, (2, 1025), device=dev,
                           generator=torch.Generator(device=dev)
                           .manual_seed(4))
    grads = {}
    for impl in ("flash", "dense"):
        attn = {n: w.detach().requires_grad_()
                for n, w in params["layers"]["attn"].items()}
        live = {**params, "layers": {**params["layers"], "attn": attn}}
        llama_loss(live, tokens,
                   dataclasses.replace(cfg1, attention_impl=impl)).backward()
        grads[impl] = {n: attn[n].grad.float() for n in ("wq", "wk", "wv")}
    return {n: ((grads["flash"][n] - grads["dense"][n]).norm()
                / grads["dense"][n].norm()).item() for n in ("wq", "wk", "wv")}


class _Lines(io.TextIOBase):
    """A stdout that keeps each JSON line and hands it to ``on_line``
    as soon as it is printed."""

    def __init__(self, on_line=None):
        self.lines: list[dict] = []
        self._part = ""
        self._on_line = on_line

    def write(self, s: str) -> int:
        self._part += s
        while "\n" in self._part:
            line, self._part = self._part.split("\n", 1)
            if line.strip():
                self.lines.append(json.loads(line))
                if self._on_line is not None:
                    self._on_line(self.lines[-1])
        return len(s)


def _run_cli(main_fn, argv: list[str], on_line=None) -> list[dict]:
    """An entry point's ``main`` in process: its JSON lines. Signal
    handlers it installs are put back after."""
    out = _Lines(on_line)
    handlers = {s: signal.getsignal(s) for s in (signal.SIGTERM,
                                                 signal.SIGINT)}
    try:
        with contextlib.redirect_stdout(out):
            rc = main_fn(argv)
    finally:
        for sig, h in handlers.items():
            signal.signal(sig, h)
    if rc not in (0, None):
        raise AssertionError(f"{argv}: exit {rc}, {out.lines[-3:]}")
    return out.lines


def _cli_profile() -> dict:
    """The command-line trainer in process with --profile-dir: where a
    step's device time goes (telemetry/profile.py)."""
    from tpu_docker_api_torch.train.__main__ import main as train_main

    lines = _run_cli(train_main, [
        "--preset", "llama3-1b", "--steps", "3", "--batch",
        str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--optim", "adamw-int8",
        "--log-every", "1", "--profile-dir", "build/train_profile",
        "--profile-steps", "2"])
    if lines[-1].get("event") != "done":
        raise AssertionError(f"trainer CLI failed: {lines[-3:]}")
    prof = [ln for ln in lines if ln.get("event") == "profile_written"]
    if len(prof) != 1:
        raise AssertionError(f"no profile summary: {lines}")
    return {"cli_lines": [ln for ln in lines if "step" in ln
                          and "event" not in ln], "profile": prof[0]}


def phase_train(dev) -> dict:
    from tpu_docker_api_torch.models.llama import llama_loss, llama_presets
    from tpu_docker_api_torch.train.trainer import synthetic_batch

    cfg = llama_presets()["llama3-1b"]
    tokens = synthetic_batch(torch.Generator(device=dev).manual_seed(1),
                             TRAIN_BATCH, TRAIN_SEQ, cfg.vocab_size)
    ln_vocab = math.log(cfg.vocab_size)
    n_leaves = len(LLAMA3_1B_LEAVES)
    runs, counts = [], {}
    for optim_name in ("adamw", "adamw-int8"):
        run = _train_run(dev, cfg, optim_name, tokens)
        state = run.pop("state")
        losses = run["losses"]
        # random weights: unit-RMS hidden states against an N(0, 1/d)
        # head give logits of std ~0.9, so the first loss is ln(vocab)
        # plus ~0.4; 1.0 either side bounds it
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{optim_name}: non-finite loss {losses}")
        if abs(losses[0] - ln_vocab) > 1.0:
            raise AssertionError(f"{optim_name}: first loss {losses[0]} "
                                 f"not within 1.0 of ln(vocab) {ln_vocab}")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"{optim_name}: loss did not fall on the "
                                 f"repeated batch: {losses}")
        want = {"flash_fwd": cfg.n_layers * TRAIN_STEPS,
                "flash_bwd_dq": cfg.n_layers * TRAIN_STEPS,
                "flash_bwd_dkv": cfg.n_layers * TRAIN_STEPS,
                "adam8": (n_leaves * TRAIN_STEPS
                          if optim_name == "adamw-int8" else 0)}
        if run["launches"] != want:
            raise AssertionError(f"{optim_name}: launches {run['launches']}"
                                 f", expected {want}")
        for name, n in run["launches"].items():
            counts[name] = counts.get(name, 0) + n
        steady = sorted(run["step_ms"][1:])[len(run["step_ms"][1:]) // 2]
        tok_s = TRAIN_BATCH * TRAIN_SEQ / (steady / 1e3)
        run.update({"step_ms_median_after_first": steady,
                    "tokens_per_sec": tok_s,
                    "mfu": cfg.flops_per_token(TRAIN_SEQ) * tok_s
                    / PEAK_FLOPS[torch.bfloat16]})
        if optim_name == "adamw-int8":
            with torch.no_grad():
                dense = llama_loss(state.params, tokens, cfg).item()
                chunked = llama_loss(
                    state.params, tokens,
                    dataclasses.replace(cfg, loss_chunk_rows=512)).item()
        runs.append(run)
        del state
        torch.cuda.empty_cache()

    # the same per-row f32 math; the mean gathers per chunk in another
    # order and the logits products may tile differently
    chunk_rel = abs(chunked - dense) / abs(dense)
    if chunk_rel > 1e-4:
        raise AssertionError(f"chunked loss {chunked} vs dense {dense}")
    # bf16 through one block: the two paths round to bf16 at different
    # places (the kernels round P and dS to bf16 before their products;
    # the dense path rounds the probabilities it hands to PV)
    grad_rel = _block_grads_rel_l2(dev, cfg)
    if max(grad_rel.values()) > 2e-2:
        raise AssertionError(f"flash vs dense block gradients: {grad_rel}")
    torch.cuda.empty_cache()
    profile = _cli_profile()
    result = {"phase": "train", "preset": "llama3-1b",
              "params": runs[0]["params"],
              "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TRAIN_STEPS,
              "runs": runs, "launches": counts,
              "remat": "selective: flash (out, lse) kept, flash_fwd once "
                       "per layer per step",
              "chunked_loss": chunked, "dense_loss": dense,
              "chunked_rel_diff": chunk_rel, "chunked_tol": 1e-4,
              "block_grad_rel_l2": grad_rel, "block_grad_tol": 2e-2,
              **profile, "card": nvidia_smi()}
    emit(result)
    return result

def _post(port: int, body: dict) -> tuple[int, bytes]:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    conn.request("POST", "/generate", body=json.dumps(body))
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, data


def _concurrent(port: int, prompts: list, max_new: int) -> tuple[list, float]:
    """One greedy request a prompt, all at once: (replies, wall s)."""
    replies: list = [None] * len(prompts)

    def client(i):
        replies[i] = _post(port, {"tokens": [prompts[i]],
                                  "maxNewTokens": max_new})

    t0 = time.perf_counter()
    clients = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    for c in clients:
        c.start()
    for c in clients:
        c.join(timeout=600)
    return replies, time.perf_counter() - t0


def _check_reply(code: int, data: bytes, rows: int, max_new: int,
                 vocab: int) -> dict:
    if code != 200:
        raise AssertionError(f"/generate answered {code}: {data[:300]!r}")
    body = json.loads(data)
    toks, lens = body["tokens"], body["lengths"]
    if len(toks) != rows or len(lens) != rows:
        raise AssertionError(f"malformed reply: {body}")
    for row, n in zip(toks, lens):
        if len(row) != max_new or not 1 <= n <= max_new or not all(
                isinstance(t, int) and 0 <= t < vocab for t in row):
            raise AssertionError(f"malformed row: {row} length {n}")
    return body


def phase_serve(dev) -> dict:
    from tpu_docker_api_torch.models.llama import (llama_forward_cached,
                                                   param_count)
    from tpu_docker_api_torch.ops import flash
    from tpu_docker_api_torch.serve.__main__ import Server, parse_args

    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    srv = Server(parse_args(["--preset", "llama3-1b", "--max-seq", "2048",
                             "--slots", "8", "--chunk", "8", "--seed", "0",
                             "--host", "127.0.0.1", "--port", "0"]))
    setup_s = time.perf_counter() - t0
    port = srv.httpd.server_address[1]
    thread = threading.Thread(target=srv.httpd.serve_forever, daemon=True)
    thread.start()
    cfg, eng = srv.cfg, srv.engine
    vocab = cfg.vocab_size
    try:
        # one short request first: cuBLAS handles, allocator pools
        _check_reply(*_post(port, {"tokens": [[1, 2, 3]],
                                   "maxNewTokens": 2}), 1, 2, vocab)
        g = torch.Generator().manual_seed(0)
        lengths = SERVE_LENGTHS
        prompts = [torch.randint(0, vocab, (n,), generator=g).tolist()
                   for n in lengths]
        max_new = 32

        # ---- the main path: counts zeroed just before, read just after
        eng.reset_latency_stats()
        prefills0 = eng.stats["prefills"]
        emitted0 = eng.stats["emitted_tokens"]
        flash.reset_launch_count()
        replies, wall = _concurrent(port, prompts, max_new)
        latency = eng.latency_stats()
        emitted = eng.stats["emitted_tokens"] - emitted0
        greedy = [_check_reply(*r, 1, max_new, vocab)["tokens"][0]
                  for r in replies]

        code, data = _post(port, {"tokens": [prompts[2]],
                                  "maxNewTokens": 16, "stream": True})
        lines = [json.loads(ln) for ln in data.decode().splitlines() if ln]
        streamed = [ln["t"] for ln in lines[:-1]]
        if (code != 200 or lines[-1] != {"done": True, "length": 16}
                or len(streamed) != 16
                or not all(0 <= t < vocab for t in streamed)):
            raise AssertionError(f"bad stream reply: {code} {lines[-3:]}")
        _check_reply(*_post(port, {"tokens": [prompts[3]],
                                   "maxNewTokens": max_new,
                                   "temperature": 0.8, "topK": 40,
                                   "topP": 0.95}), 1, max_new, vocab)
        # the same greedy prompt twice, alone: identical batch shapes and
        # read buckets, so identical tokens
        solo = [_check_reply(*_post(port, {"tokens": [prompts[2]],
                                           "maxNewTokens": max_new}),
                             1, max_new, vocab)["tokens"][0]
                for _ in range(2)]
        launches = flash.launch_count["flash_fwd"]
        prefills = eng.stats["prefills"] - prefills0
        # ---- end of the main path

        if solo[0] != solo[1]:
            raise AssertionError("same greedy prompt gave different tokens")
        if streamed != solo[0][:16]:
            raise AssertionError("streamed tokens differ from greedy")
        if launches < cfg.n_layers * prefills or launches == 0:
            raise AssertionError(f"{launches} flash launches for "
                                 f"{prefills} prefill groups")

        # first-token logits: kernel path (bucket-length cache, flash)
        # against the plain path (a longer cache keeps dense attention)
        prompt = torch.tensor([prompts[2]], device=dev)
        n, bucket = prompt.shape[1], 128
        padded = torch.zeros((1, bucket), dtype=torch.long, device=dev)
        padded[:, :n] = prompt

        def first_logits(cap):
            shape = (cfg.n_layers, 1, cap, cfg.n_kv_heads, cfg.head_dim)
            kc = torch.zeros(shape, dtype=cfg.dtype, device=dev)
            with torch.no_grad():
                out, _, _ = llama_forward_cached(
                    srv.params, padded, cfg, kc, torch.zeros_like(kc), 0,
                    last_only=n - 1)
            return out[0, 0]

        kernel_logits, plain_logits = first_logits(bucket), \
            first_logits(bucket + 1)
        if not (torch.isfinite(kernel_logits).all()
                and kernel_logits.shape == (vocab,)):
            raise AssertionError("kernel-path logits not finite")
        rel = ((kernel_logits - plain_logits).norm()
               / plain_logits.norm()).item()
        logits_tol = 2e-2  # relative L2, bf16 through 16 layers
        if rel > logits_tol:
            raise AssertionError(f"first-token logits differ: rel {rel}")
        result = {
            "phase": "serve", "preset": srv.args.preset,
            "params": param_count(srv.params), "slots": eng.slots,
            "chunk": eng.chunk, "setup_s": setup_s,
            "prompt_lengths": lengths, "max_new_tokens": max_new,
            "wall_s": wall, "ttft_p50_ms": latency["ttft_p50_ms"],
            "itl_p50_ms": latency["itl_p50_ms"],
            "decode_tok_s": emitted / wall, "emitted_tokens": emitted,
            "prefill_groups": prefills, "flash_launches": launches,
            "logits_rel_l2": rel, "logits_tol": logits_tol,
            # informational: in the concurrent run the prompt shared
            # its decode steps with longer reads (another kv bucket), so
            # bf16 near-ties may resolve differently
            "concurrent_tokens_equal_solo": greedy[2] == solo[0],
            "logits_argmax_equal": bool(kernel_logits.argmax()
                                        == plain_logits.argmax()),
            "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
            "card": nvidia_smi()}
        emit(result)
        return result
    finally:
        srv.httpd.shutdown()
        srv.close()
        thread.join(timeout=30)


#: Llama-3's vocabulary: 128,000 BPE tokens, then 256 special tokens
LLAMA3_SPECIAL_BASE, LLAMA3_VOCAB = 128000, 128256


def write_llama3_shaped_tokenizer(path: str,
                                  vocab_size: int = LLAMA3_VOCAB,
                                  n_special: int = 256) -> str:
    """A ``tokenizer.json`` in Llama-3's shape, made without a download:
    the Split (Llama-3's pattern) + ByteLevel pre-tokenizer, a BPE model
    with ``ignore_merges``, a TemplateProcessing that prepends
    ``<|begin_of_text|>``, and the ByteLevel decoder. Ids 0-255 are the
    256 byte characters in byte order; ids up to ``vocab_size -
    n_special - 1`` come from deterministic merges; the last
    ``n_special`` ids are special tokens (``<|begin_of_text|>``,
    ``<|end_of_text|>``, then reserved ones).

    The merges, in rank order: every UTF-8 lead byte of the CJK and
    emoji blocks with every continuation byte, then ASCII pairs (space,
    letters, digits, punctuation, newline) with lowercase letters and
    digits, then each merged token in the order it was made, extended by
    a lowercase letter, a digit or a continuation byte, until the
    vocabulary is full."""
    from tpu_docker_api_torch.models.tokenizer import (LLAMA3_PATTERN,
                                                       bytes_to_unicode)

    b2u = bytes_to_unicode()
    tokens = [b2u[b] for b in range(256)]
    n_bpe = vocab_size - n_special
    seen = set(tokens)
    merges: list[list[str]] = []

    def add(a: str, b: str) -> bool:
        if len(tokens) >= n_bpe or a + b in seen:
            return len(tokens) < n_bpe
        seen.add(a + b)
        tokens.append(a + b)
        merges.append([a, b])
        return len(tokens) < n_bpe

    cont = [b2u[b] for b in range(0x80, 0xC0)]
    lower = [b2u[b] for b in b"abcdefghijklmnopqrstuvwxyz0123456789"]
    heads = [b2u[b] for b in b" \nabcdefghijklmnopqrstuvwxyz"
             b"ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789.,'-"]
    for lead in [b2u[b] for b in (0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9,
                                  0xF0)]:
        for c in cont:
            add(lead, c)
    for a in heads:
        for b in lower:
            add(a, b)
    i = 256
    while len(tokens) < n_bpe:
        t = tokens[i]
        tail = cont if t[0] in {b2u[0xE3], b2u[0xF0]} | set(
            b2u[b] for b in range(0xE4, 0xEA)) else lower
        for c in tail:
            if not add(t, c):
                break
        i += 1
    names = ["<|begin_of_text|>", "<|end_of_text|>"] + [
        f"<|reserved_special_token_{k}|>" for k in range(n_special - 2)]
    added = [{"id": n_bpe + k, "content": name, "single_word": False,
              "lstrip": False, "rstrip": False, "normalized": False,
              "special": True} for k, name in enumerate(names)]
    bos = {"id": names[0], "ids": [n_bpe], "tokens": [names[0]]}
    spec = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": added, "normalizer": None,
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": LLAMA3_PATTERN},
             "behavior": "Isolated", "invert": False},
            {"type": "ByteLevel", "add_prefix_space": False,
             "trim_offsets": True, "use_regex": False}]},
        "post_processor": {"type": "Sequence", "processors": [
            {"type": "ByteLevel", "add_prefix_space": True,
             "trim_offsets": False, "use_regex": True},
            {"type": "TemplateProcessing",
             "single": [{"SpecialToken": {"id": names[0], "type_id": 0}},
                        {"Sequence": {"id": "A", "type_id": 0}}],
             "pair": [{"SpecialToken": {"id": names[0], "type_id": 0}},
                      {"Sequence": {"id": "A", "type_id": 0}},
                      {"SpecialToken": {"id": names[0], "type_id": 1}},
                      {"Sequence": {"id": "B", "type_id": 1}}],
             "special_tokens": {names[0]: bos}}]},
        "decoder": {"type": "ByteLevel", "add_prefix_space": True,
                    "trim_offsets": True, "use_regex": True},
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": None,
                  "end_of_word_suffix": None, "fuse_unk": False,
                  "byte_fallback": False, "ignore_merges": True,
                  "vocab": {t: i for i, t in enumerate(tokens)},
                  "merges": merges},
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(spec, f, ensure_ascii=False)
    return path


TOKENIZER_PATH = "build/tokenizer/tokenizer.json"
#: the text request: ASCII, accented Latin, CJK with emoji, digits with
#: newlines
INT8_TEXTS = [
    "The quick brown fox jumps over the lazy dog; it's 42 degrees outside.",
    "Crème brûlée, naïve façade — déjà vu à São Paulo, Zürich et Kraków.",
    "東京タワーの夜景はとても綺麗です 🚀🔥 一緒に行きましょう 😀👍",
    "0123456789\n\n3141592653 5897932384\n2718281828 4590452353\n",
]
INT8_COSINE_MIN = 0.98  # tests/test_quant.py's bound


def _get(port: int, path: str) -> dict:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("GET", path)
    body = json.loads(conn.getresponse().read())
    conn.close()
    return body


def _llama_weight_bytes(cfg) -> tuple[int, int]:
    """(int8-serving bytes, bf16 bytes) of a Llama tree from its shapes:
    int8 projections and head with one f32 scale an output channel, the
    embedding and norms in bf16."""
    from tpu_docker_api_torch.models import param_shapes

    shapes = param_shapes(cfg)
    projections = [*shapes["layers"]["attn"].values(),
                   *shapes["layers"]["mlp"].values(), shapes["lm_head"]]
    rest = [shapes["embed"]["tokens"], shapes["layers"]["attn_norm"],
            shapes["layers"]["mlp_norm"], shapes["final_norm"]]
    int8 = sum(math.prod(s) + 4 * math.prod(s[:-2] + s[-1:])
               for s in projections) + sum(2 * math.prod(s) for s in rest)
    return int8, sum(2 * math.prod(s) for s in projections + rest)


def _decode_step_profile(dev, cfg, params, rows: int = 8) -> dict:
    """One decode step (``rows`` slots, one token each, per-row positions):
    its median host-clocked time over 10 steps, and one step under
    ``torch.profiler``: its kernel launches, device busy time, and the
    idle share of the traced window and of the unprofiled step."""
    from torch.profiler import ProfilerActivity, profile

    from tpu_docker_api_torch.models import cached_forward_fn
    from tpu_docker_api_torch.telemetry.profile import device_time_summary

    fwd = cached_forward_fn(cfg)
    shape = (cfg.n_layers, rows, 256, cfg.n_kv_heads, cfg.head_dim)
    kc = torch.zeros(shape, dtype=cfg.dtype, device=dev)
    vc = torch.zeros_like(kc)
    tok = torch.arange(rows, device=dev)[:, None] + 1000
    pos = torch.full((rows,), 100, device=dev)

    def step():
        with torch.no_grad():
            fwd(params, tok, cfg, kc, vc, pos)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    # host-clocked steps without the profiler (its own host cost inflates
    # the traced window)
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    step_ms = sorted(times)[len(times) // 2]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    summary = device_time_summary(prof, wall, top=6)
    out = {k: summary.get(k) for k in ("kernel_events", "window_ms",
                                       "busy_ms", "idle_share",
                                       "ms_by_class", "top_kernels")}
    out["step_ms_median"] = step_ms
    if out["busy_ms"] is not None:
        out["idle_share_unprofiled"] = max(0.0, 1 - out["busy_ms"] / step_ms)
    return out


def _kernels_per_call(fn) -> int:
    """CUDA kernels one call of ``fn`` launches (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)


def _int_mm_checks(dev) -> dict:
    """``torch._int_mm`` through ``ops.quant.int8_matmul`` on the card, at
    a decode-shaped (8 rows, padded) and a prefill-shaped product of
    llama3-1b's widths, against an exact reference: the same int8
    operands in f64 (every product and partial sum is an integer below
    2^53, so f64 holds them exactly), as int64."""
    from tpu_docker_api_torch.ops import quant

    g = torch.Generator(device=dev).manual_seed(5)
    out = {}
    for name, (m, k, n) in (("decode", (8, 2048, 3072)),
                            ("prefill", (1900, 2048, 8192))):
        a = torch.randint(-127, 128, (m, k), generator=g, device=dev,
                          dtype=torch.int8)
        w = quant.quantize_weight(torch.randn(k, n, generator=g,
                                              device=dev)).w_int8
        got = quant.int8_matmul(a, w)
        torch.cuda.synchronize()
        want = (a.double() @ w.double()).long()
        equal = bool(torch.equal(got.long(), want))
        # the weight as QuantizedLinear stores it (column-major) against
        # a row-major copy, and a bf16 product of the same shape
        w_rows = w.contiguous()
        ab, wb = a.bfloat16(), w.bfloat16()
        out[name] = {"shape": [m, k, n], "bit_equal": equal,
                     "ms": cuda_ms(lambda: quant.int8_matmul(a, w), 50),
                     "ms_row_major_weight": cuda_ms(
                         lambda: quant.int8_matmul(a, w_rows), 50),
                     "bf16_mm_ms": cuda_ms(lambda: ab @ wb, 50)}
        if not equal:
            raise AssertionError(f"torch._int_mm {name} {[m, k, n]} is not "
                                 f"exact: {out[name]}")
    # the row rule the padding answers: torch._int_mm itself at 16 and 17
    # rows
    rule = {}
    for m in (16, 17):
        a = torch.ones((m, 64), dtype=torch.int8, device=dev)
        try:
            torch._int_mm(a, torch.ones((64, 64), dtype=torch.int8,
                                        device=dev))
            rule[m] = "ok"
        except RuntimeError as e:
            rule[m] = str(e).splitlines()[0][:160]
    out["rows_rule"] = rule
    return out


def phase_serve_int8_text(dev, bf16: dict) -> dict:
    """int8 serving with the tokenizer at llama3-1b full width and depth:
    ``--quantize --tokenizer`` on a Llama-3-shaped ``tokenizer.json``
    this script writes (``write_llama3_shaped_tokenizer``), random
    weights from seed 0 (the bf16 phase's, quantized after the load).
    The bf16 phase's 8-prompt greedy burst as ids, one text request of
    ``INT8_TEXTS``, one streamed text request, and one prompt twice; the
    flash_fwd count zeroed just before and read just after. Checks: int8
    leaves and their bytes, /healthz, flash launches, determinism, the
    stream against greedy, "texts" and the done line's "text", the
    tokenizer's round trip and a decode of every id, ``torch._int_mm``
    exact on the card, and the int8 logits' cosine to the bf16 model's."""
    from tpu_docker_api_torch.infer.quantize import quantized_bytes
    from tpu_docker_api_torch.models.llama import llama_forward, llama_init
    from tpu_docker_api_torch.models.tokenizer import load_tokenizer
    from tpu_docker_api_torch.ops import flash, quant
    from tpu_docker_api_torch.serve.__main__ import Server, parse_args

    t0 = time.perf_counter()
    write_llama3_shaped_tokenizer(TOKENIZER_PATH)
    write_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    srv = Server(parse_args(["--preset", "llama3-1b", "--quantize",
                             "--tokenizer", TOKENIZER_PATH,
                             "--max-seq", "2048", "--slots", "8",
                             "--chunk", "8", "--seed", "0",
                             "--host", "127.0.0.1", "--port", "0"]))
    setup_s = time.perf_counter() - t0
    port = srv.httpd.server_address[1]
    thread = threading.Thread(target=srv.httpd.serve_forever, daemon=True)
    thread.start()
    cfg, eng, tok = srv.cfg, srv.engine, srv.tokenizer
    vocab = cfg.vocab_size
    try:
        layers = srv.params["layers"]
        leaves = [*layers["attn"].values(), *layers["mlp"].values(),
                  srv.params["lm_head"]]
        if not all(isinstance(q, quant.QuantizedLinear) for q in leaves):
            raise AssertionError("a projection of the served tree is not "
                                 "int8")
        want_int8, want_bf16 = _llama_weight_bytes(cfg)
        served_bytes = quantized_bytes(srv.params)
        if served_bytes != want_int8:
            raise AssertionError(f"int8 tree holds {served_bytes} bytes, "
                                 f"its shapes say {want_int8}")
        health = _get(port, "/healthz")
        if not (health["quantized"] is True and health["tokenizer"] is True):
            raise AssertionError(f"/healthz: {health}")
        _check_reply(*_post(port, {"tokens": [[1, 2, 3]],
                                   "maxNewTokens": 2}), 1, 2, vocab)
        g = torch.Generator().manual_seed(0)
        lengths = SERVE_LENGTHS
        prompts = [torch.randint(0, vocab, (n,), generator=g).tolist()
                   for n in lengths]
        max_new = 32

        # ---- the main path: counts zeroed just before, read just after
        eng.reset_latency_stats()
        prefills0 = eng.stats["prefills"]
        emitted0 = eng.stats["emitted_tokens"]
        flash.reset_launch_count()
        replies, wall = _concurrent(port, prompts, max_new)
        latency = eng.latency_stats()
        emitted = eng.stats["emitted_tokens"] - emitted0
        for r in replies:
            _check_reply(*r, 1, max_new, vocab)

        eng.reset_latency_stats()
        code, data = _post(port, {"text": INT8_TEXTS,
                                  "maxNewTokens": max_new})
        text_latency = eng.latency_stats()
        text_body = _check_reply(code, data, len(INT8_TEXTS), max_new, vocab)
        code, data = _post(port, {"text": [INT8_TEXTS[0]],
                                  "maxNewTokens": 16, "stream": True})
        lines = [json.loads(ln) for ln in data.decode().splitlines() if ln]
        streamed = [ln["t"] for ln in lines[:-1]]
        solo = [_check_reply(*_post(port, {"text": [INT8_TEXTS[0]],
                                           "maxNewTokens": 16}),
                             1, 16, vocab) for _ in range(2)]
        launches = flash.launch_count["flash_fwd"]
        prefills = eng.stats["prefills"] - prefills0
        # ---- end of the main path

        if launches < cfg.n_layers * prefills or launches == 0:
            raise AssertionError(f"{launches} flash launches for "
                                 f"{prefills} prefill groups")
        if solo[0]["tokens"] != solo[1]["tokens"]:
            raise AssertionError("same greedy prompt gave different tokens")
        if (code != 200 or not lines[-1].get("done")
                or not isinstance(lines[-1].get("text"), str)
                or streamed != solo[0]["tokens"][0][:len(streamed)]
                or lines[-1]["length"] != len(streamed)):
            raise AssertionError(f"bad text stream: {code} {lines[-2:]}, "
                                 f"greedy {solo[0]['tokens'][0]}")
        if lines[-1]["text"] != solo[0]["texts"][0]:
            raise AssertionError("the stream's text differs from greedy's")
        texts = text_body.get("texts")
        if not (isinstance(texts, list) and len(texts) == len(INT8_TEXTS)
                and all(isinstance(t, str) for t in texts)):
            raise AssertionError(f"no texts in the reply: {text_body}")

        # the tokenizer: a round trip of the four strings (byte-level BPE
        # is lossless), a decode of every id, and its encode cost
        fresh = load_tokenizer(TOKENIZER_PATH)
        enc = {}
        for phase_name in ("cold", "warm"):
            t0 = time.perf_counter()
            ids = [fresh.encode(t) for t in INT8_TEXTS]
            enc[phase_name] = time.perf_counter() - t0
        round_trip = [fresh.decode(i[1:]) == t and i[0] == fresh._tok.added[
            "<|begin_of_text|>"] for i, t in zip(ids, INT8_TEXTS)]
        if not all(round_trip):
            raise AssertionError(f"tokenizer round trip: {round_trip}")
        if ids != [tok.encode(t) for t in INT8_TEXTS]:
            raise AssertionError("two loads of one tokenizer disagree")
        t0 = time.perf_counter()
        every = fresh.decode(list(range(LLAMA3_VOCAB)))
        decode_all_s = time.perf_counter() - t0
        n_bytes = sum(len(t.encode()) for t in INT8_TEXTS)
        encode_ms = enc["cold"] * 1e3
        text_ttft = text_latency["ttft_p50_ms"]

        int_mm = _int_mm_checks(dev)

        # the int8 model's logits against the bf16 model's: same seed,
        # one 256-token prompt, every position
        bf16_params = llama_init(cfg, torch.Generator(device=dev)
                                 .manual_seed(0))
        prompt = torch.tensor([prompts[4][:256]], device=dev)
        with torch.no_grad():
            ref = llama_forward(bf16_params, prompt, cfg)[0]
            got = llama_forward(srv.params, prompt, cfg)[0]
        if not (torch.isfinite(got).all() and got.shape == (256, vocab)):
            raise AssertionError("int8 logits not finite or misshapen")
        cos = torch.nn.functional.cosine_similarity(ref, got, dim=-1)
        argmax_equal = (ref.argmax(-1) == got.argmax(-1)).float().mean()
        if cos.min() < INT8_COSINE_MIN:
            raise AssertionError(f"int8 logits cosine {cos.min().item()} "
                                 f"< {INT8_COSINE_MIN}")
        del ref, got

        # launches of one decode step (8 slots) on each tree, and of one
        # int8 projection at the decode shape
        from tpu_docker_api_torch.infer.quantize import (
            fuse_llama_projections)

        bf16_fused = fuse_llama_projections(bf16_params)
        step_int8 = _decode_step_profile(dev, cfg, srv.params)
        step_bf16 = _decode_step_profile(dev, cfg, bf16_fused)
        x = torch.randn(8, 1, cfg.dim, device=dev, dtype=cfg.dtype)
        w_qkv = layers["attn"]["w_qkv"].unbind(0)[0]
        per_int8_linear = _kernels_per_call(lambda: quant.linear(x, w_qkv))
        per_bf16_linear = _kernels_per_call(lambda: quant.linear(
            x, bf16_fused["layers"]["attn"]["w_qkv"][0]))
        n_linears = 4 * cfg.n_layers + 1
        del bf16_params, bf16_fused
        torch.cuda.empty_cache()

        result = {
            "phase": "serve_int8_text", "preset": srv.args.preset,
            "quantized": True, "tokenizer": TOKENIZER_PATH,
            "tokenizer_write_s": write_s, "setup_s": setup_s,
            "weight_bytes_int8": served_bytes,
            "weight_bytes_bf16": want_bf16,
            "slots": eng.slots, "chunk": eng.chunk,
            "prompt_lengths": lengths, "max_new_tokens": max_new,
            "wall_s": wall, "ttft_p50_ms": latency["ttft_p50_ms"],
            "itl_p50_ms": latency["itl_p50_ms"],
            "decode_tok_s": emitted / wall, "emitted_tokens": emitted,
            "bf16_phase": {k: bf16[k] for k in ("ttft_p50_ms", "itl_p50_ms",
                                                "decode_tok_s",
                                                "max_memory_allocated")},
            "prefill_groups": prefills, "flash_launches": launches,
            "text_request": {"rows": len(INT8_TEXTS),
                             "ttft_p50_ms": text_ttft,
                             "itl_p50_ms": text_latency["itl_p50_ms"],
                             "texts": texts},
            "stream_text": lines[-1]["text"],
            "tokenizer_encode": {
                "input_bytes": n_bytes, "ms_cold": encode_ms,
                "us_per_byte_cold": enc["cold"] * 1e6 / n_bytes,
                "us_per_byte_warm": enc["warm"] * 1e6 / n_bytes,
                "share_of_text_ttft": (encode_ms / (encode_ms + text_ttft)
                                       if text_ttft else None)},
            "tokenizer_decode_all_ids_s": decode_all_s,
            "tokenizer_decode_all_chars": len(every),
            "round_trip": round_trip, "int_mm": int_mm,
            "logits_cosine_min": cos.min().item(),
            "logits_cosine_mean": cos.mean().item(),
            "logits_cosine_tol": INT8_COSINE_MIN,
            "logits_argmax_equal_share": argmax_equal.item(),
            "kernels_per_linear_call": {"int8": per_int8_linear,
                                        "bf16": per_bf16_linear},
            "linear_launches_per_decode_step": {
                "int8": per_int8_linear * n_linears,
                "bf16": per_bf16_linear * n_linears},
            "decode_step_int8": step_int8, "decode_step_bf16": step_bf16,
            "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
            "card": nvidia_smi()}
        emit(result)
        return result
    finally:
        srv.httpd.shutdown()
        srv.close()
        thread.join(timeout=30)


LIFECYCLE_DIR = "build/lifecycle"
LIFECYCLE_WINDOWS = 72  # windows of seq + 1 tokens in the token file
LIFECYCLE_MAX_NEW = 16


def _ckpt_files_equal(dev, a: str, b: str) -> dict:
    """Every tensor of two checkpoints' files, leaf by leaf: bit-equal,
    or the largest relative L2 difference of a params leaf and of an
    optimizer leaf."""
    from tpu_docker_api_torch.models.import_weights import SafeTensorsFile
    from tpu_docker_api_torch.train import checkpoint as ckpt

    out = {"bit_equal": True, "leaves": 0, "params_max_rel": 0.0,
           "opt_max_rel": 0.0, "differing": []}
    for fname, key in ((ckpt.PARAMS_FILE, "params_max_rel"),
                       (ckpt.OPT_FILE, "opt_max_rel")):
        fa = SafeTensorsFile(f"{a}/{fname}")
        fb = SafeTensorsFile(f"{b}/{fname}")
        if sorted(fa.keys()) != sorted(fb.keys()):
            raise AssertionError(f"{a} and {b} hold other tensors")
        for name in fa.keys():
            x, y = fa.tensor(name).to(dev), fb.tensor(name).to(dev)
            out["leaves"] += 1
            if torch.equal(x, y):
                continue
            out["bit_equal"] = False
            out["differing"].append(name)
            rel = ((x.float() - y.float()).norm()
                   / y.float().norm().clamp_min(1e-30)).item()
            out[key] = max(out[key], rel)
    return out


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _serve_once(argv: list[str], prompt: list[int]) -> dict:
    """A Server from ``argv`` on a free port: its ready time and the
    tokens of one greedy request."""
    from tpu_docker_api_torch.serve.__main__ import Server, parse_args

    t0 = time.perf_counter()
    srv = Server(parse_args([*argv, "--max-seq", "256", "--slots", "2",
                             "--chunk", "8", "--host", "127.0.0.1",
                             "--port", "0"]))
    ready_s = time.perf_counter() - t0
    thread = threading.Thread(target=srv.httpd.serve_forever, daemon=True)
    thread.start()
    try:
        body = _check_reply(*_post(srv.httpd.server_address[1], {
            "tokens": [prompt], "maxNewTokens": LIFECYCLE_MAX_NEW}),
            1, LIFECYCLE_MAX_NEW, srv.cfg.vocab_size)
        health = _get(srv.httpd.server_address[1], "/healthz")
        return {"ready_s": ready_s, "tokens": body["tokens"][0],
                "model": health["model"], "step": health["step"]}
    finally:
        srv.httpd.shutdown()
        srv.close()
        thread.join(timeout=30)


def phase_lifecycle(dev, preset: str = "llama3-1b", batch: int = TRAIN_BATCH,
                    seq: int = TRAIN_SEQ) -> dict:
    """Train → checkpoint → resume → export → serve at llama3-1b's full
    width and depth (batch 4 x 2048, adamw-int8, remat on), through the
    command-line entry points in process, on a token file:

    A: 4 steps, a save at step 4. B: 2 steps (saved at 2), then a second
    run on the same directory that must resume at step 2 and log step 3
    first; its steps 3-4 and every tensor of its step-4 checkpoint must
    equal A's. C: SIGTERM during step 2 must save step 2 before
    ``quiesced``, and a restart must continue to an A-equal step 4. Then
    B's step 4 is exported by the ``import_weights`` CLI and served by
    ``Server`` once from ``--hf-ckpt`` and once from ``--ckpt-dir``: one
    greedy 16-token request each, whose tokens must equal each other's
    and the slot engine's on ``restore_model_params`` in memory. Launch
    counts are zeroed just before and read just after the phase. The
    tests run it on the CPU at the tiny preset, where the wrappers run
    the plain versions and count nothing."""
    import numpy as np

    from tpu_docker_api_torch.data.loader import write_token_file
    from tpu_docker_api_torch.infer.quantize import fuse_llama_projections
    from tpu_docker_api_torch.infer.slots import SlotEngine
    from tpu_docker_api_torch.models import import_weights, param_shapes
    from tpu_docker_api_torch.models.llama import llama_presets
    from tpu_docker_api_torch.ops import flash
    from tpu_docker_api_torch.train import optim
    from tpu_docker_api_torch.train import checkpoint as ckpt
    from tpu_docker_api_torch.train.__main__ import main as train_main

    cfg = llama_presets()[preset]
    shapes = optim.tree_leaves(param_shapes(cfg))
    n_params = sum(math.prod(s) for s in shapes)
    # bf16 params, int8 mu and nu, two f32 scales a block of 256
    ckpt_est = n_params * (2 + 2) + 2 * 4 * n_params // 256
    export_est = 2 * n_params
    # peak on disk: A, B's step 4, C's steps 2 and 4; then the export
    need = int(1.1 * (4 * ckpt_est + export_est))
    shutil.rmtree(LIFECYCLE_DIR, ignore_errors=True)
    os.makedirs(LIFECYCLE_DIR)
    free = shutil.disk_usage(LIFECYCLE_DIR).free
    if free < need:
        raise AssertionError(f"lifecycle needs {need} bytes of disk, "
                             f"{free} free under {LIFECYCLE_DIR}")
    d = {k: f"{LIFECYCLE_DIR}/{k}" for k in ("A", "B", "C", "export")}
    tokens_path = f"{LIFECYCLE_DIR}/tokens.bin"
    write_token_file(np.random.default_rng(0).integers(
        0, cfg.vocab_size, LIFECYCLE_WINDOWS * (seq + 1)),
        tokens_path, "int32" if cfg.vocab_size > 65535 else "uint16")
    common = ["--preset", preset, "--batch", str(batch), "--seq", str(seq),
              "--device", str(dev), "--optim", "adamw-int8",
              "--log-every", "1", "--save-every", "4", "--data",
              tokens_path]

    def train(ckpt_dir, steps, on_line=None):
        lines = _run_cli(train_main, [*common, "--ckpt-dir", ckpt_dir,
                                      "--steps", str(steps)], on_line)
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        return {"steps": [ln for ln in lines if "event" not in ln],
                "saved": [ln for ln in lines if ln.get("event") == "saved"],
                "resumed": [ln for ln in lines
                            if ln.get("event") == "resumed"],
                "last": lines[-1]}

    def step_nums(run):
        return [ln["step"] for ln in run["steps"]]

    def quiesce_after_step_1(line):
        if line.get("step") == 1 and "event" not in line:
            # the handler sets the stop flag before step 2 runs: the
            # trainer saves and quiesces after step 2
            signal.raise_signal(signal.SIGTERM)

    try:
        # ---- the main path: counts zeroed just before, read just after
        flash.reset_launch_count()
        optim.reset_launch_count()
        t0 = time.perf_counter()
        phase_t0 = t0
        a = train(d["A"], 4)
        b1 = train(d["B"], 2)
        b2 = train(d["B"], 4)
        c1 = train(d["C"], 4, quiesce_after_step_1)
        c2 = train(d["C"], 4)
        train_s = time.perf_counter() - t0
        train_launches = {**flash.launch_count, **optim.launch_count}

        if step_nums(a) != [1, 2, 3, 4] or step_nums(b1) != [1, 2]:
            raise AssertionError(f"step lines: A {step_nums(a)}, "
                                 f"B {step_nums(b1)}")
        if step_nums(b2) != [3, 4] or b2["resumed"][0]["step"] != 2:
            raise AssertionError(f"B did not resume at step 2: {b2}")
        if (c1["last"] != {"event": "quiesced", "step": 2}
                or [s["step"] for s in c1["saved"]] != [2]):
            raise AssertionError(f"SIGTERM did not save step 2: {c1}")
        if step_nums(c2) != [3, 4] or c2["resumed"][0]["step"] != 2:
            raise AssertionError(f"C did not resume at step 2: {c2}")
        losses_equal = ([s["loss"] for s in b2["steps"]]
                        == [s["loss"] for s in a["steps"][2:]]
                        == [s["loss"] for s in c2["steps"]])
        b_vs_a = _ckpt_files_equal(dev, f"{d['A']}/4", f"{d['B']}/4")
        c_vs_a = _ckpt_files_equal(dev, f"{d['A']}/4", f"{d['C']}/4")
        # bit-equal by design (no kernel of the step uses atomics); a
        # card that is not bit-deterministic is held to 1e-3 relative
        for name, cmp in (("B", b_vs_a), ("C", c_vs_a)):
            if not cmp["bit_equal"] and cmp["params_max_rel"] > 1e-3:
                raise AssertionError(f"{name}'s step 4 differs from A's: "
                                     f"{cmp}")
        if (b_vs_a["bit_equal"] and c_vs_a["bit_equal"]
                and not losses_equal):
            raise AssertionError("equal checkpoints, other losses")
        shutil.rmtree(d["C"])
        shutil.rmtree(f"{d['B']}/2")

        exported = _run_cli(import_weights._main, [
            "--ckpt-dir", d["B"], "--preset", preset, "--out", d["export"],
            "--device", str(dev)])[-1]
        t1 = time.perf_counter()
        _, imported = import_weights.import_hf_llama(d["export"], cfg,
                                                     device=dev)
        _sync(dev)
        import_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        params, step = ckpt.restore_model_params(d["B"], cfg, dev)
        _sync(dev)
        restore_s = time.perf_counter() - t1
        flat_i, flat_p = {}, {}
        ckpt._flatten(imported, "", flat_i, {})
        ckpt._flatten(params, "", flat_p, {})
        same = flat_i.keys() == flat_p.keys() and all(
            torch.equal(flat_i[k], flat_p[k]) for k in flat_p)
        del imported
        if not same or step != 4:
            raise AssertionError(f"export of step {step} does not import "
                                 f"bit-equal")

        prompt = np.random.default_rng(1).integers(
            0, cfg.vocab_size, 100).tolist()
        eng = SlotEngine(cfg, fuse_llama_projections(params), slots=2,
                         max_seq=256, chunk=8, cache_dtype=cfg.dtype)
        h = eng.submit(prompt, LIFECYCLE_MAX_NEW)
        while not h.done():
            eng.step()
        want = h.result(0)["tokens"]
        del eng, params
        gc.collect()
        hf = _serve_once(["--hf-ckpt", d["export"], "--device", str(dev)],
                         prompt)
        ck = _serve_once(["--preset", preset, "--ckpt-dir", d["B"],
                          "--device", str(dev)], prompt)
        launches = {**flash.launch_count, **optim.launch_count}
        # ---- end of the main path

        if not hf["tokens"] == ck["tokens"] == want:
            raise AssertionError(f"greedy tokens differ: hf {hf['tokens']}"
                                 f", ckpt {ck['tokens']}, in memory {want}")
        if ck["step"] != 4 or hf["model"] != "export":
            raise AssertionError(f"/healthz: {ck}, {hf}")
        n_train_steps = 12  # A 4, B 2 + 2, C 2 + 2
        want_train = {"flash_fwd": cfg.n_layers * n_train_steps,
                      "flash_bwd_dq": cfg.n_layers * n_train_steps,
                      "flash_bwd_dkv": cfg.n_layers * n_train_steps,
                      "adam8": len(shapes) * n_train_steps}
        # on the CPU the wrappers run the plain versions, which never count
        if dev.type == "cuda" and train_launches != want_train:
            raise AssertionError(f"lifecycle train launches "
                                 f"{train_launches}, expected {want_train}")
        if dev.type == "cuda" and (launches["flash_fwd"]
                                   <= train_launches["flash_fwd"]):
            raise AssertionError("no flash_fwd launch while serving")
        saves = [{"run": run, **{k: s[k] for k in (
                     "step", "bytes", "blocked_s", "d2h_s", "write_s")}}
                 for run, r in (("A", a), ("B", b1), ("B", b2), ("C", c1),
                                ("C", c2)) for s in r["saved"]]
        result = {
            "phase": "lifecycle", "preset": preset,
            "params": n_params,
            "batch": batch, "seq": seq, "optim": "adamw-int8",
            "token_file_windows": LIFECYCLE_WINDOWS,
            "disk_free_bytes": free, "disk_needed_bytes": need,
            "train_s": train_s,
            "losses": {"A": [s["loss"] for s in a["steps"]],
                       "B": [s["loss"] for s in b1["steps"] + b2["steps"]],
                       "C": [s["loss"] for s in c1["steps"] + c2["steps"]]},
            "losses_equal": losses_equal,
            "B_vs_A": b_vs_a, "C_vs_A": c_vs_a,
            "saves": saves,
            "resume_restore_s": [r["resumed"][0]["restore_s"]
                                 for r in (b2, c2)],
            "quiesce": c1["last"],
            "export": exported, "import_s": import_s,
            "restore_params_s": restore_s,
            "serve_hf": {k: hf[k] for k in ("ready_s", "model", "step")},
            "serve_ckpt": {k: ck[k] for k in ("ready_s", "model", "step")},
            "greedy_tokens": want, "launches": launches,
            "phase_s": time.perf_counter() - phase_t0,
            "card": nvidia_smi() if dev.type == "cuda" else "cpu"}
        emit(result)
        return result
    finally:
        shutil.rmtree(LIFECYCLE_DIR, ignore_errors=True)


LORA_DIR = "build/lora"
LORA_RANK, LORA_ALPHA, LORA_TARGETS = 16, 16.0, ("wq", "wv")
LORA_TOL = 2e-2  # the train phase's block-gradient bound
LORA_CHUNK_TOL = 1e-4  # the train phase's chunked-loss bound


def _tensors(tree, prefix: str = "") -> dict:
    """Every tensor of a param tree by path: an int8 leaf's weights and
    scales, a LoRA leaf's base, A and B."""
    from tpu_docker_api_torch.ops.quant import LoraLinear, QuantizedLinear

    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_tensors(v, f"{prefix}/{k}" if prefix else k))
        return out
    if isinstance(tree, QuantizedLinear):
        return {f"{prefix}/w_int8": tree.w_int8, f"{prefix}/scale": tree.scale}
    if isinstance(tree, LoraLinear):
        return {**_tensors(tree.base, f"{prefix}/base"), f"{prefix}/a": tree.a,
                f"{prefix}/b": tree.b}
    return {prefix: tree}


def _host_copy(tree) -> dict:
    """A copy of every tensor of ``tree`` in host memory (so it adds
    nothing to the card's peak)."""
    return {k: t.to("cpu", copy=True) for k, t in _tensors(tree).items()}


def _unchanged(tree, copy: dict) -> bool:
    now = _tensors(tree)
    return now.keys() == copy.keys() and all(
        torch.equal(now[k].cpu(), v) for k, v in copy.items())


def _median(xs: list) -> float:
    return sorted(xs)[len(xs) // 2]


def _lora_train_run(dev, cfg, base, forward: str, optim_name: str,
                    tokens) -> dict:
    """TRAIN_STEPS LoRA steps (train/lora.py's entry points) on one
    repeated batch; every launch count zeroed just before, read just
    after."""
    from tpu_docker_api_torch.ops import flash
    from tpu_docker_api_torch.train import lora, optim

    opt = optim.adamw_int8() if optim_name == "adamw-int8" else None
    state, opt = lora.create_lora_state(
        cfg, torch.Generator(device=dev).manual_seed(0), LORA_RANK,
        LORA_TARGETS, opt)
    step_fn = lora.make_lora_train_step(cfg, opt, base, LORA_ALPHA, forward)
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    losses, step_ms = [], []

    # ---- the main path: counts zeroed just before, read just after
    flash.reset_launch_count()
    optim.reset_launch_count()
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, metrics = step_fn(state, tokens)
        _sync(dev)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(metrics["loss"])
    launches = {**flash.launch_count, **optim.launch_count}
    # ---- end of the main path

    steady = _median(step_ms[1:])
    return {"forward": forward, "optim": optim_name,
            "adapter_params": sum(t.numel() for t in
                                  _tensors(state.params).values()),
            "losses": [x.item() for x in losses], "first_loss": losses[0],
            "step_ms": step_ms, "step_ms_median_after_first": steady,
            "tokens_per_sec": tokens.shape[0] * (tokens.shape[1] - 1)
            / (steady / 1e3),
            "launches": launches,
            "max_memory_allocated": (torch.cuda.max_memory_allocated(dev)
                                     if dev.type == "cuda" else None),
            "state": state}


def _adapter_grads_rel_l2(dev, cfg, int8: bool) -> dict:
    """Adapter gradients of ONE full-width block (the loss through the
    lm_head), B given mass, through the flash kernels against the dense
    plain path: merged over bf16, or attached over int8."""
    from tpu_docker_api_torch.models.llama import llama_init, llama_loss
    from tpu_docker_api_torch.train import lora, optim

    cfg1 = dataclasses.replace(cfg, n_layers=1)
    base = llama_init(cfg1, torch.Generator(device=dev).manual_seed(3))
    if int8:
        base = lora.quantize_base(base)
    g = torch.Generator(device=dev).manual_seed(5)
    adapters = lora.lora_init(base, LORA_RANK, g, LORA_TARGETS)
    adapters = optim.tree_map(
        lambda t: t + 0.02 * torch.randn(t.shape, generator=g, device=dev),
        adapters)
    combine = lora.attach_lora if int8 else lora.merge_lora
    seq = min(1025, cfg.max_seq_len)
    tokens = torch.randint(0, cfg.vocab_size, (2, seq), device=dev,
                           generator=torch.Generator(device=dev)
                           .manual_seed(4))
    grads = {}
    for impl in ("flash", "dense"):
        live = optim.tree_map(lambda t: t.detach().requires_grad_(),
                              adapters)
        llama_loss(combine(base, live, LORA_ALPHA), tokens,
                   dataclasses.replace(cfg1, attention_impl=impl)).backward()
        grads[impl] = {k: t.grad.float() for k, t in _tensors(live).items()}
    return {k: ((grads["flash"][k] - ref).norm() / ref.norm()).item()
            for k, ref in grads["dense"].items()}


def _attached_server(dev, cfg, argv: list, want_tree, prompt: list,
                     max_seq: int) -> dict:
    """The attached QLoRA server at the serve phase's engine settings:
    one greedy request alone, whose tokens must equal an in-memory
    engine's on ``want_tree`` (built apart, same settings), then the
    serve phase's 8-prompt burst for its latency, and one decode step's
    kernels on the served tree."""
    from tpu_docker_api_torch.infer.slots import SlotEngine
    from tpu_docker_api_torch.serve.__main__ import Server, parse_args

    engine_args = {"slots": 8, "max_seq": max_seq, "chunk": 8}
    t0 = time.perf_counter()
    srv = Server(parse_args([*argv, "--max-seq", str(max_seq), "--slots",
                             "8", "--chunk", "8", "--host", "127.0.0.1",
                             "--port", "0"]))
    ready_s = time.perf_counter() - t0
    port = srv.httpd.server_address[1]
    thread = threading.Thread(target=srv.httpd.serve_forever, daemon=True)
    thread.start()
    try:
        got = _check_reply(*_post(port, {"tokens": [prompt],
                                         "maxNewTokens": LIFECYCLE_MAX_NEW}),
                           1, LIFECYCLE_MAX_NEW, cfg.vocab_size)["tokens"][0]
        eng = SlotEngine(cfg, want_tree, cache_dtype=cfg.dtype, **engine_args)
        h = eng.submit(prompt, LIFECYCLE_MAX_NEW)
        while not h.done():
            eng.step()
        want = h.result(0)["tokens"]
        del eng, h
        if got != want:
            raise AssertionError(f"attached server {got} != in-memory "
                                 f"{want}")
        g = torch.Generator().manual_seed(0)
        prompts = [torch.randint(0, cfg.vocab_size,
                                 (min(n * max_seq // 2048, max_seq - 33),),
                                 generator=g).tolist()
                   for n in SERVE_LENGTHS]
        srv.engine.reset_latency_stats()
        replies, wall = _concurrent(port, prompts, 32)
        for r in replies:
            _check_reply(*r, 1, 32, cfg.vocab_size)
        latency = srv.engine.latency_stats()
        lora_leaf = srv.params["layers"]["attn"]["wq"]
        decode = (_decode_step_profile(dev, cfg, srv.params)
                  if dev.type == "cuda" else None)
        return {"ready_s": ready_s, "greedy_tokens": got,
                "served_leaf": f"{type(lora_leaf).__name__}("
                               f"{type(lora_leaf.base).__name__})",
                "fused": "w_qkv" in srv.params["layers"]["attn"],
                "burst_wall_s": wall, "ttft_p50_ms": latency["ttft_p50_ms"],
                "itl_p50_ms": latency["itl_p50_ms"],
                "decode_step": decode}
    finally:
        srv.httpd.shutdown()
        srv.close()
        thread.join(timeout=30)


def _qlora_big(dev, preset: str, seq: int, steps: int) -> dict:
    """The configuration QLoRA exists for: the trainer's command line in
    process, ``--qlora --lora-rank 16 --batch 1 --optim adamw-int8
    --profile-dir``, one step traced (the second) and one after it. The
    step function is wrapped to time each step to a synchronise and to
    keep a host copy of the int8 base it closes over, which must be
    unchanged after."""
    from tpu_docker_api_torch.ops import flash
    from tpu_docker_api_torch.train import lora, optim
    from tpu_docker_api_torch.train.__main__ import main as train_main

    real = lora.make_lora_train_step
    seen: dict = {"step_ms": []}

    def wrapped(cfg, optimizer, base, alpha=16.0, forward="merged",
                mesh=None):
        seen["base"], seen["before"] = base, _host_copy(base)
        if dev.type == "cuda":
            # the load (random bf16 base, then int8) peaks apart from the
            # steps: read it here and count the steps' peak from here on
            seen["memory"] = {
                "load_peak": torch.cuda.max_memory_allocated(dev),
                "allocated_before_steps": torch.cuda.memory_allocated(dev)}
            torch.cuda.reset_peak_memory_stats(dev)
        step = real(cfg, optimizer, base, alpha, forward, mesh=mesh)

        def timed(state, tokens):
            _sync(dev)
            t0 = time.perf_counter()
            out = step(state, tokens)
            _sync(dev)
            seen["step_ms"].append((time.perf_counter() - t0) * 1e3)
            return out

        return timed

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    lora.make_lora_train_step = wrapped
    try:
        # ---- the main path: counts zeroed just before, read just after
        flash.reset_launch_count()
        optim.reset_launch_count()
        lines = _run_cli(train_main, [
            "--preset", preset, "--qlora", "--lora-rank", str(LORA_RANK),
            "--batch", "1", "--seq", str(seq), "--steps", str(steps),
            "--optim", "adamw-int8", "--log-every", "1", "--device",
            str(dev), "--profile-dir", f"{LORA_DIR}/profile_big",
            "--profile-steps", "1"])
        launches = {**flash.launch_count, **optim.launch_count}
        # ---- end of the main path
    finally:
        lora.make_lora_train_step = real
    memory = seen.get("memory")
    if memory is not None:
        memory["steps_peak"] = torch.cuda.max_memory_allocated(dev)
    losses = [ln["loss"] for ln in lines if "event" not in ln]
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{preset} QLoRA losses: {lines[-3:]}")
    if not _unchanged(seen["base"], seen["before"]):
        raise AssertionError(f"{preset} QLoRA changed its base")
    prof = [ln for ln in lines if ln.get("event") == "profile_written"]
    base_bytes = sum(t.numel() * t.element_size()
                     for t in seen["before"].values())
    step_ms = seen["step_ms"]
    del seen
    gc.collect()
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    # the first step pays the allocator's first touches, the second is
    # traced: the third is the steady one
    return {"preset": preset, "batch": 1, "seq": seq, "steps": steps,
            "losses": losses, "step_ms": step_ms,
            "tokens_per_sec_last_step": seq / (step_ms[-1] / 1e3),
            "base_bytes": base_bytes, "launches": launches,
            "max_memory_allocated": memory,
            "profile": prof[0] if prof else None}


def phase_lora(dev, train: dict | None, int8: dict | None,
               preset: str = "llama3-1b", batch: int = TRAIN_BATCH,
               seq: int = TRAIN_SEQ, big: str = "llama3-8b",
               big_seq: int = TRAIN_SEQ, max_seq: int = 2048) -> dict:
    """LoRA and QLoRA at llama3-1b's full width and depth (rank 16, alpha
    16, targets wq and wv, batch 4 x 2048), then llama3-8b's QLoRA:

    1. In process on one repeated batch: 4 merged steps under adamw over
       the bf16 base, 4 attached (QLoRA) steps under adamw-int8 over the
       int8 base. Checks: the first loss equals the base model's bit for
       bit, the base is bit-unchanged, finite losses that fall, the
       launch counts, the adapter gradients of one block through the
       kernels within 2e-2 relative L2 of the dense path (both
       forwards), the chunked loss over the int8 head within 1e-4 of the
       dense one.
    2. The command-line entry points, under ``build/lora`` (deleted at
       the end): a --qlora run of 4 steps saving at 2 and 4, a 2-step
       one resumed to 4 (bit-equal step-4 adapter checkpoints), a merged
       bf16 run; an attached ``--quantize`` server and a merged one, each
       giving an in-memory engine's greedy tokens; the attached server's
       burst latency and decode-step kernels.
    3. ``big`` (llama3-8b) QLoRA through the trainer CLI: finite losses,
       the base unchanged, peak memory, device time by kernel class with
       the straight-through backward's products named.

    The tests run it on the CPU at the tiny preset, where the wrappers
    run the plain versions and count nothing."""
    from tpu_docker_api_torch.infer.quantize import fuse_llama_projections
    from tpu_docker_api_torch.models.llama import (llama_init, llama_loss,
                                                   llama_presets)
    from tpu_docker_api_torch.ops import flash
    from tpu_docker_api_torch.train import lora, optim
    from tpu_docker_api_torch.train.__main__ import main as train_main
    from tpu_docker_api_torch.train.trainer import synthetic_batch

    phase_t0 = time.perf_counter()
    cfg = llama_presets()[preset]
    cuda = dev.type == "cuda"
    tokens = synthetic_batch(torch.Generator(device=dev).manual_seed(1),
                             batch, seq, cfg.vocab_size)
    want_steps = {"flash_fwd": cfg.n_layers * TRAIN_STEPS,
                  "flash_bwd_dq": cfg.n_layers * TRAIN_STEPS,
                  "flash_bwd_dkv": cfg.n_layers * TRAIN_STEPS}
    n_adapters = 2 * len(LORA_TARGETS)
    counts: dict = {}

    def add_counts(launches):
        for name, n in launches.items():
            counts[name] = counts.get(name, 0) + n

    # ---- 1. in process
    base = llama_init(cfg, torch.Generator(device=dev).manual_seed(0))
    runs = []
    for forward, optim_name in (("merged", "adamw"),
                                ("attached", "adamw-int8")):
        tree = base if forward == "merged" else lora.quantize_base(base)
        if forward == "attached":
            del base
            gc.collect()
        with torch.no_grad():
            base_loss = llama_loss(tree, tokens, cfg)
        before = _host_copy(tree)
        run = _lora_train_run(dev, cfg, tree, forward, optim_name, tokens)
        state = run.pop("state")
        losses = run["losses"]
        run["first_loss_equals_base"] = bool(torch.equal(
            run.pop("first_loss"), base_loss))
        run["base_unchanged"] = _unchanged(tree, before)
        del before
        if not run["first_loss_equals_base"]:
            raise AssertionError(f"{forward}: first loss {losses[0]} is not "
                                 f"the base's {base_loss.item()}")
        if not run["base_unchanged"]:
            raise AssertionError(f"{forward}: the base changed")
        if not all(math.isfinite(x) for x in losses) or \
                not losses[-1] < losses[0]:
            raise AssertionError(f"{forward}: losses {losses}")
        want = {**want_steps, "adam8": (n_adapters * TRAIN_STEPS
                                        if optim_name == "adamw-int8"
                                        else 0)}
        if cuda and run["launches"] != want:
            raise AssertionError(f"{forward}: launches {run['launches']}, "
                                 f"expected {want}")
        add_counts(run["launches"])
        if forward == "attached":
            # the int8 head dequantizes for the chunked loss
            attached = lora.attach_lora(tree, state.params, LORA_ALPHA)
            with torch.no_grad():
                dense = llama_loss(attached, tokens, cfg).item()
                chunked = llama_loss(attached, tokens, dataclasses.replace(
                    cfg, loss_chunk_rows=512)).item()
            del attached
        runs.append(run)
        del state
        _sync(dev)
    del tree
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    chunk_rel = abs(chunked - dense) / abs(dense)
    if chunk_rel > LORA_CHUNK_TOL:
        raise AssertionError(f"QLoRA chunked loss {chunked} vs dense {dense}")
    grad_rel = {"merged_bf16": _adapter_grads_rel_l2(dev, cfg, False),
                "attached_int8": _adapter_grads_rel_l2(dev, cfg, True)}
    worst = max(v for g in grad_rel.values() for v in g.values())
    if worst > LORA_TOL:
        raise AssertionError(f"adapter gradients, flash vs dense: {grad_rel}")
    if cuda:
        torch.cuda.empty_cache()

    # ---- 2. the command-line entry points
    shutil.rmtree(LORA_DIR, ignore_errors=True)
    os.makedirs(LORA_DIR)
    d = {k: f"{LORA_DIR}/{k}" for k in ("Q", "R", "M")}
    common = ["--preset", preset, "--batch", str(batch), "--seq", str(seq),
              "--device", str(dev), "--log-every", "1", "--lora-rank",
              str(LORA_RANK)]
    qlora = [*common, "--qlora", "--optim", "adamw-int8", "--save-every",
             "2"]

    def train_cli(argv):
        lines = _run_cli(train_main, argv)
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        return {"steps": [ln for ln in lines if "event" not in ln],
                "saved": [ln for ln in lines if ln.get("event") == "saved"],
                "resumed": [ln for ln in lines
                            if ln.get("event") == "resumed"],
                "last": lines[-1]}

    try:
        # ---- the main path: counts zeroed just before, read just after
        flash.reset_launch_count()
        optim.reset_launch_count()
        t0 = time.perf_counter()
        q = train_cli([*qlora, "--steps", "4", "--ckpt-dir", d["Q"]])
        r1 = train_cli([*qlora, "--steps", "2", "--ckpt-dir", d["R"]])
        r2 = train_cli([*qlora, "--steps", "4", "--ckpt-dir", d["R"]])
        m = train_cli([*common, "--steps", "2", "--ckpt-dir", d["M"]])
        cli_s = time.perf_counter() - t0
        cli_launches = {**flash.launch_count, **optim.launch_count}
        # ---- end of the main path

        if [s["step"] for s in q["steps"]] != [1, 2, 3, 4] or \
                [s["step"] for s in r2["steps"]] != [3, 4] or \
                r2["resumed"][0]["step"] != 2:
            raise AssertionError(f"QLoRA CLI steps: {q}, {r2}")
        r_vs_q = _ckpt_files_equal(dev, f"{d['Q']}/4", f"{d['R']}/4")
        if not r_vs_q["bit_equal"]:
            raise AssertionError(f"resumed QLoRA step 4 differs: {r_vs_q}")
        if [s["loss"] for s in r2["steps"]] != \
                [s["loss"] for s in q["steps"][2:]]:
            raise AssertionError("resumed QLoRA losses differ")
        # Q 4 steps, R 2 + 2, M 2; adam8 in Q's and R's (adamw-int8)
        want = {k: cfg.n_layers * 10 for k in want_steps}
        want["adam8"] = n_adapters * 8
        if cuda and cli_launches != want:
            raise AssertionError(f"LoRA CLI launches {cli_launches}, "
                                 f"expected {want}")
        add_counts(cli_launches)

        prompt = torch.randint(0, cfg.vocab_size, (100,),
                               generator=torch.Generator().manual_seed(1)
                               ).tolist()
        seed0 = llama_init(cfg, torch.Generator(device=dev).manual_seed(0))
        adapters_q = lora.restore_adapters(d["Q"], cfg, dev, LORA_RANK)
        want_attached = lora.attach_lora(lora.quantize_base(seed0),
                                         adapters_q, LORA_ALPHA)
        want_merged = fuse_llama_projections(lora.merge_lora(
            seed0, lora.restore_adapters(d["M"], cfg, dev, LORA_RANK),
            LORA_ALPHA))
        del seed0
        flash.reset_launch_count()
        attached_srv = _attached_server(
            dev, cfg, ["--preset", preset, "--quantize", "--lora-ckpt",
                       d["Q"], "--lora-rank", str(LORA_RANK),
                       "--lora-forward", "attached", "--device", str(dev),
                       "--seed", "0"], want_attached, prompt, max_seq)
        del want_attached
        merged_srv = _serve_once(["--preset", preset, "--lora-ckpt", d["M"],
                                  "--lora-rank", str(LORA_RANK), "--device",
                                  str(dev), "--seed", "0"], prompt)
        serve_flash = flash.launch_count["flash_fwd"]
        from tpu_docker_api_torch.infer.slots import SlotEngine

        eng = SlotEngine(cfg, want_merged, slots=2, max_seq=256, chunk=8,
                         cache_dtype=cfg.dtype)
        h = eng.submit(prompt, LIFECYCLE_MAX_NEW)
        while not h.done():
            eng.step()
        if merged_srv["tokens"] != h.result(0)["tokens"]:
            raise AssertionError(f"merged server {merged_srv['tokens']} != "
                                 f"in-memory {h.result(0)['tokens']}")
        del eng, h, want_merged, adapters_q
        if cuda and serve_flash == 0:
            raise AssertionError("no flash_fwd launch while serving LoRA")
        counts["flash_fwd"] = counts.get("flash_fwd", 0) + serve_flash
        t1 = time.perf_counter()
        lora.restore_adapters(d["Q"], cfg, dev, LORA_RANK)
        _sync(dev)
        restore_s = time.perf_counter() - t1
        saves = [{"run": name, **{k: s[k] for k in (
                     "step", "bytes", "blocked_s", "d2h_s", "write_s")}}
                 for name, run in (("Q", q), ("R", r1), ("R", r2), ("M", m))
                 for s in run["saved"]]
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        # ---- 3. the configuration QLoRA exists for
        big_res = _qlora_big(dev, big, big_seq, 3)
    finally:
        shutil.rmtree(LORA_DIR, ignore_errors=True)
    big_cfg = llama_presets()[big]
    if cuda and big_res["launches"] != {
            "flash_fwd": big_cfg.n_layers * 3,
            "flash_bwd_dq": big_cfg.n_layers * 3,
            "flash_bwd_dkv": big_cfg.n_layers * 3, "adam8": n_adapters * 3}:
        raise AssertionError(f"{big} QLoRA launches {big_res['launches']}")
    add_counts(big_res["launches"])

    result = {
        "phase": "lora", "preset": preset, "rank": LORA_RANK,
        "alpha": LORA_ALPHA, "targets": list(LORA_TARGETS),
        "batch": batch, "seq": seq, "steps": TRAIN_STEPS, "runs": runs,
        "full_finetune": ({r["optim"]: {k: r[k] for k in (
            "step_ms_median_after_first", "tokens_per_sec",
            "max_memory_allocated")} for r in train["runs"]}
            if train else None),
        "chunked_loss": chunked, "dense_loss": dense,
        "chunked_rel_diff": chunk_rel, "chunked_tol": LORA_CHUNK_TOL,
        "adapter_grad_rel_l2": grad_rel, "adapter_grad_tol": LORA_TOL,
        "cli": {"seconds": cli_s, "losses": {
                    "Q": [s["loss"] for s in q["steps"]],
                    "R": [s["loss"] for s in r1["steps"] + r2["steps"]],
                    "M": [s["loss"] for s in m["steps"]]},
                "R_vs_Q": r_vs_q, "saves": saves,
                "resume_restore_s": r2["resumed"][0]["restore_s"],
                "adapter_restore_s": restore_s,
                "launches": cli_launches},
        "serve_attached": attached_srv,
        "serve_int8_text_decode_kernels": (
            int8["decode_step_int8"]["kernel_events"] if int8 else None),
        "serve_merged": {k: merged_srv[k] for k in ("ready_s", "tokens")},
        "big": big_res, "launches": counts,
        "phase_s": time.perf_counter() - phase_t0,
        "card": nvidia_smi() if cuda else "cpu"}
    emit(result)
    return result


#: the serve_depth phase (slice 8): a 1,024-token system prompt and
#: suffixes of 17-512 tokens; one 1,900-token admission beside seven
#: decoding streams; the paged cache's page and pools
DEPTH_PRESET = "llama3-1b"
DEPTH_MAX_SEQ = 2048
DEPTH_PREFIX_LEN = 1024
DEPTH_SUFFIXES = [17, 40, 100, 180, 250, 333, 420, 512]
DEPTH_LONG, DEPTH_SEGMENT = 1900, 256
DEPTH_STREAM_PROMPT, DEPTH_STREAM_NEW = 64, 160
DEPTH_PAGE = 32            # --page-size 64 is refused: default buckets
#                            start at 32 and a page must divide each
DEPTH_POOL, DEPTH_TIGHT_POOL = 256, 48
DEPTH_TIGHT_NEW = 256
#: a request alone whose decode reads a 512-key view in both engines (the
#: dense read bucket and the paged 16-page bucket): the same arithmetic
DEPTH_SOLO = 300
DEPTH_BIG_SLOTS, DEPTH_BIG_SEQ = 64, 8192
#: the serve burst's pool under grow admission: its prompts' buckets hold
#: 191 pages of 32 and five requests grow one page each (196)
DEPTH_BIG_POOL = 200
DEPTH_LOGITS_TOL = 2e-2    # relative L2, bf16 through 16 layers


@contextlib.contextmanager
def _server(dev, argv: list[str]):
    """An in-process Server of the depth phase's model on a free port."""
    from tpu_docker_api_torch.serve.__main__ import Server, parse_args

    srv = Server(parse_args(["--preset", DEPTH_PRESET, "--device", str(dev),
                             "--slots", "8", "--chunk", "8", "--seed", "0",
                             "--host", "127.0.0.1", "--port", "0", *argv]))
    thread = threading.Thread(target=srv.httpd.serve_forever, daemon=True)
    thread.start()
    try:
        yield srv, srv.httpd.server_address[1]
    finally:
        srv.httpd.shutdown()
        srv.close()
        thread.join(timeout=30)
        del srv
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()


def _call(port: int, method: str, path: str, body=None) -> tuple[int, dict]:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    conn.request(method, path, body=None if body is None
                 else json.dumps(body))
    resp = conn.getresponse()
    data = json.loads(resp.read())
    conn.close()
    return resp.status, data


def _stream_times(port: int, prompt: list, max_new: int, started=None):
    """One streamed greedy request: (tokens, host arrival time of each,
    send time). ``started`` is set once the first token arrives."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    t0 = time.perf_counter()
    conn.request("POST", "/generate", body=json.dumps(
        {"tokens": [prompt], "maxNewTokens": max_new, "stream": True}))
    resp = conn.getresponse()
    toks, times, done = [], [], None
    for line in iter(resp.readline, b""):  # to the body's end
        if not line.strip():
            continue
        msg = json.loads(line)
        if "t" not in msg:
            done = msg
            continue
        toks.append(msg["t"])
        times.append(time.perf_counter())
        if started is not None:
            started.set()
    conn.close()
    if done != {"done": True, "length": max_new} or len(toks) != max_new:
        raise AssertionError(f"stream gave {len(toks)} of {max_new} "
                             f"tokens, then {done}")
    return toks, times, t0


def _burst(port: int, prompts: list, max_new: int, vocab: int) -> list:
    replies, _ = _concurrent(port, prompts, max_new)
    return [_check_reply(*r, 1, max_new, vocab)["tokens"][0]
            for r in replies]


def _rel_l2(a, b) -> float:
    return ((a - b).norm() / b.norm()).item()


def _route_logits(srv, prompt: list, **engine_args):
    """First-token logits of ``prompt`` through one admission route: a
    fresh one-slot engine on the server's params (a PagedSlotEngine when
    ``page_size`` is given) with ``prefix`` registered first, its sampler
    wrapped to keep the logits it is handed."""
    from tpu_docker_api_torch.infer.paged import PagedSlotEngine
    from tpu_docker_api_torch.infer.slots import SlotEngine

    prefix = engine_args.pop("prefix", None)
    cls = PagedSlotEngine if "page_size" in engine_args else SlotEngine
    eng = cls(srv.cfg, srv.params, slots=1, max_seq=DEPTH_MAX_SEQ,
              cache_dtype=srv.cfg.dtype, **engine_args)
    if prefix is not None:
        eng.register_prefix(prefix)
    seen = []

    def keep(logits, *rest):
        seen.append(logits[0].float().clone())
        return cls._sample_filtered(logits, *rest)

    eng._sample_filtered = keep
    for _ in range(2):  # the second admission is timed
        t0 = time.perf_counter()
        h = eng.submit(prompt, 1)
        while not h.done():
            eng.step()
        h.result(0)
        admit_s = time.perf_counter() - t0
    stats = dict(eng.stats, admit_ms=admit_s * 1e3)
    eng.close()
    return seen[-1], stats


def _segment_stall(dev, prefill_chunk: int, vocab: int) -> dict:
    """Seven streams decoding, then one long admission: each stream's
    longest gap between tokens and mean gap, the long request's TTFT."""
    g = torch.Generator().manual_seed(2)
    streams = [torch.randint(0, vocab, (DEPTH_STREAM_PROMPT,),
                             generator=g).tolist() for _ in range(7)]
    long_p = torch.randint(0, vocab, (DEPTH_LONG,), generator=g).tolist()
    with _server(dev, ["--max-seq", str(DEPTH_MAX_SEQ), "--prefill-chunk",
                       str(prefill_chunk)]) as (srv, port):
        _burst(port, [[1, 2, 3]], 2, vocab)
        # the long prompt's programs once, so both runs start warm
        _burst(port, [long_p], 2, vocab)
        out: list = [None] * 8
        started = [threading.Event() for _ in range(7)]

        def stream(i, prompt, max_new, ev=None):
            out[i] = _stream_times(port, prompt, max_new, ev)

        threads = [threading.Thread(
            target=stream, args=(i, streams[i], DEPTH_STREAM_NEW,
                                 started[i])) for i in range(7)]
        for t in threads:
            t.start()
        for ev in started:
            if not ev.wait(timeout=300):
                raise AssertionError("a stream never started")
        segments0 = srv.engine.stats["segment_prefills"]
        long_t = threading.Thread(target=stream, args=(7, long_p, 8))
        long_t.start()
        for t in [*threads, long_t]:
            t.join(timeout=600)
        segments = srv.engine.stats["segment_prefills"] - segments0
    _, long_times, long_t0 = out[7]
    gaps = []
    means = []
    for _, times, _ in out[:7]:
        d = [b - a for a, b in zip(times, times[1:])]
        gaps.append(max(d))
        means.append(sum(d) / len(d))
    # the window the long admission can stall: from its send to its first
    # token, seen by the streams still running
    in_window = [max([b - a for a, b in zip(times, times[1:])
                      if b >= long_t0] or [0.0])
                 for _, times, _ in out[:7]]
    return {"prefill_chunk": prefill_chunk, "segments": segments,
            "long_ttft_ms": (long_times[0] - long_t0) * 1e3,
            "streams_max_gap_ms": max(gaps) * 1e3,
            "streams_max_gap_after_long_submit_ms": max(in_window) * 1e3,
            "streams_itl_p50_ms": sorted(means)[3] * 1e3}


def _busy_ms(fn) -> dict:
    """One call of ``fn`` (a whole forward: more launches than the card's
    queue holds, so events around it read the host's time): its device
    busy ms and kernels under ``torch.profiler``, and its host-clocked ms
    to a synchronise, after two warm calls."""
    from torch.profiler import ProfilerActivity, profile

    from tpu_docker_api_torch.telemetry.profile import device_time_summary

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    summary = device_time_summary(prof, wall)
    return {"busy_ms": summary.get("busy_ms"),
            "kernels": summary["kernel_events"], "wall_ms": wall * 1e3}


def _decode_read_costs(dev, srv) -> dict:
    """Device ms of one 8-slot decode step at position 1900 through the
    dense cache (2,048-key read bucket) and through the page pool
    (64 pages of 32 gathered a layer), and of one 256-token segment at
    offset 1,792 against the 2,048-key view (dense f32 scores) beside the
    whole 2,048-token prefill through the flash kernel."""
    from tpu_docker_api_torch.models.llama import (llama_forward_cached,
                                                   llama_forward_paged)

    cfg, params = srv.cfg, srv.params
    L, kvh, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    rows, pos = 8, 1900
    dense_k = torch.randn((L, rows, DEPTH_MAX_SEQ, kvh, hd), device=dev,
                          dtype=cfg.dtype)
    dense_v = torch.randn_like(dense_k)
    pages = DEPTH_MAX_SEQ // DEPTH_PAGE
    pool_k = dense_k.reshape(L, rows * pages, DEPTH_PAGE, kvh, hd).clone()
    pool_v = dense_v.reshape(L, rows * pages, DEPTH_PAGE, kvh, hd).clone()
    table = torch.arange(rows * pages, device=dev).reshape(rows, pages)
    tok = torch.arange(rows, device=dev)[:, None] + 1000
    posv = torch.full((rows,), pos, device=dev)
    with torch.no_grad():
        dense_logits, _, _ = llama_forward_cached(
            params, tok, cfg, dense_k, dense_v, posv, kv_limit=DEPTH_MAX_SEQ)
        paged_logits, _, _ = llama_forward_paged(
            params, tok, cfg, pool_k, pool_v, table, posv,
            max_pos=DEPTH_MAX_SEQ)
        dense_step = _busy_ms(lambda: llama_forward_cached(
            params, tok, cfg, dense_k, dense_v, posv,
            kv_limit=DEPTH_MAX_SEQ))
        paged_step = _busy_ms(lambda: llama_forward_paged(
            params, tok, cfg, pool_k, pool_v, table, posv,
            max_pos=DEPTH_MAX_SEQ))
        seg = torch.randint(0, cfg.vocab_size, (1, DEPTH_SEGMENT),
                            device=dev)
        start = torch.tensor([DEPTH_MAX_SEQ - DEPTH_SEGMENT], device=dev)
        row_k, row_v = dense_k[:, :1].clone(), dense_v[:, :1].clone()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        segment = _busy_ms(lambda: llama_forward_cached(
            params, seg, cfg, row_k, row_v, start,
            last_only=torch.tensor([DEPTH_SEGMENT - 1]),
            kv_limit=DEPTH_MAX_SEQ))
        segment_peak = torch.cuda.max_memory_allocated(dev) - base
        whole = torch.randint(0, cfg.vocab_size, (1, DEPTH_MAX_SEQ),
                              device=dev)
        wk = torch.zeros_like(row_k)
        wv = torch.zeros_like(row_v)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        whole_step = _busy_ms(lambda: llama_forward_cached(
            params, whole, cfg, wk, wv, 0, last_only=True))
        whole_peak = torch.cuda.max_memory_allocated(dev) - base
    gather = 2 * L * rows * DEPTH_MAX_SEQ * kvh * hd * 2
    rel = _rel_l2(paged_logits, dense_logits)
    if rel != 0.0:
        # the gathered view holds the dense cache's values: the same
        # attention on the same numbers
        raise AssertionError(f"paged decode logits differ: {rel}")
    return {"decode_step_dense": dense_step,
            "decode_step_paged": paged_step,
            "paged_vs_dense_decode_logits_rel_l2": rel,
            "paged_gather_bytes_per_step": gather,
            "segment_256_at_1792": segment,
            "segment_peak_bytes": segment_peak,
            "offset_scores_bytes_per_layer": (
                cfg.n_heads * DEPTH_SEGMENT * DEPTH_MAX_SEQ * 4),
            "whole_2048_flash": whole_step,
            "whole_2048_peak_bytes": whole_peak}


def _peak_burst(dev, argv: list[str], prompts: list, vocab: int) -> dict:
    """max_memory_allocated across building a server and serving the
    burst, beside the bytes of its KV cache."""
    cuda = dev.type == "cuda"
    if cuda:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev) if cuda else None
    with _server(dev, argv) as (srv, port):
        _burst(port, prompts, 32, vocab)
        eng = srv.engine
        out = {"argv": argv, "allocated_before": before,
               "cache_bytes": 2 * eng._k.numel() * eng._k.element_size(),
               "max_memory_allocated": (
                   torch.cuda.max_memory_allocated(dev) if cuda else None),
               "deferred_admissions": eng.stats.get("deferred_admissions")}
    return out


def phase_serve_depth(dev) -> dict:
    """Prefix caching, segments and the paged cache through the server's
    HTTP entry point at llama3-1b full width and depth (module docstring,
    phase 5b)."""
    from tpu_docker_api_torch.ops import flash

    phase_t0 = time.perf_counter()
    g = torch.Generator().manual_seed(1)
    res: dict = {"phase": "serve_depth", "preset": DEPTH_PRESET}
    launches: dict = {}
    seq = ["--max-seq", str(DEPTH_MAX_SEQ)]
    with _server(dev, seq) as (srv, port):
        cfg, eng = srv.cfg, srv.engine
        vocab = cfg.vocab_size
        prefix = torch.randint(0, vocab, (DEPTH_PREFIX_LEN,),
                               generator=g).tolist()
        px_prompts = [prefix + torch.randint(0, vocab, (n,),
                                             generator=g).tolist()
                      for n in DEPTH_SUFFIXES]
        burst = [torch.randint(0, vocab, (n,), generator=g).tolist()
                 for n in SERVE_LENGTHS]
        _burst(port, [[1, 2, 3]], 2, vocab)

        # ---- 1. prefix: build, 8 prefixed requests, then without it
        flash.reset_launch_count()
        code, body = _call(port, "POST", "/prefixes", {"tokens": prefix})
        launches["dense_prefix_build"] = flash.launch_count["flash_fwd"]
        if code != 200 or body["length"] != DEPTH_PREFIX_LEN:
            raise AssertionError(f"POST /prefixes: {code} {body}")
        pid = body["prefixId"]
        _, listing = _call(port, "GET", "/prefixes")
        want_bytes = (2 * cfg.n_layers * DEPTH_PREFIX_LEN * cfg.n_kv_heads
                      * cfg.head_dim * 2)
        if listing["prefixes"] != [{"id": pid, "length": DEPTH_PREFIX_LEN,
                                    "bytes": want_bytes}]:
            raise AssertionError(f"GET /prefixes: {listing}")
        runs = {}
        for name in ("with_prefix", "without_prefix"):
            if name == "without_prefix":
                code, body = _call(port, "DELETE", f"/prefixes/{pid}")
                _, after = _call(port, "GET", "/prefixes")
                if (body != {"removed": True} or after["prefixes"]
                        or eng.stats["prefix_bytes"] != 0):
                    raise AssertionError(f"DELETE: {body} {after}")
            eng.reset_latency_stats()
            hits0 = eng.stats["prefix_hits"]
            flash.reset_launch_count()
            toks = _burst(port, px_prompts, 32, vocab)
            launches[f"dense_{name}"] = flash.launch_count["flash_fwd"]
            lat = eng.latency_stats()
            runs[name] = {"ttft_p50_ms": lat["ttft_p50_ms"],
                          "itl_p50_ms": lat["itl_p50_ms"],
                          "prefix_hits": eng.stats["prefix_hits"] - hits0,
                          "flash_launches": launches[f"dense_{name}"],
                          "tokens": toks}
        if runs["with_prefix"]["prefix_hits"] != len(px_prompts):
            raise AssertionError(f"prefix hits: {runs['with_prefix']}")
        agree = [a == b for a, b in zip(runs["with_prefix"].pop("tokens"),
                                        runs["without_prefix"].pop("tokens"))]
        res["prefix"] = {"prefix_bytes": want_bytes, "listing": listing,
                         **runs, "streams_token_equal": sum(agree)}
        # the dense burst, for the paged one below
        solo = torch.randint(0, vocab, (DEPTH_SOLO,), generator=g).tolist()
        dense_solo = _burst(port, [solo], 32, vocab)[0]
        eng.reset_latency_stats()
        dense_burst = _burst(port, burst, 32, vocab)
        lat = eng.latency_stats()
        res["dense_burst"] = {"ttft_p50_ms": lat["ttft_p50_ms"],
                              "itl_p50_ms": lat["itl_p50_ms"],
                              "cache_bytes": 2 * eng._k.numel()
                              * eng._k.element_size()}

        # ---- first-token logits of each route against the whole prompt
        probe = px_prompts[3]
        whole, whole_stats = _route_logits(srv, probe)
        routes = {
            "prefix": dict(prefix=prefix),
            "segments": dict(prefill_chunk=DEPTH_SEGMENT),
            "paged": dict(page_size=DEPTH_PAGE),
            "paged_prefix": dict(page_size=DEPTH_PAGE, prefix=prefix),
            "paged_segments": dict(page_size=DEPTH_PAGE,
                                   prefill_chunk=DEPTH_SEGMENT)}
        logits = {}
        for name, kw in routes.items():
            got, stats = _route_logits(srv, probe, **kw)
            logits[name] = {"rel_l2": _rel_l2(got, whole),
                            "argmax_equal": bool(got.argmax()
                                                 == whole.argmax()),
                            "admit_ms": stats["admit_ms"],
                            "prefix_hits": stats["prefix_hits"],
                            "segment_prefills": stats["segment_prefills"]}
            if logits[name]["rel_l2"] > DEPTH_LOGITS_TOL or not (
                    torch.isfinite(got).all()):
                raise AssertionError(f"{name} logits: {logits[name]}")
        if logits["paged"]["rel_l2"] != 0.0:
            # the same forward as the dense whole prompt, then a scatter
            raise AssertionError(f"paged whole-prompt logits: {logits}")
        res["first_token_logits"] = {"tol": DEPTH_LOGITS_TOL,
                                     "whole_admit_ms": whole_stats[
                                         "admit_ms"], **logits}
        if dev.type == "cuda":
            res["read_costs"] = _decode_read_costs(dev, srv)

    # ---- 2. segments: seven streams and one long admission
    res["segments"] = [_segment_stall(dev, pc, vocab)
                       for pc in (DEPTH_SEGMENT, 0)]

    # ---- 3. paged: the burst, the shared prefix, a tight pool
    paged = ["--page-size", str(DEPTH_PAGE)]
    with _server(dev, [*seq, *paged, "--total-pages", str(DEPTH_POOL)]) as (
            srv, port):
        eng = srv.engine
        _burst(port, [[1, 2, 3]], 2, vocab)
        eng.reset_latency_stats()
        flash.reset_launch_count()
        paged_burst = _burst(port, burst, 32, vocab)
        launches["paged_burst"] = flash.launch_count["flash_fwd"]
        lat = eng.latency_stats()
        if eng.stats["pages_free"] != eng.stats["pages_total"]:
            raise AssertionError(f"pages leaked: {eng.stats}")
        agree = sum(a == b for a, b in zip(paged_burst, dense_burst))
        if _burst(port, [solo], 32, vocab)[0] != dense_solo:
            # alone, both read 512-key views of the same values
            raise AssertionError("paged solo tokens differ from dense")
        res["paged_burst"] = {
            "ttft_p50_ms": lat["ttft_p50_ms"],
            "itl_p50_ms": lat["itl_p50_ms"],
            "cache_bytes": 2 * eng._k.numel() * eng._k.element_size(),
            "pages_total": eng.stats["pages_total"],
            "grown_pages": eng.stats["grown_pages"],
            "streams_token_equal_dense": agree}
        flash.reset_launch_count()
        code, body = _call(port, "POST", "/prefixes", {"tokens": prefix})
        launches["paged_prefix_build"] = flash.launch_count["flash_fwd"]
        if code != 200:
            raise AssertionError(f"paged POST /prefixes: {code} {body}")
        pinned = DEPTH_PREFIX_LEN // DEPTH_PAGE
        eng.reset_latency_stats()
        hits0 = eng.stats["prefix_hits"]
        flash.reset_launch_count()
        _burst(port, px_prompts, 32, vocab)
        launches["paged_with_prefix"] = flash.launch_count["flash_fwd"]
        lat = eng.latency_stats()
        free = eng.stats["pages_free"]
        if free != eng.stats["pages_total"] - pinned:
            raise AssertionError(f"pages after the prefix run: {eng.stats}")
        _call(port, "DELETE", f"/prefixes/{body['prefixId']}")
        deadline = time.monotonic() + 10  # the engine loop reclaims them
        while (eng.stats["pages_free"] != eng.stats["pages_total"]
               and time.monotonic() < deadline):
            time.sleep(0.01)
        if eng.stats["pages_free"] != eng.stats["pages_total"]:
            raise AssertionError(f"prefix pages not returned: {eng.stats}")
        res["paged_prefix"] = {"ttft_p50_ms": lat["ttft_p50_ms"],
                               "itl_p50_ms": lat["itl_p50_ms"],
                               "prefix_hits": eng.stats["prefix_hits"] - hits0,
                               "pinned_pages": pinned,
                               "pages_free_after": free}
    tight_prompts = [torch.randint(0, vocab, (20,), generator=g).tolist()
                     for _ in range(8)]
    with _server(dev, [*seq, *paged, "--total-pages",
                       str(DEPTH_TIGHT_POOL)]) as (srv, port):
        eng = srv.engine
        out: list = [None] * 8

        def stream(i):
            out[i] = _stream_times(port, tight_prompts[i], DEPTH_TIGHT_NEW)

        flash.reset_launch_count()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=stream, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        launches["paged_tight"] = flash.launch_count["flash_fwd"]
        if not all(out):
            raise AssertionError("a tight-pool stream did not finish")
        st = dict(eng.stats)
        if st["preemptions"] < 1 or st["pages_free"] != st["pages_total"]:
            raise AssertionError(f"tight pool: {st}")
        res["paged_tight"] = {
            "pages_total": st["pages_total"], "max_new": DEPTH_TIGHT_NEW,
            "wall_s": time.perf_counter() - t0,
            "preemptions": st["preemptions"],
            "grown_pages": st["grown_pages"],
            "deferred_admissions": st["deferred_admissions"],
            "prefills": st["prefills"]}

    # ---- capacity: dense and paged at 64 slots x 8192, nothing else held
    srv = eng = None
    big = ["--max-seq", str(DEPTH_BIG_SEQ), "--slots", str(DEPTH_BIG_SLOTS)]
    live = sum(math.ceil((n + 31) / DEPTH_PAGE) for n in SERVE_LENGTHS)
    res["capacity"] = {
        "dense": _peak_burst(dev, big, burst, vocab),
        "paged": _peak_burst(dev, [*big, *paged, "--total-pages",
                                   str(DEPTH_BIG_POOL)], burst, vocab),
        "burst_live_pages": live}
    for path in ("dense_prefix_build", "paged_burst", "paged_prefix_build"):
        if launches[path] < cfg.n_layers:
            raise AssertionError(f"flash_fwd launched {launches[path]} "
                                 f"times on {path}")
    res.update({"flash_launches_by_run": launches,
                "flash_launches": sum(launches.values()),
                "phase_s": time.perf_counter() - phase_t0,
                "card": nvidia_smi() if dev.type == "cuda" else "cpu"})
    emit(res)
    return res


SPEC_PRESET, SPEC_BIG = "llama3-1b", "llama3-8b"
#: the legacy generator's run (scripts/validate_tpu.py's mechanism check)
SPEC_PROMPT, SPEC_NEW, SPEC_K = 128, 128, 4
SPEC_MAX_SEQ, SPEC_SLOTS, SPEC_SLOT_NEW = 2048, 8, 32
SPEC_LENGTHS = SERVE_LENGTHS   # the serve phase's burst


def _spec_model(dev, preset: str, seed: int = 0):
    """(cfg, params) of a preset: random bf16 weights from a seed, fused
    as the server fuses them."""
    from tpu_docker_api_torch.infer.quantize import fuse_llama_projections
    from tpu_docker_api_torch.models.llama import llama_init, llama_presets

    cfg = llama_presets()[preset]
    params = llama_init(cfg, torch.Generator(device=dev).manual_seed(seed))
    return cfg, fuse_llama_projections(params)


@torch.no_grad()
def _teacher_logits(dev, cfg, params, prompt: list, out: list):
    """The target's f32 logits at the positions that emitted ``out``, from
    ONE whole-prompt (flash) prefill of prompt + output."""
    from tpu_docker_api_torch.models.llama import llama_forward_cached

    seq = torch.tensor([prompt + out], device=dev)
    n = seq.shape[1]
    kc = torch.zeros((cfg.n_layers, 1, n, cfg.n_kv_heads, cfg.head_dim),
                     dtype=cfg.dtype, device=dev)
    logits, _, _ = llama_forward_cached(params, seq, cfg, kc,
                                        torch.zeros_like(kc), 0)
    return logits[0, len(prompt) - 1:n - 1]


@torch.no_grad()
def _decode_route_logits(dev, cfg, params, prompt: list, out: list,
                         k: int):
    """The target's teacher-forced logits of ``out[1:]`` through the two
    decode routes, after one flash prefill of ``prompt``: one-token steps
    and (k+1)-token verify blocks. Returns (one, verify)."""
    from tpu_docker_api_torch.infer.engine import (init_kv_cache,
                                                   prefill_and_first_token)
    from tpu_docker_api_torch.models.llama import llama_forward_cached

    P, T = len(prompt), len(out)
    toks = torch.tensor(out, device=dev)

    def prefilled():
        cache = init_kv_cache(cfg, 1, P + T + k + 1, dtype=cfg.dtype,
                              device=dev)
        prefill_and_first_token(params, torch.tensor([prompt], device=dev),
                                cfg, cache)
        return cache.k, cache.v

    kc, vc = prefilled()
    one = []
    for t in range(T - 1):
        lg, kc, vc = llama_forward_cached(params, toks[t].view(1, 1), cfg,
                                          kc, vc, P + t)
        one.append(lg[0, -1])
    kc, vc = prefilled()
    blocks = []
    for j in range(0, T - 1, k + 1):
        lg, kc, vc = llama_forward_cached(params, toks[j:j + k + 1][None],
                                          cfg, kc, vc, P + j)
        blocks.append(lg[0])
    return torch.stack(one), torch.cat(blocks)[:T - 1]


def _near_argmax(dev, cfg, params, prompts: list, outs: list,
                 k: int) -> dict:
    """Every emitted token a near-argmax of the target's teacher-forced
    logits (one flash prefill of prompt + output). ε is the largest
    |logit| difference between routes on the same positions: the verify
    route against the one-token route, and the one-token route against
    the flash prefill. A token that is the argmax of a route lies within
    2ε of the flash logits' maximum (each of the two logits moves by at
    most ε), so that is the hard check. Reports both differences, the
    largest gap and the positions off the flash argmax."""
    gaps, eps_vo, eps_fo = [], 0.0, 0.0
    for p, o in zip(prompts, outs):
        lg = _teacher_logits(dev, cfg, params, p, o)
        emitted = torch.tensor(o, device=dev)
        gaps.append((lg.max(-1).values
                     - lg.gather(1, emitted[:, None])[:, 0]).cpu())
        one, verify = _decode_route_logits(dev, cfg, params, p, o, k)
        eps_vo = max(eps_vo, (verify - one).abs().max().item())
        eps_fo = max(eps_fo, (lg[1:] - one).abs().max().item())
    gaps = torch.cat(gaps)
    eps = max(eps_vo, eps_fo)
    res = {"positions": gaps.numel(), "max_gap": gaps.max().item(),
           "off_argmax": int((gaps > 0).sum()),
           "eps_verify_vs_one_token": eps_vo,
           "eps_flash_vs_one_token": eps_fo, "eps": eps, "bound": 2 * eps}
    if not res["max_gap"] <= 2 * eps:
        raise AssertionError(f"an emitted token is {res['max_gap']} below "
                             f"the target's argmax (2 eps {2 * eps}): {res}")
    return res


def _differing(a: list, b: list) -> int:
    """Positions where two token streams differ."""
    return sum(x != y for ra, rb in zip(a, b) for x, y in zip(ra, rb))


def _spec_legacy(dev, cfg, params) -> dict:
    """The batch-1 speculative generator, the target its own draft,
    against plain greedy decoding: rounds, accepted, ms, ε and the
    near-argmax check."""
    from tpu_docker_api_torch.infer.engine import (GenerateConfig,
                                                   make_generate_fn)
    from tpu_docker_api_torch.infer.speculative import (
        SpeculativeConfig, make_speculative_generate_fn)
    from tpu_docker_api_torch.ops import flash

    g = torch.Generator().manual_seed(3)
    prompt = torch.randint(0, cfg.vocab_size, (1, SPEC_PROMPT),
                           generator=g).to(dev)
    plain = make_generate_fn(cfg, GenerateConfig(
        max_new_tokens=SPEC_NEW, max_seq=SPEC_MAX_SEQ, cache_dtype=cfg.dtype))
    spec = make_speculative_generate_fn(cfg, cfg, SpeculativeConfig(
        max_new_tokens=SPEC_NEW, n_speculative=SPEC_K, max_seq=SPEC_MAX_SEQ))

    def timed(fn):
        fn()  # first-call costs
        _sync(dev)
        t0 = time.perf_counter()
        out = fn()
        _sync(dev)
        return out, (time.perf_counter() - t0) * 1e3

    ref, plain_ms = timed(lambda: plain(params, prompt))
    flash.reset_launch_count()
    out, spec_ms = timed(lambda: spec(params, params, prompt))
    launches = flash.launch_count["flash_fwd"]
    if out["rounds"] >= SPEC_NEW // 2:
        raise AssertionError(f"self-draft took {out['rounds']} rounds for "
                             f"{SPEC_NEW} tokens")
    toks, ref_toks = out["tokens"][0].tolist(), ref["tokens"][0].tolist()
    p = prompt[0].tolist()
    return {"prompt_len": SPEC_PROMPT, "new_tokens": SPEC_NEW,
            "k": SPEC_K, "rounds": out["rounds"],
            "accepted": out["accepted"], "plain_ms": plain_ms,
            "spec_ms": spec_ms, "flash_launches": launches,
            "differing_from_plain": _differing([toks], [ref_toks]),
            "near_argmax": _near_argmax(dev, cfg, params, [p], [toks],
                                        SPEC_K)}


def _spec_burst(dev, cfg, params, prompts: list, draft=None) -> dict:
    """The burst through a SpeculativeSlotEngine (``draft`` = (cfg,
    params)) or a plain SlotEngine: engine latency, counters, streams and
    the flash launches of the burst (zeroed after the warmup)."""
    from tpu_docker_api_torch.infer.slots import (SlotEngine,
                                                  SpeculativeSlotEngine)
    from tpu_docker_api_torch.ops import flash

    kw = dict(slots=SPEC_SLOTS, max_seq=SPEC_MAX_SEQ, cache_dtype=cfg.dtype)
    eng = (SpeculativeSlotEngine(cfg, params, draft_cfg=draft[0],
                                 draft_params=draft[1], n_spec=SPEC_K, **kw)
           if draft else SlotEngine(cfg, params, chunk=8, **kw))
    eng.warmup(rows=(1, 2))
    eng.start()
    try:
        flash.reset_launch_count()
        t0 = time.perf_counter()
        hs = [eng.submit(p, SPEC_SLOT_NEW) for p in prompts]
        outs = [h.result(600)["tokens"] for h in hs]
        wall = time.perf_counter() - t0
        launches = flash.launch_count["flash_fwd"]
        lat, stats = eng.latency_stats(), dict(eng.stats)
    finally:
        eng.close()
    if [len(o) for o in outs] != [SPEC_SLOT_NEW] * len(prompts):
        raise AssertionError(f"incomplete streams: {[len(o) for o in outs]}")
    return {"outs": outs, "wall_s": wall, "ttft_p50_ms": lat["ttft_p50_ms"],
            "itl_p50_ms": lat["itl_p50_ms"],
            "decode_chunks": stats["decode_chunks"],
            "accepted_tokens": stats["accepted_tokens"],
            "prefills": stats["prefills"], "flash_launches": launches}


def _spec_pair(dev, cfg, params, prompts: list, draft) -> dict:
    """The burst through the speculative engine and a plain one; the
    speculative streams near the target's teacher-forced argmax."""
    spec = _spec_burst(dev, cfg, params, prompts, draft)
    plain = _spec_burst(dev, cfg, params, prompts)
    res = {"speculative": spec, "plain": plain,
           "differing_from_plain": _differing(spec["outs"], plain["outs"]),
           "near_argmax": _near_argmax(dev, cfg, params, prompts,
                                       spec["outs"], SPEC_K)}
    for r in (spec, plain):
        del r["outs"]
    return res


def phase_speculative(dev) -> dict:
    """Speculative decoding through the port's entry points (module
    docstring, phase 5c)."""
    phase_t0 = time.perf_counter()
    g = torch.Generator().manual_seed(4)
    res: dict = {"phase": "speculative", "preset": SPEC_PRESET,
                 "big": SPEC_BIG}
    launches: dict = {}

    # ---- self-draft at llama3-1b: the batch-1 generator, then the engine
    cfg, params = _spec_model(dev, SPEC_PRESET)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=g).tolist()
               for n in SPEC_LENGTHS]
    res["legacy_self_draft"] = _spec_legacy(dev, cfg, params)
    launches["legacy"] = res["legacy_self_draft"]["flash_launches"]
    self_res = _spec_pair(dev, cfg, params, prompts, (cfg, params))
    res["slots_self_draft"] = self_res
    launches["slots_self_draft"] = self_res["speculative"]["flash_launches"]
    generated = SPEC_SLOT_NEW * len(prompts)
    accepted = self_res["speculative"]["accepted_tokens"]
    if accepted < 0.5 * (generated - len(prompts)):
        raise AssertionError(f"self-draft accepted {accepted} of "
                             f"{generated - len(prompts)} proposals")
    del params
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)

    # ---- a llama3-8b target with a llama3-1b draft, both random
    bcfg, bparams = _spec_model(dev, SPEC_BIG)
    dcfg, dparams = _spec_model(dev, SPEC_PRESET, seed=1)
    pair = _spec_pair(dev, bcfg, bparams, prompts, (dcfg, dparams))
    pair["max_memory_allocated"] = (torch.cuda.max_memory_allocated(dev)
                                    if dev.type == "cuda" else None)
    want = (bcfg.n_layers + dcfg.n_layers) * pair["speculative"]["prefills"]
    if pair["speculative"]["flash_launches"] != want:
        raise AssertionError(f"flash_fwd launched "
                             f"{pair['speculative']['flash_launches']} "
                             f"times for {want} prefill layers")
    res["slots_8b_1b"] = pair
    launches["slots_8b_1b"] = pair["speculative"]["flash_launches"]
    del bparams, dparams
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # ---- the CLI: --draft-preset llama3-1b --n-spec 4 (a self-draft)
    from tpu_docker_api_torch.ops import flash

    with _server(dev, ["--max-seq", str(SPEC_MAX_SEQ), "--draft-preset",
                       SPEC_PRESET, "--n-spec", str(SPEC_K)]) as (srv, port):
        health = _get(port, "/healthz")["slotEngine"]
        if not (health.get("speculative") is True
                and health.get("nSpec") == SPEC_K):
            raise AssertionError(f"/healthz: {health}")
        _burst(port, [[1, 2, 3]], 2, srv.cfg.vocab_size)
        flash.reset_launch_count()
        outs = _burst(port, prompts[:4], SPEC_SLOT_NEW, srv.cfg.vocab_size)
        launches["cli"] = flash.launch_count["flash_fwd"]
        completed = srv.engine.stats["completed"]
        _check_reply(*_post(port, {"tokens": [prompts[1]],
                                   "maxNewTokens": 8, "temperature": 0.8,
                                   "topK": 40}), 1, 8, srv.cfg.vocab_size)
        if srv.engine.stats["completed"] != completed:
            raise AssertionError("a sampled request reached the "
                                 "speculative engine")
        res["cli"] = {
            "health": {k: health[k] for k in ("speculative", "nSpec",
                                              "chunk", "slots")},
            "accepted_tokens": srv.engine.stats["accepted_tokens"],
            "near_argmax": _near_argmax(dev, srv.cfg, srv.params,
                                        prompts[:4], outs, SPEC_K)}
    for path, n in launches.items():
        if n <= 0:
            raise AssertionError(f"flash_fwd never launched on {path}")
    res.update({"flash_launches_by_run": launches,
                "flash_launches": sum(launches.values()),
                "phase_s": time.perf_counter() - phase_t0,
                "card": nvidia_smi() if dev.type == "cuda" else "cpu"})
    emit(res)
    return res


#: the servebench phase's runs, at the JAX functions' defaults
SERVEBENCH = [
    ("bench_concurrent_serving", {"preset": "llama3-1b", "streams": 8,
                                  "prompt_len": 128, "new_tok": 64}),
    ("bench_decode_roofline", {"preset": "llama3-8b", "batch": 64}),
    ("bench_int8_serving", {"preset": "llama3-8b", "batch": 64, "reps": 2}),
    ("bench_tail_latency", {"preset": "llama3-1b"}),
    ("bench_moe_serving", {"preset": "bench-moe"}),
]


def phase_servebench(dev) -> dict:
    """The port's serving benchmarks (module docstring, phase 5d): each
    result on a line of its own, each ``ok``; flash_fwd launches of the
    whole phase (its slot-engine and generate prefills)."""
    from tpu_docker_api_torch.infer import servebench
    from tpu_docker_api_torch.infer.quantize import bench_int8_serving
    from tpu_docker_api_torch.ops import flash

    phase_t0 = time.perf_counter()
    seconds = {}
    flash.reset_launch_count()
    for name, kw in SERVEBENCH:
        fn = (bench_int8_serving if name == "bench_int8_serving"
              else getattr(servebench, name))
        t0 = time.perf_counter()
        out = fn(device=dev, **kw)
        seconds[name] = time.perf_counter() - t0
        emit({"phase": "servebench", "bench": name, "args": kw,
              "seconds": seconds[name], **out})
        # bench_moe_serving's result has no "ok" (as in JAX): its decode
        # rate must be a positive number
        ok = (out["ok"] is True if "ok" in out
              else math.isfinite(out["decode_tok_s"])
              and out["decode_tok_s"] > 0)
        if not ok:
            raise AssertionError(f"{name} not ok: {out}")
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    launches = flash.launch_count["flash_fwd"]
    if launches <= 0:
        raise AssertionError("flash_fwd never launched in servebench")
    res = {"phase": "servebench_summary", "seconds": seconds,
           "flash_launches": launches,
           "phase_s": time.perf_counter() - phase_t0,
           "card": nvidia_smi() if dev.type == "cuda" else "cpu"}
    emit(res)
    return res


# ------------------------------------------------------------------ moe

#: the moe phase: Mixtral-8x7B at its published width, depth cut to fit
#: one 80 GB card (16 layers: 47.0 GB of bf16 weights serving; 4 layers
#: training under adamw-int8), and bench-moe at its full depth through
#: the trainer CLI and the server. A CPU rehearsal patches these to
#: moe-tiny and small shapes.
MOE_PRESET = "mixtral-8x7b"
MOE_SERVE_LAYERS = 16
MOE_SERVE_MAX_SEQ = 2048
MOE_TRAIN_LAYERS = 4
MOE_TRAIN_BATCH, MOE_TRAIN_SEQ = 2, 2048
MOE_CLI_PRESET = "moe:bench-moe"
MOE_CLI_BATCH, MOE_CLI_SEQ = 4, 2048
#: relative L2 of first-token logits and of one block's gradients through
#: the kernels against the plain path, with the expert picks of the
#: kernel route replayed in the plain one (bf16 through 16 layers, as
#: the serve phase's bound). Free-running, a near-tie of two experts'
#: probabilities may pick another expert on either route: that share is
#: reported, not bounded.
MOE_TOL = 2e-2
#: gather and einsum dispatch: the same products in other orders (bf16)
MOE_DISPATCH_LOSS_TOL = 1e-3


def _pick_share_differing(a: list, b: list) -> float:
    """Share of (token, choice) expert picks that differ between two
    routes' tapes."""
    diff = sum(int((x != y).sum()) for x, y in zip(a, b))
    return diff / max(1, sum(x.numel() for x in a))


def _moe_first_logits(dev, cfg, params, prompt: list) -> dict:
    """First-token logits of ``prompt`` padded to its serving bucket
    through the kernel route (a cache the bucket's length: the flash
    prefill) against the plain route (one slot longer: dense attention),
    free and with the kernel route's expert picks replayed."""
    from tpu_docker_api_torch.infer.slots import _default_buckets
    from tpu_docker_api_torch.models.moe import RouteTape, moe_forward_cached

    n = len(prompt)
    bucket = min(b for b in _default_buckets(MOE_SERVE_MAX_SEQ) if b >= n)
    padded = torch.zeros((1, bucket), dtype=torch.long, device=dev)
    padded[0, :n] = torch.tensor(prompt, device=dev)

    def logits(cap):
        shape = (cfg.n_layers, 1, cap, cfg.n_kv_heads, cfg.head_dim)
        kc = torch.zeros(shape, dtype=cfg.dtype, device=dev)
        with torch.no_grad():
            out, _, _ = moe_forward_cached(params, padded, cfg, kc,
                                           torch.zeros_like(kc), 0,
                                           last_only=n - 1)
        return out[0, 0].float()

    tape = RouteTape()
    with tape.record():
        kernel = logits(bucket)
    kernel_picks = tape.picks
    with tape.record():
        free = logits(bucket + 1)
    free_picks = tape.picks
    if not len(kernel_picks) == len(free_picks) == cfg.n_layers:
        raise AssertionError(f"routing calls: kernel route "
                             f"{len(kernel_picks)}, plain {len(free_picks)}, "
                             f"{cfg.n_layers} layers")
    with tape.replay(kernel_picks):
        pinned = logits(bucket + 1)
    if not (torch.isfinite(kernel).all() and kernel.shape
            == (cfg.vocab_size,)):
        raise AssertionError("moe kernel-route logits not finite")
    rel = _rel_l2(kernel, pinned)
    if rel > MOE_TOL:
        raise AssertionError(f"moe first-token logits differ: {rel}")
    return {"logits_prompt_len": n, "logits_bucket": bucket,
            "logits_rel_l2_pinned": rel, "logits_tol": MOE_TOL,
            "logits_rel_l2_free": _rel_l2(kernel, free),
            "argmax_equal_free": bool(kernel.argmax() == free.argmax()),
            "pick_share_differing_free": _pick_share_differing(
                kernel_picks, free_picks)}


def _moe_serve(dev) -> dict:
    """The SlotEngine in process at ``MOE_PRESET``'s width and
    ``MOE_SERVE_LAYERS`` layers: the serve phase's burst, flash launches
    per prefill group, peak memory, one decode step, route logits."""
    from tpu_docker_api_torch.infer.slots import SlotEngine
    from tpu_docker_api_torch.models.llama import param_count
    from tpu_docker_api_torch.models.moe import moe_init, moe_presets
    from tpu_docker_api_torch.ops import flash

    cfg = dataclasses.replace(moe_presets()[MOE_PRESET],
                              n_layers=MOE_SERVE_LAYERS)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = moe_init(cfg, torch.Generator(device=dev).manual_seed(0))
    _sync(dev)
    init_s = time.perf_counter() - t0
    init_peak = (torch.cuda.max_memory_allocated(dev)
                 if dev.type == "cuda" else None)
    weight_bytes = sum(t.numel() * t.element_size() for t in
                       _tensors(params).values())
    eng = SlotEngine(cfg, params, slots=8, max_seq=MOE_SERVE_MAX_SEQ,
                     chunk=8, cache_dtype=cfg.dtype, max_pending=64,
                     seed=0)
    eng.start()
    try:
        # one short request first: cuBLAS handles, allocator pools
        eng.submit([1, 2, 3], 2).result(600)
        g = torch.Generator().manual_seed(0)
        prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=g)
                   .tolist() for n in SERVE_LENGTHS]
        max_new = 32

        # ---- the main path: counts zeroed just before, read just after
        eng.reset_latency_stats()
        prefills0 = eng.stats["prefills"]
        flash.reset_launch_count()
        t0 = time.perf_counter()
        handles = [eng.submit(p, max_new) for p in prompts]
        outs = [h.result(600)["tokens"] for h in handles]
        wall = time.perf_counter() - t0
        launches = flash.launch_count["flash_fwd"]
        prefills = eng.stats["prefills"] - prefills0
        # ---- end of the main path

        latency = eng.latency_stats()
    finally:
        eng.close()
    if any(len(o) != max_new or not all(0 <= t < cfg.vocab_size
                                        for t in o) for o in outs):
        raise AssertionError(f"malformed moe tokens: {outs}")
    if launches != cfg.n_layers * prefills or prefills == 0:
        raise AssertionError(f"{launches} flash launches for {prefills} "
                             f"prefill groups of {cfg.n_layers} layers")
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)
    del eng
    gc.collect()
    step = (_decode_step_profile(dev, cfg, params) if dev.type == "cuda"
            else {})
    # a decode step reads every weight but the embedding, of which it
    # reads one row a decode row (8)
    embed = params["embed"]["tokens"]
    step_bytes = (weight_bytes - embed.numel() * embed.element_size()
                  + 8 * embed.shape[1] * embed.element_size())
    bound_ms = step_bytes / PEAK_BYTES * 1e3
    # the burst's longest prompt, in its 2048 bucket
    logits = _moe_first_logits(dev, cfg, params, prompts[-1])
    return {"preset": MOE_PRESET, "layers": cfg.n_layers,
            "params": param_count(params), "weight_bytes": weight_bytes,
            "init_s": init_s, "init_peak_memory": init_peak,
            "slots": 8, "max_seq": MOE_SERVE_MAX_SEQ,
            "prompt_lengths": SERVE_LENGTHS, "max_new_tokens": max_new,
            "wall_s": wall, "ttft_p50_ms": latency["ttft_p50_ms"],
            "itl_p50_ms": latency["itl_p50_ms"],
            "decode_tok_s": len(prompts) * max_new / wall,
            "prefill_groups": prefills, "flash_launches": launches,
            "max_memory_allocated": peak, "decode_step": step,
            "decode_step_bytes": step_bytes,
            "decode_step_weight_bound_ms": bound_ms, **logits}


def _moe_block_grads(dev, cfg) -> dict:
    """Gradients of wq, router and w_gate of ONE block (the loss through
    the lm_head) through the flash kernels against the dense plain path,
    the kernel run's expert picks replayed in the plain one; and the
    share of picks a free plain run makes otherwise."""
    from tpu_docker_api_torch.models.moe import RouteTape, moe_init, moe_loss

    cfg1 = dataclasses.replace(cfg, n_layers=1, remat=False)
    params = moe_init(cfg1, torch.Generator(device=dev).manual_seed(3))
    # the training shape: flash fwd, dq and dk/dv at (2, 32/8, 2048, 128)
    tokens = torch.randint(0, cfg.vocab_size,
                           (MOE_TRAIN_BATCH, MOE_TRAIN_SEQ + 1), device=dev,
                           generator=torch.Generator(device=dev)
                           .manual_seed(4))

    def grads(impl):
        live = {**params, "layers": {
            **params["layers"],
            "attn": {n: w.detach().requires_grad_()
                     for n, w in params["layers"]["attn"].items()},
            "moe": {n: w.detach().requires_grad_()
                    for n, w in params["layers"]["moe"].items()}}}
        moe_loss(live, tokens,
                 dataclasses.replace(cfg1, attention_impl=impl)).backward()
        return {"wq": live["layers"]["attn"]["wq"].grad.float(),
                "router": live["layers"]["moe"]["router"].grad.float(),
                "w_gate": live["layers"]["moe"]["w_gate"].grad.float()}

    tape = RouteTape()
    with tape.record():
        kernel = grads("flash")
    kernel_picks = tape.picks
    if len(kernel_picks) != 1:
        raise AssertionError(f"{len(kernel_picks)} routing calls in one "
                             f"block without remat")
    with tape.replay(kernel_picks):
        dense = grads("dense")
    free_share = _pick_share_differing(kernel_picks, tape.picks)
    rel = {n: _rel_l2(kernel[n], dense[n]) for n in kernel}
    if max(rel.values()) > MOE_TOL:
        raise AssertionError(f"moe flash vs dense block gradients: {rel}")
    return {"block_grad_tokens": list(tokens.shape),
            "block_grad_rel_l2": rel, "block_grad_tol": MOE_TOL,
            "pick_share_differing_free": free_share}


def _moe_train(dev) -> dict:
    """``MOE_TRAIN_LAYERS`` layers at ``MOE_PRESET``'s width under
    adamw-int8 on one repeated batch: losses, launches a step, step ms,
    MFU over the active parameters, peak memory."""
    from tpu_docker_api_torch.models import param_shapes
    from tpu_docker_api_torch.models.llama import param_count
    from tpu_docker_api_torch.models.moe import moe_presets
    from tpu_docker_api_torch.ops import flash
    from tpu_docker_api_torch.train import optim
    from tpu_docker_api_torch.train.trainer import (create_train_state,
                                                    make_train_step,
                                                    synthetic_batch)

    cfg = dataclasses.replace(moe_presets()[MOE_PRESET],
                              n_layers=MOE_TRAIN_LAYERS,
                              max_seq_len=MOE_TRAIN_SEQ)
    tokens = synthetic_batch(torch.Generator(device=dev).manual_seed(1),
                             MOE_TRAIN_BATCH, MOE_TRAIN_SEQ, cfg.vocab_size)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    state, opt = create_train_state(
        cfg, dev, torch.Generator(device=dev).manual_seed(0),
        optimizer=optim.adamw_int8())
    step_fn = make_train_step(cfg, opt)
    _sync(dev)
    losses, step_ms = [], []

    # ---- the main path: counts zeroed just before, read just after
    flash.reset_launch_count()
    optim.reset_launch_count()
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, metrics = step_fn(state, tokens)
        _sync(dev)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(metrics["loss"].item())
    launches = {**flash.launch_count, **optim.launch_count}
    # ---- end of the main path

    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)
    n_params = param_count(state.params)
    n_leaves = len(_tensors(param_shapes(cfg)))
    del state, metrics, opt, step_fn
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ln_vocab = math.log(cfg.vocab_size)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"moe: non-finite loss {losses}")
    if abs(losses[0] - ln_vocab) > 1.0:
        raise AssertionError(f"moe: first loss {losses[0]} not within 1.0 "
                             f"of ln(vocab) {ln_vocab}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"moe: loss did not fall: {losses}")
    want = {"flash_fwd": cfg.n_layers * TRAIN_STEPS,
            "flash_bwd_dq": cfg.n_layers * TRAIN_STEPS,
            "flash_bwd_dkv": cfg.n_layers * TRAIN_STEPS,
            "adam8": n_leaves * TRAIN_STEPS}
    if launches != want:
        raise AssertionError(f"moe train launches {launches}, expected "
                             f"{want}")
    steady = sorted(step_ms[1:])[len(step_ms[1:]) // 2]
    tok_s = MOE_TRAIN_BATCH * MOE_TRAIN_SEQ / (steady / 1e3)
    grads = _moe_block_grads(dev, cfg)
    return {"preset": MOE_PRESET, "layers": cfg.n_layers,
            "params": n_params, "batch": MOE_TRAIN_BATCH,
            "seq": MOE_TRAIN_SEQ, "optim": "adamw-int8",
            "capacity": cfg.capacity(MOE_TRAIN_BATCH * MOE_TRAIN_SEQ),
            "losses": losses, "step_ms": step_ms,
            "step_ms_median_after_first": steady, "tokens_per_sec": tok_s,
            "mfu": cfg.flops_per_token(MOE_TRAIN_SEQ) * tok_s
            / PEAK_FLOPS[torch.bfloat16],
            "launches": launches, "leaves": n_leaves,
            "max_memory_allocated": peak, **grads}


def _moe_cli(dev) -> dict:
    """The trainer CLI on ``MOE_CLI_PRESET`` at its full depth under
    ``--moe-dispatch gather`` (with ``--profile-dir``) and ``einsum``:
    equal first losses; then the server on it: a burst, a streamed
    request and /healthz."""
    from tpu_docker_api_torch.models import resolve_preset
    from tpu_docker_api_torch.ops import flash
    from tpu_docker_api_torch.train import optim
    from tpu_docker_api_torch.train.__main__ import main as train_main

    base = ["--preset", MOE_CLI_PRESET, "--device", str(dev), "--batch",
            str(MOE_CLI_BATCH), "--seq", str(MOE_CLI_SEQ), "--optim",
            "adamw-int8", "--log-every", "1"]
    runs, launches = {}, {}
    for dispatch, extra in (("gather", ["--steps", "3", "--profile-dir",
                                        "build/moe_profile",
                                        "--profile-steps", "1"]),
                            ("einsum", ["--steps", "2"])):
        # ---- the main path: counts zeroed just before, read just after
        flash.reset_launch_count()
        optim.reset_launch_count()
        lines = _run_cli(train_main, [*base, "--moe-dispatch", dispatch,
                                      *extra])
        counts = {**flash.launch_count, **optim.launch_count}
        # ---- end of the main path
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
        if lines[-1].get("event") != "done":
            raise AssertionError(f"moe trainer CLI failed: {lines[-3:]}")
        runs[dispatch] = {
            "steps": [ln for ln in lines if "loss" in ln],
            "profile": next((ln for ln in lines
                             if ln.get("event") == "profile_written"),
                            None)}
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    first = {d: r["steps"][0]["loss"] for d, r in runs.items()}
    if abs(first["gather"] - first["einsum"]) > MOE_DISPATCH_LOSS_TOL:
        raise AssertionError(f"gather and einsum first losses: {first}")
    if runs["gather"]["profile"] is None:
        raise AssertionError("moe trainer CLI wrote no profile")

    vocab = resolve_preset(MOE_CLI_PRESET)[1].vocab_size
    g = torch.Generator().manual_seed(5)
    prompts = [torch.randint(0, vocab, (n,), generator=g).tolist()
               for n in SERVE_LENGTHS]
    with _server(dev, ["--preset", MOE_CLI_PRESET, "--max-seq",
                       str(MOE_SERVE_MAX_SEQ)]) as (srv, port):
        _burst(port, [[1, 2, 3]], 2, vocab)  # warm
        # ---- the main path: counts zeroed just before, read just after
        flash.reset_launch_count()
        t0 = time.perf_counter()
        burst = _burst(port, prompts, 32, vocab)
        burst_s = time.perf_counter() - t0
        streamed, times, t_send = _stream_times(port, prompts[2], 16)
        health = _get(port, "/healthz")
        launches["flash_fwd"] += flash.launch_count["flash_fwd"]
        # ---- end of the main path
        if health.get("status") != "ok" or health["model"] != MOE_CLI_PRESET:
            raise AssertionError(f"moe server /healthz: {health}")
        if "w_qkv" in srv.params["layers"]["attn"]:
            raise AssertionError("a moe tree was fused")
    return {"cli": {d: {"first_loss": first[d],
                        "losses": [s["loss"] for s in r["steps"]],
                        "tokens_per_sec": [s["tokens_per_sec"]
                                           for s in r["steps"]]}
                    for d, r in runs.items()},
            "dispatch_first_loss_diff": abs(first["gather"]
                                            - first["einsum"]),
            "dispatch_loss_tol": MOE_DISPATCH_LOSS_TOL,
            "profile": runs["gather"]["profile"],
            "server": {"burst_s": burst_s, "rows": len(burst),
                       "stream_ttft_ms": (times[0] - t_send) * 1e3,
                       "stream_tokens": len(streamed),
                       "healthz_slot_engine": health.get("slotEngine")},
            "launches": launches}


def phase_moe(dev) -> dict:
    """The Mixtral-style MoE family (module docstring, phase 9): serving
    and training at Mixtral width in process, bench-moe through the
    trainer CLI and the server. Launch counts of every kernel over the
    phase's main paths."""
    phase_t0 = time.perf_counter()
    seconds = {}
    t0 = time.perf_counter()
    serve = _moe_serve(dev)
    seconds["serve"] = time.perf_counter() - t0
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    train = _moe_train(dev)
    seconds["train"] = time.perf_counter() - t0
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cli = _moe_cli(dev)
    seconds["cli_and_server"] = time.perf_counter() - t0
    launches = {k: train["launches"].get(k, 0) + cli["launches"].get(k, 0)
                for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                          "adam8")}
    launches["flash_fwd"] += serve["flash_launches"]
    res = {"phase": "moe", "serve": serve, "train": train, "cli": cli,
           "launches": launches, "seconds": seconds,
           "phase_s": time.perf_counter() - phase_t0,
           "card": nvidia_smi() if dev.type == "cuda" else "cpu"}
    emit(res)
    return res


# ------------------------------------------------------------ vit, encdec

#: the vit phase: vit-b16 at its published width and depth (dim 768, 12
#: layers, 12/12 heads, ffn 3072, 256 patches) at the JAX harness's batch
#: of 128 (scripts/validate_tpu.py), in process and through the trainer
#: CLI. A CPU rehearsal patches these to the tiny presets and small
#: shapes.
VIT_PRESET = "vit-b16"
VIT_BATCH = 128
VIT_TIMED_STEPS = 8
#: the encdec phase: encdec-base at its published width and full depth
#: (dim 768, 12 + 12 layers, 12/12 heads, ffn 3072, vocab 32000), trained
#: at the JAX harness's batch 32 x (512, 512); served on a burst of 8
#: sources of 17-500 tokens, 32 new tokens each
ENCDEC_PRESET = "encdec-base"
ENCDEC_BATCH, ENCDEC_SEQ = 32, 512
ENCDEC_TIMED_STEPS = 6
ENCDEC_SERVE_LENGTHS = [17, 40, 100, 180, 250, 333, 420, 500]
ENCDEC_MAX_NEW = 32
#: the JAX defaults (8 streams, 16 requests, 128-token sources, 96 new
#: tokens) but one timed repetition: the serialized baseline alone runs
#: 1,536 batch-1 decode steps a repetition
ENCDEC_BENCH = {"preset": "encdec-base", "reps": 1}
#: the attention rule's shapes: (name, batch, seq, heads, head_dim)
ATTN_RULE_SHAPES = [("vit-b16", 128, 256, 12, 64),
                    ("encdec-base encoder", 32, 512, 12, 64)]
FAMILY_TOL = 2e-2   # relative L2, bf16: block gradients, first logits
MLP_TOL = 1e-5      # f32, card against CPU, of the largest |value|


@contextlib.contextmanager
def _force_attention(impl: str):
    """``multihead_attention``'s ``auto`` choice forced to ``impl`` (the
    attention rule's measurement and the dense side of a comparison)."""
    from tpu_docker_api_torch.ops import attention

    auto = attention.auto_impl
    attention.auto_impl = lambda *a, **k: impl
    try:
        yield
    finally:
        attention.auto_impl = auto


def _reset_peak(dev) -> None:
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def _peak(dev):
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else None


def _free(dev) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _attention_rule(dev) -> list:
    """The short-encoder rule (ops/attention.py): flash (causal=False)
    against ``dense_attention`` (bf16 probabilities, as the models ask),
    forward and forward + backward, at vit-b16's and encdec-base's
    encoder shapes; the outputs agree within ``FAMILY_TOL``."""
    from tpu_docker_api_torch.ops.attention import (auto_impl,
                                                    multihead_attention)

    bf = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(7)
    rows = []
    for name, b, s, h, d in ATTN_RULE_SHAPES:
        q, k, v, do = (torch.randn(b, s, h, d, generator=g, device=dev)
                       .to(bf) for _ in range(4))
        leaves = [t.requires_grad_() for t in (q, k, v)]
        row = {"shape": name, "batch": b, "seq": s, "heads": h, "d": d,
               "auto": auto_impl(q.shape, k.shape, False,
                                 dev.type == "cuda", bf)}
        outs = {}
        for impl in ("flash", "dense"):
            def fwd(impl=impl):
                return multihead_attention(q, k, v, causal=False, impl=impl,
                                           probs_dtype=bf)

            def fwd_bwd(fwd=fwd):
                torch.autograd.grad(fwd(), leaves, do)

            with torch.no_grad():
                outs[impl] = fwd().float()
                row[f"{impl}_fwd_ms"] = cuda_ms(fwd, 10)
            row[f"{impl}_fwd_bwd_ms"] = cuda_ms(fwd_bwd, 10)
        row["out_rel_l2"] = _rel_l2(outs["flash"], outs["dense"])
        row["dense_over_flash_fwd_bwd"] = (row["dense_fwd_bwd_ms"]
                                           / row["flash_fwd_bwd_ms"])
        if row["out_rel_l2"] > FAMILY_TOL:
            raise AssertionError(f"flash vs dense attention: {row}")
        rows.append(row)
        del q, k, v, do, leaves, outs
        _free(dev)
    return rows


def _family_train_run(dev, cfg, batch, optim_name: str) -> dict:
    """TRAIN_STEPS steps through the trainer's entry points on one
    repeated batch; every launch count zeroed just before, read just
    after: losses, step ms, launches, peak memory."""
    from tpu_docker_api_torch.models.llama import param_count
    from tpu_docker_api_torch.ops import flash
    from tpu_docker_api_torch.train import optim
    from tpu_docker_api_torch.train.trainer import (create_train_state,
                                                    make_train_step)

    opt = optim.adamw_int8() if optim_name == "adamw-int8" else None
    _reset_peak(dev)
    state, opt = create_train_state(
        cfg, dev, torch.Generator(device=dev).manual_seed(0), optimizer=opt)
    step_fn = make_train_step(cfg, opt)
    _sync(dev)
    losses, step_ms = [], []

    # ---- the main path: counts zeroed just before, read just after
    flash.reset_launch_count()
    optim.reset_launch_count()
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        _sync(dev)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(metrics["loss"].item())
    launches = {**flash.launch_count, **optim.launch_count}
    # ---- end of the main path

    n_params = param_count(state.params)
    del state, metrics, step_fn
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{type(cfg).__name__}: non-finite loss "
                             f"{losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{type(cfg).__name__}: loss did not fall on "
                             f"the repeated batch: {losses}")
    return {"optim": optim_name, "params": n_params, "losses": losses,
            "step_ms": step_ms, "launches": launches,
            "max_memory_allocated": _peak(dev)}


def _timed_steps(dev, cfg, batch, optim_name: str, steps: int) -> dict:
    """``train/benchlib.py`` ``time_train_steps`` (two warm-up steps,
    then ``steps`` timed, closed by a host read of the loss) and the
    peak memory of the run."""
    from tpu_docker_api_torch.train import optim
    from tpu_docker_api_torch.train.benchlib import time_train_steps

    _free(dev)
    _reset_peak(dev)
    r = time_train_steps(cfg, batch, steps=steps, device=dev,
                         optimizer=(optim.adamw_int8()
                                    if optim_name == "adamw-int8" else None))
    if not math.isfinite(r["loss"]):
        raise AssertionError(f"time_train_steps: loss {r['loss']}")
    return {"optim": optim_name, **r, "max_memory_allocated": _peak(dev)}


def _attn_grads_rel_l2(dev, loss_fn, params, paths) -> dict:
    """Gradients of the leaves at ``paths`` (tuples of keys) of
    ``loss_fn(params)`` through the kernels (the ``auto`` choice) against
    the dense path."""
    grads = {}
    for impl in ("auto", "dense"):
        live = {}

        def swap(tree, path):
            if len(path) == 1:
                leaf = tree[path[0]].detach().requires_grad_()
                live[path] = leaf
                return {**tree, path[0]: leaf}
            return {**tree, path[0]: swap(tree[path[0]], path[1:])}

        p = params
        for path in paths:
            p = swap(p, path)
        ctx = (_force_attention("dense") if impl == "dense"
               else contextlib.nullcontext())
        with ctx:
            loss_fn(p).backward()
        grads[impl] = {"/".join(k): t.grad.float() for k, t in live.items()}
    return {n: _rel_l2(grads["auto"][n], grads["dense"][n])
            for n in grads["dense"]}


def _mlp_card_vs_cpu(dev) -> dict:
    """The MNIST MLP (BASELINE config #2): one loss and its gradients on
    the card against the CPU, f32, same weights and batch."""
    from tpu_docker_api_torch.models.mlp import mlp_init, mlp_loss

    params = mlp_init(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    x = torch.rand(256, 784, generator=g)
    labels = torch.randint(0, 10, (256,), generator=g)
    out = {}
    for where in ("cpu", dev):
        live = {k: {n: t.detach().to(where, copy=True).requires_grad_()
                    for n, t in v.items()} for k, v in params.items()}
        loss = mlp_loss(live, x.to(where), labels.to(where))
        loss.backward()
        out[str(where)] = (loss.detach().cpu(),
                           {f"{k}/{n}": t.grad.cpu()
                            for k, v in live.items() for n, t in v.items()})
    (l_cpu, g_cpu), (l_dev, g_dev) = out["cpu"], out[str(dev)]
    loss_err = abs(l_dev.item() - l_cpu.item()) / abs(l_cpu.item())
    grad_err = max(((g_dev[n] - g_cpu[n]).abs().max()
                    / g_cpu[n].abs().max()).item() for n in g_cpu)
    if loss_err > MLP_TOL or grad_err > MLP_TOL:
        raise AssertionError(f"mlp on the card vs the CPU: loss "
                             f"{loss_err}, gradients {grad_err}")
    return {"loss": l_cpu.item(), "loss_rel_err": loss_err,
            "grad_max_rel_err": grad_err, "tol": MLP_TOL}


def phase_vit(dev) -> dict:
    """The ViT family (module docstring, phase 10): the attention rule's
    timings, vit-b16 training through the trainer's entry points at
    batch 128 (a counted run under adamw-int8 on a repeated batch,
    ``time_train_steps`` under adamw and adamw-int8, and a whole step
    with each attention choice forced), one block's gradients through
    the kernels against the dense path, the trainer CLI, and the MLP."""
    from tpu_docker_api_torch.models import param_shapes
    from tpu_docker_api_torch.models.vit import (vit_init, vit_loss,
                                                 vit_presets,
                                                 vit_synthetic_batch)
    from tpu_docker_api_torch.ops import flash
    from tpu_docker_api_torch.train import optim
    from tpu_docker_api_torch.train.__main__ import main as train_main

    phase_t0 = time.perf_counter()
    seconds = {}
    t0 = time.perf_counter()
    rule = _attention_rule(dev)
    seconds["attention_rule"] = time.perf_counter() - t0
    cfg = vit_presets()[VIT_PRESET]
    batch = vit_synthetic_batch(1, VIT_BATCH, cfg, device=dev)
    n_leaves = len(_tensors(param_shapes(cfg)))

    t0 = time.perf_counter()
    run = _family_train_run(dev, cfg, batch, "adamw-int8")
    want = {"flash_fwd": cfg.n_layers * TRAIN_STEPS,
            "flash_bwd_dq": cfg.n_layers * TRAIN_STEPS,
            "flash_bwd_dkv": cfg.n_layers * TRAIN_STEPS,
            "adam8": n_leaves * TRAIN_STEPS}
    if run["launches"] != want:
        raise AssertionError(f"vit launches {run['launches']}, expected "
                             f"{want}")
    if abs(run["losses"][0] - math.log(cfg.n_classes)) > 1.0:
        raise AssertionError(f"vit: first loss {run['losses'][0]} not "
                             f"within 1.0 of ln(classes)")
    seconds["train"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    timed = []
    for optim_name in ("adamw", "adamw-int8"):
        r = _timed_steps(dev, cfg, batch, optim_name, VIT_TIMED_STEPS)
        ips = r["steps_per_sec"] * VIT_BATCH
        r.update({"images_per_sec": ips,
                  "mfu": cfg.flops_per_image() * ips
                  / PEAK_FLOPS[torch.bfloat16]})
        timed.append(r)
    with _force_attention("dense"):
        dense_step = _timed_steps(dev, cfg, batch, "adamw", VIT_TIMED_STEPS)
    dense_step["images_per_sec"] = dense_step["steps_per_sec"] * VIT_BATCH
    seconds["timed"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    cfg1 = dataclasses.replace(cfg, n_layers=1, remat=False)
    params1 = vit_init(cfg1, torch.Generator(device=dev).manual_seed(3))
    small = vit_synthetic_batch(2, 8, cfg1, device=dev)
    grads = _attn_grads_rel_l2(
        dev, lambda p: vit_loss(p, small, cfg1), params1,
        [("layers", "attn", n) for n in ("wq", "wk", "wv")])
    if max(grads.values()) > FAMILY_TOL:
        raise AssertionError(f"vit flash vs dense block gradients: {grads}")
    del params1
    _free(dev)
    seconds["block_grads"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    flash.reset_launch_count()
    optim.reset_launch_count()
    lines = _run_cli(train_main, [
        "--preset", f"vit:{VIT_PRESET}", "--device", str(dev), "--steps",
        "4", "--batch", str(VIT_BATCH), "--log-every", "1",
        "--profile-dir", "build/vit_profile", "--profile-steps", "2"])
    cli_launches = {**flash.launch_count, **optim.launch_count}
    _check_cli(lines, "vit")
    seconds["cli"] = time.perf_counter() - t0
    mlp = _mlp_card_vs_cpu(dev)
    launches = {k: run["launches"][k] + cli_launches.get(k, 0)
                for k in run["launches"]}
    res = {"phase": "vit", "preset": VIT_PRESET, "params": run["params"],
           "batch": VIT_BATCH, "patches": cfg.n_patches,
           "attention_rule": rule, "train": run, "timed": timed,
           "dense_attention_step": dense_step,
           "flash_over_dense_images_per_sec": (
               timed[0]["images_per_sec"] / dense_step["images_per_sec"]),
           "block_grad_rel_l2": grads, "block_grad_tol": FAMILY_TOL,
           "cli": {"lines": lines, "launches": cli_launches},
           "mlp": mlp, "launches": launches, "seconds": seconds,
           "phase_s": time.perf_counter() - phase_t0,
           "card": nvidia_smi() if dev.type == "cuda" else "cpu"}
    emit(res)
    return res


def _check_cli(lines: list, family: str) -> None:
    """A trainer CLI run ended with "done", finite losses and one
    profile summary."""
    if (lines[-1].get("event") != "done"
            or not all(math.isfinite(ln["loss"]) for ln in lines
                       if "loss" in ln)
            or len([ln for ln in lines
                    if ln.get("event") == "profile_written"]) != 1):
        raise AssertionError(f"{family} trainer CLI failed: {lines[-3:]}")


def _post_src(port: int, body: dict) -> dict:
    code, data = _post(port, body)
    if code != 200:
        raise AssertionError(f"/generate answered {code}: {data[:300]!r}")
    return json.loads(data)


def _encdec_first_logits(dev, srv, port: int, src: list) -> dict:
    """First-step logits of ``src`` from the server's own slot engine
    (one srcTokens request on a slot the burst used: the masked encode
    at the source's bucket, the cross K/V cast into the pooled buffers
    over the slot's stale rows, the chunk's source read bucket, the
    decode step; its sampler wrapped to keep the logits of the chunk's
    first step) against ``encdec_generate``'s (the unpadded encode,
    whose attention the ``auto`` choice picks, and its own decoder
    cache; its sampler wrapped the same way)."""
    from tpu_docker_api_torch.infer import sampling
    from tpu_docker_api_torch.models.encdec import encdec_generate

    eng, cfg = srv.engine, srv.cfg
    out = {"slot": [], "generate": []}

    def keep_slot(logits, *rest):
        # on the engine's thread: a slot armed and not yet dispatched is
        # the request's, at its first decode step
        for i, st in eng._decoding().items():
            if st.dispatched == 0:
                out["slot"].append(logits[i].float().clone())
        return type(eng)._sample(logits, *rest)

    eng._sample = keep_slot
    try:
        _post_src(port, {"srcTokens": [src], "maxNewTokens": 1})
    finally:
        del eng._sample
    make = sampling.make_sampler

    def make_keeping(*args, **kwargs):
        inner = make(*args, **kwargs)

        def sampler(logits, generator=None):
            out["generate"].append(logits[0].float().clone())
            return inner(logits, generator)
        return sampler

    sampling.make_sampler = make_keeping
    try:
        with torch.no_grad():
            encdec_generate(srv.params, torch.tensor([src], device=dev), cfg,
                            max_new_tokens=1)
    finally:
        sampling.make_sampler = make
    if len(out["generate"]) != 1 or not out["slot"]:
        raise AssertionError(f"encdec first-step logits: kept "
                             f"{len(out['slot'])} from the engine and "
                             f"{len(out['generate'])} from encdec_generate")
    slot, gen = out["slot"][0], out["generate"][0]
    if not (torch.isfinite(slot).all() and slot.shape == (cfg.vocab_size,)
            and gen.shape == slot.shape):
        raise AssertionError("encdec slot-route logits not finite")
    return {"src_len": len(src), "rel_l2": _rel_l2(slot, gen),
            "argmax_equal": bool(slot.argmax() == gen.argmax())}


def _encdec_serve(dev) -> dict:
    """The server on ``encdec:ENCDEC_PRESET``: a burst of srcTokens
    requests through the slot engine, /healthz, one ``--slots 0``
    request; each burst stream against an isolated greedy
    ``encdec_generate`` (share token-exact, reported) and the first-step
    logits of the two routes."""
    from tpu_docker_api_torch.models.encdec import encdec_generate
    from tpu_docker_api_torch.ops import flash

    g = torch.Generator().manual_seed(11)
    res = {}
    with _server(dev, ["--preset", f"encdec:{ENCDEC_PRESET}"]) as (srv,
                                                                   port):
        cfg, eng = srv.cfg, srv.engine
        srcs = [torch.randint(1, cfg.vocab_size, (n,), generator=g).tolist()
                for n in ENCDEC_SERVE_LENGTHS]
        _post_src(port, {"srcTokens": [[1, 2, 3]], "maxNewTokens": 2})
        eng.reset_latency_stats()
        replies: list = [None] * len(srcs)

        def client(i):
            replies[i] = _post_src(port, {"srcTokens": [srcs[i]],
                                          "maxNewTokens": ENCDEC_MAX_NEW})

        # ---- the main path: counts zeroed just before, read just after
        flash.reset_launch_count()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(srcs))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        wall = time.perf_counter() - t0
        slot_launches = flash.launch_count["flash_fwd"]
        # ---- end of the main path
        latency = eng.latency_stats()
        code, health = _call(port, "GET", "/healthz")
        if code != 200 or health["slotEngine"]["completed"] < len(srcs):
            raise AssertionError(f"encdec /healthz: {code} {health}")
        tokens = [r["tokens"][0] for r in replies]
        for row, n in zip(tokens, (r["lengths"][0] for r in replies)):
            if n != ENCDEC_MAX_NEW or not all(0 <= t < cfg.vocab_size
                                              for t in row):
                raise AssertionError(f"malformed encdec reply: {row}")
        with torch.no_grad():
            iso = [encdec_generate(srv.params,
                                   torch.tensor([s], device=dev), cfg,
                                   max_new_tokens=ENCDEC_MAX_NEW)[0].tolist()
                   for s in srcs]
        exact = sum(a == b for a, b in zip(tokens, iso))
        logits = _encdec_first_logits(dev, srv, port, srcs[-1])
        if logits["rel_l2"] > FAMILY_TOL:
            raise AssertionError(f"encdec first-step logits: {logits}")
        res.update({"burst_wall_s": wall,
                    "ttft_p50_ms": latency["ttft_p50_ms"],
                    "itl_p50_ms": latency["itl_p50_ms"],
                    "decode_tok_s": len(srcs) * ENCDEC_MAX_NEW / wall,
                    "slot_flash_launches": slot_launches,
                    "streams_token_exact": f"{exact}/{len(srcs)}",
                    "first_logits": logits, "logits_tol": FAMILY_TOL,
                    "healthz": health["slotEngine"]})
    with _server(dev, ["--preset", f"encdec:{ENCDEC_PRESET}", "--slots",
                       "0"]) as (srv, port):
        flash.reset_launch_count()
        body = _post_src(port, {"srcTokens": [srcs[2]],
                                "maxNewTokens": ENCDEC_MAX_NEW})
        legacy_launches = flash.launch_count["flash_fwd"]
        if body["tokens"][0] != iso[2]:
            raise AssertionError("the --slots 0 reply differs from "
                                 "encdec_generate's tokens")
        if legacy_launches != srv.cfg.enc_layers:
            raise AssertionError(f"--slots 0: {legacy_launches} flash "
                                 f"launches, expected one a layer of the "
                                 f"encoder")
        res["legacy_flash_launches"] = legacy_launches
    res["flash_launches"] = slot_launches + legacy_launches
    return res


def phase_encdec(dev) -> dict:
    """The encoder-decoder family (module docstring, phase 11):
    encdec-base trained through the trainer's entry points at 32 x
    (512, 512) (a counted run under adamw-int8 on a repeated batch,
    ``time_train_steps`` under adamw), the server's slot engine and
    ``--slots 0`` path, and ``bench_encdec_slot_serving``."""
    from tpu_docker_api_torch.infer.servebench import (
        bench_encdec_slot_serving)
    from tpu_docker_api_torch.models import param_shapes
    from tpu_docker_api_torch.models.encdec import (encdec_presets,
                                                    encdec_synthetic_batch)
    from tpu_docker_api_torch.ops import flash
    from tpu_docker_api_torch.train import optim
    from tpu_docker_api_torch.train.__main__ import main as train_main

    phase_t0 = time.perf_counter()
    seconds = {}
    cfg = encdec_presets()[ENCDEC_PRESET]
    batch = encdec_synthetic_batch(1, ENCDEC_BATCH, ENCDEC_SEQ, ENCDEC_SEQ,
                                   cfg, device=dev)
    t0 = time.perf_counter()
    run = _family_train_run(dev, cfg, batch, "adamw-int8")
    per_step = cfg.enc_layers + 2 * cfg.dec_layers  # + equal-length cross
    n_leaves = len(_tensors(param_shapes(cfg)))
    want = {"flash_fwd": per_step * TRAIN_STEPS,
            "flash_bwd_dq": per_step * TRAIN_STEPS,
            "flash_bwd_dkv": per_step * TRAIN_STEPS,
            "adam8": n_leaves * TRAIN_STEPS}
    if run["launches"] != want:
        raise AssertionError(f"encdec launches {run['launches']}, expected "
                             f"{want}")
    if abs(run["losses"][0] - math.log(cfg.vocab_size)) > 1.0:
        raise AssertionError(f"encdec: first loss {run['losses'][0]} not "
                             f"within 1.0 of ln(vocab)")
    timed = _timed_steps(dev, cfg, batch, "adamw", ENCDEC_TIMED_STEPS)
    pairs = timed["steps_per_sec"] * ENCDEC_BATCH
    timed.update({"pairs_per_sec": pairs,
                  "mfu": cfg.flops_per_pair(ENCDEC_SEQ, ENCDEC_SEQ) * pairs
                  / PEAK_FLOPS[torch.bfloat16]})
    del batch
    _free(dev)
    seconds["train"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    flash.reset_launch_count()
    optim.reset_launch_count()
    cli = _run_cli(train_main, [
        "--preset", f"encdec:{ENCDEC_PRESET}", "--device", str(dev),
        "--steps", "4", "--batch", str(ENCDEC_BATCH), "--seq",
        str(ENCDEC_SEQ), "--log-every", "1", "--profile-dir",
        "build/encdec_profile", "--profile-steps", "2"])
    cli_launches = {**flash.launch_count, **optim.launch_count}
    _check_cli(cli, "encdec")
    _free(dev)
    seconds["cli"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    serve = _encdec_serve(dev)
    seconds["serve"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    bench = bench_encdec_slot_serving(device=dev, **ENCDEC_BENCH)
    seconds["bench"] = time.perf_counter() - t0
    emit({"phase": "servebench", "bench": "bench_encdec_slot_serving",
          "args": ENCDEC_BENCH, "seconds": seconds["bench"], **bench})
    if bench["ok"] is not True:
        raise AssertionError(f"bench_encdec_slot_serving not ok: {bench}")
    launches = {k: run["launches"][k] + cli_launches[k]
                for k in run["launches"]}
    launches["flash_fwd"] += serve["flash_launches"]
    res = {"phase": "encdec", "preset": ENCDEC_PRESET,
           "params": run["params"], "batch": ENCDEC_BATCH,
           "src_len": ENCDEC_SEQ, "tgt_len": ENCDEC_SEQ, "train": run,
           "timed": timed, "cli": {"lines": cli, "launches": cli_launches},
           "serve": serve, "launches": launches,
           "seconds": seconds, "phase_s": time.perf_counter() - phase_t0,
           "card": nvidia_smi() if dev.type == "cuda" else "cpu"}
    emit(res)
    return res


# ---------------------------------------------------------------- devices

DEVICES_DIR = "build/devices"
#: the exec'd child's load: the GiB it holds, and seconds of back-to-back
#: flash calls at the training shape (bf16; R, s, heads, kv heads, d)
DEVICES_ALLOC_GIB = 4
DEVICES_LOAD_S = 3.0
DEVICES_FLASH = (4, 2048, 32, 8, 64)
#: sidecar GETs timed for the p50
DEVICES_GETS = 20
NVML_HEADERS = ("/usr/local/cuda/targets/x86_64-linux/include/nvml.h",
                "/usr/local/cuda/include/nvml.h")


def nvml_header() -> str | None:
    """The toolkit's nvml.h, where the card's machine has one."""
    return next((p for p in NVML_HEADERS if os.path.exists(p)), None)


def nvidia_smi_gpus() -> list[dict]:
    """nvidia-smi's index, UUID, name, memory (MiB), power limit (W) and
    driver version of each GPU: what the NVML reply is held against."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=index,uuid,name,memory.total,"
         "power.limit,driver_version", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout
    rows = []
    for line in out.strip().splitlines():
        idx, uuid, name, mem, power, driver = [f.strip()
                                               for f in line.split(",")]
        rows.append({"index": int(idx), "uuid": uuid, "name": name,
                     "memory_total_mib": float(mem),
                     "power_limit_w": float(power),
                     "driver_version": driver})
    return rows


#: the child a granted container runs: what CUDA shows it, then a held
#: allocation and back-to-back flash calls (the ``csrc`` kernel) for the
#: sidecar to see; one JSON line, last
_DEVICES_CHILD = """
import json, os, sys, time
import torch
from tpu_docker_api_torch.ops import flash

gib, load_s, (R, s, h, hk, d) = json.loads(sys.argv[1])
t_start = time.perf_counter()
dev = torch.device("cuda")
out = {"count": torch.cuda.device_count(), "pid": os.getpid(),
       "uuid": str(torch.cuda.get_device_properties(0).uuid)}
hold = torch.empty(int(gib * 2**30), dtype=torch.uint8, device=dev)
g = torch.Generator(device=dev).manual_seed(0)
q, k, v = (torch.randn(R, n, s, d, generator=g, device=dev)
           .to(torch.bfloat16) for n in (h, hk, hk))
flash.reset_launch_count()
with torch.no_grad():
    # the first call of a fresh process takes seconds: keep it out of
    # the load window
    t0 = time.perf_counter()
    flash.flash_attention(q, k, v)
    torch.cuda.synchronize()
    first_call_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < load_s:
        for _ in range(20):
            flash.flash_attention(q, k, v)
        torch.cuda.synchronize()
out.update(launches=flash.launch_count["flash_fwd"],
           first_call_s=first_call_s, load_s=time.perf_counter() - t0,
           seconds=time.perf_counter() - t_start)
print(json.dumps(out))
"""


def _chip0(port: int) -> dict:
    code, data = _call(port, "GET", "/api/v1/detect/gpu")
    if code != 200:
        raise AssertionError(f"sidecar answered {code}: {data}")
    return data["data"]["chips"][0]


def grant_and_exec(workdir, alloc_gib: float = DEVICES_ALLOC_GIB,
                   load_s: float = DEVICES_LOAD_S,
                   flash_shape=DEVICES_FLASH, port: int = 0) -> dict:
    """One GPU through the control plane: the sidecar's reply (``port``,
    else a sidecar started here on the real probe) seeds a
    ``ChipScheduler`` on a ``SqliteKV`` under ``workdir``; one GPU is
    granted, a second ask raises ChipNotEnough, a scheduler started anew
    on the file restores the grant; ``render_gpu_attachment`` puts it on
    a spec that ``FakeRuntime(allow_exec=True)`` runs a child under
    while the sidecar is polled; then the grant is freed. Raises unless
    the child saw exactly the granted GPU; returns the readings."""
    from tpu_docker_api_torch import errors
    from tpu_docker_api_torch.runtime import FakeRuntime
    from tpu_docker_api_torch.runtime.spec import (ContainerSpec,
                                                   render_gpu_attachment)
    from tpu_docker_api_torch.scheduler.slices import ChipScheduler
    from tpu_docker_api_torch.schemas.gpu import HostTopologyInfo
    from tpu_docker_api_torch.state.kv import SqliteKV
    from tpu_docker_api_torch.telemetry.probe import topology_from_info
    from tpu_docker_api_torch.telemetry.sidecar import SidecarServer

    srv = None
    if not port:
        srv = SidecarServer(host="127.0.0.1", port=0)
        srv.start()
        port = srv.port
    workdir = str(workdir)
    os.makedirs(workdir, exist_ok=True)
    db = os.path.join(workdir, "scheduler.db")
    for suffix in ("", "-wal", "-shm"):
        if os.path.exists(db + suffix):
            os.remove(db + suffix)
    try:
        code, reply = _call(port, "GET", "/api/v1/detect/gpu")
        if code != 200:
            raise AssertionError(f"sidecar answered {code}: {reply}")
        topo = topology_from_info(HostTopologyInfo.from_dict(reply["data"]))
        kv = SqliteKV(db)
        sched = ChipScheduler(topo, kv)
        ids, contiguous = sched.apply_chips(1, owner="smoke-0")
        uuids = sched.uuids_of(ids)
        if ids != [0] or uuids != [reply["data"]["chips"][0]["uuid"]]:
            raise AssertionError(f"granted {ids} {uuids}, not GPU 0")
        try:
            sched.apply_chips(1, owner="smoke-1")
            raise AssertionError("a second GPU was granted on a one-GPU host")
        except errors.ChipNotEnough:
            pass
        kv.close()
        kv = SqliteKV(db)
        sched = ChipScheduler(topo, kv)
        if sched.owned_chips("smoke-0") != [0]:
            raise AssertionError(f"the grant did not survive a restart: "
                                 f"{sched.status()}")
        spec = render_gpu_attachment(
            ContainerSpec(name="smoke-0", image="local",
                          env=[f"PYTHONPATH={os.getcwd()}"]),
            ids, topo, contiguous)
        idle = _chip0(port)
        rt = FakeRuntime(root=os.path.join(workdir, "runtime"),
                         allow_exec=True)
        rt.container_create(spec)
        rt.container_start("smoke-0")
        result = {}

        def run():
            result["exec"] = rt.container_exec("smoke-0", [
                sys.executable, "-c", _DEVICES_CHILD,
                json.dumps([alloc_gib, load_s, list(flash_shape)])])

        child = threading.Thread(target=run)
        t0 = time.perf_counter()
        child.start()
        polls = []
        while child.is_alive():
            polls.append(_chip0(port))
            time.sleep(0.1)
        child.join()
        exec_s = time.perf_counter() - t0
        res = result["exec"]
        if res.exit_code != 0:
            raise AssertionError(f"the granted child failed "
                                 f"({res.exit_code}): {res.output[-2000:]}")
        seen = json.loads(res.output.strip().splitlines()[-1])
        # torch prints the UUID without NVML's "GPU-" prefix
        granted = uuids[0].lower().removeprefix("gpu-")
        seen["uuid_matches"] = seen["uuid"].lower() == granted
        if seen["count"] != 1 or not seen["uuid_matches"]:
            raise AssertionError(f"the child saw {seen}, granted {uuids}")
        rt.container_stop("smoke-0")
        rt.container_remove("smoke-0")
        rt.close()
        sched.restore_chips(ids, owner="smoke-0")
        freed = ChipScheduler(topo, kv).status()["freeChips"]
        kv.close()
        if freed != topo.n_chips:
            raise AssertionError(f"restore_chips left {freed} of "
                                 f"{topo.n_chips} free")
        peak_used = max((p["hbm_used_bytes"] for p in polls), default=0)
        return {"granted": ids, "uuids": uuids, "env": spec.env,
                "idle": {k: idle[k] for k in ("hbm_used_bytes",
                                              "duty_cycle_pct", "pid")},
                "polls": len(polls),
                "peak_hbm_used_bytes": peak_used,
                "hbm_rise_bytes": peak_used - idle["hbm_used_bytes"],
                "peak_duty_cycle_pct": max(
                    (p["duty_cycle_pct"] for p in polls), default=0.0),
                "polls_with_duty": sum(p["duty_cycle_pct"] > 0
                                       for p in polls),
                "pids_seen": sorted({p["pid"] for p in polls}),
                "pid_visible": any(p["pid"] == seen["pid"] for p in polls),
                "child": seen, "exec_s": exec_s}
    finally:
        if srv is not None:
            srv.close()


def _device_requests(uuid: str) -> dict:
    """DockerRuntime against the fake Engine: the create body carries
    exactly the reference's DeviceRequests for the grant, inspect reads
    the UUID back, and a cardless spec carries none."""
    import tempfile

    from tpu_docker_api_torch.runtime.docker_http import DockerRuntime
    from tpu_docker_api_torch.runtime.fake_engine import FakeEngine
    from tpu_docker_api_torch.runtime.spec import ContainerSpec

    sock_dir = tempfile.mkdtemp(prefix="chip-smoke-engine-")
    eng = FakeEngine(os.path.join(sock_dir, "docker.sock"))
    try:
        rt = DockerRuntime(eng.docker_host)
        rt.container_create(ContainerSpec(
            name="g", image="jax:latest", chip_ids=[0], gpu_uuids=[uuid],
            env=[f"CUDA_VISIBLE_DEVICES={uuid}"]))
        body = eng.last()[3]
        want = [{"Driver": "nvidia", "Count": 0, "DeviceIDs": [uuid],
                 "Capabilities": [["gpu"]]}]
        if body["HostConfig"].get("DeviceRequests") != want:
            raise AssertionError(f"create body's DeviceRequests: "
                                 f"{body['HostConfig']}")
        back = rt.container_inspect("g").spec
        if (back.gpu_uuids, back.chip_ids) != ([uuid], [0]):
            raise AssertionError(f"inspect read back {back}")
        rt.container_create(ContainerSpec(name="z", image="jax:latest"))
        if "DeviceRequests" in eng.last()[3]["HostConfig"]:
            raise AssertionError("a cardless create carried DeviceRequests")
        rt.close()
        return {"device_requests": want, "inspect_gpu_uuids": back.gpu_uuids}
    finally:
        eng.close()
        shutil.rmtree(sock_dir, ignore_errors=True)


def phase_devices(dev) -> dict:
    """The control plane's device seams on the card: the sidecar's NVML
    reply against nvidia-smi, a grant through the scheduler and the
    runtime to a child that sees only its GPU while NVML sees its load,
    and the Docker runtime's DeviceRequests."""
    from tpu_docker_api_torch.runtime.spec import (ContainerSpec,
                                                   render_gpu_attachment)
    from tpu_docker_api_torch.scheduler.topology import generation_for
    from tpu_docker_api_torch.telemetry import nvml
    from tpu_docker_api_torch.telemetry.probe import (probe_host_info,
                                                      topology_from_info)
    from tpu_docker_api_torch.telemetry.sidecar import SidecarServer

    phase_t0 = time.perf_counter()
    header = nvml_header()
    if header:
        with open(header) as f:
            layout = nvml.header_layout_errors(f.read())
        if layout:
            raise AssertionError(f"nvml.h differs from the binding: {layout}")
    t0 = time.perf_counter()
    info = probe_host_info()
    probe_first_ms = (time.perf_counter() - t0) * 1e3
    probe_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        probe_host_info()
        probe_ms.append((time.perf_counter() - t0) * 1e3)
    if info is None or not info.driver_version or not all(
            c.uuid for c in info.chips):
        raise AssertionError(f"NVML did not answer: {info}")
    smi = nvidia_smi_gpus()
    srv = SidecarServer(host="127.0.0.1", port=0)
    srv.start()
    try:
        get_ms = []
        for _ in range(DEVICES_GETS):
            t0 = time.perf_counter()
            code, reply = _call(srv.port, "GET", "/api/v1/detect/gpu")
            get_ms.append((time.perf_counter() - t0) * 1e3)
            if code != 200:
                raise AssertionError(f"sidecar answered {code}: {reply}")
        data = reply["data"]
        if _call(srv.port, "GET", "/api/v1/detect/tpu")[0] != 200:
            raise AssertionError("the /api/v1/detect/tpu alias failed")
        chips = data["chips"]
        if len(chips) != 1 or len(smi) != 1 \
                or torch.cuda.device_count() != 1:
            raise AssertionError(f"want one GPU: reply {len(chips)}, "
                                 f"nvidia-smi {len(smi)}, torch "
                                 f"{torch.cuda.device_count()}")
        chip, row = chips[0], smi[0]
        checks = {
            "index": chip["chip_id"] == row["index"],
            "uuid": chip["uuid"] == row["uuid"],
            "name": chip["name"] == row["name"],
            "driver_version": data["driver_version"]
            == row["driver_version"] != "",
            "hbm_total_within_1_mib": abs(
                chip["hbm_total_bytes"] / 2**20 - row["memory_total_mib"])
            <= 1,
            "power_limit_within_1_w": abs(
                chip["power_limit_w"] - row["power_limit_w"]) <= 1,
            "generation_h100": data["generation"] == "h100"
            and generation_for(dev).name == "h100",
        }
        if not all(checks.values()):
            raise AssertionError(f"NVML reply {data} against nvidia-smi "
                                 f"{row}: {checks}")
        grant = grant_and_exec(DEVICES_DIR, port=srv.port)
    finally:
        srv.close()
    if grant["hbm_rise_bytes"] < DEVICES_ALLOC_GIB * 2**30:
        raise AssertionError(f"hbm_used rose {grant['hbm_rise_bytes']} "
                             f"bytes under a {DEVICES_ALLOC_GIB} GiB load")
    if grant["polls_with_duty"] == 0:
        raise AssertionError(f"duty cycle 0 on all {grant['polls']} polls "
                             f"under load")
    cardless = render_gpu_attachment(ContainerSpec(name="z", image="i"), [],
                                     topology_from_info(info))
    if any(e.startswith("CUDA_VISIBLE_DEVICES=") for e in cardless.env) \
            or cardless.gpu_uuids:
        raise AssertionError(f"a zero-GPU spec carries a GPU: {cardless}")
    requests = _device_requests(chip["uuid"])
    shutil.rmtree(DEVICES_DIR, ignore_errors=True)
    res = {"phase": "devices", "nvml_h": header, "reply": data,
           "nvidia_smi_gpus": smi, "checks": checks,
           "probe_first_ms": probe_first_ms,
           "probe_ms_median": sorted(probe_ms)[len(probe_ms) // 2],
           "sidecar_get_ms_p50": sorted(get_ms)[len(get_ms) // 2],
           "sidecar_gets": len(get_ms), "grant": grant, **requests,
           "flash_launches": grant["child"]["launches"],
           "seconds": time.perf_counter() - phase_t0, "card": nvidia_smi()}
    emit(res)
    return res


# ---------------------------------------------------------- control plane

CONTROL_DIR = "build/control_plane"
#: a host's worth of state: container families (gpuCount 0, one
#: containerPort each, replaced twice by PATCH .../volume), volumes with a
#: seeded file each, and the host port range they draw from
CONTROL_FAMILIES = 200
CONTROL_VOLUMES = 50
CONTROL_VOLUME_BYTES = 16 << 20
CONTROL_PORTS = (42000, 42999)
CONTROL_PAGE = 50

#: the child a container's exec runs: what CUDA shows it, and where a GPU
#: is granted, the flash kernel at the devices phase's shape against its
#: plain version; one JSON line
_CONTROL_CHILD = """
import json, os, sys, time
import torch
(R, s, h, hk, d), tol = json.loads(sys.argv[1])
out = {"count": torch.cuda.device_count(),
       "visible": os.environ.get("CUDA_VISIBLE_DEVICES")}
if out["count"]:
    from tpu_docker_api_torch.ops import flash
    dev = torch.device("cuda")
    out["uuid"] = str(torch.cuda.get_device_properties(0).uuid)
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(R, s, n, d, generator=g, device=dev)
               .to(torch.bfloat16).transpose(1, 2) for n in (h, hk, hk))
    flash.reset_launch_count()
    with torch.no_grad():
        t0 = time.perf_counter()
        o, _ = flash.flash_attention_fwd(q, k, v)
        torch.cuda.synchronize()
        out["first_call_s"] = time.perf_counter() - t0
        out["launches"] = flash.launch_count["flash_fwd"]
        ref, _ = flash.flash_attention_fwd_plain(q, k, v, True)
    out["max_abs_err"] = (o.float() - ref.float()).abs().max().item()
    out["tol"] = tol
print(json.dumps(out))
"""


def _free_port() -> int:
    with contextlib.closing(socket.socket()) as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


class _Daemon:
    """``python -m tpu_docker_api_torch -c cfg`` in a child process; the
    seconds from spawn to its first 200 from /healthz."""

    def __init__(self, cfg_path: str, port: int):
        self.port = port
        self.log = open(cfg_path + ".log", "ab")
        t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "tpu_docker_api_torch", "-c", cfg_path,
             "--host", "127.0.0.1"], stdout=self.log, stderr=self.log)
        while True:
            try:
                if _call(port, "GET", "/healthz")[0] == 200:
                    break
            except OSError:
                pass
            if self.proc.poll() is not None or time.perf_counter() - t0 > 120:
                self.kill()
                with open(cfg_path + ".log") as f:
                    raise AssertionError(f"the daemon did not come up: "
                                         f"{f.read()[-3000:]}")
            time.sleep(0.02)
        self.ready_s = time.perf_counter() - t0

    def kill(self, sig=signal.SIGKILL) -> None:
        if self.proc.poll() is None:
            self.proc.send_signal(sig)
            self.proc.wait(timeout=60)
        self.log.close()


def _api(port: int, method: str, path: str, body=None, want: int = 200,
         times: list | None = None):
    """One REST call; raises unless the reply's code is ``want``."""
    t0 = time.perf_counter()
    status, reply = _call(port, method, "/api/v1" + path, body)
    if times is not None:
        times.append((time.perf_counter() - t0) * 1e3)
    if reply["code"] != want:
        raise AssertionError(f"{method} {path} {body}: HTTP {status} "
                             f"{reply}, want code {want}")
    return reply["data"]


def _pct(xs: list, q: float) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))]


def _lat(xs: list) -> dict:
    return {"n": len(xs), "p50_ms": _pct(xs, 0.5), "p99_ms": _pct(xs, 0.99)}


def _drain_s(port: int) -> float:
    """Seconds until the daemon's work-queue journal is empty: the
    queue's own view, polled."""
    t0 = time.perf_counter()
    while _api(port, "GET", "/queue")["journal"]["entries"]:
        if time.perf_counter() - t0 > 300:
            raise AssertionError("the work queue did not drain in 300 s")
        time.sleep(0.005)
    return time.perf_counter() - t0


def _gpu_exec(port: int, name: str) -> dict:
    out = _api(port, "POST", f"/containers/{name}/execute", {"cmd": [
        sys.executable, "-c", _CONTROL_CHILD,
        json.dumps([list(DEVICES_FLASH), FLASH_TOL[torch.bfloat16][0]])]})
    return json.loads(out["stdout"].strip().splitlines()[-1])


def _volume_blob(i: int) -> bytes:
    import numpy as np

    return np.random.default_rng(1000 + i).bytes(CONTROL_VOLUME_BYTES)


def phase_control_plane(dev) -> dict:
    """The port's daemon through its entry point on the card
    (``python -m tpu_docker_api_torch``, the sqlite store, the fake
    runtime, the topology from NVML): the H100 granted by UUID through
    the REST API to a container whose exec runs the flash kernel, taken
    away by a rolling replacement and granted again; a host's worth of
    families and volumes; a SIGKILL right after acknowledged resizes and
    a restart on the same file; a teardown that frees everything."""
    phase_t0 = time.perf_counter()
    shutil.rmtree(CONTROL_DIR, ignore_errors=True)
    os.makedirs(CONTROL_DIR)
    root = os.path.abspath(CONTROL_DIR)
    port = _free_port()
    cfg = os.path.join(root, "daemon.toml")
    with open(cfg, "w") as f:
        f.write(f'port = {port}\nstore_backend = "sqlite"\n'
                f'sqlite_path = "{root}/state.db"\n'
                f'runtime_backend = "fake"\n'
                f'fake_runtime_root = "{root}/runtime"\n'
                f"start_port = {CONTROL_PORTS[0]}\n"
                f"end_port = {CONTROL_PORTS[1]}\n")
    smi = nvidia_smi_gpus()
    if len(smi) != 1:
        raise AssertionError(f"want one GPU, nvidia-smi shows {smi}")
    uuid = smi[0]["uuid"]
    env = [f"PYTHONPATH={os.getcwd()}"]
    lat = {"run": [], "replace": [], "delete": [], "history": [],
           "list_page": [], "resize": []}
    daemon = _Daemon(cfg, port)
    boot_s = daemon.ready_s
    try:
        # -- the GPU through the API --------------------------------------
        gpus = _api(port, "GET", "/resources/gpus")
        if [(c["uuid"], c["used"]) for c in gpus["chips"]] != [(uuid, False)]:
            raise AssertionError(f"the GPU view {gpus} is not nvidia-smi's "
                                 f"one GPU {uuid}")
        run = _api(port, "POST", "/containers", {
            "imageName": "local", "containerName": "g", "gpuCount": 1,
            "env": env}, times=lat["run"])
        if run != {"name": "g-0", "chipIds": [0], "iciContiguous": True}:
            raise AssertionError(f"run g: {run}")
        _api(port, "POST", "/containers", {"imageName": "local",
                                           "containerName": "h",
                                           "gpuCount": 1}, want=10601)
        child0 = _gpu_exec(port, "g-0")
        granted = uuid.lower().removeprefix("gpu-")
        if (child0["count"], child0.get("uuid", "").lower()) != (1, granted):
            raise AssertionError(f"g-0's child saw {child0}, granted {uuid}")
        if not child0["max_abs_err"] <= child0["tol"] \
                or child0["launches"] < 1:
            raise AssertionError(f"flash in g-0: {child0}")
        if _api(port, "PATCH", "/containers/g/gpu", {"gpuCount": 0},
                times=lat["replace"])["name"] != "g-1":
            raise AssertionError("PATCH gpuCount 0 did not make g-1")
        _drain_s(port)
        if _api(port, "GET", "/resources/gpus")["freeChips"] != 1:
            raise AssertionError("g-1 still holds the GPU")
        child1 = _gpu_exec(port, "g-1")
        if child1["count"] != 0:
            raise AssertionError(f"the GPU-less g-1 saw {child1}")
        if _api(port, "PATCH", "/containers/g/gpu", {"gpuCount": 1},
                times=lat["replace"])["name"] != "g-2":
            raise AssertionError("PATCH gpuCount 1 did not make g-2")
        _drain_s(port)
        child2 = _gpu_exec(port, "g-2")
        if (child2["count"], child2.get("uuid", "").lower()) != (1, granted):
            raise AssertionError(f"g-2's child saw {child2}, granted {uuid}")

        # -- a host's state at real size -----------------------------------
        binds = [{"src": f"{root}/data/a", "dest": "/d"},
                 {"src": f"{root}/data/b", "dest": "/d"}]
        for i in range(CONTROL_FAMILIES):
            _api(port, "POST", "/containers", {
                "imageName": "local", "containerName": f"f{i}",
                "gpuCount": 0, "binds": [binds[0]],
                "containerPorts": [{"containerPort": 8080}]},
                times=lat["run"])
        for step in range(2):
            for i in range(CONTROL_FAMILIES):
                _api(port, "PATCH", f"/containers/f{i}/volume", {
                    "oldBind": binds[step % 2],
                    "newBind": binds[(step + 1) % 2]}, times=lat["replace"])
        replace_drain_s = _drain_s(port)
        for i in range(CONTROL_FAMILIES):
            hist = _api(port, "GET", f"/containers/f{i}/history",
                        times=lat["history"])
            if [v["name"] for v in hist["versions"]] != [
                    f"f{i}-{v}" for v in range(3)]:
                raise AssertionError(f"f{i} history: {hist}")
        listed, token = [], ""
        while True:
            page = _api(port, "GET", f"/containers?limit={CONTROL_PAGE}"
                        + (f"&continue={token}" if token else ""),
                        times=lat["list_page"])
            listed += [it["name"] for it in page["items"]]
            token = page["continue"]
            if not token:
                break
        if sorted(listed) != sorted(["g"] + [f"f{i}" for i in
                                             range(CONTROL_FAMILIES)]):
            raise AssertionError(f"the paged list has {len(listed)} "
                                 f"families")
        ports_before = _api(port, "GET", "/resources/ports")
        if ports_before["usedCount"] != CONTROL_FAMILIES:
            raise AssertionError(f"ports: {ports_before['usedCount']} used")
        half = CONTROL_VOLUMES // 2
        for i in range(CONTROL_VOLUMES):
            _api(port, "POST", "/volumes", {"volumeName": f"vol{i}",
                                            "size": "1GB"})
            mount = _api(port, "GET", f"/volumes/vol{i}")["runtime"][
                "mountpoint"]
            with open(os.path.join(mount, "blob"), "wb") as f:
                f.write(_volume_blob(i))
        for i in range(half):
            _api(port, "PATCH", f"/volumes/vol{i}-0/size", {"size": "2GB"},
                 times=lat["resize"])
        resize_drain_s = _drain_s(port)

        # -- a crash right after a batch of acknowledged resizes ------------
        for i in range(half, CONTROL_VOLUMES):
            _api(port, "PATCH", f"/volumes/vol{i}-0/size", {"size": "2GB"},
                 times=lat["resize"])
        daemon.kill()
        # what the dead daemon left in its journal: the work the restart
        # must replay
        from tpu_docker_api_torch.state import keys
        from tpu_docker_api_torch.state.kv import SqliteKV

        kv = SqliteKV(f"{root}/state.db")
        pending_at_kill = len(kv.keys_prefix(keys.QUEUE_TASKS_PREFIX))
        kv.close()
        daemon = _Daemon(cfg, port)
        restart_s = daemon.ready_s
        queue = _api(port, "GET", "/queue")
        dead = _api(port, "GET", "/dead-letters")
        if queue["journal"]["entries"] or dead:
            raise AssertionError(f"after the restart: {queue} {dead}")
        for i in range(CONTROL_VOLUMES):
            info = _api(port, "GET", f"/volumes/vol{i}")
            if info["state"]["volume_name"] != f"vol{i}-1":
                raise AssertionError(f"vol{i}: {info}")
            with open(os.path.join(info["runtime"]["mountpoint"], "blob"),
                      "rb") as f:
                if f.read() != _volume_blob(i):
                    raise AssertionError(f"vol{i}-1's data differs")
        if _api(port, "GET", "/resources/ports") != ports_before:
            raise AssertionError("the port grants changed across the crash")
        for i in range(CONTROL_FAMILIES):
            if len(_api(port, "GET", f"/containers/f{i}/history")[
                    "versions"]) != 3:
                raise AssertionError(f"f{i} lost a version")
        gpus = _api(port, "GET", "/resources/gpus")
        if [(c["uuid"], c["owner"]) for c in gpus["chips"]] != [(uuid, "g")]:
            raise AssertionError(f"g-2's grant after the restart: {gpus}")
        spec = _api(port, "GET", "/containers/g")["state"]["spec"]
        if (spec["name"], spec["gpu_uuids"]) != ("g-2", [uuid]):
            raise AssertionError(f"g's spec after the restart: {spec}")
        _api(port, "POST", "/containers", {"imageName": "local",
                                           "containerName": "h",
                                           "gpuCount": 1}, want=10601)

        # -- teardown --------------------------------------------------------
        purge = {"force": True, "delEtcdInfoAndVersionRecord": True}
        for name in ["g"] + [f"f{i}" for i in range(CONTROL_FAMILIES)]:
            _api(port, "DELETE", f"/containers/{name}", purge,
                 times=lat["delete"])
        for i in range(CONTROL_VOLUMES):
            _api(port, "DELETE", f"/volumes/vol{i}", purge,
                 times=lat["delete"])
        teardown_drain_s = _drain_s(port)
        left = {"ports": _api(port, "GET", "/resources/ports")["usedCount"],
                "gpus_free": _api(port, "GET", "/resources/gpus")[
                    "freeChips"],
                "containers": _api(port, "GET", "/containers")["items"],
                "volumes": _api(port, "GET", "/volumes")["items"]}
        if left != {"ports": 0, "gpus_free": 1, "containers": [],
                    "volumes": []}:
            raise AssertionError(f"after the teardown: {left}")
    finally:
        daemon.kill(signal.SIGTERM)
    shutil.rmtree(CONTROL_DIR, ignore_errors=True)
    res = {"phase": "control_plane", "boot_s": boot_s,
           "restart_to_ready_s": restart_s,
           "journal_records_at_kill": pending_at_kill,
           "run": _lat(lat["run"]), "replace": _lat(lat["replace"]),
           "delete": _lat(lat["delete"]), "history": _lat(lat["history"]),
           "resize": _lat(lat["resize"]),
           "list_page": {**_lat(lat["list_page"]), "limit": CONTROL_PAGE},
           "queue_drain_s": {"replaces": replace_drain_s,
                             "resizes": resize_drain_s,
                             "teardown": teardown_drain_s},
           "families": CONTROL_FAMILIES, "volumes": CONTROL_VOLUMES,
           "volume_bytes": CONTROL_VOLUME_BYTES,
           "children": {"g-0": child0, "g-1": child1, "g-2": child2},
           "child_first_call_s": child0["first_call_s"],
           "flash_launches": child0["launches"] + child2["launches"],
           "seconds": time.perf_counter() - phase_t0, "card": nvidia_smi()}
    emit(res)
    return res


# ---------------------------------------------------------------- reconcile

RECONCILE_DIR = "build/reconcile"
#: the daemon half's host: control_plane's 200 families (gpuCount 0,
#: one containerPort each) beside one family holding the GPU
RECONCILE_FAMILIES = CONTROL_FAMILIES
#: repeats behind each median (full pass, dirty pass, restart-to-ready)
RECONCILE_REPEATS = 5
#: families stopped through the API before each timed dirty pass, which
#: then visits exactly these; a pass the periodic one beat to some marks
#: is retried on the next batch, at most this many times in all
RECONCILE_DIRTY_CHANGES = 20
RECONCILE_DIRTY_RETRIES = 3
#: JAX's container crash matrix (tests/test_chaos.py CASES) on the one
#: GPU: grow is gpuCount 0 -> 1, shrink 1 -> 0, volume a bind swap at 1
_RECONCILE_REPLACE = ("replace.after_version_bump", "replace.after_create_new",
                      "replace.after_quiesce_old")
_RECONCILE_PATCH = ("patch.after_alloc", "patch.after_replace")
RECONCILE_CASES = ([("grow", p) for p in _RECONCILE_REPLACE + _RECONCILE_PATCH]
                   + [("shrink", p) for p in _RECONCILE_REPLACE
                      + _RECONCILE_PATCH]
                   + [("volume", p) for p in _RECONCILE_REPLACE])


def _reconcile_program(root: str, start: bool):
    """The port's ``Program`` in this process over ``root``'s sqlite file
    and persisting fake runtime, the topology from NVML (``h100-1`` where
    NVML answers nothing); ``start=False`` leaves its work queue unstarted
    (the chaos suite's crash model)."""
    from tpu_docker_api_torch import config as cp_config
    from tpu_docker_api_torch.daemon import Program
    from tpu_docker_api_torch.runtime.fake import FakeRuntime
    from tpu_docker_api_torch.state.kv import SqliteKV

    cfg = cp_config.Config(port=0, store_backend="sqlite",
                           runtime_backend="fake", health_watch_interval=0,
                           accelerator_type="h100-1",
                           start_port=CONTROL_PORTS[0],
                           end_port=CONTROL_PORTS[1])
    prg = Program(cfg, host="127.0.0.1", kv=SqliteKV(f"{root}/state.db"),
                  runtime=FakeRuntime(root=f"{root}/runtime", allow_exec=True,
                                      persist=True))
    prg.init()
    if start:
        prg.start()
    return prg


def _reconcile_case(flow: str, point: str, root: str) -> dict:
    """One crash of the matrix: the flow dies at ``point`` (SimulatedCrash,
    a BaseException: no rollback runs), a fresh Program boots on the same
    file and root, and its startup reconcile repairs the wreckage."""
    from tpu_docker_api_torch.runtime.spec import ContainerSpec
    from tpu_docker_api_torch.schemas.container import (
        Bind, ContainerPatchChips, ContainerPatchVolume, ContainerPort,
        ContainerRun)
    from tpu_docker_api_torch.service.crashpoints import SimulatedCrash, armed
    from tpu_docker_api_torch.service.invariants import check_invariants

    os.makedirs(f"{root}/v1")
    os.makedirs(f"{root}/v2")
    dead = _reconcile_program(root, start=False)
    dead.container_svc.run_container(ContainerRun(
        image_name="local", container_name="train",
        chip_count=0 if flow == "grow" else 1,
        container_ports=[ContainerPort(8080)],
        binds=[Bind(f"{root}/v1", "/data")]))
    with open(f"{dead.runtime.container_data_dir('train-0')}/ckpt.txt",
              "w") as f:
        f.write("step=100")
    try:
        with armed(point):
            if flow == "volume":
                dead.container_svc.patch_container_volume(
                    "train", ContainerPatchVolume(
                        old_bind=Bind(f"{root}/v1", "/data"),
                        new_bind=Bind(f"{root}/v2", "/data")))
            else:
                dead.container_svc.patch_container_chips(
                    "train", ContainerPatchChips(
                        chip_count=1 if flow == "grow" else 0))
        raise AssertionError(f"{flow}@{point}: no crash")
    except SimulatedCrash:
        pass
    dead.kv.close()
    prg = _reconcile_program(root, start=True)
    try:
        report = prg.reconciler.last_report()
        if report is None:
            raise AssertionError(f"{flow}@{point}: no startup reconcile")
        failed = [a for a in report["actions"] if "error" in a]
        problems = check_invariants(prg.runtime, prg.store,
                                    prg.container_versions,
                                    prg.chip_scheduler, prg.port_scheduler)
        rt = prg.runtime
        running = [n for n in rt.container_list()
                   if rt.container_inspect(n).running]
        latest = prg.container_versions.get("train")
        state = prg.store.get_container(f"train-{latest}")
        want = (["train"] if state.desired_running
                and ContainerSpec.from_dict(state.spec).chip_ids else [""])
        owners = [c["owner"] for c in prg.chip_scheduler.status()["chips"]]
        with open(f"{rt.container_data_dir(f'train-{latest}')}/ckpt.txt") as f:
            data = f.read()
        if (failed or problems or running != [f"train-{latest}"]
                or owners != want or data != "step=100"):
            raise AssertionError(
                f"{flow}@{point}: failed {failed}, invariants {problems}, "
                f"running {running} (latest {latest}), GPU {owners} "
                f"(want {want}), data {data!r}")
        return {"case": f"{flow}@{point}", "ms": report["durationMs"],
                "actions": [a["action"] for a in report["actions"]],
                "gpu_owner": owners[0]}
    finally:
        prg.stop()


def _metric_sum(port: int, name: str) -> float:
    """The sum of ``name``'s series on the daemon's ``/metrics``."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("GET", "/metrics")
    text = conn.getresponse().read().decode()
    conn.close()
    return sum(float(line.rsplit(" ", 1)[1]) for line in text.splitlines()
               if line.startswith((name + "{", name + " ")))


def _changed_dirty_pass(port: int, names: list) -> dict:
    """A dirty pass just after ``names`` were stopped through the API. The
    1 s periodic pass drains the same marks, so the stops begin right
    after one of its passes (``reconcile_runs_total`` moved), and the pass
    is posted once ``/healthz`` shows every stopped family marked."""
    runs = _metric_sum(port, "reconcile_runs_total")
    t0 = time.perf_counter()
    while _metric_sum(port, "reconcile_runs_total") == runs:
        if time.perf_counter() - t0 > 10:
            raise AssertionError("no periodic reconcile pass in 10 s")
        time.sleep(0.005)
    for name in names:
        _api(port, "POST", f"/containers/{name}/stop")
    t0 = time.perf_counter()
    while (_call(port, "GET", "/healthz")[1]["data"]["reconcileDirty"]
           ["dirty"]["containers"] < len(names)):
        if time.perf_counter() - t0 > 10:
            break  # the periodic pass took some: the caller sees it
        time.sleep(0.002)
    return _api(port, "POST", "/reconcile?mode=dirty")


def _daemon_log_has(cfg_path: str, needle: str) -> bool:
    with open(cfg_path + ".log", errors="replace") as f:
        return needle in f.read()


def phase_reconcile(dev) -> dict:
    """The port's reconciler at one card host's size (``phase_reconcile``):
    JAX's container crash matrix in this process, then the daemon by its
    entry point with ``reconcile_on_start``, a 1 s periodic pass, the
    watch-fed dirty mode and ``fanout_workers = 4``: 200 families and ``g``
    holding the H100, a SIGKILL, ``g``'s container removed out of band
    while the daemon is down, a restart whose startup reconcile frees the
    H100, a new container granted it by UUID whose exec runs flash_fwd,
    and a dry run that finds no drift. Medians of 5: a full pass, a dirty
    pass over RECONCILE_DIRTY_CHANGES families stopped just before it,
    restart-to-ready."""
    from tpu_docker_api_torch.runtime.fake import FakeRuntime

    phase_t0 = time.perf_counter()
    shutil.rmtree(RECONCILE_DIR, ignore_errors=True)
    os.makedirs(RECONCILE_DIR)
    root = os.path.abspath(RECONCILE_DIR)
    smi = nvidia_smi_gpus()
    if len(smi) != 1:
        raise AssertionError(f"want one GPU, nvidia-smi shows {smi}")
    uuid = smi[0]["uuid"]

    # -- (a) the crash matrix, in process -----------------------------------
    matrix = [_reconcile_case(flow, point, f"{root}/case{i}")
              for i, (flow, point) in enumerate(RECONCILE_CASES)]
    matrix_ms = sorted(c["ms"] for c in matrix)

    # -- (b) the daemon by its entry point ------------------------------------
    port = _free_port()
    cfg = os.path.join(root, "daemon.toml")
    with open(cfg, "w") as f:
        f.write(f'port = {port}\nstore_backend = "sqlite"\n'
                f'sqlite_path = "{root}/state.db"\n'
                f'runtime_backend = "fake"\n'
                f'fake_runtime_root = "{root}/runtime"\n'
                f'accelerator_type = "h100-1"\n'
                f"start_port = {CONTROL_PORTS[0]}\n"
                f"end_port = {CONTROL_PORTS[1]}\n"
                "reconcile_on_start = true\nreconcile_interval = 1.0\n"
                "reconcile_full_interval_s = 30.0\nfanout_workers = 4\n")
    env = [f"PYTHONPATH={os.getcwd()}"]
    daemon = _Daemon(cfg, port)
    try:
        if _api(port, "GET", "/reconcile/events"):
            raise AssertionError("a fresh daemon's startup reconcile "
                                 "repaired something")
        for i in range(RECONCILE_FAMILIES):
            _api(port, "POST", "/containers", {
                "imageName": "local", "containerName": f"f{i}",
                "gpuCount": 0, "containerPorts": [{"containerPort": 8080}]})
        run = _api(port, "POST", "/containers", {
            "imageName": "local", "containerName": "g", "gpuCount": 1,
            "env": env})
        if run["name"] != "g-0":
            raise AssertionError(f"run g: {run}")
        daemon.kill()
        # while the daemon is down, the engine loses g's container
        FakeRuntime(root=f"{root}/runtime", persist=True).container_remove(
            "g-0", force=True)
        daemon = _Daemon(cfg, port)
        restart_s = [daemon.ready_s]
        events = _api(port, "GET", "/reconcile/events")
        repairs = [(e["action"], e["target"]) for e in events
                   if not e.get("dryRun")]
        if ("mark-family-lost", "g-0") not in repairs \
                or ("free-leaked-chips", "g") not in repairs \
                or any("error" in e for e in events):
            raise AssertionError(f"the startup repair: {events}")
        if _daemon_log_has(cfg, "startup reconcile failed"):
            raise AssertionError("the startup reconcile failed")
        gpus = _api(port, "GET", "/resources/gpus")
        if [(c["uuid"], c["used"]) for c in gpus["chips"]] != [(uuid, False)]:
            raise AssertionError(f"the H100 after the repair: {gpus}")
        if _api(port, "POST", "/containers", {
                "imageName": "local", "containerName": "h", "gpuCount": 1,
                "env": env})["name"] != "h-0":
            raise AssertionError("run h after the repair")
        spec = _api(port, "GET", "/containers/h")["state"]["spec"]
        if spec["gpu_uuids"] != [uuid]:
            raise AssertionError(f"h's grant: {spec['gpu_uuids']}")
        child = _gpu_exec(port, "h-0")
        granted = uuid.lower().removeprefix("gpu-")
        if (child["count"], child.get("uuid", "").lower()) != (1, granted) \
                or not child["max_abs_err"] <= child["tol"] \
                or child["launches"] < 1:
            raise AssertionError(f"flash in h-0: {child}")
        dry = _api(port, "GET", "/reconcile?dryRun=true&mode=full")
        if dry["actions"] or dry["visitedFamilies"] < RECONCILE_FAMILIES:
            raise AssertionError(f"drift after the repair: {dry}")
        full, dirty, dirty_visited, dirty_missed = [], [], [], []
        batches = iter(range(0, RECONCILE_FAMILIES, RECONCILE_DIRTY_CHANGES))
        for _ in range(RECONCILE_REPEATS):
            rep = _api(port, "POST", "/reconcile?mode=full")
            if rep["mode"] != "full" or rep["actions"]:
                raise AssertionError(f"a full pass: {rep}")
            full.append(rep["durationMs"])
            while True:
                b = next(batches)
                rep = _changed_dirty_pass(port, [
                    f"f{i}-0" for i in range(b, b + RECONCILE_DIRTY_CHANGES)])
                if rep["mode"] != "dirty" or rep["actions"] \
                        or rep["visitedFamilies"] > RECONCILE_DIRTY_CHANGES:
                    raise AssertionError(f"a dirty pass: {rep}")
                if rep["visitedFamilies"] == RECONCILE_DIRTY_CHANGES:
                    break
                dirty_missed.append(rep["visitedFamilies"])
                if len(dirty_missed) > RECONCILE_DIRTY_RETRIES:
                    raise AssertionError(
                        f"the periodic pass drained the marks of "
                        f"{len(dirty_missed)} timed dirty passes: "
                        f"visited {dirty_missed}")
            dirty.append(rep["durationMs"])
            dirty_visited.append(rep["visitedFamilies"])
        health = _call(port, "GET", "/healthz")[1]["data"]
        if (health["fanout"]["workers"], health["storeHealth"]["mode"]) \
                != (4, "healthy") or "reconcileDirty" not in health:
            raise AssertionError(f"/healthz: {health}")
        for _ in range(RECONCILE_REPEATS - 1):
            daemon.kill()
            daemon = _Daemon(cfg, port)
            restart_s.append(daemon.ready_s)
            if _api(port, "GET", "/reconcile/events"):
                raise AssertionError("a clean restart repaired something")
        if _daemon_log_has(cfg, "startup reconcile failed"):
            raise AssertionError("a startup reconcile failed")
    finally:
        daemon.kill(signal.SIGTERM)
    shutil.rmtree(RECONCILE_DIR, ignore_errors=True)
    res = {"phase": "reconcile",
           "matrix": matrix, "matrix_startup_ms_median":
               matrix_ms[len(matrix_ms) // 2],
           "families": RECONCILE_FAMILIES, "startup_repair": repairs,
           "full_pass_ms_median": sorted(full)[len(full) // 2],
           "dirty_pass_ms_median": sorted(dirty)[len(dirty) // 2],
           "full_pass_ms": full, "dirty_pass_ms": dirty,
           "dirty_pass_visited": dirty_visited,
           "dirty_pass_retried_visited": dirty_missed,
           "restart_to_ready_s_median": sorted(restart_s)[len(restart_s) // 2],
           "restart_to_ready_s": restart_s,
           "dry_run_visited": dry["visitedFamilies"],
           "child": child, "flash_launches": child["launches"],
           "seconds": time.perf_counter() - phase_t0, "card": nvidia_smi()}
    emit(res)
    return res


PAR_DIR = "build/parallel"
PAR_PRESET = "llama3-1b"
PAR_STEPS = 3
PAR_MOE_PRESET = "moe:bench-moe"
PAR_MOE_BATCH, PAR_MOE_SEQ = 2, 2048
PAR_SERVE_PROMPT, PAR_SERVE_NEW, PAR_SERVE_REPS = 1900, 32, 3
PAR_SP_SEQ = 2048
PAR_LOSS_TOL, PAR_GRAD_TOL, PAR_LOGIT_TOL = 1e-3, 2e-2, 2e-2


def _par_run(dev, cfg, mesh, tokens, optim_name: str,
             pipeline: bool = False) -> dict:
    """PAR_STEPS steps of ``cfg`` from seed 0 on ``mesh`` (None: the
    single-device path), counts zeroed just before and read just after;
    the state comes back too. ``pipeline``: the trainer CLI's ``--pp``
    path (its ``pipeline_parts``: the pp rules and the 1F1B
    ``grad_fn``). ``peak_above_entry`` is the peak less what was
    allocated when the call began (another run's live state), so two
    runs' peaks compare."""
    from tpu_docker_api_torch.ops import flash
    from tpu_docker_api_torch.train import optim
    from tpu_docker_api_torch.train.__main__ import pipeline_parts
    from tpu_docker_api_torch.train.trainer import (create_train_state,
                                                    make_train_step)

    entry = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
    opt = optim.adamw_int8() if optim_name == "adamw-int8" else None
    rules, grad_fn = (pipeline_parts(cfg, mesh, tokens.shape[0]) if pipeline
                      else (None, None))
    state, opt = create_train_state(
        cfg, dev, torch.Generator(device=dev).manual_seed(0),
        optimizer=opt, mesh=mesh, rules=rules)
    step_fn = make_train_step(cfg, opt, mesh=mesh, grad_fn=grad_fn,
                              rules=rules)
    _par_sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    losses, step_ms, per_step = [], [], []
    flash.reset_launch_count()
    optim.reset_launch_count()
    for _ in range(PAR_STEPS):
        before = {**flash.launch_count, **optim.launch_count}
        t0 = time.perf_counter()
        state, metrics = step_fn(state, tokens)
        _par_sync(dev)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(metrics["loss"].item())
        after = {**flash.launch_count, **optim.launch_count}
        per_step.append({k: after[k] - before[k] for k in after})
    launches = {**flash.launch_count, **optim.launch_count}
    return {"losses": losses, "step_ms": step_ms, "launches": launches,
            "launches_per_step": per_step,
            "max_memory_allocated": (torch.cuda.max_memory_allocated(dev)
                                     if dev.type == "cuda" else None),
            "peak_above_entry": (torch.cuda.max_memory_allocated(dev) - entry
                                 if dev.type == "cuda" else None),
            "state": state, "optimizer": opt}


def _par_sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _par_empty_cache(dev) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _par_grads(dev, cfg, params, tokens, mesh) -> dict:
    """Gradients of the loss at ``params`` (step 1's), by leaf path."""
    from tpu_docker_api_torch.models import model_fns
    from tpu_docker_api_torch.parallel import sharding
    from tpu_docker_api_torch.train.optim import tree_leaves, tree_map

    _, loss, _ = model_fns(cfg)
    live = tree_map(lambda p: sharding.local(p).detach().requires_grad_(),
                    params)
    if mesh is None:
        value = loss(live, tokens, cfg)
    else:
        value = loss(live, sharding.split_batch(tokens, mesh), cfg,
                     mesh=mesh)
    grads = torch.autograd.grad(value, tree_leaves(live))
    paths = list(sharding.flatten_paths(params))
    return dict(zip(paths, grads))


def _par_server(argv: list, prompt: list) -> dict:
    """An in-process server of ``argv``: after a short warm request,
    PAR_SERVE_REPS streamed greedy requests of ``prompt`` one after
    another; the tokens of the first, the engine's TTFT and ITL p50
    over them, the flash launches of the first. On a rank other than 0
    of a mesh server: {} once rank 0 stops."""
    from tpu_docker_api_torch.ops import flash
    from tpu_docker_api_torch.serve.__main__ import Server, parse_args

    srv = Server(parse_args(argv + ["--host", "127.0.0.1", "--port", "0"]))
    if srv.rank != 0:   # a rank of a mesh server: step with rank 0
        srv.follow()
        return {}
    port = srv.httpd.server_address[1]
    thread = threading.Thread(target=srv.httpd.serve_forever, daemon=True)
    thread.start()
    try:
        _post(port, {"tokens": [[1, 2, 3]], "maxNewTokens": 2})
        srv.engine.reset_latency_stats()
        streams, launches = [], None
        for _ in range(PAR_SERVE_REPS):
            flash.reset_launch_count()
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
            conn.request("POST", "/generate", body=json.dumps(
                {"tokens": [prompt], "maxNewTokens": PAR_SERVE_NEW,
                 "stream": True}))
            resp = conn.getresponse()
            streams.append([json.loads(raw)["t"] for raw in resp
                            if b'"t"' in raw])
            conn.close()
            if launches is None:
                launches = flash.launch_count["flash_fwd"]
        lat = srv.engine.latency_stats()
        if any(s != streams[0] for s in streams):
            raise AssertionError(f"one greedy prompt, several streams: "
                                 f"{streams}")
        return {"tokens": streams[0], "ttft_p50_ms": lat["ttft_p50_ms"],
                "itl_p50_ms": lat["itl_p50_ms"], "requests": lat["n"],
                "flash_launches": launches, "mesh": srv.mesh is not None,
                "engine": type(srv.engine).__name__}
    finally:
        srv.httpd.shutdown()
        srv.close()
        thread.join(timeout=30)


def phase_parallel(dev) -> dict:
    """The mesh path at world size 1 (module docstring)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from tpu_docker_api_torch.models import resolve_preset
    from tpu_docker_api_torch.models.llama import llama_forward
    from tpu_docker_api_torch.ops import flash
    from tpu_docker_api_torch.parallel import sharding
    from tpu_docker_api_torch.parallel.mesh import MeshPlan, build_mesh
    from tpu_docker_api_torch.train.checkpoint import CheckpointManager
    from tpu_docker_api_torch.train.trainer import synthetic_batch
    from tpu_docker_api_torch.workload.torchenv import bootstrap_torch

    t_phase = time.perf_counter()
    bootstrap_torch(dev.type, force=True)
    try:
        mesh = build_mesh(MeshPlan(dp=1, fsdp=1, tp=1))
        _, cfg = resolve_preset(PAR_PRESET)
        tokens = synthetic_batch(torch.Generator(device=dev).manual_seed(1),
                                 TRAIN_BATCH, TRAIN_SEQ, cfg.vocab_size)

        # ---- the main path: the mesh run's counts are zeroed just
        # before its steps and read just after (_par_run)
        runs = {}
        for name, m in (("mesh", mesh), ("single", None)):
            runs[name] = _par_run(dev, cfg, m, tokens, "adamw-int8")
        par_launches = dict(runs["mesh"]["launches"])
        # ---- end of the main path

        mesh_state, single_state = (runs["mesh"].pop("state"),
                                    runs["single"].pop("state"))
        leaves = sharding.flatten_paths(mesh_state.params)
        if not all(isinstance(v, DTensor) for v in leaves.values()):
            raise AssertionError("mesh-path params are not DTensors")
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(
            runs["mesh"]["losses"], runs["single"]["losses"]))
        if loss_rel > PAR_LOSS_TOL:
            raise AssertionError(f"mesh vs single losses: "
                                 f"{runs['mesh']['losses']} "
                                 f"{runs['single']['losses']}")
        if runs["mesh"]["launches_per_step"] != runs["single"][
                "launches_per_step"]:
            raise AssertionError(f"launches a step differ: "
                                 f"{runs['mesh']['launches_per_step']} vs "
                                 f"{runs['single']['launches_per_step']}")
        if any(n <= 0 for n in par_launches.values()):
            raise AssertionError(f"a kernel never launched: {par_launches}")

        # step 1's gradients, from the shared init (bit-equal)
        from tpu_docker_api_torch.train.trainer import create_train_state

        init_m, _ = create_train_state(
            cfg, dev, torch.Generator(device=dev).manual_seed(0), mesh=mesh)
        init_s, _ = create_train_state(
            cfg, dev, torch.Generator(device=dev).manual_seed(0))
        flat_m = sharding.flatten_paths(init_m.params)
        flat_s = sharding.flatten_paths(init_s.params)
        init_equal = all(torch.equal(flat_m[k].to_local(), flat_s[k])
                         for k in flat_s)
        if not init_equal:
            raise AssertionError("the sharded init differs from the "
                                 "single-device init")
        g_m = _par_grads(dev, cfg, init_m.params, tokens, mesh)
        g_s = _par_grads(dev, cfg, init_s.params, tokens, None)
        grad_rel = {k: _rel_l2(g_m[k].float(), g_s[k].float())
                    for k in g_s}
        del g_m, g_s, init_m, init_s, flat_m, flat_s
        _par_empty_cache(dev)
        if max(grad_rel.values()) > PAR_GRAD_TOL:
            raise AssertionError(f"mesh vs single step-1 gradients: "
                                 f"{grad_rel}")

        # sequence parallelism at sp 1: ring, zigzag and ulysses against
        # the flash path, on the mesh run's trained params
        params = mesh_state.params

        def tree_local(t):
            return ({k: tree_local(v) for k, v in t.items()}
                    if isinstance(t, dict) else sharding.local(t))

        lparams = tree_local(params)
        sp_tokens = tokens[:1, :PAR_SP_SEQ]
        sp = {}
        with torch.no_grad():
            ref = llama_forward(lparams, sp_tokens, dataclasses.replace(
                cfg, attention_impl="flash"), mesh)
            for impl in ("ring", "ring-zigzag", "ulysses"):
                flash.reset_launch_count()
                got = llama_forward(lparams, sp_tokens, dataclasses.replace(
                    cfg, attention_impl=impl), mesh)
                sp[impl] = {"rel_l2": _rel_l2(got, ref),
                            "max_abs_err": (got - ref).abs().max().item(),
                            "flash_launches":
                                flash.launch_count["flash_fwd"]}
                del got
            del ref
        if max(v["rel_l2"] for v in sp.values()) > PAR_LOGIT_TOL:
            raise AssertionError(f"sp=1 logits against flash: {sp}")
        if sp["ulysses"]["flash_launches"] != cfg.n_layers:
            raise AssertionError(f"ulysses did not run flash_fwd: {sp}")
        par_launches["flash_fwd"] += sp["ulysses"]["flash_launches"]

        # the mesh state's checkpoint, restored on the single-device path
        ck = os.path.join(PAR_DIR, "ckpt")
        shutil.rmtree(ck, ignore_errors=True)
        t0 = time.perf_counter()
        mgr = CheckpointManager(ck)
        mgr.save(mesh_state)
        mgr.close()
        save_s = time.perf_counter() - t0
        restored = CheckpointManager(ck).restore(
            cfg, runs["mesh"].pop("optimizer"), device=dev)
        from tpu_docker_api_torch.train.checkpoint import (_file_shape,
                                                           _flatten)

        want: dict = {}
        got: dict = {}
        _flatten(mesh_state.params, "", want, {})
        _flatten(mesh_state.opt_state, "opt/", want, {})
        _flatten(restored.params, "", got, {})
        _flatten(restored.opt_state, "opt/", got, {})
        ckpt_equal = set(want) == set(got) and all(
            torch.equal(sharding.local(want[k]).reshape(
                _file_shape(k, want[k])), got[k]) for k in want)
        del restored, want, got, mesh_state, single_state, params, lparams
        runs["single"].pop("optimizer")
        shutil.rmtree(PAR_DIR, ignore_errors=True)
        _par_empty_cache(dev)
        if not ckpt_equal:
            raise AssertionError("the mesh checkpoint did not restore "
                                 "bit-equal on the single-device path")

        # expert parallelism: one bench-moe step on an --ep 1 mesh, sort
        _, mcfg = resolve_preset(PAR_MOE_PRESET)
        mcfg = dataclasses.replace(mcfg, dispatch_impl="sort")
        moe_tokens = synthetic_batch(
            torch.Generator(device=dev).manual_seed(2), PAR_MOE_BATCH,
            PAR_MOE_SEQ, mcfg.vocab_size)
        emesh = build_mesh(MeshPlan(dp=1, ep=1))
        moe = {}
        for name, m in (("mesh", emesh), ("single", None)):
            from tpu_docker_api_torch.train.trainer import (
                create_train_state as cts, make_train_step)

            st, opt = cts(mcfg, dev, torch.Generator(device=dev)
                          .manual_seed(0), mesh=m)
            st, metrics = make_train_step(mcfg, opt, mesh=m)(st, moe_tokens)
            moe[name] = metrics["loss"].item()
            del st, opt
            _par_empty_cache(dev)
        moe_rel = abs(moe["mesh"] - moe["single"]) / abs(moe["single"])
        if moe_rel > PAR_LOSS_TOL:
            raise AssertionError(f"moe ep 1 vs single: {moe}")

        # serving: --tp 1 (the mirrored slot engine) against one device
        prompt = torch.randint(0, cfg.vocab_size, (PAR_SERVE_PROMPT,),
                               generator=torch.Generator().manual_seed(5)
                               ).tolist()
        base = ["--preset", PAR_PRESET, "--max-seq", str(PAR_SP_SEQ),
                "--slots", "4", "--seed", "0", "--device", dev.type]
        serve = {"single": _par_server(base, prompt),
                 "mesh": _par_server(base + ["--tp", "1"], prompt)}
        if not serve["mesh"]["mesh"] or serve["mesh"]["engine"] != \
                "SlotEngine":
            raise AssertionError(f"--tp 1 did not serve through the slot "
                                 f"engine on a mesh: {serve['mesh']}")
        if serve["mesh"]["tokens"] != serve["single"]["tokens"]:
            raise AssertionError(f"tp 1 stream differs from one device: "
                                 f"{serve}")
        if serve["mesh"]["flash_launches"] <= 0:
            raise AssertionError("the tp 1 server's prefill launched no "
                                 "flash_fwd")
        par_launches["flash_fwd"] += serve["mesh"]["flash_launches"]
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    result = {"phase": "parallel", "world_size": 1, "preset": PAR_PRESET,
              "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": PAR_STEPS,
              "optim": "adamw-int8", "runs": runs,
              "loss_max_rel": loss_rel, "loss_tol": PAR_LOSS_TOL,
              "init_bit_equal": init_equal,
              "grad_max_rel_l2": max(grad_rel.values()),
              "grad_tol": PAR_GRAD_TOL, "sp1": sp,
              "logit_tol": PAR_LOGIT_TOL, "moe": {**moe, "rel": moe_rel},
              "serve": serve, "ckpt_bit_equal": ckpt_equal,
              "ckpt_save_s": save_s, "launches": par_launches,
              "multi_rank_speed": "not measured (one card)",
              "phase_s": time.perf_counter() - t_phase,
              "card": nvidia_smi()}
    emit(result)
    return result


# ---- --pp's 1F1B pipeline on one card (phase_pipeline)
PIPE_MICRO = TRAIN_BATCH   # the CLI's n_micro at dp·fsdp 1: a row each


def pipeline_launches(cfg, n_micro: int, adam8: int) -> dict:
    """The launches one 1F1B step implies on a stage of every layer:
    each microbatch's forward and its recompute in the backward run
    flash_fwd once a layer, the backward dq and dk/dv once a layer;
    adam8 once a leaf (``adam8``: the plain step's count)."""
    L = cfg.n_layers
    return {"flash_fwd": 2 * L * n_micro, "flash_bwd_dq": L * n_micro,
            "flash_bwd_dkv": L * n_micro, "adam8": adam8}


def phase_pipeline(dev, par: dict) -> dict:
    """``--pp``'s path at pp 1 (module docstring): llama3-1b at the
    parallel phase's batch through the trainer CLI's ``pipeline_parts``
    (``make_train_step(grad_fn=pipeline_1f1b_grads)``), held against
    that phase's single-device run of the same steps."""
    import torch.distributed as dist

    from tpu_docker_api_torch.models import resolve_preset
    from tpu_docker_api_torch.parallel import sharding
    from tpu_docker_api_torch.parallel.mesh import MeshPlan, build_mesh
    from tpu_docker_api_torch.train.__main__ import pipeline_parts
    from tpu_docker_api_torch.train.optim import tree_map
    from tpu_docker_api_torch.train.trainer import (create_train_state,
                                                    synthetic_batch)
    from tpu_docker_api_torch.workload.torchenv import bootstrap_torch

    t_phase = time.perf_counter()
    bootstrap_torch(dev.type, force=True)
    try:
        mesh = build_mesh(MeshPlan(dp=1, pp=1))
        _, cfg = resolve_preset(PAR_PRESET)
        # phase_parallel's batch, so its single-device run is the
        # reference
        tokens = synthetic_batch(torch.Generator(device=dev).manual_seed(1),
                                 TRAIN_BATCH, TRAIN_SEQ, cfg.vocab_size)

        # ---- the main path: the counts are zeroed just before its
        # steps and read just after (_par_run)
        run = _par_run(dev, cfg, mesh, tokens, "adamw-int8", pipeline=True)
        launches = dict(run["launches"])
        # ---- end of the main path

        del run["state"], run["optimizer"]
        _par_empty_cache(dev)
        single = par["runs"]["single"]
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(
            run["losses"], single["losses"]))
        want = pipeline_launches(cfg, PIPE_MICRO,
                                 single["launches_per_step"][0]["adam8"])

        # step 1's gradients, from the shared init
        rules, grad_fn = pipeline_parts(cfg, mesh, TRAIN_BATCH)
        init_p, _ = create_train_state(
            cfg, dev, torch.Generator(device=dev).manual_seed(0),
            mesh=mesh, rules=rules)
        _, g_p = grad_fn(tree_map(sharding.local, init_p.params), tokens)
        g_p = sharding.flatten_paths(g_p)
        del init_p
        init_s, _ = create_train_state(
            cfg, dev, torch.Generator(device=dev).manual_seed(0))
        g_s = _par_grads(dev, cfg, init_s.params, tokens, None)
        del init_s
        grad_rel = {k: _rel_l2(g_p[k].float(), g_s[k].float())
                    for k in g_s}
        del g_p, g_s
        _par_empty_cache(dev)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    result = {"phase": "pipeline", "preset": PAR_PRESET, "pp": 1,
              "n_micro": PIPE_MICRO, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
              "steps": PAR_STEPS, "optim": "adamw-int8",
              "losses": run["losses"], "single_losses": single["losses"],
              "loss_max_rel": loss_rel, "loss_tol": PAR_LOSS_TOL,
              "grad_max_rel_l2": max(grad_rel.values()),
              "grad_rel_l2": grad_rel, "grad_tol": PAR_GRAD_TOL,
              "step_ms": run["step_ms"], "single_step_ms": single["step_ms"],
              "step_ms_over_single": (run["step_ms"][-1]
                                      / single["step_ms"][-1]),
              "max_memory_allocated": run["max_memory_allocated"],
              "peak_above_entry": run["peak_above_entry"],
              "single_peak_above_entry": single["peak_above_entry"],
              "launches_per_step": run["launches_per_step"],
              "launches_per_step_expected": want, "launches": launches,
              "bubble_and_sends": "not measured (one card: pp 1)",
              "phase_s": time.perf_counter() - t_phase,
              "card": nvidia_smi()}
    emit(result)
    if loss_rel > PAR_LOSS_TOL:
        raise AssertionError(f"pipeline vs single losses: {run['losses']} "
                             f"{single['losses']}")
    if max(grad_rel.values()) > PAR_GRAD_TOL:
        raise AssertionError(f"pipeline vs single step-1 gradients: "
                             f"{grad_rel}")
    if any(n != want for n in run["launches_per_step"]):
        raise AssertionError(f"pipeline launches a step "
                             f"{run['launches_per_step']}, the schedule "
                             f"implies {want}")
    return result


# ---- the mesh path across every visible card (phase_mesh)
MESH_BATCH = 8                  # global rows of TRAIN_SEQ tokens
MESH_FAMILY_BATCH = {"vit:vit-b16": 128, "encdec:encdec-base": 32}


def mesh_jobs(world: int) -> list[dict]:
    """The multi-rank runs of ``world`` ranks: llama3-1b on pure dp,
    fsdp, tp, fsdp × tp, tp × sp with zigzag ring, sp with zigzag ring
    and with Ulysses (shapes whose kv heads do not split left out), and
    through ``--pp``'s 1F1B pipeline at pp = world, pp 2 × tp and
    pp 2 × dp; bench-moe at ep = world (sort); vit-b16 and encdec-base
    at tp = world (their products split over tp); encdec-base on its
    rings at sp = world and sp 2 × tp."""
    from tpu_docker_api_torch.models import resolve_preset

    _, cfg = resolve_preset(PAR_PRESET)
    half = world // 2
    llama = [({"dp": world}, "auto"), ({"dp": 1, "fsdp": world}, "auto"),
             ({"dp": 1, "tp": world}, "auto")]
    if half > 1:
        llama += [({"dp": 1, "fsdp": 2, "tp": half}, "auto"),
                  ({"dp": 1, "tp": 2, "sp": half}, "ring-zigzag")]
    llama += [({"dp": 1, "sp": world}, "ring-zigzag"),
              ({"dp": 1, "sp": world}, "ulysses")]

    def fits(plan, impl):
        tp = plan.get("tp", 1)
        heads = cfg.n_kv_heads // tp if cfg.n_kv_heads % tp == 0 else 0
        return heads and (impl != "ulysses" or heads % plan["sp"] == 0)

    jobs = [{"preset": PAR_PRESET, "plan": p, "impl": i,
             "optim": "adamw-int8"} for p, i in llama if fits(p, i)]
    # --pp: the 1F1B pipeline through the CLI's pipeline_parts
    pipe = [{"dp": 1, "pp": world}]
    if half > 1:
        pipe += [{"dp": 1, "pp": 2, "tp": half}, {"dp": half, "pp": 2}]
    jobs += [{"preset": PAR_PRESET, "plan": p, "impl": "auto",
              "optim": "adamw-int8", "pipeline": True} for p in pipe
             if cfg.n_layers % p["pp"] == 0 and fits(p, "auto")]
    jobs.append({"preset": PAR_MOE_PRESET, "plan": {"dp": 1, "ep": world},
                 "impl": "sort", "optim": "adamw"})
    for preset in MESH_FAMILY_BATCH:
        jobs.append({"preset": preset, "plan": {"dp": 1, "tp": world},
                     "impl": "auto", "optim": "adamw-int8"})
    # the encoder-decoder's rings: sp over the source and the target
    encdec = "encdec:" + ENCDEC_PRESET
    jobs.append({"preset": encdec, "plan": {"dp": 1, "sp": world},
                 "impl": "auto", "optim": "adamw-int8"})
    if half > 1:
        jobs.append({"preset": encdec, "plan": {"dp": 1, "sp": 2,
                                                "tp": half},
                     "impl": "auto", "optim": "adamw-int8"})
    return jobs


def _mesh_inputs(job: dict, dev):
    """(config, global batch) of a ``mesh_jobs`` run, the same on every
    rank and on the single-device reference."""
    from tpu_docker_api_torch.models import resolve_preset
    from tpu_docker_api_torch.models.encdec import encdec_synthetic_batch
    from tpu_docker_api_torch.models.vit import vit_synthetic_batch
    from tpu_docker_api_torch.train.trainer import synthetic_batch

    family, cfg = resolve_preset(job["preset"])
    gen = torch.Generator(device=dev).manual_seed(1)
    if family == "vit":
        return cfg, vit_synthetic_batch(1, MESH_FAMILY_BATCH[job["preset"]],
                                        cfg, device=dev)
    if family == "encdec":
        return cfg, encdec_synthetic_batch(
            1, MESH_FAMILY_BATCH[job["preset"]], ENCDEC_SEQ, ENCDEC_SEQ,
            cfg, device=dev)
    if family == "moe":
        cfg = dataclasses.replace(cfg, dispatch_impl=job["impl"])
        return cfg, synthetic_batch(gen, PAR_MOE_BATCH, PAR_MOE_SEQ,
                                    cfg.vocab_size)
    cfg = dataclasses.replace(cfg, attention_impl=job["impl"])
    return cfg, synthetic_batch(gen, MESH_BATCH, TRAIN_SEQ, cfg.vocab_size)


def _mesh_prompts(vocab: int, rows: int) -> list:
    g = torch.Generator().manual_seed(5)
    return [torch.randint(0, vocab, (PAR_SERVE_PROMPT,), generator=g)
            .tolist() for _ in range(rows)]


def _par_generate(argv: list, requests: list) -> dict:
    """An in-process ``--slots 0`` server of ``argv``: greedy
    ``requests`` (lists of rows) one after another; their rows' tokens,
    the ms of each and ``/healthz``'s ``meshRows`` (a rank other than 0
    steps with rank 0 and returns {})."""
    from tpu_docker_api_torch.serve.__main__ import Server, parse_args

    srv = Server(parse_args(argv + ["--host", "127.0.0.1", "--port", "0"]))
    if srv.rank != 0:
        srv.follow()
        return {}
    port = srv.httpd.server_address[1]
    thread = threading.Thread(target=srv.httpd.serve_forever, daemon=True)
    thread.start()
    try:
        rows, ms = [], []
        for req in requests:
            t0 = time.perf_counter()
            code, data = _post(port, {"tokens": req,
                                      "maxNewTokens": PAR_SERVE_NEW})
            ms.append((time.perf_counter() - t0) * 1e3)
            if code != 200:
                raise AssertionError(f"/generate answered {code}: "
                                     f"{data[:300]!r}")
            rows += json.loads(data)["tokens"]
        return {"tokens": rows, "ms": ms,
                "mesh_rows": _get(port, "/healthz").get("meshRows")}
    finally:
        srv.httpd.shutdown()
        srv.close()
        thread.join(timeout=30)


def mesh_rank() -> int:
    """One rank of ``phase_mesh`` (``python -m chip_smoke --mesh-rank``,
    started by ``workload/torchenv.py``'s launcher): every
    ``mesh_jobs`` run through ``_par_run``, then ``serve --tp world``
    (the mirrored slot engine) on one 1,900-token greedy request and
    ``serve --dp world --slots 0`` on one request of ``world`` such rows;
    rank 0 writes what it saw to PAR_DIR/mesh.json."""
    import torch.distributed as dist

    from tpu_docker_api_torch.models import resolve_preset
    from tpu_docker_api_torch.parallel.mesh import MeshPlan, build_mesh
    from tpu_docker_api_torch.workload.torchenv import bootstrap_torch

    dev, rank, world = bootstrap_torch("cuda", force=True)
    runs = []
    for job in mesh_jobs(world):
        cfg, batch = _mesh_inputs(job, dev)
        run = _par_run(dev, cfg, build_mesh(MeshPlan(**job["plan"])), batch,
                       job["optim"], pipeline=job.get("pipeline", False))
        del run["state"], run["optimizer"], batch
        runs.append({**job, **run})
        _par_empty_cache(dev)
    _, cfg = resolve_preset(PAR_PRESET)
    base = ["--preset", PAR_PRESET, "--max-seq", str(PAR_SP_SEQ),
            "--seed", "0", "--device", "cuda"]
    prompts = _mesh_prompts(cfg.vocab_size, world)
    tp = (_par_server(base + ["--slots", "4", "--tp", str(world)],
                      prompts[0]) if cfg.n_kv_heads % world == 0 else
          {"skipped": f"{cfg.n_kv_heads} kv heads, {world} ranks"})
    _par_empty_cache(dev)
    dp = _par_generate(base + ["--slots", "0", "--dp", str(world)],
                       [prompts])
    dist.barrier()
    dist.destroy_process_group()
    if rank == 0:
        with open(os.path.join(PAR_DIR, "mesh.json"), "w") as f:
            json.dump({"world": world, "runs": runs, "serve_tp": tp,
                       "serve_dp": dp}, f)
    return 0


def phase_mesh(dev) -> dict:
    """The mesh path on every visible card against this process's card
    alone: ``mesh_rank`` on each card, then the same runs and requests
    on the single-device path here. Hard: every run's losses within
    PAR_LOSS_TOL of one card's, the ``--dp`` rows split one a rank and
    equal to one card's generation of each row alone. The tp server's
    stream is reported against one card's (bf16 partial sums reduced
    over tp may round otherwise)."""
    from tpu_docker_api_torch.models import resolve_preset
    from tpu_docker_api_torch.workload.torchenv import launch_workers

    t0 = time.perf_counter()
    world = torch.cuda.device_count()
    os.makedirs(PAR_DIR, exist_ok=True)
    path = os.path.join(PAR_DIR, "mesh.json")
    if os.path.exists(path):
        os.remove(path)
    code = launch_workers("chip_smoke", ["--mesh-rank"], world, "cuda")
    if code:
        raise AssertionError(f"a mesh rank exited with {code}")
    with open(path) as f:
        got = json.load(f)
    ranks_s = time.perf_counter() - t0
    single: dict = {}
    rows = []
    for run in got["runs"]:
        # one card runs llama on its own attention rule (flash)
        job = {**run, "impl": ("auto" if run["preset"] == PAR_PRESET
                               else run["impl"])}
        key = (job["preset"], job["impl"], job["optim"])
        if key not in single:
            cfg, batch = _mesh_inputs(job, dev)
            ref = _par_run(dev, cfg, None, batch, run["optim"])
            del ref["state"], ref["optimizer"], batch
            single[key] = ref
            _par_empty_cache(dev)
        ref = single[key]
        rel = max(abs(a - b) / abs(b) for a, b in zip(run["losses"],
                                                       ref["losses"]))
        rows.append({"preset": run["preset"], "plan": run["plan"],
                     "impl": run["impl"],
                     "pipeline": run.get("pipeline", False),
                     "losses": run["losses"],
                     "step_ms": run["step_ms"],
                     "max_memory_allocated": run["max_memory_allocated"],
                     "peak_above_entry": run["peak_above_entry"],
                     "launches_per_step": run["launches_per_step"][-1],
                     "single_step_ms": ref["step_ms"],
                     "single_max_memory_allocated":
                         ref["max_memory_allocated"],
                     "single_peak_above_entry": ref["peak_above_entry"],
                     "loss_max_rel": rel})
    _, cfg = resolve_preset(PAR_PRESET)
    base = ["--preset", PAR_PRESET, "--max-seq", str(PAR_SP_SEQ),
            "--seed", "0", "--device", "cuda"]
    prompts = _mesh_prompts(cfg.vocab_size, world)
    tp = got["serve_tp"]
    if "tokens" in tp:
        one = _par_server(base + ["--slots", "4"], prompts[0])
        tp.update(single_tokens=one["tokens"],
                  equal_tokens=sum(a == b for a, b in zip(tp["tokens"],
                                                          one["tokens"])),
                  single_ttft_p50_ms=one["ttft_p50_ms"],
                  single_itl_p50_ms=one["itl_p50_ms"])
    dp = got["serve_dp"]
    one = _par_generate(base + ["--slots", "0"], [[p] for p in prompts])
    dp.update(single_tokens=one["tokens"], single_ms=one["ms"])
    res = {"phase": "mesh", "world": world, "runs": rows, "serve_tp": tp,
           "serve_dp": dp, "loss_tol": PAR_LOSS_TOL,
           "ranks_s": ranks_s, "seconds": time.perf_counter() - t0,
           "card": nvidia_smi()}
    emit(res)
    bad = [r for r in rows if r["loss_max_rel"] > PAR_LOSS_TOL]
    if bad:
        raise AssertionError(f"mesh losses off one card's: {bad}")
    if dp["mesh_rows"] != [1] * world or dp["tokens"] != one["tokens"]:
        raise AssertionError(f"--dp {world} rows not split one a rank, or "
                             f"not one card's: {dp}")
    return res


def main() -> int:
    """No arguments: every phase on the first card (``phase_mesh`` too
    where more than one card is visible). ``--mesh``: the build and
    ``phase_mesh`` alone. ``--mesh-rank``: one of its ranks."""
    args = sys.argv[1:]
    if args == ["--mesh-rank"]:
        return mesh_rank()
    if args not in ([], ["--mesh"]):
        print(f"chip_smoke: unknown arguments {args}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    try:
        from tpu_docker_api_torch import _build
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    read_card_peaks(dev)
    card = nvidia_smi()
    emit({"phase": "env", "nvidia_smi": card, "python": sys.version,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count()})
    t0 = time.perf_counter()
    info = _build.build_all()
    build_s = time.perf_counter() - t0
    # the bf16 flash kernels (flash_fwd_kernel_tc, flash_bwd_dq_kernel_tc,
    # flash_bwd_dkv_kernel_tc) must run on the tensor cores: wgmma (HGMMA)
    # in each one's machine code
    sass = {name: _build.sass_counts(name) for name in _build.KERNELS}
    tc_kernels = {fn: counts for name in ("flash_fwd", "flash_bwd")
                  for fn, counts in _build.sass_counts_by_function(
                      name).items() if "_kernel_tc" in fn}
    emit({"phase": "build", "seconds": build_s, "kernels": info,
          "tensor_core_instructions": sass,
          "tensor_core_kernels": tc_kernels})
    if len(tc_kernels) != 6 or not all(c["HGMMA"]
                                       for c in tc_kernels.values()):
        raise AssertionError(f"a bf16 flash kernel (3 kernels x 2 head "
                             f"dims) has no wgmma: {tc_kernels}")
    for name in ("flash_fwd", "flash_bwd"):
        # ptxas's C75xx notes: wgmma it had to serialize (a slower
        # kernel, and no error otherwise)
        notes = [ln for ln in info.get(name, {}).get("ptxas", [])
                 if "(C75" in ln]
        if notes:
            raise AssertionError(f"{name}: ptxas serialized wgmma: {notes}")
    if args == ["--mesh"]:
        if torch.cuda.device_count() < 2:
            raise AssertionError("--mesh needs more than one card")
        phase_mesh(dev)
        print(card, flush=True)
        return 0
    devices_res = phase_devices(dev)
    control_res = phase_control_plane(dev)
    reconcile_res = phase_reconcile(dev)
    fwd_res = phase_kernels(dev)
    bwd_res = phase_flash_bwd(dev)
    adam_res = phase_adam8(dev)
    serve_res = phase_serve(dev)
    int8_res = phase_serve_int8_text(dev, serve_res)
    depth_res = phase_serve_depth(dev)
    spec_res = phase_speculative(dev)
    bench_res = phase_servebench(dev)
    train_res = phase_train(dev)
    life_res = phase_lifecycle(dev)
    lora_res = phase_lora(dev, train_res, int8_res)
    moe_res = phase_moe(dev)
    vit_res = phase_vit(dev)
    encdec_res = phase_encdec(dev)
    par_res = phase_parallel(dev)
    par_n = par_res["launches"]
    pipe_n = phase_pipeline(dev, par_res)["launches"]
    if torch.cuda.device_count() > 1:
        phase_mesh(dev)
    train_n, life_n = train_res["launches"], life_res["launches"]
    lora_n, moe_n = lora_res["launches"], moe_res["launches"]
    vit_n, encdec_n = vit_res["launches"], encdec_res["launches"]
    by_path = {
        "flash_fwd": {"devices": devices_res["flash_launches"],
                      "control_plane": control_res["flash_launches"],
                      "reconcile": reconcile_res["flash_launches"],
                      "serve": serve_res["flash_launches"],
                      "serve_int8_text": int8_res["flash_launches"],
                      "serve_depth": depth_res["flash_launches"],
                      "speculative": spec_res["flash_launches"],
                      "servebench": bench_res["flash_launches"],
                      "train": train_n["flash_fwd"],
                      "lifecycle": life_n["flash_fwd"],
                      "lora": lora_n["flash_fwd"],
                      "moe": moe_n["flash_fwd"],
                      "vit": vit_n["flash_fwd"],
                      "encdec": encdec_n["flash_fwd"],
                      "parallel": par_n["flash_fwd"],
                      "pipeline": pipe_n["flash_fwd"]},
        **{name: {"train": train_n[name], "lifecycle": life_n[name],
                  "lora": lora_n[name], "moe": moe_n[name],
                  "vit": vit_n[name], "encdec": encdec_n[name],
                  "parallel": par_n[name], "pipeline": pipe_n[name]}
           for name in ("flash_bwd_dq", "flash_bwd_dkv", "adam8")}}
    rows = [
        ("flash_fwd", "tpu_docker_api_torch/csrc/flash_fwd.cu",
         "tpu_docker_api/ops/flash_pallas.py:95", fwd_res),
        ("flash_bwd_dq", "tpu_docker_api_torch/csrc/flash_bwd.cu",
         "tpu_docker_api/ops/flash_pallas.py:164", bwd_res["flash_bwd_dq"]),
        ("flash_bwd_dkv", "tpu_docker_api_torch/csrc/flash_bwd.cu",
         "tpu_docker_api/ops/flash_pallas.py:205", bwd_res["flash_bwd_dkv"]),
        ("adam8", "tpu_docker_api_torch/csrc/adam8.cu",
         "tpu_docker_api/train/optim.py:103", adam_res),
    ]
    for name, _, _, _ in rows:
        for path, n in by_path[name].items():
            if n <= 0:
                raise AssertionError(f"{name} never launched on the {path} "
                                     f"path")
    emit({"kernels": [{
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": sum(by_path[name].values()),
        "launches_by_path": by_path[name],
        "max_abs_err": res["max_abs_err"], "ms": res["ms"],
        "host_us": res["host_us"], "ms_back_to_back": res["ms_back_to_back"],
        "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
        "bound_by": res["bound_by"], "library_ms": res["library_ms"],
        **({"at_train_shape": res["at_train_shape"]}
           if "at_train_shape" in res else {})}
        for name, source, replaces, res in rows]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    # a fatal signal (a fault in a kernel or in CUDA) prints the stack
    faulthandler.enable()
    try:
        sys.exit(main())
    except Exception as e:  # every failed check or phase: exit 1, say why
        traceback.print_exc()
        print(f"chip_smoke: failed: {type(e).__name__}: {e}"[:2000],
              file=sys.stderr, flush=True)
        sys.exit(1)
