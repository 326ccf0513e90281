"""Inference-serving entry point of the port (counterpart of
``tpu_docker_api/serve/__main__.py``): Llama presets and the ``moe:``
and ``encdec:`` families (``vit:`` has no generative serving path).

    python -m tpu_docker_api_torch.serve --preset llama3-1b --port 8000 \
        [--ckpt-dir CKPT | --hf-ckpt HF_DIR] [--quantize] [--tokenizer TOK]
    python -m tpu_docker_api_torch.serve --device cpu --preset tiny
    python -m tpu_docker_api_torch.serve --device cpu --preset tiny \
        --draft-preset tiny --n-spec 4
    python -m tpu_docker_api_torch.serve --device cpu --preset moe:moe-tiny
    python -m tpu_docker_api_torch.serve --device cpu --preset encdec:tiny

HTTP surface (stdlib server):

    GET  /healthz   → {"status": "ok", "model": ..., "step": ...,
                       "quantized": ..., "tokenizer": ...,
                       "slotEngine": {...}}
    GET  /metrics   → Prometheus text: serve_ttft_seconds and
                      serve_itl_seconds histograms per completed request,
                      serve_tokens_emitted_total, serve_requests_completed_total,
                      and with a paged cache serve_pages_free and
                      serve_deferred_admissions_total
    POST /prefixes  {"tokens": [...]} (or, with a tokenizer, {"text": "..."})
                    → {"prefixId", "length"}: a shared prompt prefix;
                      /generate prompts starting with it prefill only the
                      suffix
    GET  /prefixes  → {"prefixes": [{"id", "length", "bytes"}]}
    DELETE /prefixes/{id} → {"removed": bool}
    POST /generate  → {"tokens": [[...]], "lengths": [...]}
        body: {"tokens": [[...prompt ids...]], "maxNewTokens": 64,
               "temperature": 0.8, "topK": 0, "topP": 1.0, "eosId": 2,
               "stream": false}
        "stream": true (one prompt row, slot path only) answers with
        chunked ndjson: {"t": token} per token, then
        {"done": true, "length": n}.
        With a tokenizer (--tokenizer, or the tokenizer.json of
        --hf-ckpt), "text": ["..."] replaces the token rows: the reply
        adds the decoded "texts" (a stream's done line its "text"), and
        eosId defaults to the tokenizer's (an explicit eosId wins).

Requests stream through the continuous-batching slot engine
(infer/slots.py) by default; rows in one body may be ragged, each row is
its own request. ``--prefill-chunk N`` admits longer prompts in N-token
segments between decode chunks; ``--page-size P [--total-pages N]``
serves from a paged KV cache (infer/paged.py). ``--draft-preset NAME
[--draft-ckpt DIR] [--n-spec K]`` serves greedy requests through the
speculative slot engine (a draft proposes K tokens a round, the target
verifies them in one forward; ``/healthz`` shows ``speculative`` and
``nSpec``), and sampled requests through the ``--slots 0`` path.
``--slots 0`` serves through ``make_generate_fn`` instead, one
generation at a time, with equal-length rows (and no /prefixes).

Weights: ``--ckpt-dir`` restores the params of a training checkpoint's
latest step (params only; its step shows in ``/healthz``), ``--hf-ckpt``
imports an HF-layout llama checkpoint (geometry from its
``config.json``, the model's name from the directory's), and without
either the weights are random (``--seed``). The two are exclusive.
``--quantize`` serves int8 projections (ops/quant.py): with ``--hf-ckpt``
they are quantized while they load, otherwise the loaded tree is
quantized after; projection fusion runs after either. ``--lora-ckpt``
serves trained LoRA adapters (train/lora.py) over those weights, in the
JAX load order: merged into the float base before any quantization
(``--lora-forward merged``, the default), or attached unmerged after it
(``attached``: with ``--quantize``, the numerics of ``train --qlora``;
such a tree is not fused). A ``moe:NAME`` preset (models/moe.py) serves
through the same slot engine, ``/prefixes``, ``--prefill-chunk``,
``--ckpt-dir`` and ``--slots 0``; as in JAX, ``--quantize``,
``--page-size`` and ``--draft-preset`` take Llama presets only, and
projection fusion applies to Llama trees only. An ``encdec:NAME`` preset
(models/encdec.py) serves seq2seq: ``/generate`` bodies carry
``srcTokens`` rows (ragged, each its own request) in place of ``tokens``,
decoded from BOS through the encoder-decoder slot engine
(infer/encdec_slots.py; no /prefixes, no ``--prefill-chunk`` and no
``--draft-preset``, as in JAX), or with ``--slots 0`` through
``encdec_generate`` with equal-length rows (``lengths`` only with an
``eosId``).

Meshes (``--dp --fsdp --tp``, one process a device; parallel/): given
any of them, or started as one rank of a larger job, the server loads
its weights as shards (random from ``--seed``, or ``--ckpt-dir``
restored into them, whatever mesh wrote it). Rank 0 answers HTTP; one
command started without ``RANK`` starts a rank for every visible GPU,
or ``--nproc-per-node N`` gloo ranks with ``--device cpu``. A tp/fsdp
mesh serves llama and moe presets through the slot engine (the cache's
kv heads split over tp, slots replicated; dense or ``--page-size``),
every rank stepping it in lockstep with rank 0 (infer/mirror.py). A dp
mesh, an ``encdec:`` preset and ``--slots 0`` serve through the
``--slots 0`` path: every rank holds the weights gathered whole, and
the rows of each request split over the ranks (``Server.generate``;
``/healthz`` counts each rank's rows as ``meshRows``). ``--quantize``, ``--hf-ckpt``,
``--lora-ckpt`` and ``--draft-preset`` are single-device only. Flags of the JAX
entry point that the port does not have yet are refused with the ROADMAP
item that brings them. Runs on ``cuda`` unless ``--device cpu`` is
given.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import torch

from tpu_docker_api_torch import resolve_device
from tpu_docker_api_torch.telemetry.metrics import MetricsRegistry

#: JAX-CLI flags the port does not take yet → what brings them
_NOT_PORTED = {
    "it selects a JAX platform; use --device": ("platform",),
    "it makes JAX CPU devices; use --device cpu --nproc-per-node N":
        ("virtual_devices",),
}

#: the mesh axes the server takes
MESH_FLAGS = ("dp", "fsdp", "tp")


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m tpu_docker_api_torch.serve")
    p.add_argument("--preset", default="llama3-1b")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max-seq", type=int, default=0,
                   help="0 = model default")
    p.add_argument("--slots", type=int, default=8,
                   help="continuous-batching slots (0 disables the slot "
                        "engine)")
    p.add_argument("--chunk", type=int, default=8,
                   help="decode steps per slot-engine dispatch")
    p.add_argument("--prefill-chunk", type=int, default=0,
                   help="> 0: prompts longer than this prefill in "
                        "segments interleaved with decode (bounds the "
                        "stall a long admission inflicts on active "
                        "streams); 0 = whole-prompt admission")
    p.add_argument("--page-size", type=int, default=0,
                   help="> 0: paged KV cache (infer/paged.py) — the slot "
                        "cache becomes a page pool and its memory follows "
                        "--total-pages instead of slots x max-seq; "
                        "/prefixes (refcounted shared pages) and "
                        "--prefill-chunk (page-aware segments) compose")
    p.add_argument("--total-pages", type=int, default=0,
                   help="pool size in pages (0 = dense-equivalent "
                        "capacity); only with --page-size")
    p.add_argument("--max-prefix-bytes", type=int, default=256 * 2**20,
                   help="device-memory budget of POST /prefixes K/V in "
                        "bytes (0 = unbounded); a registration past it "
                        "gets a 400")
    p.add_argument("--no-fuse-proj", action="store_true",
                   help="disable the default q|k|v and gate|up projection "
                        "fusion (for A/B measurement)")
    p.add_argument("--device", default="cuda",
                   help="torch device to serve on (cuda, cuda:N or cpu)")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights")
    p.add_argument("--ckpt-dir", default="",
                   help="training checkpoint to serve (its latest step, "
                        "params only); '' serves random weights")
    p.add_argument("--hf-ckpt", default="",
                   help="HF-layout llama checkpoint dir (config.json + "
                        "safetensors); its config.json sets the geometry "
                        "and --preset is ignored")
    p.add_argument("--quantize", action="store_true",
                   help="serve int8 projections (quantized while an "
                        "--hf-ckpt loads, else after the load)")
    p.add_argument("--tokenizer", default="",
                   help="tokenizer.json, or a directory with one: "
                        "/generate also takes {\"text\": [...]} and "
                        "replies with decoded \"texts\". Defaults to "
                        "--hf-ckpt's tokenizer.json when present")
    p.add_argument("--lora-ckpt", default="",
                   help="adapter-only checkpoint dir (train --lora-rank): "
                        "its latest adapters are merged into the base at "
                        "load, or attached unmerged (--lora-forward "
                        "attached); --lora-rank/--lora-alpha/"
                        "--lora-targets must match training")
    p.add_argument("--lora-rank", type=int, default=0)
    p.add_argument("--lora-alpha", type=float, default=16.0)
    p.add_argument("--lora-targets", default="wq,wv")
    p.add_argument("--lora-forward", default="merged",
                   choices=["merged", "attached"],
                   help="merged: fold the adapters into the bf16 base "
                        "before any --quantize; attached: quantize first, "
                        "then evaluate Wx + s·B(Ax) unmerged (QLoRA's "
                        "training numerics)")
    p.add_argument("--draft-preset", default="",
                   help="serve speculatively with this (smaller) llama "
                        "preset as the draft model: greedy requests go "
                        "through the speculative slot engine, sampled "
                        "ones through the --slots 0 path")
    p.add_argument("--draft-ckpt", default="",
                   help="training checkpoint of the draft (its latest "
                        "step, params only); '' = random weights")
    p.add_argument("--n-spec", type=int, default=4,
                   help="draft tokens proposed per speculative round")
    for name in MESH_FLAGS:
        p.add_argument("--" + name, type=int, default=None,
                       help="mesh axis size (dp -1 = the ranks left); any "
                            "of them serves on a mesh")
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
    if args.total_pages and not args.page_size:
        p.error("--total-pages requires --page-size (the dense engine has "
                "no page pool)")
    if args.hf_ckpt and args.ckpt_dir:
        p.error("--hf-ckpt and --ckpt-dir are exclusive")
    family = (args.preset.partition(":")[0] if ":" in args.preset
              and not args.hf_ckpt else "llama")
    if family == "vit":
        p.error("vit presets have no generative serving path")
    if family == "encdec":
        if args.prefill_chunk:
            p.error("--prefill-chunk does not apply to seq2seq admission "
                    "(sources are bounded by max_src_len)")
        if args.draft_preset:
            p.error("--draft-preset is not supported with encdec presets")
    if family != "llama":
        if args.quantize:
            p.error("--quantize currently supports llama presets only")
        if args.page_size:
            p.error("--page-size requires a llama preset (paged engine v1 "
                    "scope)")
    if not args.lora_ckpt and (
            args.lora_rank > 0 or args.lora_alpha != 16.0
            or args.lora_targets != "wq,wv"
            or args.lora_forward != "merged"):
        # a LoRA flag without --lora-ckpt would serve the bare base
        p.error("--lora-rank/--lora-alpha/--lora-targets/--lora-forward "
                "require --lora-ckpt")
    if args.draft_preset:
        if args.page_size:
            p.error("--page-size and --draft-preset are exclusive (the "
                    "speculative engine uses the dense cache)")
        if any(spec.partition(":")[1] for spec in (args.preset,
                                                   args.draft_preset)):
            p.error("--draft-preset requires llama presets (target and "
                    "draft) on a single device")
        if args.prefill_chunk:
            p.error("--prefill-chunk is not supported with --draft-preset "
                    "(speculative segments would fill the target cache "
                    "only)")
    elif args.draft_ckpt or args.n_spec != 4:
        # either flag alone would serve plainly, without a draft
        p.error("--draft-ckpt/--n-spec require --draft-preset")
    if args.lora_ckpt and args.lora_rank < 1:
        p.error("--lora-ckpt requires --lora-rank (the rank the adapters "
                "were trained at)")
    if args.nproc_per_node > 1 and args.device != "cpu":
        p.error("--nproc-per-node is for --device cpu (on cuda one rank "
                "starts for every visible GPU)")
    if mesh_wanted(args):
        given = [f for f, on in (("--quantize", args.quantize),
                                 ("--hf-ckpt", args.hf_ckpt),
                                 ("--lora-ckpt", args.lora_ckpt),
                                 ("--draft-preset", args.draft_preset)) if on]
        if given:
            p.error(f"{', '.join(given)}: single-device only in the PyTorch "
                    f"package (no mesh)")
    return args


def mesh_wanted(args) -> bool:
    """The mesh path: a mesh flag given, or more than one rank."""
    from tpu_docker_api_torch.workload.torchenv import world_size

    return (any(getattr(args, a) is not None for a in MESH_FLAGS)
            or args.nproc_per_node > 1 or world_size() > 1)


def _as_int(value, field: str) -> int:
    """A JSON request field that must be an integer: no bool, no
    non-integral number, no digit string."""
    if (isinstance(value, bool) or not isinstance(value, (int, float))
            or int(value) != value):
        raise ValueError(f"{field} must be an integer")
    return int(value)


class Server:
    """A bound HTTP server with its model, engine and metrics. ``httpd``
    is ready for ``serve_forever``; :meth:`close` stops the engine."""

    def __init__(self, args: argparse.Namespace):
        from tpu_docker_api_torch.infer.quantize import (
            fuse_llama_projections, quantize_llama_params)
        from tpu_docker_api_torch.infer.slots import SlotEngine
        from tpu_docker_api_torch.models import model_fns, resolve_preset

        self.args = args
        #: on a mesh: the mesh, this rank, and the engine's mirror
        self.mesh, self.rank, self.mirror = None, 0, None
        if mesh_wanted(args):
            from tpu_docker_api_torch.parallel.mesh import (MeshPlan,
                                                            build_mesh)
            from tpu_docker_api_torch.workload.torchenv import (
                bootstrap_torch)

            self.device, self.rank, _ = bootstrap_torch(args.device,
                                                        force=True)
            self.mesh = build_mesh(MeshPlan(**{
                a: getattr(args, a) for a in MESH_FLAGS
                if getattr(args, a) is not None}))
        else:
            self.device = resolve_device(args.device)
        #: the checkpoint step served (0 for HF and random weights)
        self.step = 0
        # the JAX load order: a merged --lora-ckpt folds into the float
        # base before the (lossy) quantization; the attached forward
        # quantizes first (QLoRA's training numerics), then wraps
        attached = bool(args.lora_ckpt) and args.lora_forward == "attached"
        quantized = False
        family = "llama"
        if args.hf_ckpt:
            from tpu_docker_api_torch.models.import_weights import (
                hf_llama_config, import_hf_llama)

            cfg = hf_llama_config(args.hf_ckpt)
            args.preset = os.path.basename(os.path.normpath(args.hf_ckpt))
            quantized = args.quantize and (not args.lora_ckpt or attached)
            _, params = import_hf_llama(args.hf_ckpt, cfg,
                                        device=self.device,
                                        quantize=quantized)
        else:
            family, cfg = resolve_preset(args.preset)
            if args.ckpt_dir:
                from tpu_docker_api_torch.train.checkpoint import (
                    restore_model_params)

                params, self.step = restore_model_params(
                    args.ckpt_dir, cfg, self.device, mesh=self.mesh)
            else:
                init_fn, _, rules = model_fns(cfg)
                gen = torch.Generator(device=self.device).manual_seed(
                    args.seed)
                if self.mesh is None:
                    params = init_fn(cfg, gen)
                else:
                    from tpu_docker_api_torch.parallel import sharding

                    params = init_fn(cfg, gen, place=lambda path, t: (
                        sharding.distribute(
                            t, sharding.spec_for(path, rules), self.mesh)))
        self.cfg = cfg
        slot_mesh = (self.mesh is not None and args.slots > 0
                     and family in ("llama", "moe")
                     and self.mesh.shape["dp"] == 1)
        if self.mesh is not None:
            params = self._mesh_params(params, cfg, slot_mesh)
        if args.lora_ckpt:
            from tpu_docker_api_torch.train.lora import (attach_lora,
                                                         merge_lora,
                                                         restore_adapters)

            targets = tuple(t.strip() for t in args.lora_targets.split(",")
                            if t.strip())
            adapters = restore_adapters(args.lora_ckpt, cfg, self.device,
                                        args.lora_rank, targets)
            if attached:
                if args.quantize and not quantized:
                    params = quantize_llama_params(params)
                    quantized = True
                params = attach_lora(params, adapters, args.lora_alpha)
            else:
                params = merge_lora(params, adapters, args.lora_alpha)
            del adapters
        if args.quantize and not quantized:
            params = quantize_llama_params(params)
        # fusion concatenates the projections an attached tree keeps
        # apart (its adapters hang off the unfused leaves); it is
        # Llama-shaped (an MoE tree has no dense gate|up to fuse)
        if (family == "llama" and not args.no_fuse_proj and not attached
                and self.mesh is None):
            params = fuse_llama_projections(params)
        self.params = params
        tok_path = args.tokenizer
        if not tok_path and args.hf_ckpt and os.path.exists(
                os.path.join(args.hf_ckpt, "tokenizer.json")):
            tok_path = args.hf_ckpt
        self.tokenizer = None
        if tok_path:
            from tpu_docker_api_torch.models.tokenizer import load_tokenizer

            self.tokenizer = load_tokenizer(tok_path)
        self.family = family
        self.max_seq = args.max_seq or (cfg.max_tgt_len
                                        if family == "encdec"
                                        else cfg.max_seq_len)
        self.metrics = MetricsRegistry()
        self.engine = None
        seed = int.from_bytes(os.urandom(4), "little")
        if self.mesh is not None:
            from tpu_docker_api_torch.infer.mirror import Mirror

            self.mirror = Mirror()
            seed = self.mirror.broadcast(seed)  # one engine seed a job
        if args.slots > 0 and (self.mesh is None or slot_mesh):
            common = dict(
                slots=args.slots, max_seq=self.max_seq, chunk=args.chunk,
                prefill_chunk=args.prefill_chunk, cache_dtype=cfg.dtype,
                # shed load once the queue is 8x the slot count deep
                max_pending=args.slots * 8, seed=seed)
            if slot_mesh:
                common.update(mesh=self.mesh, mirror=self.mirror)
            if family == "encdec":
                from tpu_docker_api_torch.infer.encdec_slots import (
                    EncDecSlotEngine)

                self.engine = EncDecSlotEngine(cfg, params, **common)
            elif args.draft_preset:
                from tpu_docker_api_torch.infer.slots import (
                    SpeculativeSlotEngine)

                draft_cfg, draft_params = self._load_draft(args)
                self.engine = SpeculativeSlotEngine(
                    cfg, params, draft_cfg=draft_cfg,
                    draft_params=draft_params, n_spec=args.n_spec, **common)
            elif args.page_size > 0:
                from tpu_docker_api_torch.infer.paged import PagedSlotEngine

                self.engine = PagedSlotEngine(
                    cfg, params, page_size=args.page_size,
                    total_pages=args.total_pages or None, **common)
            else:
                self.engine = SlotEngine(
                    cfg, params, max_prefix_bytes=args.max_prefix_bytes,
                    **common)
            self._wire_metrics(self.engine)
            if self.rank == 0:
                self.engine.start()
        self._fns: dict[tuple, object] = {}
        self._gen_lock = threading.Lock()  # one legacy generation at a time
        self._rng = torch.Generator(device=self.device).manual_seed(
            int.from_bytes(os.urandom(4), "little"))
        #: on a mesh: the ``--slots 0`` rows each rank generated
        self.mesh_rows = [0] * (self.mesh.size if self.mesh else 0)
        self.httpd = None
        if self.rank == 0:
            self.httpd = ThreadingHTTPServer((args.host, args.port),
                                             _make_handler(self))

    def _mesh_params(self, params, cfg, slot_mesh: bool) -> dict:
        """The tree a rank serves from on a mesh: its local shards for
        the mirrored slot engine; for the ``--slots 0`` path, whose rows
        split over the ranks, the weights gathered whole."""
        from tpu_docker_api_torch.parallel import sharding

        def walk(tree, fn):
            if isinstance(tree, dict):
                return {k: walk(v, fn) for k, v in tree.items()}
            return fn(tree)

        if slot_mesh:
            return walk(params, sharding.local)
        return walk(params, sharding.full_tensor)

    def follow(self) -> None:
        """A rank other than 0: step the mirrored engine with rank 0, or
        generate its rows of each ``--slots 0`` request rank 0 sends,
        until rank 0 stops the job."""
        if self.engine is not None:
            self.engine.follow()
            return
        while True:
            msg = self.mirror.broadcast(None)
            if msg.get("stop"):
                return
            self._gather_rows(self._my_rows(msg))

    def generate(self, key: tuple, prompts: list) -> dict:
        """The ``--slots 0`` generation of ``prompts`` (equal-length token
        rows) under the sampling config ``key``, as lists. On a mesh rank
        0 sends the request to every rank, each generates its contiguous
        block of the rows on its whole copy of the weights (the rows
        split over the ranks, as JAX splits the batch over dp), and rank
        0 joins the blocks in rank order."""
        fn = self.generate_fn(*key)   # checks the arguments on rank 0
        with self._gen_lock:
            if self.mesh is None:
                out = fn(self.params, torch.tensor(
                    prompts, dtype=torch.long, device=self.device),
                    self._rng)
                return {k: v.tolist() for k, v in out.items()}
            msg = {"gen": key, "prompts": prompts,
                   "seed": int.from_bytes(os.urandom(4), "little")}
            self.mirror.broadcast(msg)
            parts = self._gather_rows(self._my_rows(msg))
            out: dict = {}
            for r, part in enumerate(parts):
                if "error" in part:   # a bad request stays a 400
                    kind = ValueError if part["kind"] == "ValueError" \
                        else RuntimeError
                    raise kind(f"rank {r}: {part['error']}")
                self.mesh_rows[r] += part.pop("rows")
                for k, v in part.items():
                    out.setdefault(k, []).extend(v)
        return out

    def _my_rows(self, msg: dict) -> dict:
        """This rank's block of ``msg``'s rows, generated: its lists and
        ``rows``, or ``error`` and its ``kind``."""
        import torch.distributed as dist

        world, prompts = dist.get_world_size(), msg["prompts"]
        lo = self.rank * len(prompts) // world
        hi = (self.rank + 1) * len(prompts) // world
        if lo == hi:
            return {"rows": 0}
        try:
            gen = torch.Generator(device=self.device).manual_seed(
                msg["seed"] + self.rank)
            out = self.generate_fn(*msg["gen"])(self.params, torch.tensor(
                prompts[lo:hi], dtype=torch.long, device=self.device), gen)
            return {"rows": hi - lo, **{k: v.tolist() for k, v in out.items()}}
        except Exception as e:  # noqa: BLE001 — rank 0 reports it
            return {"error": str(e), "kind": type(e).__name__}

    def _gather_rows(self, part: dict):
        """Every rank's part on rank 0 (None elsewhere)."""
        import torch.distributed as dist

        parts = ([None] * dist.get_world_size() if self.rank == 0
                 else None)
        dist.gather_object(part, parts, dst=0, group=self.mirror.group)
        return parts

    def _load_draft(self, args) -> tuple:
        """The draft's config and params: ``--draft-ckpt`` restored, else
        random weights from seed 0 (the JAX server's ``PRNGKey(0)``), so
        a draft of the target's preset at ``--seed 0`` is the target
        itself. Projections fuse as the target's do."""
        from tpu_docker_api_torch.infer.quantize import fuse_llama_projections
        from tpu_docker_api_torch.models import model_fns, resolve_preset

        _, draft_cfg = resolve_preset(args.draft_preset)
        if args.draft_ckpt:
            from tpu_docker_api_torch.train.checkpoint import (
                restore_model_params)

            draft_params, _ = restore_model_params(args.draft_ckpt,
                                                   draft_cfg, self.device)
        else:
            init_fn, _, _ = model_fns(draft_cfg)
            draft_params = init_fn(draft_cfg, torch.Generator(
                device=self.device).manual_seed(0))
        if not args.no_fuse_proj:
            draft_params = fuse_llama_projections(draft_params)
        return draft_cfg, draft_params

    def _wire_metrics(self, engine) -> None:
        reg = self.metrics

        def slo_hook(ttft, itl, n_tokens):
            reg.observe("serve_ttft_seconds", ttft,
                        help="submit to first host-resolved token, per "
                             "request")
            if itl is not None:
                reg.observe("serve_itl_seconds", itl,
                            help="mean inter-token gap per request "
                                 "(chunk-granular cadence)")
            reg.counter_inc("serve_tokens_emitted_total", value=n_tokens,
                            help="tokens emitted by completed requests")

        engine.metrics_hook = slo_hook
        reg.counter_fn("serve_requests_completed_total",
                       lambda: engine.stats["completed"],
                       help="requests completed by the slot engine")
        if "pages_free" in engine.stats:
            reg.gauge_fn("serve_pages_free",
                         lambda: engine.stats["pages_free"],
                         help="free pages in the paged KV pool")
            reg.counter_fn("serve_deferred_admissions_total",
                           lambda: engine.stats["deferred_admissions"],
                           help="admissions deferred on pool pressure")

    def generate_fn(self, max_new: int, temperature: float, top_k: int,
                    top_p: float, eos_id: int | None):
        """``make_generate_fn`` (encdec: ``encdec_generate``) for the
        legacy path, cached per sampling config (bounded: 16 entries,
        oldest evicted)."""
        from tpu_docker_api_torch.infer.engine import (GenerateConfig,
                                                       make_generate_fn)

        key = (max_new, temperature, top_k, top_p, eos_id)
        fn = self._fns.get(key)
        if fn is None:
            if self.family == "encdec":
                fn = self._encdec_generate_fn(*key)
            else:
                fn = make_generate_fn(self.cfg, GenerateConfig(
                    max_new_tokens=max_new, temperature=temperature,
                    top_k=top_k, top_p=top_p, eos_id=eos_id,
                    max_seq=self.max_seq, cache_dtype=self.cfg.dtype))
            if len(self._fns) >= 16:
                self._fns.pop(next(iter(self._fns)))
            self._fns[key] = fn
        return fn

    def _encdec_generate_fn(self, max_new, temperature, top_k, top_p,
                            eos_id):
        """The ``--slots 0`` seq2seq generation: ``encdec_generate`` of
        equal-length source rows, ``{"tokens"}`` (``"lengths"`` too with
        an ``eos_id``). The sampler's arguments are checked here, before
        the function is cached."""
        from tpu_docker_api_torch.infer.sampling import make_sampler
        from tpu_docker_api_torch.models.encdec import encdec_generate

        if max_new > self.max_seq:
            raise ValueError(f"maxNewTokens {max_new} exceeds capacity "
                             f"{self.max_seq}")
        make_sampler(temperature, top_k=top_k, top_p=top_p)

        def fn(params, src, generator):
            out = encdec_generate(params, src, self.cfg,
                                  max_new_tokens=max_new, eos_id=eos_id,
                                  temperature=temperature, top_k=top_k,
                                  top_p=top_p, generator=generator)
            return out if eos_id is not None else {"tokens": out}

        return fn

    def close(self, drain: float = 0.0) -> None:
        if self.httpd is not None:
            self.httpd.server_close()
        if self.engine is not None:
            self.engine.close(drain=drain)
        if self.mirror is not None:
            with self._gen_lock:   # after the generation in flight
                self.mirror.stop()


def _make_handler(srv: Server):
    cfg = srv.cfg
    #: the body's field of token rows: seq2seq sources for encdec
    rows_field = "srcTokens" if srv.family == "encdec" else "tokens"

    def valid_token_row(row) -> bool:
        return (isinstance(row, list) and bool(row)
                and all(isinstance(t, int) and not isinstance(t, bool)
                        and 0 <= t < cfg.vocab_size for t in row))

    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.1 for chunked streaming; every non-streamed reply
        # carries Content-Length so keep-alive stays correct
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):
            pass

        def _chunk(self, data: bytes) -> None:
            self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")

        def _reply(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _body(self):
            length = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(length) or b"{}")

        def do_GET(self):
            if self.path == "/prefixes":
                if srv.engine is None:
                    self._reply(400, {"error": "prefix caching requires "
                                               "the slot engine path"})
                    return
                self._reply(200, {"prefixes": srv.engine.prefixes()})
                return
            if self.path == "/metrics":
                body = srv.metrics.render().encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            if self.path != "/healthz":
                self._reply(404, {"error": f"no route {self.path}"})
                return
            payload = {"status": "ok", "model": srv.args.preset,
                       "step": srv.step, "quantized": srv.args.quantize,
                       "tokenizer": srv.tokenizer is not None,
                       "device": str(srv.device),
                       "devices": (srv.mesh.size if srv.mesh is not None
                                   else torch.cuda.device_count()
                                   if srv.device.type == "cuda" else 1)}
            if srv.mesh is not None and srv.engine is None:
                payload["meshRows"] = list(srv.mesh_rows)
            code = 200
            eng = srv.engine
            if eng is not None:
                payload["slotEngine"] = {"slots": eng.slots,
                                         "chunk": eng.chunk, **eng.stats,
                                         "latency": eng.latency_stats()}
                if hasattr(eng, "n_spec"):
                    payload["slotEngine"]["speculative"] = True
                    payload["slotEngine"]["nSpec"] = eng.n_spec
                if eng.dead:
                    # degraded must be visible at the HTTP level
                    payload["status"] = "degraded"
                    payload["slotEngine"]["dead"] = eng.dead
                    code = 503
            self._reply(code, payload)

        def do_DELETE(self):
            if not self.path.startswith("/prefixes/"):
                self._reply(404, {"error": f"no route {self.path}"})
                return
            if srv.engine is None:
                self._reply(400, {"error": "prefix caching requires the "
                                           "slot engine path"})
                return
            pid = self.path[len("/prefixes/"):]
            self._reply(200, {"removed": srv.engine.unregister_prefix(pid)})

        def _register_prefix(self):
            """POST /prefixes {"tokens": [...]} or, with a tokenizer,
            {"text": "..."} (one string): a shared prompt prefix that
            /generate prompts starting with it prefill past."""
            if srv.engine is None:
                raise ValueError("prefix caching requires the slot engine "
                                 "path (--slots > 0)")
            req = self._body()
            toks = req.get("tokens") if isinstance(req, dict) else None
            text = req.get("text") if isinstance(req, dict) else None
            if text is not None:
                if srv.tokenizer is None:
                    raise ValueError('"text" requires --tokenizer (or an '
                                     '--hf-ckpt shipping a tokenizer.json)')
                if toks is not None:
                    raise ValueError('"text" and "tokens" are exclusive')
                if not isinstance(text, str) or not text:
                    raise ValueError('"text" must be ONE non-empty string '
                                     'here (a prefix is a single shared '
                                     'header, not a batch)')
                toks = srv.tokenizer.encode(text)
            if not valid_token_row(toks):
                raise ValueError(f"tokens must be a non-empty list of ids "
                                 f"in [0, {cfg.vocab_size})")
            pid = srv.engine.register_prefix(toks)
            self._reply(200, {"prefixId": pid, "length": len(toks)})

        def do_POST(self):
            if self.path not in ("/generate", "/prefixes"):
                self._reply(404, {"error": f"no route {self.path}"})
                return
            try:
                if self.path == "/prefixes":
                    self._register_prefix()
                else:
                    self._generate()
            except ValueError as e:
                self._reply(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — serving must not die
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

        def _generate(self):
            from tpu_docker_api_torch.infer.slots import QueueFull

            req = self._body()
            if not isinstance(req, dict):
                raise ValueError("body must be a JSON object")
            prompts = req.get(rows_field)
            texts_in = req.get("text")
            tok = srv.tokenizer
            if texts_in is not None:
                if tok is None:
                    raise ValueError('"text" requires --tokenizer (or an '
                                     '--hf-ckpt shipping a tokenizer.json)')
                if prompts is not None:
                    raise ValueError('"text" and token-id rows are '
                                     'exclusive')
                if (not isinstance(texts_in, list) or not texts_in
                        or not all(isinstance(t, str) and t
                                   for t in texts_in)):
                    raise ValueError('"text" must be a non-empty list of '
                                     'non-empty strings')
                prompts = [tok.encode(t) for t in texts_in]
            if not prompts or not all(valid_token_row(r) for r in prompts):
                raise ValueError(
                    f"{rows_field} must be a non-empty list of non-empty "
                    f"rows of token ids in [0, {cfg.vocab_size})")

            def req_float(name, default):
                v = req.get(name, default)
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    raise ValueError(f"{name} must be a number")
                return float(v)

            max_new = _as_int(req.get("maxNewTokens", 64), "maxNewTokens")
            if max_new < 1:
                raise ValueError(f"maxNewTokens must be >= 1, got {max_new}")
            temperature = req_float("temperature", 0.0)
            top_k = _as_int(req.get("topK", 0), "topK")
            if top_k > cfg.vocab_size:
                raise ValueError(f"topK must be <= vocab size "
                                 f"{cfg.vocab_size}, got {top_k}")
            top_p = req_float("topP", 1.0)
            eos_id = (_as_int(req["eosId"], "eosId") if "eosId" in req
                      else None)
            if eos_id is None and texts_in is not None:
                # text requests stop at the tokenizer's eos by default;
                # an explicit eosId wins
                eos_id = tok.eos_id
            do_stream = req.get("stream", False)
            if not isinstance(do_stream, bool):
                raise ValueError("stream must be a JSON boolean")
            eng = srv.engine
            # a dead engine falls back to the --slots 0 path; so does a
            # sampled request on a (greedy-only) speculative engine
            slot_ok = eng is not None and not eng.dead
            if slot_ok and hasattr(eng, "n_spec") and (
                    temperature != 0.0 or top_k != 0 or top_p != 1.0):
                slot_ok = False
            if eng is not None and not slot_ok and srv.mesh is not None:
                # the mesh engine's ranks hold shards, not whole weights
                self._reply(503, {"error": f"slot engine stopped: "
                                           f"{eng.dead}"})
                return
            if do_stream and not slot_ok:
                raise ValueError("stream requires the slot engine path "
                                 "(--slots > 0)")
            if do_stream and len(prompts) != 1:
                raise ValueError("stream serves exactly one prompt row")

            if slot_ok:
                # validate EVERY row + queue room before submitting any —
                # a failure mid-list would orphan the earlier rows
                for r in prompts:
                    eng.validate(r, max_new, top_k=top_k, top_p=top_p)
                if not eng.has_room(len(prompts)):
                    self._reply(503, {"error": "admission queue at capacity"})
                    return
                try:
                    handles = [eng.submit(r, max_new, temperature,
                                          eos_id=eos_id, stream=do_stream,
                                          top_k=top_k, top_p=top_p)
                               for r in prompts]
                except QueueFull as e:
                    self._reply(503, {"error": str(e)})
                    return
                if do_stream:
                    self._stream(handles[0],
                                 tok if texts_in is not None else None)
                    return
                outs = [h.result(timeout=600) for h in handles]
                payload = {
                    "tokens": [o["tokens"] + [0] * (max_new - o["length"])
                               for o in outs],
                    "lengths": [o["length"] for o in outs]}
                if texts_in is not None:
                    payload["texts"] = [tok.decode(o["tokens"][:o["length"]])
                                        for o in outs]
                self._reply(200, payload)
                return

            if len({len(r) for r in prompts}) > 1:
                raise ValueError("this serving path (--slots 0) needs "
                                 "equal-length prompt rows — left-pad them")
            if temperature == 0.0:
                # greedy ignores the filters; don't cache a program per
                # assorted topK/topP
                top_k, top_p = 0, 1.0
            payload = srv.generate(
                (max_new, temperature, top_k, top_p, eos_id), prompts)
            if texts_in is not None:
                payload["texts"] = [tok.decode(row[:n]) for row, n in zip(
                    payload["tokens"], payload.get(
                        "lengths", [max_new] * len(payload["tokens"])))]
            self._reply(200, payload)

        def _stream(self, handle, tok):
            # chunked ndjson; once headers are out an error must DROP the
            # connection (a second status line would poison the stream)
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            try:
                for t in handle.stream(timeout=600):
                    self._chunk(json.dumps({"t": t}).encode() + b"\n")
                res = handle.result(0)
                done = {"done": True, "length": res["length"]}
                if tok is not None:
                    # BPE pieces do not decode one id at a time: the whole
                    # decoded text rides the done line
                    done["text"] = tok.decode(res["tokens"][:res["length"]])
                self._chunk(json.dumps(done).encode() + b"\n")
                self.wfile.write(b"0\r\n\r\n")
            except Exception:  # noqa: BLE001
                self.close_connection = True

    return Handler


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    if mesh_wanted(args):
        from tpu_docker_api_torch.workload.torchenv import (launch_workers,
                                                            without_flag,
                                                            workers_wanted)

        n = workers_wanted(args.device, args.nproc_per_node)
        if n > 1:
            return launch_workers("tpu_docker_api_torch.serve",
                                  without_flag(argv, "--nproc-per-node"), n,
                                  "cpu" if args.device == "cpu" else "cuda")
    srv = Server(args)
    if srv.rank != 0:
        # rank 0 stops the job (its close releases the others); a signal
        # the launcher passes on must not end a rank mid-step
        signal.signal(signal.SIGTERM, signal.SIG_IGN)
        signal.signal(signal.SIGINT, signal.SIG_IGN)
        try:
            srv.follow()
        finally:
            import torch.distributed as dist

            dist.destroy_process_group()
        return 0

    def _stop(signum, _frame):
        threading.Thread(target=srv.httpd.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _stop)
    signal.signal(signal.SIGINT, _stop)
    print(json.dumps({"event": "serving", "model": srv.args.preset,
                      "device": str(srv.device),
                      "quantized": srv.args.quantize,
                      "port": srv.httpd.server_address[1],
                      "slots": srv.engine.slots if srv.engine else 0}),
          flush=True)
    srv.httpd.serve_forever()
    # drain: handler threads may still wait on handles after shutdown()
    srv.close(drain=8)
    print(json.dumps({"event": "stopped"}), flush=True)
    if srv.mesh is not None:
        import torch.distributed as dist

        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
