"""The port stands alone: with ``jax``, ``tpu_docker_api`` and the
packages the port's GPU hosts need not have (``safetensors``,
``transformers``, ``orbax``, ``tokenizers``, ``regex``, ``requests``) blocked on
``sys.meta_path``, every module of ``tpu_docker_api_torch`` and
``chip_smoke.py`` import, and a tiny forward, the native batcher, a paged engine with a
shared prefix and segments, speculative decoding (the batch-1 generator
and the slot engine), the int8-serving benchmark, a train step (Llama
and MoE), a QLoRA step,
checkpoint save and restore, HF export and import (int8 at load too), and a
tokenizer written by ``chip_smoke.py``, a GPU grant from the
scheduler through the fake runtime, the control-plane daemon booted
with a container run through one REST call, and an ``EtcdKV`` (over the
standard library, ``requests`` blocked) against the fake gateway, on the
CPU. With ``torch`` blocked too, the daemon boots on etcd with its
reconciler and answers ``/api/v1/reconcile``, and again with leader
election, workflows, the compactor and the serving gateway on."""

import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = textwrap.dedent("""
    import importlib, pkgutil, sys, tempfile

    BLOCKED = ("jax", "jaxlib", "tpu_docker_api", "safetensors",
               "transformers", "orbax", "tokenizers", "regex", "requests")

    class Block:
        def find_spec(self, name, path=None, target=None):
            top = name.split(".")[0]
            if top in BLOCKED:
                raise ImportError(f"blocked import of {name}")
            return None

    for mod in list(sys.modules):
        if mod.split(".")[0] in BLOCKED:
            del sys.modules[mod]
    sys.meta_path.insert(0, Block())

    import torch
    import tpu_docker_api_torch as pkg
    names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                   pkg.__name__ + ".")]
    for name in names:
        importlib.import_module(name)
    for needed in ("tpu_docker_api_torch.ops.xent",
                   "tpu_docker_api_torch.train.optim",
                   "tpu_docker_api_torch.train.trainer",
                   "tpu_docker_api_torch.train.__main__",
                   "tpu_docker_api_torch.train.checkpoint",
                   "tpu_docker_api_torch.train.lora",
                   "tpu_docker_api_torch.data.loader",
                   "tpu_docker_api_torch.models.import_weights",
                   "tpu_docker_api_torch.models.tokenizer",
                   "tpu_docker_api_torch.ops.paged",
                   "tpu_docker_api_torch.infer.paged",
                   "tpu_docker_api_torch.infer.speculative",
                   "tpu_docker_api_torch.infer.servebench",
                   "tpu_docker_api_torch.models.moe",
                   "tpu_docker_api_torch.errors",
                   "tpu_docker_api_torch.telemetry.trace",
                   "tpu_docker_api_torch.telemetry.nvml",
                   "tpu_docker_api_torch.telemetry.probe",
                   "tpu_docker_api_torch.telemetry.sidecar",
                   "tpu_docker_api_torch.state.keys",
                   "tpu_docker_api_torch.state.kv",
                   "tpu_docker_api_torch.schemas.gpu",
                   "tpu_docker_api_torch.scheduler.topology",
                   "tpu_docker_api_torch.scheduler.slices",
                   "tpu_docker_api_torch.scheduler.ports",
                   "tpu_docker_api_torch.runtime.spec",
                   "tpu_docker_api_torch.runtime.base",
                   "tpu_docker_api_torch.runtime.fake",
                   "tpu_docker_api_torch.runtime.docker_http",
                   "tpu_docker_api_torch.runtime.fake_engine",
                   "tpu_docker_api_torch.utils.backoff",
                   "tpu_docker_api_torch.utils.files",
                   "tpu_docker_api_torch.service.crashpoints",
                   "tpu_docker_api_torch.service.container",
                   "tpu_docker_api_torch.service.volume",
                   "tpu_docker_api_torch.service.watch",
                   "tpu_docker_api_torch.state.txn",
                   "tpu_docker_api_torch.state.version",
                   "tpu_docker_api_torch.state.store",
                   "tpu_docker_api_torch.state.pager",
                   "tpu_docker_api_torch.state.workqueue",
                   "tpu_docker_api_torch.state.informer",
                   "tpu_docker_api_torch.state.faulty",
                   "tpu_docker_api_torch.runtime.fanout",
                   "tpu_docker_api_torch.runtime.faulty",
                   "tpu_docker_api_torch.service.reconcile",
                   "tpu_docker_api_torch.service.store_health",
                   "tpu_docker_api_torch.service.invariants",
                   "tpu_docker_api_torch.service.job",
                   "tpu_docker_api_torch.service.job_supervisor",
                   "tpu_docker_api_torch.service.host_health",
                   "tpu_docker_api_torch.scheduler.pod",
                   "tpu_docker_api_torch.schemas.workflow",
                   "tpu_docker_api_torch.service.workflow",
                   "tpu_docker_api_torch.service.leader",
                   "tpu_docker_api_torch.service.shard",
                   "tpu_docker_api_torch.service.compactor",
                   "tpu_docker_api_torch.schemas.job",
                   "tpu_docker_api_torch.schemas.state",
                   "tpu_docker_api_torch.schemas.container",
                   "tpu_docker_api_torch.schemas.volume",
                   "tpu_docker_api_torch.api.app",
                   "tpu_docker_api_torch.api.codes",
                   "tpu_docker_api_torch.api.response",
                   "tpu_docker_api_torch.buildinfo",
                   "tpu_docker_api_torch.config",
                   "tpu_docker_api_torch.daemon",
                   "tpu_docker_api_torch.parallel.mesh",
                   "tpu_docker_api_torch.parallel.sharding",
                   "tpu_docker_api_torch.parallel.comm",
                   "tpu_docker_api_torch.parallel.ring",
                   "tpu_docker_api_torch.parallel.ulysses",
                   "tpu_docker_api_torch.workload.torchenv",
                   "tpu_docker_api_torch.infer.mirror",
                   "tpu_docker_api_torch.__main__"):
        assert needed in names, needed
    importlib.import_module("chip_smoke")

    from tpu_docker_api_torch.models.llama import (llama_init,
                                                   llama_presets,
                                                   llama_forward)
    cfg = llama_presets()["tiny"]
    params = llama_init(cfg, torch.Generator().manual_seed(0))
    logits = llama_forward(params, torch.zeros(1, 5, dtype=torch.long), cfg)
    assert logits.shape == (1, 5, cfg.vocab_size)
    assert torch.isfinite(logits).all()

    from tpu_docker_api_torch.infer.paged import PagedSlotEngine
    eng = PagedSlotEngine(cfg, params, page_size=16, slots=2, max_seq=64,
                          chunk=4, prefill_chunk=8, total_pages=8)
    eng.register_prefix(list(range(1, 17)))
    hs = [eng.submit(list(range(1, 17)) + [5], 3),
          eng.submit(list(range(2, 30)), 3)]
    while not all(h.done() for h in hs):
        eng.step()
    assert [h.result(0)["length"] for h in hs] == [3, 3]
    assert eng.stats["prefix_hits"] == 1 and eng.stats["segment_prefills"]

    from tpu_docker_api_torch.infer.speculative import (
        SpeculativeConfig, make_speculative_generate_fn)
    from tpu_docker_api_torch.infer.slots import SpeculativeSlotEngine
    out = make_speculative_generate_fn(cfg, cfg, SpeculativeConfig(
        max_new_tokens=6, n_speculative=2, max_seq=32))(
        params, params, torch.ones(1, 4, dtype=torch.long))
    assert out["tokens"].shape == (1, 6) and out["rounds"] >= 1
    eng = SpeculativeSlotEngine(cfg, params, draft_cfg=cfg,
                                draft_params=params, n_spec=2, slots=2,
                                max_seq=32)
    hs = [eng.submit([3, 1, 4], 5), eng.submit([2, 7], 3)]
    while not all(h.done() for h in hs):
        eng.step()
    assert [h.result(0)["length"] for h in hs] == [5, 3]

    from tpu_docker_api_torch.infer import servebench
    from tpu_docker_api_torch.infer.quantize import bench_int8_serving
    assert servebench._hbm_bw("cpu") is None
    res = bench_int8_serving("tiny", batch=2, new_tok=3, prompt_len=4,
                             reps=1, max_seq=16, device="cpu")
    assert res["ok"] and res["batch"] == 2

    from tpu_docker_api_torch.train.trainer import (create_train_state,
                                                    make_train_step)
    state, opt = create_train_state(cfg, "cpu")
    state, metrics = make_train_step(cfg, opt)(
        state, torch.zeros(1, 6, dtype=torch.long))
    assert torch.isfinite(metrics["loss"])
    from tpu_docker_api_torch.models.moe import moe_presets
    mcfg = moe_presets()["moe-tiny"]
    mstate, mopt = create_train_state(mcfg, "cpu")
    mstate, metrics = make_train_step(mcfg, mopt)(
        mstate, torch.zeros(1, 6, dtype=torch.long))
    assert torch.isfinite(metrics["loss"])

    import numpy as np
    from tpu_docker_api_torch.data import loader
    with tempfile.TemporaryDirectory() as d:
        loader.write_token_file(np.arange(300) % 250, d + "/t.bin")
        fn = loader.make_batch_fn(loader.open_token_files(d + "/t.bin", 9), 2)
        assert isinstance(fn, loader._NativeBatcher)
        assert fn(0).shape == (2, 9)

    from tpu_docker_api_torch.train import lora
    lstate, lopt = lora.create_lora_state(cfg, torch.Generator(), 2)
    lstep = lora.make_lora_train_step(
        cfg, lopt, lora.quantize_base(state.params), forward="attached")
    lstate, metrics = lstep(lstate, torch.zeros(1, 6, dtype=torch.long))
    assert torch.isfinite(metrics["loss"])

    from tpu_docker_api_torch.models.import_weights import (
        export_hf_llama, import_hf_llama)
    from tpu_docker_api_torch.train.checkpoint import CheckpointManager
    with tempfile.TemporaryDirectory() as d:
        with CheckpointManager(d + "/ck") as mgr:
            mgr.save(state)
        back = mgr.restore(cfg, opt, device="cpu")
        assert back.step == 1
        export_hf_llama(back.params, cfg, d + "/hf")
        _, params = import_hf_llama(d + "/hf", device="cpu")
        assert torch.equal(params["lm_head"], state.params["lm_head"])
        _, qparams = import_hf_llama(d + "/hf", device="cpu", quantize=True)
        assert llama_forward(qparams, torch.zeros(1, 5, dtype=torch.long),
                             cfg).isfinite().all()
        import chip_smoke
        from tpu_docker_api_torch.models.import_weights import load_tokenizer
        tok = load_tokenizer(chip_smoke.write_llama3_shaped_tokenizer(
            d + "/tok/tokenizer.json", vocab_size=2000, n_special=4))
        assert tok.decode(tok.encode("héllo 東京")[1:]) == "héllo 東京"
    from tpu_docker_api_torch.runtime import FakeRuntime, render_gpu_attachment
    from tpu_docker_api_torch.runtime.spec import ContainerSpec
    from tpu_docker_api_torch.scheduler import ChipScheduler, HostTopology
    from tpu_docker_api_torch.state import SqliteKV
    from tpu_docker_api_torch.telemetry.sidecar import fake_host_info
    from tpu_docker_api_torch.telemetry.probe import topology_from_info
    topo = topology_from_info(fake_host_info("h100-8"))
    assert topo == HostTopology.build("h100-8")
    with tempfile.TemporaryDirectory() as d:
        sched = ChipScheduler(topo, SqliteKV(d + "/s.db"))
        ids, _ = sched.apply_chips(2, owner="o")
        spec = render_gpu_attachment(ContainerSpec(name="c", image="i"),
                                     ids, topo)
        rt = FakeRuntime(root=d + "/rt", allow_exec=True)
        rt.container_create(spec)
        rt.container_start("c")
        out = rt.container_exec("c", ["sh", "-c",
                                      "echo $CUDA_VISIBLE_DEVICES"]).output
        assert out.strip() == ",".join(sched.uuids_of(ids))
    import http.client, json
    from tpu_docker_api_torch import config as cp_config
    from tpu_docker_api_torch.daemon import Program
    prg = Program(cp_config.Config(port=0, runtime_backend="fake",
                                   health_watch_interval=0),
                  host="127.0.0.1")
    prg.init()
    prg.start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", prg.api_server.port,
                                          timeout=30)
        conn.request("POST", "/api/v1/containers", body=json.dumps(
            {"imageName": "i", "containerName": "c", "gpuCount": 1}))
        reply = json.loads(conn.getresponse().read())
        conn.close()
        assert reply["code"] == 200 and reply["data"]["name"] == "c-0", reply
    finally:
        prg.stop()
    sys.path.insert(0, "tests")
    from etcd_gateway import start_gateway, stop_gateway
    from tpu_docker_api_torch.state.kv import CountingKV, EtcdKV
    server, _ = start_gateway()
    try:
        etcd = CountingKV(EtcdKV(f"http://127.0.0.1:{server.server_address[1]}"))
        w = etcd.watch("/x/", etcd.current_rev())
        etcd.apply([("put", "/x/a", "1"), ("put", "/x/b", "2")])
        assert etcd.range_prefix("/x/") == {"/x/a": "1", "/x/b": "2"}
        got = []
        for _ in range(50):
            got += w.poll(0.1)
            if len(got) == 2:
                break
        assert [e.key for e in got] == ["/x/a", "/x/b"], got
        w.close()
        etcd.close()
        assert etcd.snapshot()["apply"] == 1
    finally:
        stop_gateway(server)
    assert not any(m.split(".")[0] in BLOCKED for m in sys.modules)
    print("ISOLATED", len(names))
""")

#: the control-plane daemon with torch blocked too: it boots on an etcd
#: store (the fake gateway) with its reconciler on, and answers the
#: reconcile route; then an HA daemon (leader election, workflows, the
#: compactor, the serving gateway) boots on the same store and leads
_NO_TORCH_CHILD = textwrap.dedent("""
    import http.client, json, sys, tempfile, time

    BLOCKED = ("jax", "jaxlib", "tpu_docker_api", "torch", "requests")

    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, Block())
    sys.path.insert(0, "tests")
    from etcd_gateway import start_gateway, stop_gateway
    from tpu_docker_api_torch import config as cp_config
    from tpu_docker_api_torch.daemon import Program

    server, _ = start_gateway()
    addr = f"http://127.0.0.1:{server.server_address[1]}"
    prg = Program(cp_config.Config(
        port=0, runtime_backend="fake", store_backend="etcd", etcd_addr=addr,
        health_watch_interval=0, reconcile_interval=0.2,
        reconcile_full_interval_s=30.0, fanout_workers=4,
        fake_runtime_root=tempfile.mkdtemp()), host="127.0.0.1")
    prg.init()
    prg.start()
    try:
        def call(method, path, body=None):
            conn = http.client.HTTPConnection("127.0.0.1",
                                              prg.api_server.port, timeout=30)
            conn.request(method, path, body=json.dumps(body).encode()
                         if body is not None else None)
            reply = json.loads(conn.getresponse().read())
            conn.close()
            return reply
        assert call("POST", "/api/v1/containers", {
            "imageName": "i", "containerName": "c",
            "gpuCount": 1})["code"] == 200
        prg.runtime.crash_container("c-0")
        report = call("POST", "/api/v1/reconcile?mode=full")["data"]
        # the 0.2 s periodic pass may repair the crash before the explicit
        # one runs: the repair is the reconciler's whichever pass made it
        repairs = [(e["action"], e["target"])
                   for e in call("GET", "/api/v1/reconcile/events")["data"]
                   if not e["dryRun"]]
        assert repairs == [("restart-dead", "c-0")], (repairs, report)
        assert report["actions"] in ([], [{"action": "restart-dead",
                                           "target": "c-0"}]), report
        assert prg.runtime.container_inspect("c-0").running
        health = call("GET", "/healthz")["data"]
        assert health["fanout"]["workers"] == 4
        assert health["storeHealth"]["mode"] == "healthy"
        assert "reconcileDirty" in health
    finally:
        prg.stop()

    # the HA daemon on the same store: leader election with its informer
    # read path, workflows at JAX's interval, the history compactor and
    # the serving gateway on its own listener
    prg = Program(cp_config.Config(
        port=0, runtime_backend="fake", store_backend="etcd", etcd_addr=addr,
        health_watch_interval=0, leader_election=True, leader_ttl_s=5.0,
        leader_renew_interval_s=0.05, history_retention_versions=3,
        gateway_enabled=True, gateway_port=0,
        fake_runtime_root=tempfile.mkdtemp()), host="127.0.0.1")
    prg.init()
    prg.start()
    try:
        deadline = time.monotonic() + 30
        while (not prg.leader_elector.accepts_mutations
               and time.monotonic() < deadline):
            time.sleep(0.01)
        assert call("GET", "/api/v1/leader")["data"]["role"] == "leader"
        assert call("POST", "/api/v1/workflows", {
            "workflowName": "w", "steps": [
                {"name": "a", "image": "i", "chipCount": 1}]})["code"] == 200
        assert call("POST", "/api/v1/compact")["code"] == 200
        gw = call("GET", "/api/v1/gateway")["data"]
        assert gw["instanceId"] == prg.gateway.instance_id
        assert call("GET", "/healthz")["data"]["gateway"]["inFlight"] == 0
        assert type(prg.job_svc.drain_coordinator).__name__ \
            == "DrainCoordinator"
    finally:
        prg.stop()
        stop_gateway(server)
    assert not any(m.split(".")[0] in BLOCKED for m in sys.modules)
    print("NO-TORCH DAEMON OK")
""")


def test_port_imports_no_jax_and_no_jax_package():
    proc = subprocess.run([sys.executable, "-c", _CHILD], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "ISOLATED" in proc.stdout
    assert int(proc.stdout.split()[-1]) >= 25  # every module was walked


def test_daemon_boots_without_torch_on_etcd():
    proc = subprocess.run([sys.executable, "-c", _NO_TORCH_CHILD], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "NO-TORCH DAEMON OK" in proc.stdout


def test_entry_points_refuse_cuda_without_a_card():
    """Without a card, asking for the default device raises; no entry
    point carries on on the CPU: neither ``resolve_device`` nor the
    trainer's command line with its default ``--device``."""
    import pytest
    import torch

    from tpu_docker_api_torch import resolve_device

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    assert resolve_device("cpu").type == "cpu"
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_docker_api_torch.train", "--preset",
         "tiny", "--steps", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "CUDA requested but no CUDA device" in proc.stderr
    assert proc.stdout == ""


def test_chip_smoke_defines_each_top_level_name_once():
    """A second top-level definition of a name in ``chip_smoke.py``
    silently replaces the first for every phase that calls it."""
    import ast
    from collections import Counter

    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = Counter()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names[node.name] += 1
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                for n in ast.walk(t):
                    if isinstance(n, ast.Name):
                        names[n.id] += 1
    assert [n for n, c in names.items() if c > 1] == []


def test_no_port_file_names_tpu_native():
    """The port keeps its own copy of the native loader's source and
    builds it: no module or source of ``tpu_docker_api_torch``, and not
    ``chip_smoke.py``, names the JAX package's native directory, so none
    can load its library."""
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, names in os.walk(os.path.join(ROOT, "tpu_docker_api_torch")):
        files += [os.path.join(base, n) for n in names
                  if n.endswith((".py", ".cc", ".cu", ".cuh"))]
    assert len(files) > 100
    named = [f for f in files if "tpu_native" in open(f).read()]
    assert named == []
