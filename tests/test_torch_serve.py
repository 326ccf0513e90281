"""The port's HTTP server, in process on the CPU (tiny preset):
/healthz, /metrics, /generate (ragged rows, sampling, validation), a
streamed request, and weights from ``--ckpt-dir`` and ``--hf-ckpt``
answering greedy requests with the tokens of the params in memory."""

import http.client
import json
import threading

import pytest

from tpu_docker_api_torch.serve.__main__ import Server, parse_args


@pytest.fixture(scope="module")
def server():
    srv = Server(parse_args(["--device", "cpu", "--preset", "tiny",
                             "--host", "127.0.0.1", "--port", "0",
                             "--max-seq", "64", "--slots", "4",
                             "--chunk", "4"]))
    t = threading.Thread(target=srv.httpd.serve_forever, daemon=True)
    t.start()
    yield srv
    srv.httpd.shutdown()
    srv.close()
    t.join(timeout=10)


def _request(srv, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1",
                                      srv.httpd.server_address[1],
                                      timeout=60)
    conn.request(method, path,
                 body=None if body is None else json.dumps(body))
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, data


def test_healthz(server):
    code, data = _request(server, "GET", "/healthz")
    body = json.loads(data)
    assert code == 200 and body["status"] == "ok"
    assert body["model"] == "tiny" and body["device"] == "cpu"
    assert body["slotEngine"]["slots"] == 4


def test_generate_ragged_rows(server):
    code, data = _request(server, "POST", "/generate", {
        "tokens": [[1, 2, 3], [4, 5, 6, 7, 8, 9, 10]], "maxNewTokens": 5})
    body = json.loads(data)
    assert code == 200
    assert body["lengths"] == [5, 5]
    assert all(len(r) == 5 and all(0 <= t < 256 for t in r)
               for r in body["tokens"])
    # greedy is deterministic: the same prompt gives the same tokens
    _, again = _request(server, "POST", "/generate", {
        "tokens": [[1, 2, 3]], "maxNewTokens": 5})
    assert json.loads(again)["tokens"][0] == body["tokens"][0]


def test_generate_sampled(server):
    code, data = _request(server, "POST", "/generate", {
        "tokens": [[3, 1, 4, 1, 5]], "maxNewTokens": 4, "temperature": 0.8,
        "topK": 20, "topP": 0.9})
    assert code == 200
    assert len(json.loads(data)["tokens"][0]) == 4


@pytest.mark.parametrize("body", [
    {"tokens": [[1, 999]]},
    {"tokens": [[1]], "maxNewTokens": 0},
    {"tokens": [[1]], "maxNewTokens": 1.5},
    {"tokens": [[1]], "topP": 0.0},
    {"tokens": [[1]], "stream": "yes"},
    {"tokens": [[1], [2]], "stream": True},
    {"tokens": [[1] * 60], "maxNewTokens": 10},
])
def test_generate_rejects_bad_bodies(server, body):
    code, data = _request(server, "POST", "/generate", body)
    assert code == 400 and "error" in json.loads(data)


def test_stream(server):
    code, data = _request(server, "POST", "/generate", {
        "tokens": [[7, 8, 9]], "maxNewTokens": 6, "stream": True})
    assert code == 200
    lines = [json.loads(ln) for ln in data.decode().splitlines() if ln]
    assert lines[-1] == {"done": True, "length": 6}
    streamed = [ln["t"] for ln in lines[:-1]]
    _, ref = _request(server, "POST", "/generate", {
        "tokens": [[7, 8, 9]], "maxNewTokens": 6})
    assert streamed == json.loads(ref)["tokens"][0]


def test_metrics(server):
    _request(server, "POST", "/generate", {"tokens": [[1]],
                                           "maxNewTokens": 2})
    code, data = _request(server, "GET", "/metrics")
    text = data.decode()
    assert code == 200
    assert "serve_ttft_seconds_count" in text
    assert "serve_requests_completed_total" in text


def test_metrics_registry_renders_as_jax():
    """The port's registry copy renders the same exposition text as the
    JAX package's for the calls serving makes."""
    from tpu_docker_api.telemetry.metrics import MetricsRegistry as JaxReg
    from tpu_docker_api_torch.telemetry.metrics import MetricsRegistry

    texts = []
    for reg in (JaxReg(), MetricsRegistry()):
        reg.observe("serve_ttft_seconds", 0.03, help="ttft")
        reg.observe("serve_ttft_seconds", 7.0, help="ttft")
        reg.observe("lat", 0.2, labels={"route": 'a"b'})
        reg.counter_inc("serve_tokens_emitted_total", value=5, help="tok")
        reg.counter_inc("hits", labels={"k": "x"})
        reg.counter_fn("serve_requests_completed_total", lambda: 3,
                       help="done\nline")
        reg.gauge_fn("slots_free", lambda: 2.5)
        with pytest.raises(ValueError):
            reg.gauge_fn("hits", lambda: 0)
        texts.append(reg.render())
    assert texts[0] == texts[1]
    assert "serve_ttft_seconds_count 2" in texts[1]


def test_legacy_path_and_cuda_default():
    srv = Server(parse_args(["--device", "cpu", "--preset", "tiny",
                             "--host", "127.0.0.1", "--port", "0",
                             "--max-seq", "64", "--slots", "0"]))
    t = threading.Thread(target=srv.httpd.serve_forever, daemon=True)
    t.start()
    try:
        code, data = _request(srv, "POST", "/generate", {
            "tokens": [[1, 2], [3, 4]], "maxNewTokens": 3})
        assert code == 200 and json.loads(data)["lengths"] == [3, 3]
        code, _ = _request(srv, "POST", "/generate", {
            "tokens": [[1, 2], [3]], "maxNewTokens": 3})
        assert code == 400
    finally:
        srv.httpd.shutdown()
        srv.close()
        t.join(timeout=10)
    assert parse_args([]).device == "cuda"


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A checkpoint of the port at step 3 and its HF export."""
    import torch

    from tpu_docker_api_torch.models.import_weights import export_hf_llama
    from tpu_docker_api_torch.models.llama import llama_presets
    from tpu_docker_api_torch.train.checkpoint import CheckpointManager
    from tpu_docker_api_torch.train.optim import adamw_int8
    from tpu_docker_api_torch.train.trainer import (TrainState,
                                                    create_train_state)

    root = tmp_path_factory.mktemp("weights")
    cfg = llama_presets()["tiny"]
    state, _ = create_train_state(cfg, "cpu",
                                  torch.Generator().manual_seed(11),
                                  adamw_int8())
    with CheckpointManager(root / "ckpt") as mgr:
        mgr.save(TrainState(3, state.params, state.opt_state))
    export_hf_llama(state.params, cfg, str(root / "tiny-hf"))
    return cfg, state.params, root


def _greedy_in_memory(cfg, params, prompt, max_new):
    """The slot engine of the server's settings on the params in memory."""
    from tpu_docker_api_torch.infer.quantize import fuse_llama_projections
    from tpu_docker_api_torch.infer.slots import SlotEngine

    eng = SlotEngine(cfg, fuse_llama_projections(params), slots=4,
                     max_seq=64, chunk=4, cache_dtype=cfg.dtype)
    h = eng.submit(prompt, max_new)
    while not h.done():
        eng.step()
    return h.result(0)["tokens"]


@pytest.mark.parametrize("source", ["--ckpt-dir", "--hf-ckpt"])
def test_serves_checkpoint_weights(trained, source):
    cfg, params, root = trained
    where = str(root / ("ckpt" if source == "--ckpt-dir" else "tiny-hf"))
    srv = Server(parse_args(["--device", "cpu", "--preset", "tiny", source,
                             where, "--host", "127.0.0.1", "--port", "0",
                             "--max-seq", "64", "--slots", "4",
                             "--chunk", "4"]))
    t = threading.Thread(target=srv.httpd.serve_forever, daemon=True)
    t.start()
    try:
        prompt = [5, 9, 2, 7, 31]
        code, data = _request(srv, "POST", "/generate", {
            "tokens": [prompt], "maxNewTokens": 8})
        assert code == 200
        assert json.loads(data)["tokens"][0] == _greedy_in_memory(
            cfg, params, prompt, 8)
        _, health = _request(srv, "GET", "/healthz")
        health = json.loads(health)
        if source == "--ckpt-dir":
            assert health["step"] == 3 and health["model"] == "tiny"
        else:
            assert health["step"] == 0 and health["model"] == "tiny-hf"
        code, data = _request(srv, "POST", "/generate", {
            "text": ["hello"], "maxNewTokens": 2})
        assert code == 400
        assert "tokenizer" in json.loads(data)["error"]
        assert "ROADMAP" in json.loads(data)["error"]
    finally:
        srv.httpd.shutdown()
        srv.close()
        t.join(timeout=10)


@pytest.mark.parametrize("flags,msg", [
    (["--tokenizer", "tok.json"], "ROADMAP"),
    (["--ckpt-dir", "a", "--hf-ckpt", "b"], "exclusive")])
def test_refused_flags(capsys, flags, msg):
    with pytest.raises(SystemExit) as e:
        parse_args(flags)
    assert e.value.code == 2 and msg in capsys.readouterr().err


def test_missing_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        Server(parse_args(["--device", "cpu", "--preset", "tiny",
                           "--ckpt-dir", str(tmp_path / "none"),
                           "--port", "0", "--host", "127.0.0.1"]))
