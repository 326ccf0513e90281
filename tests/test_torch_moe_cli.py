"""The MoE family through the port's entry points on the CPU (moe-tiny):
the trainer CLI (``--moe-dispatch``, resume from ``--ckpt-dir``, a
SIGTERM quiesce, ``--profile-dir``, ``--optim adamw-int8``, LoRA on
wq,wv), the server (``/generate`` on the slot engine and on ``--slots
0``, a stream, ``/prefixes``, ``--prefill-chunk``, ``--ckpt-dir``), the
JAX entry points' family guards, and ``bench_moe_serving`` against the
JAX function. The entry points run in process: ``main(argv)`` with its
JSON lines captured, and ``Server`` on a free port."""

import contextlib
import http.client
import io
import json
import signal
import threading

import pytest
import torch

from tpu_docker_api.infer import servebench as jbench
from tpu_docker_api_torch.infer import servebench as tbench
from tpu_docker_api_torch.infer.slots import SlotEngine
from tpu_docker_api_torch.models import moe as tm
from tpu_docker_api_torch.serve.__main__ import Server, parse_args
from tpu_docker_api_torch.train import __main__ as train_cli
from tpu_docker_api_torch.train.checkpoint import (CheckpointManager,
                                                   restore_model_params)

SMALL = ["--device", "cpu", "--preset", "moe:moe-tiny", "--batch", "2",
         "--seq", "16", "--log-every", "1"]


class _Out(io.StringIO):
    """stdout that raises SIGTERM in this process once ``after`` step
    lines have been printed (0: never)."""

    def __init__(self, after: int = 0):
        super().__init__()
        self.after = after

    def write(self, s):
        n = super().write(s)
        if self.after and self.getvalue().count('"loss"') == self.after:
            self.after = 0
            signal.raise_signal(signal.SIGTERM)
        return n


def _train(argv, quiesce_after: int = 0):
    """(exit code, JSON lines) of the trainer's ``main`` in process; the
    signal handlers it installs are put back after."""
    out = _Out(quiesce_after)
    handlers = {s: signal.getsignal(s) for s in (signal.SIGTERM,
                                                 signal.SIGINT)}
    try:
        with contextlib.redirect_stdout(out):
            rc = train_cli.main(argv)
    finally:
        for sig, h in handlers.items():
            signal.signal(sig, h)
    return rc, [json.loads(ln) for ln in out.getvalue().splitlines()]


def _steps(lines):
    return [ln for ln in lines if "event" not in ln]


# ---------------------------------------------------------------- trainer

@pytest.mark.parametrize("dispatch", ["einsum", "gather", "sort"])
def test_trainer_cli_moe_dispatch(dispatch):
    """``--moe-dispatch`` reaches the model: on one device the three
    dispatches give the same first loss (the same math)."""
    rc, lines = _train([*SMALL, "--steps", "2", "--moe-dispatch", dispatch])
    assert rc == 0
    steps = _steps(lines)
    assert [ln["step"] for ln in steps] == [1, 2]
    assert lines[-1] == {"event": "done", "step": 2}
    rc, auto = _train([*SMALL, "--steps", "1"])
    assert abs(steps[0]["loss"] - _steps(auto)[0]["loss"]) <= 1e-4


@pytest.mark.parametrize("dispatch,einsum_calls", [("einsum", True),
                                                    ("gather", False)])
def test_trainer_cli_dispatch_reaches_the_model(monkeypatch, dispatch,
                                                einsum_calls):
    """The einsum dispatch alone builds the one-hot tensors (``_route``)."""
    calls = []
    route = tm._route

    def spy(*a, **k):
        calls.append(1)
        return route(*a, **k)

    monkeypatch.setattr(tm, "_route", spy)
    rc, _ = _train([*SMALL, "--steps", "1", "--moe-dispatch", dispatch])
    assert rc == 0 and bool(calls) == einsum_calls


@pytest.mark.parametrize("optim_name", ["adamw", "adamw-int8"])
def test_trainer_cli_resumes_a_moe_checkpoint(tmp_path, optim_name):
    """Two steps, then a second run on the same --ckpt-dir resumes at
    step 2: its steps 3-4 give the losses, and its step-4 checkpoint the
    bytes, of an uninterrupted run (the f32 router included)."""
    flags = [*SMALL, "--optim", optim_name]
    rc, whole = _train([*flags, "--steps", "4", "--ckpt-dir",
                        str(tmp_path / "a")])
    assert rc == 0
    rc, first = _train([*flags, "--steps", "2", "--ckpt-dir",
                        str(tmp_path / "b")])
    assert rc == 0 and [ln["step"] for ln in _steps(first)] == [1, 2]
    rc, second = _train([*flags, "--steps", "4", "--ckpt-dir",
                         str(tmp_path / "b")])
    assert rc == 0
    assert second[0]["event"] == "resumed" and second[0]["step"] == 2
    assert [ln["loss"] for ln in _steps(second)] == [
        ln["loss"] for ln in _steps(whole)[2:]]
    for name in ("params.safetensors", "opt_state.safetensors"):
        assert (tmp_path / "a" / "4" / name).read_bytes() == \
            (tmp_path / "b" / "4" / name).read_bytes(), name
    params, step = restore_model_params(str(tmp_path / "a"),
                                        tm.moe_presets()["moe-tiny"], "cpu")
    assert step == 4
    assert params["layers"]["moe"]["router"].dtype == torch.float32


def test_trainer_cli_quiesce_and_profile(tmp_path):
    """SIGTERM after the first step saves it and says so; a restart with
    --profile-dir continues and writes a trace of its steps."""
    ck = str(tmp_path / "ck")
    rc, lines = _train([*SMALL, "--steps", "1000", "--ckpt-dir", ck,
                        "--save-every", "1000"], quiesce_after=1)
    assert rc == 0 and lines[-1]["event"] == "quiesced"
    n = lines[-1]["step"]
    assert [ln["step"] for ln in lines if ln.get("event") == "saved"] == [n]
    prof = str(tmp_path / "prof")
    rc, lines = _train([*SMALL, "--steps", str(n + 3), "--ckpt-dir", ck,
                        "--profile-dir", prof, "--profile-steps", "1"])
    assert rc == 0
    assert [ln["step"] for ln in _steps(lines)] == [n + 1, n + 2, n + 3]
    written = [ln for ln in lines if ln.get("event") == "profile_written"]
    assert len(written) == 1 and (tmp_path / "prof" / "trace.json").exists()


def test_trainer_cli_lora_on_a_moe_tree(tmp_path):
    """--lora-rank 4 on wq,wv of a MoE tree: adapter-only checkpoints
    (A and B of wq and wv, f32), and a restart resumes them."""
    ck = str(tmp_path / "lora")
    rc, lines = _train([*SMALL, "--steps", "2", "--lora-rank", "4",
                        "--ckpt-dir", ck, "--optim", "adamw-int8"])
    assert rc == 0 and lines[-1] == {"event": "done", "step": 2}
    params = CheckpointManager(ck).restore_params(device="cpu")
    attn = params["layers"]["attn"]
    assert set(params) == {"layers"} and set(params["layers"]) == {"attn"}
    assert set(attn) == {"wq", "wv"}
    assert attn["wq"]["a"].shape == (2, 64, 4)
    assert attn["wq"]["a"].dtype == torch.float32
    rc, lines = _train([*SMALL, "--steps", "3", "--lora-rank", "4",
                        "--ckpt-dir", ck, "--optim", "adamw-int8"])
    assert rc == 0
    assert (lines[0]["event"], lines[0]["step"]) == ("resumed", 2)


@pytest.mark.parametrize("flags,msg", [
    (["--preset", "tiny", "--moe-dispatch", "einsum"],
     "--moe-dispatch applies to moe: presets only"),
    (["--preset", "moe:moe-tiny", "--lora-rank", "4", "--qlora"],
     "--qlora supports llama presets only")])
def test_trainer_keeps_the_jax_family_guards(capsys, flags, msg):
    with pytest.raises(SystemExit) as e:
        train_cli.parse_args(["--device", "cpu", *flags])
    assert e.value.code == 2 and msg in capsys.readouterr().err


# ----------------------------------------------------------------- server

def _serve(argv):
    srv = Server(parse_args(["--device", "cpu", "--preset", "moe:moe-tiny",
                             "--host", "127.0.0.1", "--port", "0",
                             "--max-seq", "64", *argv]))
    t = threading.Thread(target=srv.httpd.serve_forever, daemon=True)
    t.start()
    return srv, t


def _stop(srv, t):
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


def _greedy_in_memory(cfg, params, prompt, max_new, **kw):
    eng = SlotEngine(cfg, params, slots=4, max_seq=64, chunk=4,
                     cache_dtype=cfg.dtype, **kw)
    h = eng.submit(prompt, max_new)
    while not h.done():
        eng.step()
    return h.result(0)["tokens"]


@pytest.fixture(scope="module")
def moe_server():
    srv, t = _serve(["--slots", "4", "--chunk", "4"])
    yield srv
    _stop(srv, t)


def test_moe_server_generates(moe_server):
    """The analog of tests/test_serve.py's moe preset case, and more:
    greedy ragged rows equal the in-memory engine's, a stream equals
    the greedy tokens, /healthz names the preset. The tree is not fused
    (fusion is Llama-only)."""
    srv = moe_server
    attn = srv.params["layers"]["attn"]
    assert "w_qkv" not in attn and {"wq", "wk", "wv"} <= set(attn)
    assert isinstance(srv.cfg, tm.MoEConfig)
    code, data = _request(srv, "POST", "/generate", {
        "tokens": [[1, 2, 3], [4, 5, 6, 7, 8, 9]], "maxNewTokens": 4})
    assert code == 200
    body = json.loads(data)
    assert body["lengths"] == [4, 4]
    assert body["tokens"][0] == _greedy_in_memory(srv.cfg, srv.params,
                                                  [1, 2, 3], 4)
    code, data = _request(srv, "POST", "/generate", {
        "tokens": [[1, 2, 3]], "maxNewTokens": 4, "stream": True})
    lines = [json.loads(ln) for ln in data.decode().splitlines() if ln]
    assert [ln["t"] for ln in lines[:-1]] == body["tokens"][0]
    assert lines[-1] == {"done": True, "length": 4}
    code, data = _request(srv, "GET", "/healthz")
    assert code == 200 and json.loads(data)["model"] == "moe:moe-tiny"


def test_moe_server_prefixes(moe_server):
    srv = moe_server
    prefix = [((i * 7) % 251) + 1 for i in range(20)]
    code, data = _request(srv, "POST", "/prefixes", {"tokens": prefix})
    assert code == 200
    pid = json.loads(data)["prefixId"]
    prompt = prefix + [11, 12]
    code, data = _request(srv, "POST", "/generate", {
        "tokens": [prompt], "maxNewTokens": 5})
    assert code == 200
    assert srv.engine.stats["prefix_hits"] >= 1
    assert json.loads(data)["tokens"][0] == _greedy_in_memory(
        srv.cfg, srv.params, prompt, 5)
    assert _request(srv, "DELETE", f"/prefixes/{pid}")[0] == 200


def test_moe_server_prefill_chunk_and_legacy_path():
    """--prefill-chunk segments and the --slots 0 generator on moe:."""
    srv, t = _serve(["--slots", "2", "--chunk", "2", "--prefill-chunk",
                     "8"])
    try:
        prompt = [((i * 5) % 251) + 1 for i in range(30)]
        code, data = _request(srv, "POST", "/generate", {
            "tokens": [prompt], "maxNewTokens": 4})
        assert code == 200 and srv.engine.stats["segment_prefills"] > 1
        assert json.loads(data)["tokens"][0] == _greedy_in_memory(
            srv.cfg, srv.params, prompt, 4, prefill_chunk=8)
    finally:
        _stop(srv, t)
    srv, t = _serve(["--slots", "0"])
    try:
        code, data = _request(srv, "POST", "/generate", {
            "tokens": [[1, 2], [3, 4]], "maxNewTokens": 3})
        assert code == 200 and json.loads(data)["lengths"] == [3, 3]
    finally:
        _stop(srv, t)


def test_moe_server_serves_a_checkpoint(tmp_path):
    """--ckpt-dir restores a MoE training checkpoint (params only): the
    server's greedy tokens are those of the params in memory."""
    rc, _ = _train([*SMALL, "--steps", "2", "--ckpt-dir",
                    str(tmp_path / "ck"), "--optim", "adamw-int8"])
    assert rc == 0
    cfg = tm.moe_presets()["moe-tiny"]
    params, step = restore_model_params(str(tmp_path / "ck"), cfg, "cpu")
    srv, t = _serve(["--slots", "4", "--chunk", "4", "--ckpt-dir",
                     str(tmp_path / "ck")])
    try:
        prompt = [5, 9, 2, 7, 31]
        code, data = _request(srv, "POST", "/generate", {
            "tokens": [prompt], "maxNewTokens": 6})
        assert code == 200
        assert json.loads(data)["tokens"][0] == _greedy_in_memory(
            cfg, params, prompt, 6)
        assert json.loads(_request(srv, "GET", "/healthz")[1])["step"] == 2
    finally:
        _stop(srv, t)


@pytest.mark.parametrize("flags,msg", [
    (["--quantize"], "--quantize currently supports llama presets only"),
    (["--page-size", "16"], "--page-size requires a llama preset"),
    (["--draft-preset", "tiny"], "requires llama presets")])
def test_server_keeps_the_jax_family_guards(capsys, flags, msg):
    with pytest.raises(SystemExit) as e:
        parse_args(["--preset", "moe:moe-tiny", *flags])
    assert e.value.code == 2 and msg in capsys.readouterr().err


# -------------------------------------------------------------- benchmark

def test_bench_moe_serving_keys_as_jax():
    kw = dict(preset="moe-tiny", batch=2, prompt_len=8, new_tok=4,
              max_seq=32, reps=1)
    jres = jbench.bench_moe_serving(**kw)
    tres = tbench.bench_moe_serving(**kw, device="cpu")
    json.dumps(tres)
    assert set(tres) - set(jres) == {"card"} and set(jres) <= set(tres)
    for k in ("preset", "batch", "new_tokens"):
        assert tres[k] == jres[k], k
    assert tres["decode_tok_s"] > 0 and tres["card"] == "cpu"


def test_bench_moe_serving_defaults_as_jax():
    import inspect

    jsig = inspect.signature(jbench.bench_moe_serving).parameters
    tsig = inspect.signature(tbench.bench_moe_serving).parameters
    for name, p in jsig.items():
        assert tsig[name].default == p.default, name
    assert tsig["device"].default == "cuda"
