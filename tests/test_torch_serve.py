"""The port's HTTP server, in process on the CPU (tiny preset):
/healthz, /metrics, /generate (ragged rows, sampling, validation), a
streamed request, weights from ``--ckpt-dir`` and ``--hf-ckpt`` answering
greedy requests with the tokens of the params in memory, int8 serving
(``--quantize``) and text bodies (``--tokenizer``), /prefixes,
``--prefill-chunk`` and the paged cache (``--page-size``,
``--total-pages``) answering as an in-memory engine of the same settings,
and the JAX flags the port refuses by name."""

import http.client
import json
import threading

import pytest
import torch

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
    assert body["quantized"] is False and body["tokenizer"] is False


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


def _write_wordlevel(path):
    """A WordLevel + Whitespace tokenizer.json (the JAX tests' kind) whose
    ids fit the tiny preset's vocabulary of 256."""
    from tokenizers import Tokenizer as RustTokenizer
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import Whitespace

    words = ["<unk>", "hello", "world", "tpu", "serving"] + [
        f"w{i}" for i in range(200)]
    tok = RustTokenizer(WordLevel({w: i for i, w in enumerate(words)},
                                  unk_token="<unk>"))
    tok.pre_tokenizer = Whitespace()
    tok.save(str(path))
    return str(path)


@pytest.mark.parametrize("source", ["--ckpt-dir", "--hf-ckpt"])
def test_serves_checkpoint_weights(trained, source):
    cfg, params, root = trained
    where = str(root / ("ckpt" if source == "--ckpt-dir" else "tiny-hf"))
    tok_flags = []
    if source == "--ckpt-dir":
        tok_flags = ["--tokenizer", _write_wordlevel(root / "words.json")]
    else:  # picked up from the checkpoint directory
        _write_wordlevel(root / "tiny-hf" / "tokenizer.json")
    srv = Server(parse_args(["--device", "cpu", "--preset", "tiny", source,
                             where, "--host", "127.0.0.1", "--port", "0",
                             "--max-seq", "64", "--slots", "4",
                             "--chunk", "4", *tok_flags]))
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
        assert health["tokenizer"] is True and health["quantized"] is False
        # a text round trip: the prompt's ids are the tokenizer's, and the
        # reply's "texts" decode the generated ids
        code, data = _request(srv, "POST", "/generate", {
            "text": ["hello tpu world"], "maxNewTokens": 8})
        body = json.loads(data)
        assert code == 200
        assert body["tokens"][0] == _greedy_in_memory(cfg, params, [1, 3, 2],
                                                      8)
        assert body["texts"] == [srv.tokenizer.decode(body["tokens"][0])]
    finally:
        srv.httpd.shutdown()
        srv.close()
        t.join(timeout=10)


@pytest.mark.parametrize("flags,msg", [
    (["--draft-preset", "tiny", "--page-size", "16"], "exclusive"),
    (["--lora-rank", "8"], "require --lora-ckpt"),
    (["--lora-ckpt", "a"], "--lora-ckpt requires --lora-rank"),
    (["--draft-preset", "tiny", "--prefill-chunk", "8"],
     "--prefill-chunk is not supported with --draft-preset"),
    (["--draft-preset", "moe:moe-tiny"], "requires llama presets"),
    (["--tp", "2", "--quantize"], "single-device only"),
    (["--platform", "cpu", "--virtual-devices", "4"], "use --device"),
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


def test_every_unported_jax_flag_is_refused_by_name(capsys):
    """Each flag of the JAX server that the port lacks names itself and
    what brings it, never argparse's generic "unrecognized arguments"."""
    from tpu_docker_api_torch.serve.__main__ import _NOT_PORTED

    for names in _NOT_PORTED.values():
        for name in names:
            flag = "--" + name.replace("_", "-")
            with pytest.raises(SystemExit) as e:
                parse_args([flag, "1"])
            err = capsys.readouterr().err
            assert e.value.code == 2 and flag in err
            assert "unrecognized" not in err


# ------------------------------------------------- int8 and text serving

VOCAB = 320  # the byte-level tokenizer's ids fit; the tiny preset's 256 not


@pytest.fixture(scope="module")
def int8_text(tmp_path_factory):
    """An HF checkpoint of the tiny preset at vocab 320 with a Llama-3
    style byte-level tokenizer.json (vocab 300) beside it, and a second
    directory whose tokenizer_config.json names an eos token."""
    import dataclasses

    import torch

    from test_torch_tokenizer import write_llama3_style
    from tpu_docker_api_torch.models.import_weights import export_hf_llama
    from tpu_docker_api_torch.models.llama import llama_init, llama_presets

    root = tmp_path_factory.mktemp("int8_text")
    cfg = dataclasses.replace(llama_presets()["tiny"], vocab_size=VOCAB)
    params = llama_init(cfg, torch.Generator().manual_seed(3))
    export_hf_llama(params, cfg, str(root / "hf"))
    write_llama3_style(str(root / "hf" / "tokenizer.json"), vocab_size=300)
    return cfg, root


def _serve(argv):
    srv = Server(parse_args(["--device", "cpu", "--host", "127.0.0.1",
                             "--port", "0", "--max-seq", "64", "--chunk",
                             "4", *argv]))
    t = threading.Thread(target=srv.httpd.serve_forever, daemon=True)
    t.start()
    return srv, t


def _stop(srv, t):
    srv.httpd.shutdown()
    srv.close()
    t.join(timeout=10)


@pytest.fixture(scope="module")
def int8_server(int8_text):
    _, root = int8_text
    srv, t = _serve(["--hf-ckpt", str(root / "hf"), "--quantize",
                     "--slots", "4"])
    yield srv
    _stop(srv, t)


TEXTS = ["Hello world! It's a test.", "Café 東京 🚀 42\n\nend"]


def test_int8_healthz_and_tree(int8_server):
    from tpu_docker_api_torch.ops.quant import QuantizedLinear

    _, data = _request(int8_server, "GET", "/healthz")
    health = json.loads(data)
    assert health["quantized"] is True and health["tokenizer"] is True
    assert health["model"] == "hf"
    layers = int8_server.params["layers"]
    for leaf in (layers["attn"]["w_qkv"], layers["mlp"]["w_down"],
                 int8_server.params["lm_head"]):
        assert isinstance(leaf, QuantizedLinear)


def test_int8_greedy_equals_int8_at_load_in_memory(int8_text, int8_server):
    """The server's tokens are the slot engine's on the int8 tree that
    ``import_hf_llama(quantize=True)`` gives, fused."""
    from tpu_docker_api_torch.models.import_weights import import_hf_llama

    cfg, root = int8_text
    _, qparams = import_hf_llama(str(root / "hf"), device="cpu",
                                 quantize=True)
    prompt = [5, 9, 2, 7, 31, 300, 12]
    _, data = _request(int8_server, "POST", "/generate", {
        "tokens": [prompt], "maxNewTokens": 8})
    assert json.loads(data)["tokens"][0] == _greedy_in_memory(
        cfg, qparams, prompt, 8)


def test_text_request_answers_texts(int8_server):
    tok = int8_server.tokenizer
    code, data = _request(int8_server, "POST", "/generate", {
        "text": TEXTS, "maxNewTokens": 6})
    body = json.loads(data)
    assert code == 200 and len(body["texts"]) == 2
    _, ids = _request(int8_server, "POST", "/generate", {
        "tokens": [tok.encode(t) for t in TEXTS], "maxNewTokens": 6})
    assert body["tokens"] == json.loads(ids)["tokens"]
    assert body["texts"] == [tok.decode(r[:n]) for r, n in
                             zip(body["tokens"], body["lengths"])]


def test_text_stream_done_line_carries_the_text(int8_server):
    code, data = _request(int8_server, "POST", "/generate", {
        "text": [TEXTS[0]], "maxNewTokens": 6, "stream": True})
    lines = [json.loads(ln) for ln in data.decode().splitlines() if ln]
    assert code == 200 and lines[-1]["done"] is True
    _, ref = _request(int8_server, "POST", "/generate", {
        "text": [TEXTS[0]], "maxNewTokens": 6})
    ref = json.loads(ref)
    assert [ln["t"] for ln in lines[:-1]] == ref["tokens"][0]
    assert lines[-1]["text"] == ref["texts"][0]


@pytest.mark.parametrize("body,msg", [
    ({"text": ["a"], "tokens": [[1]]}, "exclusive"),
    ({"text": "not a list"}, "non-empty list"),
    ({"text": ["ok", ""]}, "non-empty list"),
    ({"text": [3]}, "non-empty list")])
def test_bad_text_bodies(int8_server, body, msg):
    code, data = _request(int8_server, "POST", "/generate", body)
    assert code == 400 and msg in json.loads(data)["error"]


def test_text_without_a_tokenizer_is_a_400(server):
    code, data = _request(server, "POST", "/generate", {"text": ["hi"]})
    assert code == 400 and "--tokenizer" in json.loads(data)["error"]


def test_text_stops_at_the_tokenizers_eos(int8_text, int8_server, tmp_path):
    """With tokenizer_config.json naming an eos token, a text request
    stops at it (inclusive) unless the body names its own eosId."""
    import shutil

    from transformers import PreTrainedTokenizerFast

    _, root = int8_text
    _, data = _request(int8_server, "POST", "/generate", {
        "text": [TEXTS[1]], "maxNewTokens": 8})
    free = json.loads(data)["tokens"][0]
    eos = int8_server.tokenizer._tok.id_to_token(free[2])
    tok_dir = tmp_path / "tok"
    PreTrainedTokenizerFast(
        tokenizer_file=str(root / "hf" / "tokenizer.json"),
        eos_token=eos).save_pretrained(tok_dir)
    hf_dir = tmp_path / "hf"
    shutil.copytree(root / "hf", hf_dir)
    srv, t = _serve(["--hf-ckpt", str(hf_dir), "--quantize", "--slots", "2",
                     "--tokenizer", str(tok_dir)])
    try:
        assert srv.tokenizer.eos_id == free[2]
        _, data = _request(srv, "POST", "/generate", {
            "text": [TEXTS[1]], "maxNewTokens": 8})
        body = json.loads(data)
        first = free.index(free[2])
        assert body["lengths"] == [first + 1]
        assert body["tokens"][0][:first + 1] == free[:first + 1]
        _, data = _request(srv, "POST", "/generate", {
            "text": [TEXTS[1]], "maxNewTokens": 8, "eosId": VOCAB - 1})
        assert json.loads(data)["tokens"][0] == free
        # token-id requests never take the tokenizer's eos
        _, data = _request(srv, "POST", "/generate", {
            "tokens": [srv.tokenizer.encode(TEXTS[1])], "maxNewTokens": 8})
        assert json.loads(data)["lengths"] == [8]
    finally:
        _stop(srv, t)


def test_legacy_path_answers_texts(int8_text, int8_server):
    _, root = int8_text
    srv, t = _serve(["--hf-ckpt", str(root / "hf"), "--quantize",
                     "--slots", "0"])
    try:
        # this path needs equal-length rows: two texts of one token count
        tok = srv.tokenizer
        pair = ["Hello world", next(t for t in ("Hello there", "Bye world",
                                                "Hello, world", "Hello")
                                    if len(tok.encode(t)) == len(
                                        tok.encode("Hello world")))]
        code, data = _request(srv, "POST", "/generate", {
            "text": pair, "maxNewTokens": 5})
        body = json.loads(data)
        assert code == 200 and len(body["texts"]) == 2
        assert body["texts"] == [srv.tokenizer.decode(r[:n]) for r, n in
                                 zip(body["tokens"], body["lengths"])]
        _, ref = _request(int8_server, "POST", "/generate", {
            "text": ["Hello world"], "maxNewTokens": 5})
        assert body["tokens"][0] == json.loads(ref)["tokens"][0]
    finally:
        _stop(srv, t)


def test_quantize_after_a_checkpoint_load(trained):
    """--ckpt-dir --quantize: the restored tree, then quantize_llama_params
    (the JAX server's order), then fusion."""
    from tpu_docker_api_torch.infer.quantize import quantize_llama_params

    cfg, params, root = trained
    srv, t = _serve(["--preset", "tiny", "--ckpt-dir", str(root / "ckpt"),
                     "--quantize", "--slots", "4"])
    try:
        prompt = [3, 1, 4, 1, 5]
        _, data = _request(srv, "POST", "/generate", {
            "tokens": [prompt], "maxNewTokens": 8})
        assert json.loads(data)["tokens"][0] == _greedy_in_memory(
            cfg, quantize_llama_params(params), prompt, 8)
    finally:
        _stop(srv, t)


def test_int8_greedy_tokens_follow_jax(int8_text):
    """The JAX server's engine on the int8 tree of its own int8-at-load
    import, f32 activations, against the port's forward on the same tree
    (converted), teacher-forced on the JAX tokens: at every step the JAX
    token is the port's argmax, or within 0.05 of its max logit. Each
    int8 product is bit-equal between the packages
    (tests/test_torch_quant.py); the float parts sum in each framework's
    order (~1e-7 apart), and where an activation sits on a rounding
    boundary it quantizes one count apart, which moves the logits by a
    few hundredths and may flip a near-tie (observed: 47 of 48 steps
    exact, the other 0.011 below the max)."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from tpu_docker_api.infer.quantize import fuse_llama_projections as jfuse
    from tpu_docker_api.infer.slots import SlotEngine as JSlotEngine
    from tpu_docker_api.models import import_weights as jiw
    from tpu_docker_api_torch.models.convert import params_from_numpy
    from tpu_docker_api_torch.models.llama import (llama_forward,
                                                   llama_presets)

    _, root = int8_text
    jcfg, jq = jiw.import_hf_llama(str(root / "hf"), quantize=True)
    jcfg = dataclasses.replace(jcfg, dtype=jnp.float32)
    jq = jfuse(jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x,
        jq))
    tcfg = dataclasses.replace(llama_presets()["tiny"], vocab_size=VOCAB,
                               dtype=torch.float32)
    tq = params_from_numpy(jax.tree_util.tree_map(np.asarray, jq), "cpu")
    exact = steps = 0
    for seed in range(4):
        prompt = np.random.default_rng(seed).integers(0, VOCAB, 9).tolist()
        jeng = JSlotEngine(jcfg, jq, slots=4, max_seq=64, chunk=4)
        jh = jeng.submit(prompt, 12)
        while not jh.done():
            jeng.step()
        want = jh.result(0)["tokens"]
        with torch.no_grad():
            logits = llama_forward(tq, torch.tensor([prompt + want]), tcfg)[0]
        for i, t in enumerate(want):
            row = logits[len(prompt) - 1 + i]
            assert row.max() - row[t] <= 0.05, (seed, i)
            exact += int(row.argmax()) == t
            steps += 1
    assert exact >= 0.9 * steps


# ------------------------------------- prefixes, segments and the paged cache

PX = list(range(5, 5 + 32))  # bucket 32; two pages at --page-size 16


def test_prefixes_round_trip(server):
    """POST registers (and dedupes), GET lists with the bytes the K/V
    pin, a prompt extending the prefix takes the suffix route with the
    tokens of the whole-prompt route, DELETE removes once."""
    code, data = _request(server, "POST", "/prefixes", {"tokens": PX})
    body = json.loads(data)
    assert code == 200 and body["length"] == len(PX)
    pid = body["prefixId"]
    _, again = _request(server, "POST", "/prefixes", {"tokens": PX})
    assert json.loads(again)["prefixId"] == pid
    _, data = _request(server, "GET", "/prefixes")
    (entry,) = json.loads(data)["prefixes"]
    # 2 x layers x bucket 32 x kv heads x head_dim x bf16
    assert entry == {"id": pid, "length": len(PX),
                     "bytes": 2 * 2 * 32 * 2 * 16 * 2}
    hits = server.engine.stats["prefix_hits"]
    _, data = _request(server, "POST", "/generate", {
        "tokens": [PX + [9, 9, 9]], "maxNewTokens": 5})
    assert server.engine.stats["prefix_hits"] == hits + 1
    assert len(json.loads(data)["tokens"][0]) == 5
    for removed in (True, False):
        code, data = _request(server, "DELETE", f"/prefixes/{pid}")
        assert code == 200 and json.loads(data) == {"removed": removed}
    _, data = _request(server, "GET", "/prefixes")
    assert json.loads(data)["prefixes"] == []
    assert server.engine.stats["prefix_bytes"] == 0


@pytest.mark.parametrize("body,msg", [
    ({"tokens": []}, "non-empty list"),
    ({"tokens": [1, 999]}, "non-empty list"),
    ({"text": "hi"}, "--tokenizer"),
    ({"tokens": [1] * 63}, "no room")])
def test_bad_prefix_bodies(server, body, msg):
    code, data = _request(server, "POST", "/prefixes", body)
    assert code == 400 and msg in json.loads(data)["error"]


def test_prefix_text_body(int8_server):
    tok = int8_server.tokenizer
    code, data = _request(int8_server, "POST", "/prefixes",
                          {"text": TEXTS[0]})
    body = json.loads(data)
    assert code == 200 and body["length"] == len(tok.encode(TEXTS[0]))
    code, data = _request(int8_server, "POST", "/prefixes",
                          {"text": [TEXTS[0]]})
    assert code == 400 and "ONE" in json.loads(data)["error"]
    _request(int8_server, "DELETE", f"/prefixes/{body['prefixId']}")


def test_prefixes_need_the_slot_engine():
    srv, t = _serve(["--preset", "tiny", "--slots", "0"])
    try:
        for method, path, body in (("GET", "/prefixes", None),
                                   ("POST", "/prefixes", {"tokens": [1]}),
                                   ("DELETE", "/prefixes/px-1", None)):
            code, data = _request(srv, method, path, body)
            assert code == 400 and "slot engine" in json.loads(data)["error"]
    finally:
        _stop(srv, t)


def test_prefix_byte_budget_refused():
    """--max-prefix-bytes: a registration past the budget is a 400, and
    a removal gives its bytes back."""
    per = 2 * 2 * 32 * 2 * 16 * 2   # one bucket-32 prefix, bf16
    srv, t = _serve(["--preset", "tiny", "--slots", "2",
                     "--max-prefix-bytes", str(per)])
    try:
        code, data = _request(srv, "POST", "/prefixes", {"tokens": PX})
        pid = json.loads(data)["prefixId"]
        code, data = _request(srv, "POST", "/prefixes",
                              {"tokens": PX[:10]})
        assert code == 400 and "byte budget" in json.loads(data)["error"]
        _request(srv, "DELETE", f"/prefixes/{pid}")
        code, _ = _request(srv, "POST", "/prefixes", {"tokens": PX[:10]})
        assert code == 200
    finally:
        _stop(srv, t)


def test_draft_preset_serves_greedy_and_falls_back_sampled():
    """--draft-preset tiny at --seed 0: the draft's weights are the
    target's (acceptance ~1). /healthz shows speculative and nSpec;
    greedy rows answer with the tokens of an in-memory speculative engine
    of the same settings and the isolated greedy decode; a sampled
    request takes the --slots 0 path instead of a 400."""
    from tpu_docker_api_torch.infer.slots import SpeculativeSlotEngine

    srv, t = _serve(["--preset", "tiny", "--slots", "2", "--seed", "0",
                     "--draft-preset", "tiny", "--n-spec", "3"])
    try:
        eng = srv.engine
        assert isinstance(eng, SpeculativeSlotEngine) and eng.chunk == 4
        assert all(torch.equal(a, b) for a, b in zip(
            _leaves(eng.draft_params), _leaves(srv.params)))
        _, data = _request(srv, "GET", "/healthz")
        health = json.loads(data)["slotEngine"]
        assert health["speculative"] is True and health["nSpec"] == 3
        assert health["accepted_tokens"] == 0
        prompts = [[7, 3, 2, 9], [1, 4]]
        code, data = _request(srv, "POST", "/generate", {
            "tokens": prompts, "maxNewTokens": 6, "temperature": 0.0})
        assert code == 200
        got = json.loads(data)["tokens"]
        mem = SpeculativeSlotEngine(srv.cfg, srv.params,
                                    draft_cfg=srv.cfg,
                                    draft_params=srv.params, n_spec=3,
                                    slots=2, max_seq=64,
                                    cache_dtype=srv.cfg.dtype)
        hs = [mem.submit(p, 6) for p in prompts]
        while not all(h.done() for h in hs):
            mem.step()
        assert got == [h.result(0)["tokens"] for h in hs]
        _, data = _request(srv, "GET", "/healthz")
        assert json.loads(data)["slotEngine"]["accepted_tokens"] > 0
        completed = eng.stats["completed"]
        code, data = _request(srv, "POST", "/generate", {
            "tokens": [[1, 2, 3]], "maxNewTokens": 4, "temperature": 0.9,
            "topK": 5})
        assert code == 200 and len(json.loads(data)["tokens"][0]) == 4
        assert eng.stats["completed"] == completed  # not the engine's
        code, data = _request(srv, "POST", "/generate", {
            "tokens": [[1, 2, 3]], "maxNewTokens": 4, "temperature": 0.9,
            "stream": True})
        assert code == 400 and "slot engine" in json.loads(data)["error"]
    finally:
        _stop(srv, t)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def test_draft_ckpt_restores_the_draft(trained):
    """--draft-ckpt restores a training checkpoint's params as the draft
    (fused as the target's are), beside random target weights."""
    from tpu_docker_api_torch.infer.quantize import fuse_llama_projections

    _, params, root = trained
    srv, t = _serve(["--preset", "tiny", "--slots", "2", "--seed", "5",
                     "--draft-preset", "tiny", "--draft-ckpt",
                     str(root / "ckpt")])
    try:
        want = _leaves(fuse_llama_projections(params))
        assert all(torch.equal(a, b) for a, b in zip(
            _leaves(srv.engine.draft_params), want))
        code, data = _request(srv, "POST", "/generate", {
            "tokens": [[5, 9, 2]], "maxNewTokens": 5})
        assert code == 200 and json.loads(data)["lengths"] == [5]
    finally:
        _stop(srv, t)


@pytest.mark.parametrize("flags", [["--draft-ckpt", "d"],
                                   ["--n-spec", "2"]])
def test_draft_flags_require_a_draft_preset(capsys, flags):
    with pytest.raises(SystemExit) as e:
        parse_args(flags)
    assert e.value.code == 2 and "require --draft-preset" in (
        capsys.readouterr().err)


@pytest.mark.parametrize("flags", [
    ["--prefill-chunk", "8"],
    ["--page-size", "16"],
    ["--page-size", "16", "--total-pages", "10", "--prefill-chunk", "8"]])
def test_depth_servers_answer_as_an_in_memory_engine(flags):
    """A server with segments, a paged cache or both answers greedy
    requests (one past --prefill-chunk, one through a registered prefix)
    with the tokens of an in-memory engine of the same settings on the
    server's params; a paged server shows its pool in /healthz and
    /metrics."""
    from tpu_docker_api_torch.infer.paged import PagedSlotEngine
    from tpu_docker_api_torch.infer.slots import SlotEngine

    srv, t = _serve(["--preset", "tiny", "--slots", "4", *flags])
    try:
        prompts = [list(range(3, 40)), PX + [7, 7], [4, 2]]
        code, data = _request(srv, "POST", "/prefixes", {"tokens": PX})
        assert code == 200
        code, data = _request(srv, "POST", "/generate", {
            "tokens": prompts, "maxNewTokens": 6})
        assert code == 200
        got = json.loads(data)["tokens"]
        args = srv.args
        kw = dict(slots=4, max_seq=64, chunk=4, cache_dtype=srv.cfg.dtype,
                  prefill_chunk=args.prefill_chunk)
        want = []
        for p in prompts:
            eng = (PagedSlotEngine(srv.cfg, srv.params,
                                   page_size=args.page_size,
                                   total_pages=args.total_pages or None,
                                   **kw)
                   if args.page_size else SlotEngine(srv.cfg, srv.params,
                                                     **kw))
            eng.register_prefix(PX)
            h = eng.submit(p, 6)
            while not h.done():
                eng.step()
            want.append(h.result(0)["tokens"])
        assert got == want
        _, data = _request(srv, "GET", "/healthz")
        health = json.loads(data)["slotEngine"]
        assert health["prefix_hits"] >= 1
        _, metrics = _request(srv, "GET", "/metrics")
        if args.page_size:
            assert health["pages_total"] == (args.total_pages or 16)
            assert health["pages_free"] == health["pages_total"] - 2
            assert (f"serve_pages_free {health['pages_free']}\n".encode()
                    in metrics)
            assert b"serve_deferred_admissions_total" in metrics
        else:
            assert b"serve_pages_free" not in metrics
        if args.prefill_chunk:
            assert health["segment_prefills"] >= 5
    finally:
        _stop(srv, t)


def test_total_pages_requires_page_size(capsys):
    with pytest.raises(SystemExit) as e:
        parse_args(["--total-pages", "8"])
    assert e.value.code == 2 and "--page-size" in capsys.readouterr().err
