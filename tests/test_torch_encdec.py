"""The port's encoder-decoder family (``models/encdec.py``), its trainer
and server paths and ``bench_encdec_slot_serving``, against the JAX
package's, same weights.

The tiny preset in f32 on the CPU; weights are drawn with numpy from a
seed and cross into both packages through ``models/convert.py``.
Tolerances: f32 encodes, forwards, losses and decode-step logits 1e-5;
gradients 1e-5 of each leaf's largest; a padded row's encode equal to
its unpadded encode at real positions to f32 reduction order (its pad
positions' content changes nothing, bit for bit); ``encdec_generate``
token-exact (greedy, with and without eos); the chunked loss 1e-5
relative; three train steps the losses at 1e-4 and the parameters as
the Llama trainer's test holds them (tests/test_torch_train.py).
"""

import dataclasses
import http.client
import json
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_docker_api.models import encdec as je
from tpu_docker_api.ops.rope import rope_frequencies as jrope
from tpu_docker_api.parallel.mesh import single_device_mesh
from tpu_docker_api.train import optim as jopt
from tpu_docker_api.train import trainer as jtrainer
from tpu_docker_api_torch import models as tmodels
from tpu_docker_api_torch.infer import servebench
from tpu_docker_api_torch.models import encdec as te
from tpu_docker_api_torch.models.convert import (params_from_numpy,
                                                 params_to_numpy)
from tpu_docker_api_torch.ops.rope import rope_frequencies
from tpu_docker_api_torch.train import optim, trainer
from test_torch_vit import ROUTES, _grads_by_route, check_bf16_grads

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5


def numpy_encdec_params(cfg, seed: int) -> dict:
    """An encdec param tree of numpy f32 arrays from a numpy seed (norm
    scales drawn around 1, matrices scaled by 1/sqrt(fan_in)), in the
    layout both packages share."""
    rng = np.random.default_rng(seed)

    def make(spec):
        if isinstance(spec, dict):
            return {k: make(v) for k, v in spec.items()}
        shape, fan_in = spec
        noise = rng.standard_normal(shape).astype(np.float32)
        if fan_in is None:
            return 1.0 + 0.1 * noise
        return noise / np.float32(np.sqrt(fan_in))

    return make(te.encdec_param_specs(cfg))


def _cfgs(**kw):
    return (dataclasses.replace(je.encdec_presets()["tiny"],
                                dtype=jnp.float32, **kw),
            dataclasses.replace(te.encdec_presets()["tiny"],
                                dtype=torch.float32, **kw))


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = _cfgs()
    tree = numpy_encdec_params(tcfg, seed=3)
    return (jcfg, tcfg, jax.tree_util.tree_map(jnp.asarray, tree),
            params_from_numpy(tree, "cpu"))


def _tokens(b, s, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (b, s)).astype(
        np.int32)


def _t(a):
    return torch.from_numpy(np.asarray(a)).long()


# ----------------------------------------------------- config and init

@pytest.mark.parametrize("name", ["encdec-base", "tiny"])
def test_presets_fields_and_flops_as_jax(name):
    jcfg, tcfg = je.encdec_presets()[name], te.encdec_presets()[name]
    for f in dataclasses.fields(je.EncDecConfig):
        if f.name != "dtype":
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    assert tcfg.dtype == torch.bfloat16 and tcfg.head_dim == jcfg.head_dim
    for s, t in ((512, 512), (128, 96), (17, 3)):
        assert tcfg.flops_per_pair(s, t) == jcfg.flops_per_pair(s, t)
    assert set(te.encdec_presets()) == set(je.encdec_presets())


@pytest.mark.parametrize("name", ["encdec-base", "tiny"])
def test_param_shapes_and_dtypes_match_jax_init(name):
    jcfg, tcfg = je.encdec_presets()[name], te.encdec_presets()[name]
    abstract = jax.eval_shape(lambda: je.encdec_init(jcfg,
                                                     jax.random.PRNGKey(0)))
    shapes, dtypes = tmodels.param_shapes(tcfg), tmodels.param_dtypes(tcfg)
    paths = jax.tree_util.tree_leaves_with_path(abstract)
    for path, leaf in paths:
        s, d = shapes, dtypes
        for p in path:
            s, d = s[p.key], d[p.key]
        assert tuple(s) == leaf.shape, path
        assert str(d).split(".")[-1] == str(leaf.dtype), path
    assert len(paths) == len(jax.tree_util.tree_leaves(
        shapes, is_leaf=lambda x: isinstance(x, tuple)))


def test_init_and_registry():
    cfg = te.encdec_presets()["tiny"]
    p = te.encdec_init(cfg, torch.Generator().manual_seed(0))
    assert bool((p["dec_layers"]["cross_norm"] == 1).all())
    wk = p["dec_layers"]["cross_attn"]["wk"].float()
    assert wk.abs().max() <= 2 / cfg.dim**0.5 + 1e-3
    assert not torch.equal(wk[0], wk[1])
    assert tmodels.model_fns(cfg)[:2] == (te.encdec_init, te.encdec_loss)
    assert tmodels.resolve_preset("encdec:encdec-base") == (
        "encdec", te.encdec_presets()["encdec-base"])
    with pytest.raises(TypeError):
        tmodels.cached_forward_fn(cfg)  # decodes through its own engine


# ------------------------------------------------------------ encode

def test_encode_matches_jax(setup):
    jcfg, tcfg, jp, tp = setup
    src = _tokens(2, 13)
    ref = np.asarray(je.encdec_encode(jp, jnp.asarray(src), jcfg))
    got = te.encdec_encode(tp, _t(src), tcfg)
    assert got.dtype == torch.float32 and got.shape == (2, 13, 64)
    np.testing.assert_allclose(got.detach().numpy(), ref, atol=TOL)


def test_encode_with_kv_len_matches_jax_and_the_unpadded_encode(setup):
    """A right-padded row with its ``kv_len`` encodes as the JAX function
    does and as the unpadded source at the real positions, and what the
    pad positions hold changes nothing there, bit for bit (masked scores
    add exp(-1e30 - max) == 0). Against the unpadded encode it agrees to
    f32 reduction order, not bit for bit: torch's CPU softmax and
    matmuls sum in an order that follows the length (1.2e-6 apart)."""
    jcfg, tcfg, jp, tp = setup
    src = _tokens(2, 16, seed=1)
    lens = np.array([16, 9], np.int32)
    ref = np.asarray(je.encdec_encode(jp, jnp.asarray(src), jcfg,
                                      kv_len=jnp.asarray(lens)))
    got = te.encdec_encode(tp, _t(src), tcfg,
                           kv_len=_t(lens)).detach().numpy()
    np.testing.assert_allclose(got, ref, atol=TOL)
    alone = te.encdec_encode(tp, _t(src[1:, :9]), tcfg).detach().numpy()
    np.testing.assert_allclose(got[1, :9], alone[0], atol=TOL)
    other_pad = src.copy()
    other_pad[1, 9:] = _tokens(1, 7, seed=9)[0]
    again = te.encdec_encode(tp, _t(other_pad), tcfg,
                             kv_len=_t(lens)).detach().numpy()
    np.testing.assert_array_equal(again[1, :9], got[1, :9])
    np.testing.assert_array_equal(again[0], got[0])


# ----------------------------------------------------- forward and loss

def test_forward_matches_jax(setup):
    jcfg, tcfg, jp, tp = setup
    src, tgt = _tokens(2, 11, seed=2), _tokens(2, 7, seed=3)
    ref = np.asarray(je.encdec_forward(jp, (jnp.asarray(src),
                                            jnp.asarray(tgt)), jcfg))
    got = te.encdec_forward(tp, (_t(src), _t(tgt)), tcfg)
    assert got.dtype == torch.float32 and got.shape == (2, 7, 256)
    np.testing.assert_allclose(got.detach().numpy(), ref, atol=TOL)


@pytest.mark.parametrize("chunk", [0, 5])
@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_jax(setup, chunk, remat):
    """Dense and chunked (``loss_chunk_rows``) heads, remat on and off,
    at equal source and target lengths (the cross-attention a
    self-attention shape) and the loss against the JAX function."""
    jcfg, tcfg, jp, tp = setup
    jcfg, tcfg = (dataclasses.replace(c, loss_chunk_rows=chunk, remat=remat)
                  for c in (jcfg, tcfg))
    src, tgt = _tokens(2, 10, seed=4), _tokens(2, 11, seed=5)
    jloss, jgrads = jax.value_and_grad(je.encdec_loss)(
        jp, (jnp.asarray(src), jnp.asarray(tgt)), jcfg)
    live = optim.tree_map(lambda t: t.detach().requires_grad_(), tp)
    loss = te.encdec_loss(live, (_t(src), _t(tgt)), tcfg)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=TOL)
    got = dict(jax.tree_util.tree_leaves_with_path(
        params_to_numpy(optim.tree_map(lambda t: t.grad, live))))
    for path, ref in jax.tree_util.tree_leaves_with_path(jgrads):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got[path], ref,
                                   atol=TOL * np.abs(ref).max(),
                                   err_msg=str(path))


def test_synthetic_batch_rows_are_layout_invariant():
    cfg = te.encdec_presets()["tiny"]
    src, tgt = te.encdec_synthetic_batch((1, 3), 4, 12, 9, cfg)
    assert src.shape == (4, 12) and tgt.shape == (4, 10)
    assert src.dtype == tgt.dtype == torch.long
    assert 0 <= int(src.min()) and int(tgt.max()) < 256
    lo = te.encdec_synthetic_batch((1, 3), 1, 12, 9, cfg)
    hi = te.encdec_synthetic_batch((1, 3), 3, 12, 9, cfg, row_offset=1)
    assert torch.equal(torch.cat([lo[0], hi[0]]), src)
    assert torch.equal(torch.cat([lo[1], hi[1]]), tgt)


# ------------------------------------------------------------- decode

def test_slot_decode_step_matches_jax(setup):
    """One decode position for 3 slots at positions 0, 4 and 7 (caches
    holding earlier positions), ragged source lengths and a read bucket:
    logits at 1e-5 and the caches written at each row's position."""
    jcfg, tcfg, jp, tp = setup
    rng = np.random.default_rng(6)
    Ld, S, T, C, kvh, hd = 2, 3, 16, 12, 2, 16
    kc = rng.standard_normal((Ld, S, T, kvh, hd)).astype(np.float32)
    vc = rng.standard_normal((Ld, S, T, kvh, hd)).astype(np.float32)
    ck = rng.standard_normal((Ld, S, C, kvh, hd)).astype(np.float32)
    cv = rng.standard_normal((Ld, S, C, kvh, hd)).astype(np.float32)
    tok, pos = np.array([0, 5, 9], np.int32), np.array([0, 4, 7], np.int32)
    src_lens = np.array([12, 3, 7], np.int32)
    jc, js = jrope(jcfg.head_dim, T, jcfg.rope_theta)
    ref, rk, rv = je.encdec_slot_decode_step(
        jp, jnp.asarray(tok), jnp.asarray(pos), jcfg, jnp.asarray(kc),
        jnp.asarray(vc), jnp.asarray(ck), jnp.asarray(cv),
        jnp.asarray(src_lens), jc, js, kv_limit=8)
    tk, tvv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    got, gk, gv = te.encdec_slot_decode_step(
        tp, _t(tok), _t(pos), tcfg, tk, tvv, torch.from_numpy(ck),
        torch.from_numpy(cv), _t(src_lens),
        *rope_frequencies(tcfg.head_dim, T, tcfg.rope_theta), kv_limit=8)
    assert gk is tk and gv is tvv  # updated in place
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL)
    np.testing.assert_allclose(gk.numpy(), np.asarray(rk), atol=TOL)
    np.testing.assert_allclose(gv.numpy(), np.asarray(rv), atol=TOL)


def test_slot_decode_step_drops_writes_past_capacity(setup):
    """A slot at a position past the cache (a finished slot decoding
    garbage) writes nothing, as the JAX scatter's ``mode="drop"``."""
    _, tcfg, _, tp = setup
    kc = torch.randn(2, 2, 8, 2, 16)
    before = kc.clone()
    te.encdec_slot_decode_step(
        tp, _t([1, 2]), _t([8, 3]), tcfg, kc, torch.zeros_like(kc),
        torch.randn(2, 2, 5, 2, 16), torch.randn(2, 2, 5, 2, 16),
        _t([5, 5]), *rope_frequencies(tcfg.head_dim, 8, tcfg.rope_theta))
    assert torch.equal(kc[:, 0], before[:, 0])
    assert not torch.equal(kc[:, 1, 3], before[:, 1, 3])


@pytest.mark.parametrize("eos", [None, "third"])
def test_generate_greedy_tokens_as_jax(setup, eos):
    jcfg, tcfg, jp, tp = setup
    src = _tokens(3, 9, seed=7)
    ref = je.encdec_generate(jp, jnp.asarray(src), jcfg, max_new_tokens=12)
    ref = np.asarray(ref)
    eos_id = None if eos is None else int(ref[0, 2])
    first = None if eos is None else list(ref[0]).index(eos_id)
    got = te.encdec_generate(tp, _t(src), tcfg, max_new_tokens=12,
                             eos_id=eos_id, pad_id=7)
    if eos_id is None:
        np.testing.assert_array_equal(got.numpy(), ref)
        return
    jout = je.encdec_generate(jp, jnp.asarray(src), jcfg, max_new_tokens=12,
                              eos_id=eos_id, pad_id=7)
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(jout["tokens"]))
    np.testing.assert_array_equal(got["lengths"].numpy(),
                                  np.asarray(jout["lengths"]))
    assert int(got["lengths"][0]) == first + 1


def test_generate_samples_stay_in_vocab_and_follow_the_generator(setup):
    _, tcfg, _, tp = setup
    src = _t(_tokens(2, 5, seed=8))

    def draw(seed):
        return te.encdec_generate(
            tp, src, tcfg, max_new_tokens=6, temperature=0.9, top_k=8,
            top_p=0.9, generator=torch.Generator().manual_seed(seed))

    a = draw(1)
    assert a.shape == (2, 6) and int(a.min()) >= 0 and int(a.max()) < 256
    assert torch.equal(a, draw(1))


# ------------------------------------------------------------ trainer

@pytest.mark.parametrize("optim_name", ["adamw", "adamw-int8"])
def test_three_train_steps_match_jax(setup, optim_name):
    """Three steps of both trainers on (src, tgt) pairs from the same
    params: losses and gradient norms at 1e-4, the parameters as the
    Llama trainer's test holds them."""
    jcfg, tcfg, _, _ = setup
    mesh = single_device_mesh()
    if optim_name == "adamw":
        jtx, ttx = jtrainer.default_optimizer(), trainer.default_optimizer()
    else:
        jtx, ttx = jopt.adamw_int8(impl="xla"), optim.adamw_int8()
    jstate, jtx = jtrainer.create_train_state(jcfg, mesh,
                                              jax.random.PRNGKey(0), jtx)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                      jstate.params), "cpu")
    tstate = trainer.TrainState(0, params, ttx.init(params))
    jstep = jtrainer.make_train_step(jcfg, mesh, jtx)
    tstep = trainer.make_train_step(tcfg, ttx)
    losses = []
    for i in range(3):
        src, tgt = _tokens(2, 8, seed=20 + i), _tokens(2, 9, seed=30 + i)
        jstate, jmet = jstep(jstate, (jnp.asarray(src), jnp.asarray(tgt)))
        tstate, tmet = tstep(tstate, (_t(src), _t(tgt)))
        np.testing.assert_allclose(tmet["loss"].item(), float(jmet["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(tmet["grad_norm"].item(),
                                   float(jmet["grad_norm"]), rtol=1e-4)
        losses.append(tmet["loss"].item())
    got = dict(jax.tree_util.tree_leaves_with_path(
        params_to_numpy(tstate.params)))
    for path, ref in jax.tree_util.tree_leaves_with_path(jstate.params):
        diff = np.abs(got[path] - np.asarray(ref))
        assert diff.max() <= 6 * 3e-4, path
        assert (diff > 2e-6).mean() <= 1e-3, path


def test_trainer_loss_falls_on_a_repeated_pair_batch():
    cfg = dataclasses.replace(te.encdec_presets()["tiny"],
                              dtype=torch.float32)
    state, tx = trainer.create_train_state(
        cfg, "cpu", torch.Generator().manual_seed(0))
    step = trainer.make_train_step(cfg, tx)
    batch = te.encdec_synthetic_batch(0, 4, 12, 12, cfg)
    losses = []
    for _ in range(4):
        state, metrics = step(state, batch)
        losses.append(metrics["loss"].item())
    assert losses[-1] < losses[0]


def _cli(module, *args, timeout=240):
    return subprocess.run(
        [sys.executable, "-m", module, *args],
        cwd=ROOT, capture_output=True, text=True, timeout=timeout)


def test_trainer_cli_trains_encdec_and_resumes(tmp_path):
    """``--preset encdec:tiny``: (src, tgt) pairs of ``--seq`` tokens a
    side, adamw-int8 checkpoints (the tree and its int8 moments pass
    ``check_params``) that a longer run resumes."""
    args = ("--device", "cpu", "--preset", "encdec:tiny", "--batch", "2",
            "--seq", "16", "--log-every", "1", "--optim", "adamw-int8",
            "--ckpt-dir", str(tmp_path), "--save-every", "2")
    proc = _cli("tpu_docker_api_torch.train", *args, "--steps", "2")
    assert proc.returncode == 0, proc.stderr
    lines = [json.loads(ln) for ln in proc.stdout.splitlines()]
    assert [ln["step"] for ln in lines if "loss" in ln] == [1, 2]
    assert all(np.isfinite(ln["loss"]) for ln in lines if "loss" in ln)
    assert lines[-1] == {"event": "done", "step": 2}
    proc = _cli("tpu_docker_api_torch.train", *args, "--steps", "3")
    assert proc.returncode == 0, proc.stderr
    lines = [json.loads(ln) for ln in proc.stdout.splitlines()]
    assert lines[0]["event"] == "resumed" and lines[0]["step"] == 2
    assert [ln["step"] for ln in lines if "loss" in ln] == [3]


@pytest.mark.parametrize("module,flags,msg", [
    ("tpu_docker_api_torch.train", ["--data", "x.bin"],
     "--data does not apply to encdec: presets"),
    ("tpu_docker_api_torch.train", ["--moe-dispatch", "gather"],
     "--moe-dispatch applies to moe: presets only"),
    ("tpu_docker_api_torch.serve", ["--draft-preset", "tiny"],
     "--draft-preset is not supported with encdec presets"),
    ("tpu_docker_api_torch.serve", ["--prefill-chunk", "8"],
     "--prefill-chunk does not apply to seq2seq admission"),
    ("tpu_docker_api_torch.serve", ["--quantize"],
     "--quantize currently supports llama presets only")])
def test_clis_keep_the_jax_encdec_guards(module, flags, msg):
    proc = _cli(module, "--device", "cpu", "--preset", "encdec:tiny",
                *flags, timeout=60)
    assert proc.returncode == 2 and msg in proc.stderr


# ------------------------------------------------------------- server

@pytest.fixture(scope="module")
def servers():
    """The tiny encdec preset (bf16, random weights from seed 0) behind
    both serving paths: the slot engine and ``--slots 0``."""
    from tpu_docker_api_torch.serve.__main__ import Server, parse_args

    out = []
    for extra in ([], ["--slots", "0"]):
        srv = Server(parse_args(["--device", "cpu", "--preset",
                                 "encdec:tiny", "--host", "127.0.0.1",
                                 "--port", "0", "--slots", "4", *extra]))
        th = threading.Thread(target=srv.httpd.serve_forever, daemon=True)
        th.start()
        out.append((srv, th))
    yield [srv for srv, _ in out]
    for srv, th in out:
        srv.httpd.shutdown()
        srv.close()
        th.join(timeout=30)


def _call(srv, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1",
                                      srv.httpd.server_address[1],
                                      timeout=120)
    conn.request(method, path, body=None if body is None
                 else json.dumps(body))
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, data


def test_server_answers_src_tokens_through_the_slot_engine(servers):
    srv, legacy = servers
    srcs = [[1, 2, 3], [4, 5, 6, 7, 8, 9, 10]]
    code, data = _call(srv, "POST", "/generate",
                       {"srcTokens": srcs, "maxNewTokens": 5})
    assert code == 200, data
    body = json.loads(data)
    assert body["lengths"] == [5, 5]
    with torch.no_grad():
        iso = [te.encdec_generate(srv.params, torch.tensor([s]), srv.cfg,
                                  max_new_tokens=5)[0].tolist()
               for s in srcs]
    assert body["tokens"] == iso
    code, data = _call(srv, "GET", "/healthz")
    health = json.loads(data)
    assert code == 200 and health["slotEngine"]["completed"] >= 2
    # the legacy path gives the same tokens, equal-length rows only
    code, data = _call(legacy, "POST", "/generate",
                       {"srcTokens": [srcs[0], [9, 9, 9]],
                        "maxNewTokens": 5})
    assert code == 200 and json.loads(data)["tokens"][0] == iso[0]
    assert "lengths" not in json.loads(data)  # as JAX: only with eosId
    code, data = _call(legacy, "POST", "/generate",
                       {"srcTokens": [srcs[0]], "maxNewTokens": 5,
                        "eosId": iso[0][-1]})
    assert json.loads(data)["lengths"] == [iso[0].index(iso[0][-1]) + 1]
    code, _ = _call(legacy, "POST", "/generate",
                    {"srcTokens": srcs, "maxNewTokens": 5})
    assert code == 400  # ragged rows need the slot engine
    code, _ = _call(legacy, "POST", "/generate",
                    {"srcTokens": [[1]], "maxNewTokens": 65})
    assert code == 400  # past the decoder's capacity


def test_server_streams_and_refuses_what_seq2seq_lacks(servers):
    srv, _ = servers
    code, data = _call(srv, "POST", "/generate",
                       {"srcTokens": [[3, 1, 4]], "maxNewTokens": 4,
                        "stream": True})
    lines = [json.loads(ln) for ln in data.decode().splitlines() if ln]
    assert code == 200 and lines[-1] == {"done": True, "length": 4}
    code, data = _call(srv, "POST", "/generate",
                       {"tokens": [[1, 2]], "maxNewTokens": 4})
    assert code == 400 and b"srcTokens" in data
    code, data = _call(srv, "POST", "/prefixes", {"tokens": [1, 2, 3]})
    assert code == 400 and b"no prefix registry" in data
    code, data = _call(srv, "POST", "/generate",
                       {"srcTokens": [[1] * 65], "maxNewTokens": 4})
    assert code == 400 and b"largest source bucket" in data


# ---------------------------------------------------------- servebench

def test_bench_encdec_slot_serving_on_tiny():
    out = servebench.bench_encdec_slot_serving(
        "tiny", streams=2, requests=3, src_len=10, new_tok=5, reps=1,
        return_tokens=True, device="cpu")
    assert out["ok"] is True and out["requests"] == 3
    assert len(out["slot_tokens"]) == 3
    assert {"match_rows", "serialized_tok_s", "slot_tok_s", "speedup",
            "streams", "src_len", "new_tokens", "preset"} <= set(out)


def test_bench_encdec_slot_serving_defaults_as_jax():
    import inspect

    from tpu_docker_api.infer import servebench as jsb

    jsig = inspect.signature(jsb.bench_encdec_slot_serving).parameters
    tsig = inspect.signature(servebench.bench_encdec_slot_serving).parameters
    for name, p in jsig.items():
        assert tsig[name].default == p.default, name


# --------------------------------------------------------------- card only

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_encdec_through_the_kernels_matches_the_plain_path(cuda, dtype,
                                                           record_property):
    """encdec-base width, 2 + 2 layers, remat on, 2 x (256, 256) on the
    card, through the flash kernels (the encoder and the equal-length
    cross-attention non-causal, the decoder causal) against the dense
    plain path; one launch of each kernel a flash call: enc + 2 x dec.
    f32 (the kernels' CUDA-core path): the loss and the gradients of the
    encoder's, the decoder's and the cross-attention's wq within 1e-4
    relative. bf16 (the tensor-core kernels): the loss within 2e-2, and
    the gradients as tests/test_torch_vit.py's ``check_bf16_grads``
    holds them."""
    cfg = dataclasses.replace(te.encdec_presets()["encdec-base"],
                              enc_layers=2, dec_layers=2, vocab_size=1024,
                              dtype=dtype)
    params = te.encdec_init(cfg, torch.Generator(device=cuda).manual_seed(0))
    batch = te.encdec_synthetic_batch(1, 2, 256, 256, cfg, device=cuda)
    res = _grads_by_route(
        lambda p: te.encdec_loss(p, batch, cfg), params,
        {"enc wq": ("enc_layers", "attn", "wq"),
         "dec wq": ("dec_layers", "self_attn", "wq"),
         "cross wq": ("dec_layers", "cross_attn", "wq")},
        ROUTES if dtype == torch.bfloat16 else ("kernels", "dense"))
    calls = cfg.enc_layers + 2 * cfg.dec_layers
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert res["kernels"][2][name] == calls, name
        assert res["dense"][2][name] == 0, name
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert abs(res["kernels"][0] - res["dense"][0]) < tol * res["dense"][0]
    if dtype == torch.float32:
        for name, g in res["kernels"][1].items():
            ref = res["dense"][1][name]
            assert float((g - ref).norm() / ref.norm()) < tol, name
    else:
        check_bf16_grads(res, record_property)
