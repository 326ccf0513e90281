"""The port's safetensors I/O and HF-layout bridge
(models/import_weights.py) against the JAX package's and the
``safetensors`` package.

- A JAX ``export_hf_llama`` imports into the port bit-equal to
  ``params_from_numpy`` of the JAX params; a port export imports into
  JAX bit-equal to the params it came from.
- The port's reader agrees with the ``safetensors`` package (present
  here for the tests only) on a sharded index, a bare file and every
  dtype the port reads; files the port writes load in that package.
- Tied embeddings, the rope-scaling blocks of
  tests/test_import_weights.py, refusal of a non-llama checkpoint and of
  a shape mismatch.
- Forward logits of the port on its import against the JAX forward on
  its own, f32, at 1e-4 (tests/test_torch_llama.py's TOL).
- The export CLI on a training checkpoint of the port.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_docker_api.models import import_weights as jiw
from tpu_docker_api.models import llama as jl
from tpu_docker_api_torch.models import import_weights as tiw
from tpu_docker_api_torch.models import llama as tl
from tpu_docker_api_torch.models.convert import (params_from_numpy,
                                                 params_to_numpy)
from tpu_docker_api_torch.train import checkpoint as ckpt
from tpu_docker_api_torch.train import optim

TOL = 1e-4
_LLAMA31_SCALING = {"rope_type": "llama3", "factor": 8.0,
                    "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                    "original_max_position_embeddings": 8192}


@pytest.fixture(scope="module")
def jax_tiny():
    cfg = jl.llama_presets()["tiny"]
    return cfg, jl.llama_init(cfg, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def jax_export(jax_tiny, tmp_path_factory):
    cfg, params = jax_tiny
    out = str(tmp_path_factory.mktemp("jax_hf"))
    jiw.export_hf_llama(params, cfg, out)
    return out


def _host(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _assert_trees_equal(got, want):
    """Port tree (tensors) against a port tree, bit for bit and dtype."""
    flat_g, flat_w = {}, {}
    ckpt._flatten(got, "", flat_g, {})
    ckpt._flatten(want, "", flat_w, {})
    assert flat_g.keys() == flat_w.keys()
    for k in flat_w:
        assert flat_g[k].dtype == flat_w[k].dtype, k
        assert torch.equal(flat_g[k], flat_w[k]), k


def _assert_jax_trees_equal(a, b):
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert np.array_equal(np.asarray(x), np.asarray(y))


# -------------------------------------------------------- the two bridges


def test_jax_export_imports_bit_equal(jax_tiny, jax_export):
    _, jparams = jax_tiny
    cfg, params = tiw.import_hf_llama(jax_export, device="cpu")
    assert cfg.dtype == torch.bfloat16 and cfg.n_layers == 2
    _assert_trees_equal(params, params_from_numpy(_host(jparams), "cpu"))


@pytest.mark.parametrize("tie", [False, True])
def test_port_export_imports_into_jax_bit_equal(jax_tiny, tmp_path, tie):
    jcfg, jparams = jax_tiny
    if tie:  # a tied checkpoint only round-trips a tied head
        jparams = {**jparams, "lm_head": jparams["embed"]["tokens"].T}
    params = params_from_numpy(_host(jparams), "cpu")
    tcfg = tl.llama_presets()["tiny"]
    tiw.export_hf_llama(params, tcfg, str(tmp_path), tie_embeddings=tie)
    names = jiw.HFCheckpoint(str(tmp_path)).names()
    assert ("lm_head.weight" in names) != tie
    jcfg2, back = jiw.import_hf_llama(str(tmp_path))
    assert jcfg2.dim == jcfg.dim and jcfg2.vocab_size == jcfg.vocab_size
    _assert_jax_trees_equal(back, jparams)
    # and into the port itself
    _, again = tiw.import_hf_llama(str(tmp_path), device="cpu")
    _assert_trees_equal(again, params)


def test_tied_jax_export_rebuilds_the_head(jax_tiny, tmp_path):
    jcfg, jparams = jax_tiny
    jiw.export_hf_llama(jparams, jcfg, str(tmp_path), tie_embeddings=True)
    _, params = tiw.import_hf_llama(str(tmp_path), device="cpu")
    assert torch.equal(params["lm_head"], params["embed"]["tokens"].T)
    assert params["lm_head"].is_contiguous()


def test_config_matches_jax_parse(jax_export, tmp_path):
    hf = json.load(open(os.path.join(jax_export, "config.json")))
    hf.update(num_key_value_heads=1, rms_norm_eps=1e-6, rope_theta=5e5,
              rope_scaling=dict(_LLAMA31_SCALING), head_dim=16)
    (tmp_path / "config.json").write_text(json.dumps(hf))
    want = jiw.hf_llama_config(str(tmp_path))
    got = tiw.hf_llama_config(str(tmp_path))
    for f in ("vocab_size", "dim", "n_layers", "n_heads", "n_kv_heads",
              "ffn_dim", "max_seq_len", "rope_theta", "norm_eps"):
        assert getattr(got, f) == getattr(want, f), f
    assert dataclasses.asdict(got.rope_scaling) == dataclasses.asdict(
        want.rope_scaling)


# --------------------------------------------------- the safetensors I/O


def test_reader_matches_safetensors_on_a_sharded_index(jax_export, tmp_path):
    from safetensors.numpy import load_file, save_file

    every = load_file(os.path.join(jax_export, "model.safetensors"))
    names = sorted(every)
    weight_map = {}
    for i, part in enumerate((names[:7], names[7:])):
        fname = f"model-{i + 1:05d}-of-00002.safetensors"
        save_file({k: every[k] for k in part}, str(tmp_path / fname))
        weight_map.update({k: fname for k in part})
    (tmp_path / "model.safetensors.index.json").write_text(
        json.dumps({"metadata": {}, "weight_map": weight_map}))
    ck = tiw.HFCheckpoint(str(tmp_path))
    assert ck.names() == names
    for k in names:
        want = params_from_numpy(every[k], "cpu")
        got = ck.tensor(k)
        assert got.dtype == want.dtype and torch.equal(got, want), k
    (tmp_path / "config.json").write_text(
        open(os.path.join(jax_export, "config.json")).read())
    _, a = tiw.import_hf_llama(str(tmp_path), device="cpu")
    _, b = tiw.import_hf_llama(jax_export, device="cpu")
    _assert_trees_equal(a, b)


def test_reader_matches_safetensors_on_every_dtype(tmp_path):
    from safetensors.numpy import save_file
    from safetensors.torch import load_file

    rng = np.random.default_rng(0)
    arrays = {
        "bf16": rng.standard_normal((3, 5)).astype(jnp.bfloat16),
        "f16": rng.standard_normal((7,)).astype(np.float16),
        "f32": rng.standard_normal((2, 3, 4)).astype(np.float32),
        "i8": rng.integers(-128, 127, (9,)).astype(np.int8),
        "i32": rng.integers(-2**31, 2**31 - 1, (4, 1)).astype(np.int32),
        "i64": rng.integers(-2**62, 2**62, (3,)).astype(np.int64),
        "scalar": np.array(1.5, np.float32),
        "empty": np.zeros((0, 4), np.float32),
    }
    path = str(tmp_path / "all.safetensors")
    save_file(arrays, path, metadata={"k": "v"})
    f = tiw.SafeTensorsFile(path)
    assert f.metadata == {"k": "v"} and sorted(f.keys()) == sorted(arrays)
    want = load_file(path)
    for k in arrays:
        got = f.tensor(k)
        assert got.dtype == want[k].dtype and got.shape == want[k].shape, k
        assert torch.equal(got, want[k]), k
    # the bare file resolves through HFCheckpoint too
    assert torch.equal(tiw.HFCheckpoint(path).tensor("i64"), want["i64"])


def test_writer_output_loads_in_safetensors(tmp_path):
    from safetensors.torch import load_file

    g = torch.Generator().manual_seed(0)
    tensors = {"a/b": torch.randn(3, 4, generator=g).bfloat16(),
               "c": torch.randint(-5, 5, (17,), generator=g).to(torch.int8),
               "d": torch.randn(5, 3, generator=g).T,  # not contiguous
               "e": torch.arange(6, dtype=torch.int64),
               "f": torch.tensor(2.0, dtype=torch.float16)}
    path = tmp_path / "x.safetensors"
    n = tiw.save_file(tensors, path, metadata={"format": "pt"})
    assert n == os.path.getsize(path)
    back = load_file(str(path))
    for k, t in tensors.items():
        assert back[k].dtype == t.dtype and torch.equal(back[k], t), k
    f = tiw.SafeTensorsFile(path)
    for k, t in tensors.items():
        assert torch.equal(f.tensor(k), t), k
        # every tensor starts aligned to its element size
        assert (f._start + f._entries[k]["data_offsets"][0]) % \
            t.element_size() == 0, k


def test_reader_views_are_copy_on_write(tmp_path):
    path = tmp_path / "x.safetensors"
    tiw.save_file({"w": torch.ones(4)}, path)
    view = tiw.SafeTensorsFile(path).tensor("w")
    view.mul_(3)
    assert torch.equal(tiw.SafeTensorsFile(path).tensor("w"), torch.ones(4))


def test_reader_refuses_a_truncated_file(tmp_path):
    path = tmp_path / "x.safetensors"
    tiw.save_file({"w": torch.ones(64)}, path)
    data = path.read_bytes()
    path.write_bytes(data[:-8])
    with pytest.raises(ValueError, match="does not hold"):
        tiw.SafeTensorsFile(path)


# -------------------------------------------------------------- refusals


def test_non_llama_checkpoint_refused(jax_export, tmp_path):
    hf = json.load(open(os.path.join(jax_export, "config.json")))
    hf["architectures"] = ["MistralForCausalLM"]
    (tmp_path / "config.json").write_text(json.dumps(hf))
    with pytest.raises(ValueError, match="not a llama"):
        tiw.hf_llama_config(str(tmp_path))


def test_shape_mismatch_names_the_tensor(jax_export):
    cfg = tiw.hf_llama_config(jax_export)
    wrong = dataclasses.replace(cfg, ffn_dim=cfg.ffn_dim * 2)
    with pytest.raises(ValueError, match="gate_proj.weight: shape"):
        tiw.import_hf_llama(jax_export, wrong, device="cpu")


def test_missing_tensor_names_it(jax_export, tmp_path):
    from safetensors.numpy import load_file, save_file

    every = load_file(os.path.join(jax_export, "model.safetensors"))
    every.pop("model.norm.weight")
    save_file(every, str(tmp_path / "model.safetensors"))
    (tmp_path / "config.json").write_text(
        open(os.path.join(jax_export, "config.json")).read())
    with pytest.raises(KeyError, match="model.norm.weight"):
        tiw.import_hf_llama(str(tmp_path), device="cpu")


# ---------------------------------------------------------- int8 at load


def _tied_export(jax_tiny, tmp_path, tie):
    jcfg, jparams = jax_tiny
    if tie:
        jparams = {**jparams, "lm_head": jparams["embed"]["tokens"].T}
    jiw.export_hf_llama(jparams, jcfg, str(tmp_path), tie_embeddings=tie)
    return str(tmp_path)


@pytest.mark.parametrize("tie", [False, True])
def test_quantize_at_load_equals_import_then_quantize(jax_tiny, tmp_path,
                                                      tie):
    from tpu_docker_api_torch.infer.quantize import quantize_llama_params
    from tpu_docker_api_torch.ops.quant import QuantizedLinear

    path = _tied_export(jax_tiny, tmp_path, tie)
    _, q = tiw.import_hf_llama(path, device="cpu", quantize=True)
    _, plain = tiw.import_hf_llama(path, device="cpu")
    want = quantize_llama_params(plain)
    flat_q, flat_w = dict(_named(q)), dict(_named(want))
    assert flat_q.keys() == flat_w.keys()
    for k in flat_w:
        a, b = flat_q[k], flat_w[k]
        assert type(a) is type(b), k
        if isinstance(a, QuantizedLinear):
            assert torch.equal(a.w_int8, b.w_int8), k
            assert torch.equal(a.scale, b.scale), k
            assert a.w_int8.stride(-2) == 1, k  # the card's layout
        else:
            assert a.dtype == b.dtype and torch.equal(a, b), k


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named(v, f"{prefix}{k}/")
    else:
        yield prefix, tree


@pytest.mark.parametrize("tie", [False, True])
def test_quantize_at_load_matches_jax(jax_tiny, tmp_path, tie):
    """Both packages' int8-at-load imports of one checkpoint: the same
    int8 weights and f32 scales, bit for bit."""
    from tpu_docker_api_torch.ops.quant import QuantizedLinear

    path = _tied_export(jax_tiny, tmp_path, tie)
    _, q = tiw.import_hf_llama(path, device="cpu", quantize=True)
    _, jq = jiw.import_hf_llama(path, quantize=True)
    names = 0
    for name, leaf in _named(q):
        jleaf = jq
        for part in name.strip("/").split("/"):
            jleaf = jleaf[part]
        if isinstance(leaf, QuantizedLinear):
            np.testing.assert_array_equal(leaf.w_int8.numpy(),
                                          np.asarray(jleaf.w_int8))
            np.testing.assert_array_equal(leaf.scale.numpy(),
                                          np.asarray(jleaf.scale))
            names += 1
        else:
            np.testing.assert_array_equal(params_to_numpy(leaf),
                                          np.asarray(jleaf, np.float32))
    assert names == 8  # seven projections and the head


# ---------------------------------------------------------- rope scaling


def _config_with(jax_export, tmp_path, block):
    hf = json.load(open(os.path.join(jax_export, "config.json")))
    if block is None:
        hf.pop("rope_scaling", None)
    else:
        hf["rope_scaling"] = block
    (tmp_path / "config.json").write_text(json.dumps(hf))
    st = tmp_path / "model.safetensors"
    if not st.exists():
        os.symlink(os.path.join(jax_export, "model.safetensors"), st)
    return str(tmp_path)


def test_llama3_block_parses(jax_export, tmp_path):
    rs = tiw.hf_llama_config(
        _config_with(jax_export, tmp_path, _LLAMA31_SCALING)).rope_scaling
    assert rs is not None and rs.factor == 8.0
    assert rs.low_freq_factor == 1.0 and rs.high_freq_factor == 4.0
    assert rs.original_max_position_embeddings == 8192


def test_old_style_type_key_parses(jax_export, tmp_path):
    block = dict(_LLAMA31_SCALING)
    block["type"] = block.pop("rope_type")
    cfg = tiw.hf_llama_config(_config_with(jax_export, tmp_path, block))
    assert cfg.rope_scaling is not None


def test_default_type_is_noop(jax_export, tmp_path):
    cfg = tiw.hf_llama_config(_config_with(jax_export, tmp_path,
                                           {"rope_type": "default"}))
    assert cfg.rope_scaling is None


@pytest.mark.parametrize("rtype", ["yarn", "linear", "dynamic", "longrope"])
def test_unknown_type_refused(jax_export, tmp_path, rtype):
    with pytest.raises(ValueError, match="not.*supported"):
        tiw.hf_llama_config(_config_with(
            jax_export, tmp_path, {"rope_type": rtype, "factor": 2.0}))


def test_head_dim_checked(jax_export, tmp_path):
    hf = json.load(open(os.path.join(jax_export, "config.json")))
    hf["head_dim"] = 8
    (tmp_path / "config.json").write_text(json.dumps(hf))
    with pytest.raises(ValueError, match="head_dim"):
        tiw.hf_llama_config(str(tmp_path))


def test_scaling_reaches_the_forward_tables(jax_export, tmp_path,
                                            monkeypatch):
    cfg, params = tiw.import_hf_llama(
        _config_with(jax_export, tmp_path, _LLAMA31_SCALING), device="cpu")
    seen = []
    real = tl.rope_frequencies

    def spy(head_dim, seq, theta=10000.0, scaling=None, **kw):
        seen.append(scaling)
        return real(head_dim, seq, theta, scaling, **kw)

    monkeypatch.setattr(tl, "rope_frequencies", spy)
    tl.llama_forward(params, torch.zeros(1, 8, dtype=torch.long), cfg)
    assert seen == [cfg.rope_scaling] and seen[0].factor == 8.0


def test_export_round_trips_the_scaling_block(jax_tiny, tmp_path):
    from tpu_docker_api_torch.ops.rope import RopeScaling

    _, jparams = jax_tiny
    cfg = dataclasses.replace(tl.llama_presets()["tiny"],
                              rope_scaling=RopeScaling())
    tiw.export_hf_llama(params_from_numpy(_host(jparams), "cpu"), cfg,
                        str(tmp_path))
    written = json.load(open(tmp_path / "config.json"))["rope_scaling"]
    assert written == _LLAMA31_SCALING
    assert tiw.hf_llama_config(str(tmp_path)).rope_scaling == \
        cfg.rope_scaling
    jcfg = jiw.hf_llama_config(str(tmp_path))
    assert jcfg.rope_scaling.factor == 8.0


@pytest.mark.parametrize("block", [None, _LLAMA31_SCALING])
def test_forward_on_imports_matches_jax(jax_export, tmp_path, block):
    """Each package imports the same checkpoint and runs its forward in
    f32 over 96 positions (deep enough for the llama3 scaling to bite)."""
    path = _config_with(jax_export, tmp_path, block)
    jcfg, jparams = jiw.import_hf_llama(path)
    jcfg = dataclasses.replace(jcfg, dtype=jnp.float32)
    jparams = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32),
                                     jparams)
    tcfg, tparams = tiw.import_hf_llama(path, device="cpu")
    tcfg = dataclasses.replace(tcfg, dtype=torch.float32)
    tparams = optim.tree_map(lambda t: t.float(), tparams)
    toks = np.random.default_rng(3).integers(0, 256, (2, 96)).astype(
        np.int32)
    want = np.asarray(jl.llama_forward(jparams, jnp.asarray(toks), jcfg))
    with torch.no_grad():
        got = tl.llama_forward(tparams, torch.from_numpy(toks).long(),
                               tcfg).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


# ------------------------------------------------------------ export CLI


def test_export_cli_on_a_port_checkpoint(tmp_path, capsys):
    from tpu_docker_api_torch.train import trainer

    cfg = tl.llama_presets()["tiny"]
    state, _ = trainer.create_train_state(
        cfg, "cpu", torch.Generator().manual_seed(0), optim.adamw_int8())
    state = dataclasses.replace(state, step=7)
    with ckpt.CheckpointManager(tmp_path / "ck") as mgr:
        mgr.save(state)
    tiw._main(["--ckpt-dir", str(tmp_path / "ck"), "--preset", "tiny",
               "--out", str(tmp_path / "hf"), "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert line["event"] == "exported" and line["step"] == 7
    assert line["bytes"] == os.path.getsize(tmp_path / "hf" /
                                            "model.safetensors")
    _, params = tiw.import_hf_llama(str(tmp_path / "hf"), cfg, device="cpu")
    _assert_trees_equal(params, state.params)
    # the JAX importer reads it as well
    _, jparams = jiw.import_hf_llama(str(tmp_path / "hf"))
    _assert_trees_equal(params_from_numpy(_host(jparams), "cpu"),
                        state.params)
    assert params_to_numpy(params)["lm_head"].dtype == np.float32


def test_reader_copies_out_an_unaligned_tensor(tmp_path):
    """A writer that does not align (an int8 tensor ahead of an f32 one)
    still reads back right: the reader copies such a tensor out of the
    mapping instead of viewing it."""
    import struct

    i8 = torch.arange(-3, 2, dtype=torch.int8)
    f32 = torch.linspace(-1, 1, 6)
    header = {"a": {"dtype": "I8", "shape": [5], "data_offsets": [0, 5]},
              "b": {"dtype": "F32", "shape": [2, 3],
                    "data_offsets": [5, 29]}}
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    path = tmp_path / "odd.safetensors"
    path.write_bytes(struct.pack("<Q", len(blob)) + blob
                     + i8.numpy().tobytes() + f32.numpy().tobytes())
    f = tiw.SafeTensorsFile(path)
    assert torch.equal(f.tensor("a"), i8)
    assert torch.equal(f.tensor("b"), f32.reshape(2, 3))
