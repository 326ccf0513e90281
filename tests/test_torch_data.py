"""The port's token loader against the JAX package's, bit for bit.

Token files are made from a numpy seed; the same files go through
``tpu_docker_api.data.loader.make_batch_fn`` and the port's, and every
batch must be equal in value and dtype (int32): ``.bin`` at uint16 and
int32, ``.npy``, directories of several files, several seeds, steps
past the end of an epoch, and process sharding.

The port's ``.bin`` batches come from its native batcher
(``csrc/dataloader.cc``, built here with ``g++`` at first use): it is
held bit-equal to JAX's numpy path on multi-file sources whose windows
straddle file boundaries, at uint16 and int32, over seeds, steps past an
epoch and process shards; its step+1 lookahead is seen to hit and a
non-sequential step to miss; JAX's numpy opt-outs stay on numpy; and a
failed build or open raises instead of falling back.
"""

import os
import time

import numpy as np
import pytest

from tpu_docker_api.data import loader as jloader
from tpu_docker_api_torch import _build
from tpu_docker_api_torch.data import loader as tloader


def _tokens(n, high, seed):
    return np.random.default_rng(seed).integers(0, high, n)


def _both(path, window, bin_dtype, batch, seed, pidx=0, pcount=1):
    fns = []
    for mod in (jloader, tloader):
        src = mod.open_token_files(path, window=window, bin_dtype=bin_dtype)
        fns.append(mod.make_batch_fn(src, batch, seed=seed,
                                     process_index=pidx,
                                     process_count=pcount))
    return fns


def _assert_same(jfn, tfn, steps):
    for step in steps:
        want, got = jfn(step), tfn(step)
        assert got.dtype == np.int32 and want.dtype == np.int32
        np.testing.assert_array_equal(got, want, err_msg=f"step {step}")


@pytest.mark.parametrize("bin_dtype,high", [("uint16", 65535),
                                            ("int32", 128256)])
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_bin_batches_match_jax(tmp_path, bin_dtype, high, seed):
    path = tmp_path / "tok.bin"
    tloader.write_token_file(_tokens(997, high, seed), path, bin_dtype)
    jfn, tfn = _both(path, 17, bin_dtype, 4, seed)
    # 997 // 17 = 58 windows, 4 rows a step: steps past 15 wrap epochs
    _assert_same(jfn, tfn, range(0, 40))


def test_npy_batches_match_jax(tmp_path):
    path = tmp_path / "tok.npy"
    np.save(path, _tokens(500, 30000, 3).astype(np.int32))
    jfn, tfn = _both(path, 9, "uint16", 3, 5)
    _assert_same(jfn, tfn, range(25))


def test_directory_of_mixed_files_matches_jax(tmp_path):
    tloader.write_token_file(_tokens(301, 1000, 1), tmp_path / "a.bin")
    np.save(tmp_path / "b.npy", _tokens(250, 1000, 2).astype(np.uint16))
    tloader.write_token_file(_tokens(123, 1000, 3), tmp_path / "c.bin")
    (tmp_path / "notes.txt").write_text("skipped")
    jfn, tfn = _both(tmp_path, 33, "uint16", 2, 11)
    _assert_same(jfn, tfn, range(0, 30))
    jsrc = jloader.open_token_files(tmp_path, window=33)
    tsrc = tloader.open_token_files(tmp_path, window=33)
    assert tsrc.n_tokens == jsrc.n_tokens and tsrc.n_windows == jsrc.n_windows
    for w in (0, 9, 10, 20, 40):  # windows that span file boundaries too
        np.testing.assert_array_equal(tsrc.read_window(w),
                                      jsrc.read_window(w))


@pytest.mark.parametrize("pcount", [2, 4])
def test_process_shards_match_jax(tmp_path, pcount):
    path = tmp_path / "tok.bin"
    tloader.write_token_file(_tokens(2000, 50000, 4), path)
    rows = []
    for pidx in range(pcount):
        jfn, tfn = _both(path, 25, "uint16", 8, 3, pidx, pcount)
        _assert_same(jfn, tfn, range(12))
        rows.append(tfn(5))
        assert tloader.rows_for_process(8, pidx, pcount) == \
            jloader.rows_for_process(8, pidx, pcount)
    # the shards tile the global batch
    whole = _both(path, 25, "uint16", 8, 3)[1](5)
    np.testing.assert_array_equal(np.concatenate(rows), whole)


def test_batch_is_a_pure_function_of_the_step(tmp_path):
    path = tmp_path / "tok.bin"
    tloader.write_token_file(_tokens(1000, 500, 0), path)
    src = tloader.open_token_files(path, window=11)
    fn = tloader.make_batch_fn(src, 4, seed=2)
    first = [fn(s) for s in range(10)]
    again = tloader.make_batch_fn(src, 4, seed=2)
    for s in (7, 3, 9, 0):  # any order, a fresh function
        np.testing.assert_array_equal(again(s), first[s])


def _error(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the test compares them
        return type(e), str(e)
    return None


@pytest.mark.parametrize("case", ["window", "short", "empty", "suffix",
                                  "ndim", "batch", "fit"])
def test_errors_match_jax(tmp_path, case):
    np.save(tmp_path / "two_d.npy", np.zeros((3, 4), np.int32))
    (tmp_path / "tok.txt").write_text("1 2 3")
    calls = {
        "window": lambda m: m.TokenSource(arrays=(np.arange(10),), window=1),
        "short": lambda m: m.TokenSource(arrays=(np.arange(5),), window=9),
        "empty": lambda m: m.TokenSource(arrays=(), window=4),
        "suffix": lambda m: m.open_token_files(tmp_path / "tok.txt", 4),
        "ndim": lambda m: m.open_token_files(tmp_path / "two_d.npy", 2),
        "batch": lambda m: m.rows_for_process(6, 0, 4),
        "fit": lambda m: m.write_token_file(np.array([70000]),
                                            tmp_path / "x.bin", "uint16"),
    }
    want = _error(lambda: calls[case](jloader))
    got = _error(lambda: calls[case](tloader))
    assert want is not None and got == want


def _jax_numpy_fn(monkeypatch, path, window, bin_dtype, batch, seed,
                  pidx=0, pcount=1):
    """JAX's ``make_batch_fn`` on its numpy path (its native library,
    where one is built, bound away)."""
    monkeypatch.setattr(jloader, "_native_lib", lambda: None)
    src = jloader.open_token_files(path, window=window, bin_dtype=bin_dtype)
    return jloader.make_batch_fn(src, batch, seed=seed, process_index=pidx,
                                 process_count=pcount)


def _straddling_dir(tmp_path, bin_dtype, high):
    """Four .bin files of 7, 40, 3 and 95 tokens: 17-token windows
    straddle every boundary, and one file is shorter than a window."""
    for i, n in enumerate((7, 40, 3, 95)):
        tloader.write_token_file(_tokens(n, high, 10 + i),
                                 tmp_path / f"{i}.bin", bin_dtype)
    return tmp_path


@pytest.mark.parametrize("pcount", [1, 3])
@pytest.mark.parametrize("bin_dtype,high", [("uint16", 65535),
                                            ("int32", 128256)])
def test_native_batcher_bit_equal_to_jax(tmp_path, monkeypatch, bin_dtype,
                                         high, pcount):
    """Multi-file sources, 8 windows: 6 rows a step wrap the epoch every
    few steps; seeds 0, 1 and 7; each process shard of the batch."""
    root = _straddling_dir(tmp_path, bin_dtype, high)
    for seed in (0, 1, 7):
        for pidx in range(pcount):
            src = tloader.open_token_files(root, window=17,
                                           bin_dtype=bin_dtype)
            assert src.bin_paths == tuple(
                str(root / f"{i}.bin") for i in range(4))
            tfn = tloader.make_batch_fn(src, 6, seed=seed,
                                        process_index=pidx,
                                        process_count=pcount)
            assert isinstance(tfn, tloader._NativeBatcher)
            jfn = _jax_numpy_fn(monkeypatch, root, 17, bin_dtype, 6, seed,
                                pidx, pcount)
            _assert_same(jfn, tfn, [*range(0, 20), 97, 3, 1000])


def test_native_lookahead_hits_the_next_step_and_misses_a_jump(
        tmp_path, monkeypatch):
    """After step s the worker computes step s+1 for the same rows: a
    sequential call is served from it (a hit), a jump is computed on
    the spot (no hit); both equal the numpy path."""
    path = tmp_path / "tok.bin"
    tloader.write_token_file(_tokens(5000, 60000, 5), path)
    src = tloader.open_token_files(path, window=33)
    fn = tloader.make_batch_fn(src, 4, seed=2)
    ref = _jax_numpy_fn(monkeypatch, path, 33, "uint16", 4, 2)
    assert isinstance(fn, tloader._NativeBatcher) and fn.hits == 0
    step = 0
    np.testing.assert_array_equal(fn(step), ref(step))
    deadline = time.monotonic() + 30
    while fn.hits == 0 and time.monotonic() < deadline:
        time.sleep(0.05)    # give the worker time to fill step + 1
        step += 1
        np.testing.assert_array_equal(fn(step), ref(step))
    assert fn.hits >= 1
    time.sleep(0.05)
    hits = fn.hits
    np.testing.assert_array_equal(fn(step + 9), ref(step + 9))
    assert fn.hits == hits


@pytest.mark.parametrize("case", ["int16", "npy", "seed", "switch"])
def test_numpy_opt_outs_match_jax(tmp_path, monkeypatch, case):
    """JAX's numpy cases stay numpy: an int16 .bin (uint16's width, a
    sign the widen loop would lose), an .npy source, a negative seed and
    ``TPU_DOCKER_API_NATIVE_DATA=0``."""
    bin_dtype, seed = ("int16" if case == "int16" else "uint16",
                       -1 if case == "seed" else 3)
    if case == "npy":
        path = tmp_path / "tok.npy"
        np.save(path, _tokens(700, 30000, 6).astype(np.uint16))
    else:
        path = tmp_path / "tok.bin"
        tokens = _tokens(700, 30000, 6)
        if case == "int16":
            tokens = tokens - 15000   # negative ids: a sign to keep
        tloader.write_token_file(tokens, path, bin_dtype)
    if case == "switch":
        monkeypatch.setenv("TPU_DOCKER_API_NATIVE_DATA", "0")
    jfn = _jax_numpy_fn(monkeypatch, path, 13, bin_dtype, 4, seed)
    src = tloader.open_token_files(path, window=13, bin_dtype=bin_dtype)
    tfn = tloader.make_batch_fn(src, 4, seed=seed)
    assert not isinstance(tfn, tloader._NativeBatcher)
    assert not tloader.native_wanted(src, seed)
    _assert_same(jfn, tfn, range(0, 30))


def test_native_build_failure_raises_with_the_compiler_output(
        tmp_path, monkeypatch):
    """A compiler that fails is an error carrying its output, never a
    quiet numpy path."""
    cxx = tmp_path / "broken-cxx"
    cxx.write_text("#!/bin/sh\necho 'no such toolchain' >&2\nexit 3\n")
    cxx.chmod(0o755)
    monkeypatch.setenv("CXX", str(cxx))
    monkeypatch.setattr(_build, "HOST_BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_host_libs", {})
    path = tmp_path / "tok.bin"
    tloader.write_token_file(_tokens(500, 1000, 7), path)
    src = tloader.open_token_files(path, window=9)
    with pytest.raises(RuntimeError, match="no such toolchain") as err:
        tloader.make_batch_fn(src, 2, seed=0)
    assert "exit 3" in str(err.value)
    assert not list((tmp_path / "build").iterdir())   # no partial file


def test_native_open_failure_raises(tmp_path):
    """A source the C++ cannot open (the file gone after the memory map
    was taken) raises ``OSError`` instead of falling back."""
    path = tmp_path / "tok.bin"
    tloader.write_token_file(_tokens(500, 1000, 8), path)
    src = tloader.open_token_files(path, window=9)
    os.unlink(path)
    with pytest.raises(OSError, match="tpudata_open failed"):
        tloader.make_batch_fn(src, 2, seed=0)


def test_native_library_is_the_port_build(tmp_path):
    """The batcher's library is the one built from the port's own source
    under build/host, named by its hash; nothing else is loaded."""
    path = tmp_path / "tok.bin"
    tloader.write_token_file(_tokens(500, 1000, 9), path)
    fn = tloader.make_batch_fn(tloader.open_token_files(path, window=9), 2)
    want = _build.host_library_path("tpudata")
    assert fn._lib._name == str(want) and want.exists()
    assert want.parent == _build.BUILD_DIR.parent / "host"
    assert want.name.startswith("libtpudata-")
