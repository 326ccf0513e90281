"""The port's token loader against the JAX package's, bit for bit.

Token files are made from a numpy seed; the same files go through
``tpu_docker_api.data.loader.make_batch_fn`` and the port's, and every
batch must be equal in value and dtype (int32): ``.bin`` at uint16 and
int32, ``.npy``, directories of several files, several seeds, steps
past the end of an epoch, and process sharding.
"""

import numpy as np
import pytest

from tpu_docker_api.data import loader as jloader
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
