"""The port's control-plane state layer against the JAX package's on the
CPU: ``state/txn.py`` ``StoreTxn`` (with the schedulers' ``txn=`` claims),
``state/version.py`` ``VersionMap``, ``state/store.py`` ``StateStore``,
``state/pager.py`` and the crash points of ``state/kv.py`` ``KV.apply``
(``service/crashpoints.py``). Each package gets the same seeded script;
values, revisions, persisted strings and error classes must be equal."""

import json
import types

import numpy as np
import pytest

from tpu_docker_api.scheduler import ports as jports
from tpu_docker_api.scheduler import slices as jslices
from tpu_docker_api.scheduler import topology as jtopo
from tpu_docker_api.schemas import state as jstate
from tpu_docker_api.service import crashpoints as jcrash
from tpu_docker_api.state import keys as jkeys
from tpu_docker_api.state import kv as jkv
from tpu_docker_api.state import pager as jpager
from tpu_docker_api.state import store as jstore
from tpu_docker_api.state import txn as jtxn
from tpu_docker_api.state import version as jversion
from tpu_docker_api_torch.scheduler import ports as tports
from tpu_docker_api_torch.scheduler import slices as tslices
from tpu_docker_api_torch.scheduler import topology as ttopo
from tpu_docker_api_torch.schemas import state as tstate
from tpu_docker_api_torch.service import crashpoints as tcrash
from tpu_docker_api_torch.state import keys as tkeys
from tpu_docker_api_torch.state import kv as tkv
from tpu_docker_api_torch.state import pager as tpager
from tpu_docker_api_torch.state import store as tstore
from tpu_docker_api_torch.state import txn as ttxn
from tpu_docker_api_torch.state import version as tversion

JAX = types.SimpleNamespace(
    kv=jkv, keys=jkeys, txn=jtxn, version=jversion, store=jstore,
    pager=jpager, state=jstate, crash=jcrash, slices=jslices, ports=jports)
PORT = types.SimpleNamespace(
    kv=tkv, keys=tkeys, txn=ttxn, version=tversion, store=tstore,
    pager=tpager, state=tstate, crash=tcrash, slices=tslices, ports=tports)
H100 = ttopo.GENERATIONS["h100"]


def _topology(pkg):
    """An HGX line of 8 in each package (JAX's Generation carrying the
    port's part's figures), so chip ids line up."""
    top = ttopo.HostTopology.build("h100-8")
    if pkg is PORT:
        return top
    gen = jtopo.Generation(H100.name, H100.cores_per_chip, H100.host_mesh,
                           H100.hbm_bytes_per_chip, H100.peak_bf16_flops,
                           H100.torus_dims)
    return jtopo.HostTopology(gen, top.mesh_shape, dict(top.coords))


def _kv(pkg, backend, tmp_path, tag):
    if backend == "memory":
        return pkg.kv.MemoryKV()
    return pkg.kv.SqliteKV(str(tmp_path / f"{tag}.db"))


def _counting(kv):
    """Count the store round trips a flow makes (writes: put, delete,
    delete_prefix and apply, each one call to the backend)."""
    calls = []
    for name in ("put", "delete", "delete_prefix", "apply"):
        orig = getattr(kv, name)

        def wrapped(*a, _orig=orig, _name=name, **k):
            calls.append(_name)
            return _orig(*a, **k)
        setattr(kv, name, wrapped)
    return calls


def _outcome(fn):
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 — the class is the outcome
        return type(e).__name__


# -- StoreTxn and the schedulers' txn= claims ---------------------------------


def _run_txn(pkg, kv):
    chips = pkg.slices.ChipScheduler(_topology(pkg), kv)
    ports = pkg.ports.PortScheduler(kv, 40000, 40009)
    out = []
    calls = _counting(kv)
    txn = pkg.txn.StoreTxn(kv)
    out.append(chips.apply_chips(3, owner="a", txn=txn))
    out.append(ports.apply_ports(2, owner="a", txn=txn))
    out.append(chips.try_claim_chips([6, 7], owner="b", txn=txn))
    txn.add_op(("put", "/x/spec", "s"))
    out.append((txn.pending, kv.get_or(pkg.keys.SCHEDULER_CHIPS_KEY)))
    txn.commit()
    out.append(list(calls))  # one apply for every claim and the op
    out.append(_outcome(txn.commit))
    release = pkg.txn.StoreTxn(kv)
    chips.restore_chips([0, 1], owner="a", txn=release)
    ports.restore_ports(out[1], owner="a", txn=release)
    release.commit()
    out.append(list(calls))
    out.append(pkg.txn.StoreTxn(kv).pending)
    uncommitted = pkg.txn.StoreTxn(kv)
    chips.apply_chips(1, owner="c", txn=uncommitted)  # never committed
    out.append(kv.range_prefix(pkg.keys.PREFIX))
    out.append(kv.current_rev())
    out.append(sorted(chips.owned_chips("c")))
    return out


@pytest.mark.parametrize("backend", ["memory", "sqlite"])
def test_txn_claims_commit_in_one_apply_as_jax(backend, tmp_path):
    want = _run_txn(JAX, _kv(JAX, backend, tmp_path, "jax"))
    got = _run_txn(PORT, _kv(PORT, backend, tmp_path, "port"))
    assert got == want
    assert got[4] == ["apply"] and got[6] == ["apply", "apply"]
    assert got[5] == "RuntimeError"
    assert (tports.PortScheduler.apply_ports.__code__.co_varnames[:4]
            == jports.PortScheduler.apply_ports.__code__.co_varnames[:4])


# -- VersionMap ---------------------------------------------------------------


def _version_script(seed):
    rng = np.random.default_rng(seed)
    names = ["a", "b", "c"]
    ops = []
    for _ in range(60):
        op = rng.choice(["next", "next", "set", "rollback", "remove", "get",
                         "snapshot", "restart"])
        name = str(rng.choice(names))
        ops.append((str(op), name, int(rng.integers(-1, 5))))
    return ops


def _run_versions(pkg, kv, script):
    key = pkg.keys.VERSIONS_CONTAINER_KEY
    vm = pkg.version.VersionMap(kv, key)
    out = []
    for op, name, v in script:
        if op == "next":
            res = vm.next_version(name)
        elif op == "set":
            res = vm.set(name, max(v, 0))
        elif op == "rollback":
            res = vm.rollback(name, None if v < 0 else v)
        elif op == "remove":
            res = vm.remove(name)
        elif op == "get":
            res = (vm.get(name), vm.contains(name))
        elif op == "snapshot":
            res = vm.snapshot()
        else:
            vm = pkg.version.VersionMap(kv, key)  # a restart
            res = vm.snapshot()
        out.append((res, kv.get_or(key)))
    return out


@pytest.mark.parametrize("backend", ["memory", "sqlite"])
@pytest.mark.parametrize("seed", range(3))
def test_version_map_scripts_match_jax(backend, seed, tmp_path):
    script = _version_script(seed)
    want = _run_versions(JAX, _kv(JAX, backend, tmp_path, "jax"), script)
    got = _run_versions(PORT, _kv(PORT, backend, tmp_path, "port"), script)
    assert got == want


# -- StateStore ----------------------------------------------------------------


def _store_script(seed):
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(40):
        kind = str(rng.choice(["put_c", "put_c", "put_v", "get_c", "get_v",
                               "history", "latest", "del_version",
                               "del_family"]))
        base = str(rng.choice(["t", "u"]))
        ops.append((kind, base, int(rng.integers(0, 4)),
                    bool(rng.integers(0, 2))))
    return ops


def _run_store(pkg, kv, script):
    st = pkg.store.StateStore(kv)
    R = pkg.keys.Resource
    out = []
    for kind, base, v, versioned in script:
        name = f"{base}-{v}" if versioned else base
        if kind == "put_c":
            fn = lambda: st.put_container(pkg.state.ContainerState(  # noqa: E731
                container_name=f"{base}-{v}", version=v,
                spec={"name": f"{base}-{v}", "image": "i", "env": [str(v)]},
                desired_running=bool(v % 2)))
        elif kind == "put_v":
            fn = lambda: st.put_volume(pkg.state.VolumeState(  # noqa: E731
                volume_name=f"{base}-{v}", version=v, size=f"{v}GB",
                driver_opts={"size": f"{v}GB"}))
        elif kind == "get_c":
            fn = lambda: st.get_container(name).to_dict()  # noqa: E731
        elif kind == "get_v":
            fn = lambda: st.get_volume(name).to_dict()  # noqa: E731
        elif kind == "history":
            fn = lambda: (st.history(R.CONTAINERS, base),  # noqa: E731
                          st.history(R.VOLUMES, base))
        elif kind == "latest":
            fn = lambda: (st.latest_version(R.CONTAINERS, base),  # noqa: E731
                          st.latest_version(R.VOLUMES, base))
        elif kind == "del_version":
            fn = lambda: st.delete_version(R.CONTAINERS, name)  # noqa: E731
        else:
            fn = lambda: st.delete_family(R.VOLUMES, name)  # noqa: E731
        out.append((_outcome(fn), kv.current_rev()))
    out.append(kv.range_prefix(pkg.keys.PREFIX))
    return out


@pytest.mark.parametrize("backend", ["memory", "sqlite"])
@pytest.mark.parametrize("seed", range(3))
def test_state_store_scripts_match_jax(backend, seed, tmp_path):
    script = _store_script(seed)
    want = _run_store(JAX, _kv(JAX, backend, tmp_path, "jax"), script)
    got = _run_store(PORT, _kv(PORT, backend, tmp_path, "port"), script)
    assert got == want
    assert "NotExistInStore" in [o for o, _ in got[:-1]]


@pytest.mark.parametrize("method,args", [
    ("put_job", (None,)), ("get_job", ("j",)), ("put_service", (None,)),
    ("get_service", ("s",)), ("put_workflow", (None,)),
    ("get_workflow", ("w",))])
def test_store_refuses_unported_families_by_name(method, args):
    st = tstore.StateStore(tkv.MemoryKV())
    with pytest.raises(NotImplementedError,
                       match=f"{method}.*ROADMAP Queue 1 item 10"):
        getattr(st, method)(*args)


# -- pager ---------------------------------------------------------------------


def _run_pager(pkg, kv):
    st = pkg.store.StateStore(kv)
    R = pkg.keys.Resource
    for i in range(7):
        for v in range(1 + i % 3):
            st.put_container(pkg.state.ContainerState(
                container_name=f"f{i}-{v}", version=v, spec={"i": i}))
    out = [pkg.pager.list_families(kv, R.CONTAINERS)]
    for limit in (1, 3, 4, 100):
        token, pages = "", []
        while True:
            page = pkg.pager.list_families(kv, R.CONTAINERS, limit=limit,
                                           token=token)
            pages.append(page)
            token = page["continue"]
            if not token:
                break
        out.append(pages)
    first = pkg.pager.list_families(kv, R.CONTAINERS, limit=2)
    st.put_container(pkg.state.ContainerState(
        container_name="a0-0", version=0, spec={}))
    out.append(_outcome(lambda: pkg.pager.list_families(
        kv, R.CONTAINERS, limit=2, token=first["continue"])))
    out.append(_outcome(lambda: pkg.pager.list_families(
        kv, R.CONTAINERS, limit=2, token="!!garbage")))
    out.append(_outcome(lambda: pkg.pager.list_families(
        kv, R.VOLUMES, limit=2, token=first["continue"])))
    out.append(_outcome(lambda: pkg.pager.list_families(
        kv, R.CONTAINERS, token=first["continue"])))
    return out


@pytest.mark.parametrize("backend", ["memory", "sqlite"])
def test_pager_walks_match_jax(backend, tmp_path):
    want = _run_pager(JAX, _kv(JAX, backend, tmp_path, "jax"))
    got = _run_pager(PORT, _kv(PORT, backend, tmp_path, "port"))
    assert got == want
    assert got[-4:] == ["ContinueExpired", "BadRequest", "BadRequest",
                        "BadRequest"]
    assert [it["name"] for it in got[0]["items"]] == [f"f{i}"
                                                       for i in range(7)]


# -- crash points in KV.apply -------------------------------------------------


def _run_crashes(pkg, kv):
    crash = pkg.crash
    out = []
    for label, skip in (("txn.before_apply", 0), ("txn.after_apply", 0),
                        ("txn.before_apply", 1)):
        with crash.armed(label, skip=skip):
            for i in range(2):
                try:
                    kv.apply([("put", f"/k/{label}/{skip}/{i}", "v"),
                              ("put", f"/k/{label}/{skip}/{i}b", "w")])
                    out.append("applied")
                except crash.SimulatedCrash as e:
                    out.append(e.label)
                out.append(kv.range_prefix("/k/"))
    kv.apply([("put", "/k/free", "1")])  # disarmed again
    out.append(kv.range_prefix("/k/"))
    out.append(_outcome(lambda: crash.armed("job.run.after_create")
                        .__enter__()))
    return out


@pytest.mark.parametrize("backend", ["memory", "sqlite"])
def test_kv_apply_fires_crash_points_where_jax_does(backend, tmp_path):
    """A crash before the txn applies nothing, one after applies all, and
    ``skip`` picks which commit dies, in both packages."""
    want = _run_crashes(JAX, _kv(JAX, backend, tmp_path, "jax"))
    got = _run_crashes(PORT, _kv(PORT, backend, tmp_path, "port"))
    assert got[:-1] == want[:-1]
    assert got[0] == "txn.before_apply" and got[1] == {}
    assert got[4] == "txn.after_apply" and len(got[5]) == 2
    # the job labels come with the job service: the port refuses them
    assert want[-1] is None and got[-1] == "ValueError"


def test_port_knows_the_slice_crash_points_jax_fires():
    assert tcrash.KNOWN_CRASH_POINTS == (
        jcrash.CONTAINER_CRASH_POINTS + jcrash.QUEUE_CRASH_POINTS
        + jcrash.TXN_CRASH_POINTS + jcrash.FANOUT_CRASH_POINTS
        + jcrash.RECONCILE_CRASH_POINTS)
    assert issubclass(tcrash.SimulatedCrash, BaseException)
    assert not issubclass(tcrash.SimulatedCrash, Exception)


def test_container_run_costs_three_store_round_trips(tmp_path):
    """Version bump, one claim txn (chips and ports), one spec txn: JAX's
    three (service/container.py run_container), counted in each package."""
    from tpu_docker_api.runtime.fake import FakeRuntime as JFake
    from tpu_docker_api.schemas.container import ContainerPort as JPort
    from tpu_docker_api.schemas.container import ContainerRun as JRun
    from tpu_docker_api.service.container import ContainerService as JSvc
    from tpu_docker_api.state.workqueue import WorkQueue as JWQ
    from tpu_docker_api_torch.runtime.fake import FakeRuntime as TFake
    from tpu_docker_api_torch.schemas.container import ContainerPort as TPort
    from tpu_docker_api_torch.schemas.container import ContainerRun as TRun
    from tpu_docker_api_torch.service.container import ContainerService as TSvc
    from tpu_docker_api_torch.state.workqueue import WorkQueue as TWQ

    counts = []
    for pkg, fake, run, port, svc_cls, wq_cls, tag in (
            (JAX, JFake, JRun, JPort, JSvc, JWQ, "jax"),
            (PORT, TFake, TRun, TPort, TSvc, TWQ, "port")):
        kv = pkg.kv.MemoryKV()
        svc = svc_cls(fake(root=str(tmp_path / tag)), pkg.store.StateStore(kv),
                      pkg.slices.ChipScheduler(_topology(pkg), kv),
                      pkg.ports.PortScheduler(kv, 40000, 40099),
                      pkg.version.VersionMap(kv, pkg.keys.VERSIONS_CONTAINER_KEY),
                      wq_cls(kv))
        calls = _counting(kv)
        out = svc.run_container(run(image_name="i", container_name="c",
                                    chip_count=2,
                                    container_ports=[port(80), port(81)]))
        counts.append((out, list(calls), json.loads(
            kv.get(pkg.keys.SCHEDULER_PORTS_KEY))))
    assert counts[0] == counts[1]
    assert counts[1][1] == ["put", "apply", "apply"]
