"""Shared harness of the control-plane tests that hold the port against the
JAX package (test_torch_reconcile, _chaos, _fanout, _informer, _faulty,
_etcd_kv, _store_health, _pod, _job_supervisor, _host_health, _job_chaos,
_job_e2e, _admission, _service, _workflow, _leader, _shard, _compactor,
_gateway):
each package's modules under one namespace, so a test runs one script
through ``JAX`` and ``PORT`` and compares what each left behind.
Both packages get the same host: an HGX line of 8 GPUs. JAX's topology
knows no GPU part, so the job tests teach it ``h100`` for their duration
(``jax_knows_h100``): a JAX pod then has the port's hosts, GPU for GPU."""

import contextlib
import re
import types

from tpu_docker_api import config as jconfig
from tpu_docker_api.api import gateway_app as jgwapp
from tpu_docker_api import daemon as jdaemon
from tpu_docker_api import errors as jerrors
from tpu_docker_api.runtime import fake as jfake
from tpu_docker_api.runtime import fanout as jfanout
from tpu_docker_api.runtime import faulty as jfaulty
from tpu_docker_api.runtime import spec as jspec
from tpu_docker_api.scheduler import pod as jpod
from tpu_docker_api.scheduler import ports as jports
from tpu_docker_api.scheduler import slices as jslices
from tpu_docker_api.scheduler import topology as jtopo
from tpu_docker_api.schemas import container as jcontainer
from tpu_docker_api.schemas import job as jjobschema
from tpu_docker_api.schemas import service as jsvcschema
from tpu_docker_api.schemas import state as jstate
from tpu_docker_api.schemas import volume as jvolume
from tpu_docker_api.schemas import workflow as jwfschema
from tpu_docker_api.service import admission as jadmission
from tpu_docker_api.service import compactor as jcompactor
from tpu_docker_api.service import container as jcsvc
from tpu_docker_api.service import crashpoints as jcrash
from tpu_docker_api.service import gateway as jgateway
from tpu_docker_api.service import host_health as jhosthealth
from tpu_docker_api.service import invariants as jinv
from tpu_docker_api.service import job as jjob
from tpu_docker_api.service import job_supervisor as jsup
from tpu_docker_api.service import leader as jleader
from tpu_docker_api.service import reconcile as jrec
from tpu_docker_api.service import serving as jserving
from tpu_docker_api.service import shard as jshard
from tpu_docker_api.service import store_health as jhealth
from tpu_docker_api.service import watch as jwatch
from tpu_docker_api.service import workflow as jworkflow
from tpu_docker_api.state import faulty as jfaultykv
from tpu_docker_api.state import informer as jinformer
from tpu_docker_api.state import keys as jkeys
from tpu_docker_api.state import kv as jkv
from tpu_docker_api.state import store as jstore
from tpu_docker_api.state import txn as jtxn
from tpu_docker_api.state import version as jversion
from tpu_docker_api.state import workqueue as jwq
from tpu_docker_api.telemetry import metrics as jmetrics
from tpu_docker_api.telemetry import trace as jtrace
from tpu_docker_api_torch import config as tconfig
from tpu_docker_api_torch.api import gateway_app as tgwapp
from tpu_docker_api_torch import daemon as tdaemon
from tpu_docker_api_torch import errors as terrors
from tpu_docker_api_torch.runtime import fake as tfake
from tpu_docker_api_torch.runtime import fanout as tfanout
from tpu_docker_api_torch.runtime import faulty as tfaulty
from tpu_docker_api_torch.runtime import spec as tspec
from tpu_docker_api_torch.scheduler import pod as tpod
from tpu_docker_api_torch.scheduler import ports as tports
from tpu_docker_api_torch.scheduler import slices as tslices
from tpu_docker_api_torch.scheduler import topology as ttopo
from tpu_docker_api_torch.schemas import container as tcontainer
from tpu_docker_api_torch.schemas import job as tjobschema
from tpu_docker_api_torch.schemas import service as tsvcschema
from tpu_docker_api_torch.schemas import state as tstate
from tpu_docker_api_torch.schemas import volume as tvolume
from tpu_docker_api_torch.schemas import workflow as twfschema
from tpu_docker_api_torch.service import admission as tadmission
from tpu_docker_api_torch.service import compactor as tcompactor
from tpu_docker_api_torch.service import container as tcsvc
from tpu_docker_api_torch.service import crashpoints as tcrash
from tpu_docker_api_torch.service import gateway as tgateway
from tpu_docker_api_torch.service import host_health as thosthealth
from tpu_docker_api_torch.service import invariants as tinv
from tpu_docker_api_torch.service import job as tjob
from tpu_docker_api_torch.service import job_supervisor as tsup
from tpu_docker_api_torch.service import leader as tleader
from tpu_docker_api_torch.service import reconcile as trec
from tpu_docker_api_torch.service import serving as tserving
from tpu_docker_api_torch.service import shard as tshard
from tpu_docker_api_torch.service import store_health as thealth
from tpu_docker_api_torch.service import watch as twatch
from tpu_docker_api_torch.service import workflow as tworkflow
from tpu_docker_api_torch.state import faulty as tfaultykv
from tpu_docker_api_torch.state import informer as tinformer
from tpu_docker_api_torch.state import keys as tkeys
from tpu_docker_api_torch.state import kv as tkv
from tpu_docker_api_torch.state import store as tstore
from tpu_docker_api_torch.state import txn as ttxn
from tpu_docker_api_torch.state import version as tversion
from tpu_docker_api_torch.state import workqueue as twq
from tpu_docker_api_torch.telemetry import metrics as tmetrics
from tpu_docker_api_torch.telemetry import trace as ttrace

JAX = types.SimpleNamespace(
    name="jax", config=jconfig, daemon=jdaemon, errors=jerrors, fake=jfake,
    fanout=jfanout, faulty=jfaulty, spec=jspec, ports=jports,
    slices=jslices, c=jcontainer, v=jvolume, csvc=jcsvc, crash=jcrash,
    inv=jinv, rec=jrec, health=jhealth, faultykv=jfaultykv,
    informer=jinformer, keys=jkeys, kv=jkv, store=jstore, version=jversion,
    wq=jwq, metrics=jmetrics, topo=jtopo, pod=jpod, js=jjobschema,
    job=jjob, sup=jsup, hh=jhosthealth, watch=jwatch, txn=jtxn,
    adm=jadmission, serving=jserving, ss=jsvcschema, wfs=jwfschema,
    wf=jworkflow, leader=jleader, shard=jshard, compactor=jcompactor,
    state=jstate, gateway=jgateway, gwapp=jgwapp, trace=jtrace)
PORT = types.SimpleNamespace(
    name="port", config=tconfig, daemon=tdaemon, errors=terrors, fake=tfake,
    fanout=tfanout, faulty=tfaulty, spec=tspec, ports=tports,
    slices=tslices, c=tcontainer, v=tvolume, csvc=tcsvc, crash=tcrash,
    inv=tinv, rec=trec, health=thealth, faultykv=tfaultykv,
    informer=tinformer, keys=tkeys, kv=tkv, store=tstore, version=tversion,
    wq=twq, metrics=tmetrics, topo=ttopo, pod=tpod, js=tjobschema,
    job=tjob, sup=tsup, hh=thosthealth, watch=twatch, txn=ttxn,
    adm=tadmission, serving=tserving, ss=tsvcschema, wfs=twfschema,
    wf=tworkflow, leader=tleader, shard=tshard, compactor=tcompactor,
    state=tstate, gateway=tgateway, gwapp=tgwapp, trace=ttrace)
PKGS = (JAX, PORT)
H100 = ttopo.GENERATIONS["h100"]
#: the H100 as JAX's topology module spells a generation
JAX_H100 = jtopo.Generation(H100.name, H100.cores_per_chip, H100.host_mesh,
                            H100.hbm_bytes_per_chip, H100.peak_bf16_flops,
                            H100.torus_dims)


@contextlib.contextmanager
def jax_knows_h100():
    """JAX's ``parse_accelerator_type`` and ``HostTopology.build`` take
    ``"h100-N"`` inside the block (its GENERATIONS table is restored
    after)."""
    jtopo.GENERATIONS["h100"] = JAX_H100
    try:
        yield
    finally:
        jtopo.GENERATIONS.pop("h100", None)


def topology(pkg, acc: str = "h100-8"):
    """An HGX line of H100s in either package's topology type."""
    top = ttopo.HostTopology.build(acc)
    if pkg is PORT:
        return top
    return jtopo.HostTopology(JAX_H100, top.mesh_shape, dict(top.coords))


def boot(pkg, kv, runtime, **cfg):
    """A Program over injected state, init only: no HTTP server, and the
    work queue deliberately NOT started (tests/test_chaos.py's crash
    model: what the dying flow enqueued dies with it unless journaled)."""
    conf = pkg.config.Config(store_backend="memory", runtime_backend="fake",
                             health_watch_interval=0, end_port=40099, **cfg)
    prg = pkg.daemon.Program(conf, kv=kv, runtime=runtime)
    prg._discover_topology = lambda: topology(pkg)
    prg.init()
    return prg


def world(runtime, versions, chips, ports) -> dict:
    """What the control plane and the engine hold: the comparison's
    currency across packages (no ids, no clocks, no attachment form)."""
    rt = {}
    for name in sorted(runtime.container_list()):
        info = runtime.container_inspect(name)
        rt[name] = (info.running, info.status)
    return {
        "versions": dict(sorted(versions.snapshot().items())),
        "runtime": rt,
        "gpus": [(c["chipId"], c["owner"]) for c in chips.status()["chips"]
                 if c["used"]],
        "ports": dict(sorted(ports.status()["owners"].items())),
    }


def prg_world(prg) -> dict:
    return world(prg.runtime, prg.container_versions, prg.chip_scheduler,
                 prg.port_scheduler)


def invariants(pkg, prg) -> list:
    return pkg.inv.check_invariants(
        prg.runtime, prg.store, prg.container_versions, prg.chip_scheduler,
        prg.port_scheduler)


_HEX = re.compile(r"\b[0-9a-f]{12,64}\b")


def scrub(obj):
    """Random ids (task ids, container ids) read as ``<id>``."""
    if isinstance(obj, dict):
        return {k: scrub(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(scrub(v) for v in obj)
    if isinstance(obj, str):
        return _HEX.sub("<id>", obj)
    return obj


def shape(report) -> dict:
    """A reconcile report without its clock and random ids."""
    return scrub({k: v for k, v in report.items() if k != "durationMs"})


def outcome(fn, *args, **kwargs):
    """``("ok", value)`` or ``("raise", error class name)``: a call's
    result in a form two packages' calls compare by."""
    try:
        return ("ok", fn(*args, **kwargs))
    except Exception as e:  # noqa: BLE001 — the class is the outcome
        return ("raise", type(e).__name__)


def pod_world(pod, sched, versions=None) -> dict:
    """What a pod holds, host by host: the containers and their states,
    the GPU and port owners, the slice registry, cordons and down hosts,
    and the job versions — comparable across packages."""
    hosts = {}
    for hid in sorted(pod.hosts):
        h = pod.hosts[hid]
        rt = {}
        try:
            names = sorted(h.runtime.container_list())
        except Exception as e:  # noqa: BLE001 — an unreachable engine
            names, rt = [], {"<unreachable>": type(e).__name__}
        for name in names:
            info = h.runtime.container_inspect(name)
            rt[name] = (info.running, info.status)
        hosts[hid] = {
            "runtime": rt,
            "gpus": [(c["chipId"], c["owner"])
                     for c in h.chips.status()["chips"] if c["used"]],
            "ports": dict(sorted(h.ports.status()["owners"].items())),
        }
    st = sched.status()
    out = {"hosts": hosts, "slices": st["slices"],
           "cordoned": st["cordonedHosts"], "down": st["downHosts"]}
    if versions is not None:
        out["versions"] = dict(sorted(versions.snapshot().items()))
    return out


def job_world(prg) -> dict:
    return pod_world(prg.pod, prg.pod_scheduler, prg.job_versions)


def job_invariants(pkg, prg) -> list:
    return pkg.inv.check_job_invariants(prg.pod, prg.pod_scheduler,
                                        prg.store, prg.job_versions)


def dist_env(env: list[str]) -> dict:
    """A member's distributed bootstrap in one vocabulary for both
    packages: the rendezvous, this member's index, the members of the job
    and the GPUs this member holds."""
    e = dict(x.split("=", 1) for x in env)
    if "JAX_COORDINATOR_ADDRESS" in e:
        return {"master": e["JAX_COORDINATOR_ADDRESS"],
                "member": int(e["JAX_PROCESS_ID"]),
                "members": int(e["JAX_NUM_PROCESSES"]),
                "gpus": len(e.get("TPU_VISIBLE_CHIPS", "").split(","))}
    k = int(e.get("LOCAL_WORLD_SIZE", "1"))
    return {"master": f"{e['MASTER_ADDR']}:{e['MASTER_PORT']}",
            "member": int(e.get("NODE_RANK", e.get("RANK", "0"))),
            "members": int(e["WORLD_SIZE"]) // k,
            "gpus": k}


def pod_program(pkg, n_hosts: int = 1, kv=None, rts=None, **cfg):
    """A Program over a row of ``n_hosts`` 8-GPU hosts (h0 the daemon's
    local host sharing the injected engine, the others remote fake
    engines; one host is a single-host pod), init only: no loop or HTTP
    server runs, so a test drives ``admit_once``/``tick`` inline. Used
    inside ``jax_knows_h100``."""
    kv = kv if kv is not None else pkg.kv.MemoryKV()
    rts = rts or {f"h{i}": pkg.fake.FakeRuntime() for i in range(n_hosts)}
    conf = pkg.config.Config(
        store_backend="memory", runtime_backend="fake",
        accelerator_type="h100-8", health_watch_interval=0, end_port=40099,
        pod_hosts=[] if len(rts) == 1 else [
            {"host_id": f"h{i}", "address": f"10.0.0.{i + 1}",
             "grid_coord": [i, 0, 0],
             **({"local": True} if i == 0 else {"runtime_backend": "fake"})}
            for i in range(len(rts))], **cfg)
    prg = pkg.daemon.Program(conf, kv=kv, runtime=rts["h0"],
                             pod_runtimes={h: r for h, r in rts.items()
                                           if h != "h0"})
    prg._discover_topology = lambda: topology(pkg)
    prg.init()
    return prg


def market_oracle(pkg, prg) -> list:
    """The service, job and container oracles of one Program."""
    return (pkg.inv.check_service_invariants(
        prg.store, prg.service_versions, prg.job_versions)
        + job_invariants(pkg, prg)
        + pkg.inv.check_invariants(
            prg.runtime, prg.store, prg.container_versions,
            prg.chip_scheduler, prg.port_scheduler,
            job_versions=prg.job_versions))


#: event fields stamped from a clock or a trace, left out of a comparison
_CLOCKED = ("ts", "wait_ms", "traceId", "waitingS")


def unclocked(obj):
    """``obj`` without the clock- and trace-stamped fields (a resize's
    ``ts``, an event's ``wait_ms``, ``traceId``, an entry's
    ``waitingS``, a service's ``lastScale.ts`` and signal ``ts``)."""
    if isinstance(obj, dict):
        return {k: unclocked(v) for k, v in obj.items()
                if k not in _CLOCKED}
    if isinstance(obj, (list, tuple)):
        return type(obj)(unclocked(v) for v in obj)
    return obj


def market_books(pkg, prg) -> dict:
    """What the capacity market and the services left behind: every job
    family's stored latest state, the admission journal in precedence
    order, the service records, the pod (containers, GPU and port owners,
    slices, versions), the market's event ring and the oracles."""
    jobs = {}
    for base, v in sorted(prg.job_versions.snapshot().items()):
        try:
            jobs[base] = prg.store.get_job(f"{base}-{v}").to_dict()
        except Exception as e:  # noqa: BLE001 — a half-made version
            jobs[base] = type(e).__name__
    services = {}
    for base, v in sorted(prg.service_versions.snapshot().items()):
        try:
            services[base] = prg.store.get_service(f"{base}-{v}").to_dict()
        except Exception as e:  # noqa: BLE001 — a half-made version
            services[base] = type(e).__name__
    return unclocked({
        "jobs": jobs, "services": services,
        "records": [(r.base, r.kind, r.klass, r.skips, r.seq)
                    for r in prg.admission._ordered()],
        "world": job_world(prg),
        "admission_events": prg.admission.events_view(1000),
        "service_events": prg.serving.events_view(1000),
        "oracle": market_oracle(pkg, prg)})


def both(case):
    """``case(pkg)`` through each package: equal results required; the
    port's is returned."""
    got = [case(pkg) for pkg in PKGS]
    if isinstance(got[0], dict) and isinstance(got[1], dict):
        differ = {k: (got[0].get(k), got[1].get(k))
                  for k in set(got[0]) | set(got[1])
                  if got[0].get(k) != got[1].get(k)}
        assert not differ, f"jax vs port: {differ}"
    assert got[1] == got[0]
    return got[1]

