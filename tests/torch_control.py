"""Shared harness of the control-plane tests that hold the port against the
JAX package (test_torch_reconcile, _chaos, _fanout, _informer, _faulty,
_etcd_kv, _store_health): each package's modules under one namespace, so a
test runs one script through ``JAX`` and ``PORT`` and compares what each
left behind. Both packages get the same host: an HGX line of 8 GPUs."""

import re
import types

from tpu_docker_api import config as jconfig
from tpu_docker_api import daemon as jdaemon
from tpu_docker_api import errors as jerrors
from tpu_docker_api.runtime import fake as jfake
from tpu_docker_api.runtime import fanout as jfanout
from tpu_docker_api.runtime import faulty as jfaulty
from tpu_docker_api.runtime import spec as jspec
from tpu_docker_api.scheduler import ports as jports
from tpu_docker_api.scheduler import slices as jslices
from tpu_docker_api.scheduler import topology as jtopo
from tpu_docker_api.schemas import container as jcontainer
from tpu_docker_api.schemas import volume as jvolume
from tpu_docker_api.service import container as jcsvc
from tpu_docker_api.service import crashpoints as jcrash
from tpu_docker_api.service import invariants as jinv
from tpu_docker_api.service import reconcile as jrec
from tpu_docker_api.service import store_health as jhealth
from tpu_docker_api.state import faulty as jfaultykv
from tpu_docker_api.state import informer as jinformer
from tpu_docker_api.state import keys as jkeys
from tpu_docker_api.state import kv as jkv
from tpu_docker_api.state import store as jstore
from tpu_docker_api.state import version as jversion
from tpu_docker_api.state import workqueue as jwq
from tpu_docker_api.telemetry import metrics as jmetrics
from tpu_docker_api_torch import config as tconfig
from tpu_docker_api_torch import daemon as tdaemon
from tpu_docker_api_torch import errors as terrors
from tpu_docker_api_torch.runtime import fake as tfake
from tpu_docker_api_torch.runtime import fanout as tfanout
from tpu_docker_api_torch.runtime import faulty as tfaulty
from tpu_docker_api_torch.runtime import spec as tspec
from tpu_docker_api_torch.scheduler import ports as tports
from tpu_docker_api_torch.scheduler import slices as tslices
from tpu_docker_api_torch.scheduler import topology as ttopo
from tpu_docker_api_torch.schemas import container as tcontainer
from tpu_docker_api_torch.schemas import volume as tvolume
from tpu_docker_api_torch.service import container as tcsvc
from tpu_docker_api_torch.service import crashpoints as tcrash
from tpu_docker_api_torch.service import invariants as tinv
from tpu_docker_api_torch.service import reconcile as trec
from tpu_docker_api_torch.service import store_health as thealth
from tpu_docker_api_torch.state import faulty as tfaultykv
from tpu_docker_api_torch.state import informer as tinformer
from tpu_docker_api_torch.state import keys as tkeys
from tpu_docker_api_torch.state import kv as tkv
from tpu_docker_api_torch.state import store as tstore
from tpu_docker_api_torch.state import version as tversion
from tpu_docker_api_torch.state import workqueue as twq
from tpu_docker_api_torch.telemetry import metrics as tmetrics

JAX = types.SimpleNamespace(
    name="jax", config=jconfig, daemon=jdaemon, errors=jerrors, fake=jfake,
    fanout=jfanout, faulty=jfaulty, spec=jspec, ports=jports,
    slices=jslices, c=jcontainer, v=jvolume, csvc=jcsvc, crash=jcrash,
    inv=jinv, rec=jrec, health=jhealth, faultykv=jfaultykv,
    informer=jinformer, keys=jkeys, kv=jkv, store=jstore, version=jversion,
    wq=jwq, metrics=jmetrics)
PORT = types.SimpleNamespace(
    name="port", config=tconfig, daemon=tdaemon, errors=terrors, fake=tfake,
    fanout=tfanout, faulty=tfaulty, spec=tspec, ports=tports,
    slices=tslices, c=tcontainer, v=tvolume, csvc=tcsvc, crash=tcrash,
    inv=tinv, rec=trec, health=thealth, faultykv=tfaultykv,
    informer=tinformer, keys=tkeys, kv=tkv, store=tstore, version=tversion,
    wq=twq, metrics=tmetrics)
PKGS = (JAX, PORT)
H100 = ttopo.GENERATIONS["h100"]


def topology(pkg):
    """An HGX line of 8 H100s in either package's topology type."""
    top = ttopo.HostTopology.build("h100-8")
    if pkg is PORT:
        return top
    gen = jtopo.Generation(H100.name, H100.cores_per_chip, H100.host_mesh,
                           H100.hbm_bytes_per_chip, H100.peak_bf16_flops,
                           H100.torus_dims)
    return jtopo.HostTopology(gen, top.mesh_shape, dict(top.coords))


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
