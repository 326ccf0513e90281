"""The port's OpenAPI contract (``api/openapi.py``) against the JAX
package's: every case of ``tests/test_openapi.py`` runs on the port's
spec and live router, and the port's ``build_spec()`` equals JAX's
committed ``api/openapi.json`` key for key — the same paths, operations,
parameters and request schemas. The only differences are five prose
texts that say GPU, torch and NCCL where JAX's say TPU, JAX and ICI
(``GPU_WORDING``), pinned here."""

import json
import pathlib
import subprocess
import sys

import pytest

from tpu_docker_api.api import openapi as jopenapi
from tpu_docker_api_torch.api.app import build_router
from tpu_docker_api_torch.api.openapi import build_spec, route_inventory

REPO = pathlib.Path(__file__).resolve().parent.parent

#: the JSON paths of the spec whose text is the port's own
GPU_WORDING = {
    ("info", "description"),
    ("paths", "/api/v1/containers", "post", "summary"),
    ("paths", "/api/v1/jobs", "post", "summary"),
    ("components", "schemas", "ContainerRun", "properties", "chipCount",
     "description"),
    ("components", "schemas", "JobRun", "properties", "numSlices",
     "description"),
}


def _live_routes():
    """Every route a fully-wired port router exposes, plus the raw
    /metrics endpoint served outside the router."""

    class _Any:
        def __getattr__(self, _):
            return lambda *a, **k: {}

    svc = _Any()
    r = build_router(svc, svc, svc, svc, work_queue=svc, health_watcher=svc,
                     metrics=None, job_svc=svc, pod_scheduler=svc,
                     reconciler=svc, job_supervisor=svc, host_monitor=svc,
                     admission=svc, serving=svc, compactor=svc, tracer=svc,
                     gateway=svc, workflow_svc=svc)
    routes = {(m, p) for m, _, p, _ in r._routes}
    routes.add(("GET", "/metrics"))
    return routes


def _differences(a, b, path=()):
    """JSON paths where ``a`` and ``b`` differ (a key on one side only
    counts as a difference at that key)."""
    if isinstance(a, dict) and isinstance(b, dict):
        out = set()
        for k in set(a) | set(b):
            if k not in a or k not in b:
                out.add(path + (k,))
            else:
                out |= _differences(a[k], b[k], path + (k,))
        return out
    return set() if a == b else {path}


def _committed():
    return json.loads((REPO / "api" / "openapi.json").read_text())


def test_spec_covers_every_live_route():
    assert _live_routes() <= route_inventory()


def test_spec_has_no_phantom_routes():
    assert route_inventory() <= _live_routes()


def test_committed_contract_in_sync():
    """The port's spec is JAX's committed contract apart from the GPU
    wording, and JAX's generator still writes that contract."""
    committed = _committed()
    assert _differences(committed, build_spec()) == GPU_WORDING
    assert jopenapi.build_spec() == committed
    assert route_inventory() == jopenapi.route_inventory()


def test_example_config_loads():
    from tpu_docker_api_torch.config import Config, load

    cfg = load(str(REPO / "etc" / "config.toml"))
    assert cfg.port == Config().port
    assert cfg.runtime_backend == "docker"


def test_request_schemas_resolve():
    spec = build_spec()
    schemas = spec["components"]["schemas"]
    for path, ops in spec["paths"].items():
        for op in ops.values():
            body = op.get("requestBody")
            if body:
                ref = body["content"]["application/json"]["schema"]["$ref"]
                assert ref.rsplit("/", 1)[1] in schemas, f"{path}: dangling {ref}"


@pytest.mark.parametrize("where", sorted(GPU_WORDING))
def test_gpu_wording_says_gpu_where_jax_says_tpu(where):
    def at(spec):
        for k in where:
            spec = spec[k]
        return spec

    port, jax = at(build_spec()), at(_committed())
    assert port != jax
    for word in ("TPU", "JAX", "ICI", "MEGASCALE"):
        assert word not in port, (where, port)


def test_module_prints_the_spec():
    out = subprocess.run(
        [sys.executable, "-m", "tpu_docker_api_torch.api.openapi"],
        cwd=REPO, capture_output=True, text=True, timeout=120, check=True)
    assert json.loads(out.stdout) == build_spec()
