"""Typed state store over the KV backends.

The service layer's one stop for persisted specs. Wraps `state.kv.KV` with the
per-version key layout from `state.keys`, giving the rollback-capable history
the reference advertises but cannot deliver (SURVEY.md appendix, etcd quirk).

The port's copy of ``tpu_docker_api/state/store.py``: the container, volume,
job, service and workflow families.
"""

from __future__ import annotations

import json

from tpu_docker_api_torch import errors
from tpu_docker_api_torch.schemas.state import ContainerState, VolumeState
from tpu_docker_api_torch.state import keys
from tpu_docker_api_torch.state.keys import Resource
from tpu_docker_api_torch.state.kv import KV
from tpu_docker_api_torch.telemetry import trace


class StateStore:
    def __init__(self, kv: KV) -> None:
        self.kv = kv

    # -- generic ----------------------------------------------------------------

    def _put(self, resource: Resource, base: str, version: int, payload: dict,
             pointer: bool = True) -> None:
        # one atomic apply, not two puts: the version record and the family's
        # latest pointer land together — no crash window where a pointer
        # names a spec that was never written (and one store round trip per
        # version transition instead of two). ``pointer=False`` updates a
        # RETIRED version's record (the quiesce bookkeeping a swap/migrate/
        # resize writes after the new version took the pointer) without
        # rewinding the family's latest back onto it.
        with trace.child("store.put", resource=resource.value, base=base,
                         version=version):
            self.kv.apply(self._put_ops(resource, base, version, payload,
                                        pointer=pointer))

    @staticmethod
    def _put_ops(resource: Resource, base: str, version: int,
                 payload: dict, pointer: bool = True) -> list[tuple]:
        ops = [
            ("put", keys.version_key(resource, base, version),
             json.dumps(payload)),
        ]
        if pointer:
            ops.append(("put", keys.latest_key(resource, base), str(version)))
        return ops

    def _get(self, resource: Resource, name: str) -> dict:
        """Fetch by versioned name, or by base name (⇒ latest version)."""
        with trace.child("store.get", resource=resource.value, target=name):
            base, version = keys.split_versioned_name(name)
            if version is None:
                latest = self.kv.get_or(keys.latest_key(resource, base))
                if latest is None:
                    raise errors.NotExistInStore(name)
                version = int(latest)
            raw = self.kv.get_or(keys.version_key(resource, base, version))
            if raw is None:
                raise errors.NotExistInStore(name)
            return json.loads(raw)

    def latest_version(self, resource: Resource, base: str) -> int | None:
        raw = self.kv.get_or(keys.latest_key(resource, base))
        return None if raw is None else int(raw)

    def history(self, resource: Resource, base: str) -> list[int]:
        """Stored versions, oldest first — sorted numerically (zero-padded
        keys are already key-sorted, but parse-and-sort keeps this robust
        to hand-written keys). Keys-only scan: deriving which versions
        exist must not haul every version's full JSON over the wire."""
        prefix = f"{keys.PREFIX}/{resource.value}/{base}/v/"
        return sorted(
            int(k.rsplit("/", 1)[1]) for k in self.kv.keys_prefix(prefix))

    def delete_family(self, resource: Resource, name: str) -> None:
        """Drop every version + the latest pointer (delEtcdInfo semantics)."""
        base, _ = keys.split_versioned_name(name)
        self.kv.delete_prefix(keys.family_prefix(resource, base))

    def delete_version(self, resource: Resource, name: str) -> None:
        base, version = keys.split_versioned_name(name)
        if version is not None:
            self.kv.delete(keys.version_key(resource, base, version))

    # -- containers -------------------------------------------------------------

    def put_container(self, st: ContainerState) -> None:
        base, _ = keys.split_versioned_name(st.container_name)
        self._put(Resource.CONTAINERS, base, st.version, st.to_dict())

    def get_container(self, name: str) -> ContainerState:
        return ContainerState.from_dict(self._get(Resource.CONTAINERS, name))

    # -- jobs -------------------------------------------------------------------

    def put_job(self, st, pointer: bool = True) -> None:
        """``pointer=False`` rewrites a retired version's record (e.g. the
        old gang marked stopped after a swap) without rewinding the
        family's latest pointer onto it — a bare-name ``GET`` must keep
        serving the version that actually superseded it."""
        base, _ = keys.split_versioned_name(st.job_name)
        self._put(Resource.JOBS, base, st.version, st.to_dict(),
                  pointer=pointer)

    def get_job(self, name: str):
        from tpu_docker_api_torch.schemas.job import JobState

        return JobState.from_dict(self._get(Resource.JOBS, name))

    # -- services ---------------------------------------------------------------

    def put_service(self, st) -> None:
        base, _ = keys.split_versioned_name(st.service_name)
        self._put(Resource.SERVICES, base, st.version, st.to_dict())

    def get_service(self, name: str):
        from tpu_docker_api_torch.schemas.service import ServiceState

        return ServiceState.from_dict(self._get(Resource.SERVICES, name))

    # -- workflows --------------------------------------------------------------

    def put_workflow(self, st) -> None:
        base, _ = keys.split_versioned_name(st.workflow_name)
        self._put(Resource.WORKFLOWS, base, st.version, st.to_dict())

    def get_workflow(self, name: str):
        from tpu_docker_api_torch.schemas.workflow import WorkflowState

        return WorkflowState.from_dict(self._get(Resource.WORKFLOWS, name))

    # -- volumes ----------------------------------------------------------------

    def put_volume(self, st: VolumeState) -> None:
        base, _ = keys.split_versioned_name(st.volume_name)
        self._put(Resource.VOLUMES, base, st.version, st.to_dict())

    def get_volume(self, name: str) -> VolumeState:
        return VolumeState.from_dict(self._get(Resource.VOLUMES, name))
