"""State layer of the port (parity: reference L4 — ``internal/etcd/``):
the KV backends and the key layout. The port's counterpart of
``tpu_docker_api/state/``; the store, version map, work queue and
informer come with the rest of the control plane (ROADMAP Queue 1 item
10)."""

from tpu_docker_api_torch.state.kv import KV, MemoryKV, SqliteKV, open_store  # noqa: F401
from tpu_docker_api_torch.state.keys import Resource, family_key, version_key  # noqa: F401
