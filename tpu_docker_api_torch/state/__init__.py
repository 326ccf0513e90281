"""State & versioning layer of the port (parity: reference L4 —
``internal/etcd/``, ``internal/version/``, ``internal/workQueue/``): the KV
backends, the key layout, the typed store, version maps, batched txns, the
list pager, the durable work queue, the watch-fed informer and the faulty
store of the chaos tests. The port's counterpart of
``tpu_docker_api/state/``."""

from tpu_docker_api_torch.state.kv import KV, MemoryKV, SqliteKV, open_store  # noqa: F401
from tpu_docker_api_torch.state.keys import Resource, family_key, version_key  # noqa: F401
from tpu_docker_api_torch.state.store import StateStore  # noqa: F401
from tpu_docker_api_torch.state.version import VersionMap  # noqa: F401
from tpu_docker_api_torch.state.workqueue import TaskRecord, WorkQueue  # noqa: F401
