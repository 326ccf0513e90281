"""The port's history compactor (``service/compactor.py``) against the JAX
package's on the CPU: every case of ``tests/test_compactor.py`` runs one
script through each package — retention bounds version history without
touching the latest pointer's version or a version a live runtime member
still references, settled admission records and acked queue markers
drain, deletes ride ≤100-op chunks — and the store keys each left, the
compaction reports and the chunk sizes must be JAX's. JAX's own
assertions then hold on the port's side."""

import json
import types

import torch_control as tc


def recording_kv(pkg):
    """A pass-through store that records every apply's op count."""
    class RecordingKV(pkg.kv.KV):
        def __init__(self, inner):
            self.inner = inner
            self.apply_sizes: list[int] = []

        def put(self, k, v):
            self.inner.put(k, v)

        def get(self, k):
            return self.inner.get(k)

        def delete(self, k):
            self.inner.delete(k)

        def range_prefix(self, p):
            return self.inner.range_prefix(p)

        def keys_prefix(self, p, limit=0, start_after=""):
            return self.inner.keys_prefix(p, limit=limit,
                                          start_after=start_after)

        def _apply(self, ops, guards=None):
            self.apply_sizes.append(len(ops))
            self.inner._apply(ops, guards)

    return RecordingKV(pkg.kv.MemoryKV())


class Env:
    def __init__(self, pkg, root, retention=3, runtime=None):
        keys = pkg.keys
        self.pkg = pkg
        self.kv = recording_kv(pkg)
        self.store = pkg.store.StateStore(self.kv)
        self.runtime = runtime if runtime is not None else \
            pkg.fake.FakeRuntime(root=str(root))
        self.cvm = pkg.version.VersionMap(self.kv,
                                          keys.VERSIONS_CONTAINER_KEY)
        self.jvm = pkg.version.VersionMap(self.kv, keys.VERSIONS_JOB_KEY)
        self.compactor = pkg.compactor.HistoryCompactor(
            self.kv, self.store,
            maps=[(keys.Resource.CONTAINERS, self.cvm),
                  (keys.Resource.JOBS, self.jvm)],
            retention=retention, runtime=self.runtime,
            registry=pkg.metrics.MetricsRegistry())

    def seed_container_family(self, base, versions, latest=None):
        pkg = self.pkg
        for v in range(versions):
            spec = pkg.spec.ContainerSpec(name=f"{base}-{v}",
                                          image="jax").to_dict()
            self.store.put_container(pkg.state.ContainerState(
                container_name=f"{base}-{v}", version=v, spec=spec))
        if latest is not None:
            self.kv.put(pkg.keys.latest_key(pkg.keys.Resource.CONTAINERS,
                                            base), str(latest))
        self.cvm.set(base, latest if latest is not None else versions - 1)

    def history(self, base):
        return self.store.history(self.pkg.keys.Resource.CONTAINERS, base)

    def books(self, **extra) -> dict:
        """The store's keys (the port's container spec carries its GPUs'
        UUIDs besides JAX's fields), the apply sizes and ``extra``."""
        return {"store": sorted(self.kv.range_prefix("/")),
                "applies": self.kv.apply_sizes, **extra}


def both_envs(script, tmp_path, **kw):
    """``script(env)`` through an Env of each package: equal books."""
    return tc.both(lambda pkg: script(Env(pkg, tmp_path / pkg.name, **kw)))


class TestRetention:
    def test_trims_past_retention_keeping_newest(self, tmp_path):
        def script(env):
            env.seed_container_family("t", versions=8)
            report = env.compactor.compact_once()
            return env.books(history=env.history("t"),
                             trimmed=report["trimmed"])

        out = both_envs(script, tmp_path)
        assert out["history"] == [5, 6, 7]
        assert out["trimmed"] == {"containers": 5}

    def test_under_retention_untouched(self, tmp_path):
        def script(env):
            env.seed_container_family("t", versions=2)
            return env.books(total=env.compactor.compact_once()[
                "trimmedTotal"], history=env.history("t"))

        out = both_envs(script, tmp_path)
        assert out["total"] == 0 and out["history"] == [0, 1]

    def test_latest_pointer_version_survives_any_age(self, tmp_path):
        def script(env):
            # rolled back: the pointer names an OLD version
            env.seed_container_family("t", versions=8, latest=1)
            env.compactor.compact_once()
            return env.books(history=env.history("t"))

        assert both_envs(script, tmp_path)["history"] == [1, 5, 6, 7]

    def test_live_member_version_survives(self, tmp_path):
        def script(env):
            env.seed_container_family("t", versions=8)
            env.runtime.seed_running(
                ["t-2"], env.pkg.spec.ContainerSpec(name="t-2", image="jax"),
                running=False)
            report = env.compactor.compact_once()
            spared = env.history("t")
            env.runtime.container_remove("t-2", force=True)
            env.compactor.compact_once()
            return env.books(spared=spared, live=report["protectedLive"],
                             after=env.history("t"))

        out = both_envs(script, tmp_path)
        assert out["spared"] == [2, 5, 6, 7] and out["live"] == 1
        # the spared version trims the moment its member is gone
        assert out["after"] == [5, 6, 7]

    def test_live_job_member_version_survives(self, tmp_path):
        def case(pkg):
            rt = pkg.fake.FakeRuntime(root=str(tmp_path / pkg.name))
            env = Env(pkg, tmp_path / pkg.name, runtime=rt)
            env.compactor._pod = types.SimpleNamespace(
                hosts={"h0": types.SimpleNamespace(runtime=rt)})
            for v in range(6):
                env.store.put_job(pkg.js.JobState(
                    job_name=f"j-{v}", version=v, image="jax", cmd=[],
                    env=[], binds=[], chip_count=0, coordinator_port=0,
                    placements=[["h0", f"j-{v}-p0", 0, [], 0]]))
            env.jvm.set("j", 5)
            rt.seed_running(["j-1-p0"], pkg.spec.ContainerSpec(
                name="j-1-p0", image="jax"), running=False)
            env.compactor.compact_once()
            return env.books(history=env.store.history(
                pkg.keys.Resource.JOBS, "j"))

        assert tc.both(case)["history"] == [1, 3, 4, 5]

    def test_deletes_ride_chunks_under_etcd_ceiling(self, tmp_path):
        def script(env):
            for i in range(3):
                env.seed_container_family(f"t{i}", versions=60)
            env.kv.apply_sizes.clear()
            env.compactor.compact_once()
            return env.books()

        sizes = both_envs(script, tmp_path, retention=2)["applies"]
        assert sum(sizes) == 3 * (60 - 2)
        assert max(sizes) <= 100 and len(sizes) >= 2


class TestDrains:
    def test_orphan_admission_record_purged_live_kept(self, tmp_path):
        def script(env):
            pkg, keys = env.pkg, env.pkg.keys
            env.store.put_job(pkg.js.JobState(
                job_name="alive-0", version=0, image="jax", cmd=[], env=[],
                binds=[], chip_count=0, coordinator_port=0, placements=[]))
            env.jvm.set("alive", 0)
            env.kv.put(keys.admission_record_key(1), json.dumps(
                {"seq": 1, "base": "ghost", "kind": "queued",
                 "class": "batch"}))
            env.kv.put(keys.admission_record_key(2), json.dumps(
                {"seq": 2, "base": "alive", "kind": "queued",
                 "class": "batch"}))
            report = env.compactor.compact_once()
            return env.books(purged=report["admissionPurged"], left=sorted(
                env.kv.range_prefix(keys.ADMISSION_PREFIX)))

        out = both_envs(script, tmp_path)
        assert out["purged"] == 1
        assert out["left"] == [tc.PORT.keys.admission_record_key(2)]

    def test_acked_markers_swept(self, tmp_path):
        def script(env):
            env.compactor._wq = env.pkg.wq.WorkQueue(env.kv)
            env.kv.put(env.pkg.keys.queue_marker_key("dead-task"), "{}")
            env.compactor.compact_once()
            return env.books(markers=env.kv.range_prefix(
                env.pkg.keys.QUEUE_MARKERS_PREFIX))

        assert both_envs(script, tmp_path)["markers"] == {}

    def test_probe_failure_protects_the_version(self, tmp_path, monkeypatch):
        def script(env):
            env.seed_container_family("t", versions=6)

            def boom(name):
                raise RuntimeError("engine down")

            monkeypatch.setattr(env.runtime, "container_exists", boom)
            env.compactor.compact_once()
            return env.books(history=env.history("t"))

        # nothing trimmed: every probe failed, every version protected
        assert both_envs(script, tmp_path)["history"] == [0, 1, 2, 3, 4, 5]
