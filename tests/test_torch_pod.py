"""The port's pod scheduler and job service against the JAX package's on the
CPU (``tests/test_pod.py``, in full): each test runs one script through
both packages on the same pod — 8 hosts of 4 H100s on a 2×2×2 host grid,
JAX's 32-chip v5p-64 shape with GPU hosts — and compares what each
returned and left behind (versions, slice grants, GPU and port owners per
host, each host's containers and their states). Where JAX's test reads the
TPU bootstrap env, the port's member env is read in the same vocabulary
(``torch_control.dist_env``): the rendezvous, the member index, the member
count and the GPUs a member holds."""

import types

import pytest

import torch_control as tc


@pytest.fixture(autouse=True)
def _jax_knows_h100():
    with tc.jax_knows_h100():
        yield


def make_pod(pkg, kv, grid=(2, 2, 2), acc="h100-4"):
    """Pod of 4-GPU hosts on a host grid — (2,2,2) grid = 32 GPUs."""
    hosts = []
    i = 0
    for z in range(grid[2]):
        for y in range(grid[1]):
            for x in range(grid[0]):
                hid = f"h{i}"
                topo = pkg.topo.HostTopology.build(acc)
                hosts.append(pkg.pod.PodHost(
                    host_id=hid,
                    address=f"10.0.0.{i + 1}",
                    grid_coord=(x, y, z),
                    topology=topo,
                    runtime=pkg.fake.FakeRuntime(),
                    chips=pkg.slices.ChipScheduler(
                        topo, kv, pkg.keys.host_chips_key(hid)),
                    ports=pkg.ports.PortScheduler(
                        kv, 40000, 40100,
                        store_key=pkg.keys.host_ports_key(hid)),
                ))
                i += 1
    return pkg.pod.Pod(pkg.topo.GENERATIONS["h100"], grid, hosts)


def world(pkg, kv=None):
    kv = kv if kv is not None else pkg.kv.MemoryKV()
    pod = make_pod(pkg, kv)
    sched = pkg.pod.PodScheduler(pod, kv)
    svc = pkg.job.JobService(
        pod, sched, pkg.store.StateStore(kv),
        pkg.version.VersionMap(kv, pkg.keys.VERSIONS_JOB_KEY))
    return types.SimpleNamespace(pkg=pkg, kv=kv, pod=pod, sched=sched,
                                 svc=svc, e=pkg.errors, js=pkg.js)


def both(script):
    """``script(w)`` on a fresh world of each package: the two results and
    end states must be equal; returns the port's world and result."""
    got = []
    for pkg in tc.PKGS:
        w = world(pkg)
        res = script(w)
        got.append((w, res, tc.pod_world(w.pod, w.sched, w.svc.versions)))
    (_, jres, jworld), (pw, pres, pworld) = got
    assert pres == jres
    assert pworld == jworld
    return pw, pres


def member_env(w, proc) -> dict:
    ci = w.pod.hosts[proc["hostId"]].runtime.container_inspect(
        proc["container"])
    return tc.dist_env(ci.spec.env)


def raises(w, exc, fn, *a, **kw):
    with pytest.raises(getattr(w.e, exc)):
        fn(*a, **kw)
    return exc


class TestPodScheduler:
    def test_full_pod_slice(self):
        def script(w):
            g = w.sched.apply_slice(n_chips=32, owner="big-1")
            return g.to_dict()
        _, g = both(script)
        assert len(g["hosts"]) == 8
        assert g["host_block_shape"] == [2, 2, 2]
        assert g["ici_contiguous"]

    def test_multi_host_block_is_contiguous(self):
        def script(w):
            g = w.sched.apply_slice(n_chips=16, owner="j-1")
            return [w.pod.hosts[h].grid_coord for h, _ in g.hosts]
        _, coords = both(script)
        assert len(coords) == 4
        spans = [max(c[d] for c in coords) - min(c[d] for c in coords) + 1
                 for d in range(3)]
        assert spans[0] * spans[1] * spans[2] == 4

    def test_host_granularity_enforced(self):
        def script(w):
            return [raises(w, "BadRequest", w.sched.apply_slice, n_chips=6,
                           owner="odd-1"),
                    raises(w, "BadRequest", w.sched.apply_slice, n_chips=24,
                           owner="odd-2")]
        both(script)

    def test_sub_host_delegates_to_one_host(self):
        def script(w):
            g = w.sched.apply_slice(n_chips=2, owner="small-1")
            hid, chips = g.hosts[0]
            return len(g.hosts), sorted(w.pod.hosts[hid].chips.free_chips), \
                chips
        _, (n, free, chips) = both(script)
        assert n == 1 and len(chips) == 2
        assert set(free) == {0, 1, 2, 3} - set(chips)

    def test_sub_host_tightest_fit(self):
        def script(w):
            w.sched.apply_slice(n_chips=2, owner="a-1")
            g = w.sched.apply_slice(n_chips=2, owner="b-1")
            return g.hosts[0][0], w.pod.hosts["h0"].chips.free_chips
        _, res = both(script)
        assert res == ("h0", [])

    def test_partial_host_blocks_multi_host_slice(self):
        def script(w):
            w.sched.apply_slice(n_chips=1, owner="frag-1")
            g = w.sched.apply_slice(n_chips=16, owner="j-1")
            return len(g.hosts), raises(w, "ChipNotEnough",
                                        w.sched.apply_slice, n_chips=16,
                                        owner="j2-1")
        _, (n, _) = both(script)
        assert n == 4

    def test_restore_slice_owner_guarded(self):
        def script(w):
            g = w.sched.apply_slice(n_chips=8, owner="j-1")
            w.sched.restore_slice("j-1")
            ok = all(set(c) <= set(w.pod.hosts[h].chips.free_chips)
                     for h, c in g.hosts)
            w.sched.restore_slice("j-1")
            return ok, w.sched.get_grant("j-1")
        _, res = both(script)
        assert res == (True, None)

    def test_duplicate_owner_rejected(self):
        def script(w):
            w.sched.apply_slice(n_chips=4, owner="j-1")
            return raises(w, "ContainerExisted", w.sched.apply_slice,
                          n_chips=4, owner="j-1")
        both(script)

    def test_grants_survive_restart(self):
        def script(w):
            w.sched.apply_slice(n_chips=16, owner="j-1")
            sched2 = w.pkg.pod.PodScheduler(make_pod(w.pkg, w.kv), w.kv)
            g = sched2.get_grant("j-1")
            return g.n_chips, raises(w, "ChipNotEnough", sched2.apply_slice,
                                     n_chips=32, owner="j2-1")
        _, (n, _) = both(script)
        assert n == 16

    def test_status_view(self):
        def script(w):
            w.sched.apply_slice(n_chips=8, owner="j-1")
            return w.sched.status()
        _, st = both(script)
        assert st["totalChips"] == 32 and st["chipsPerHost"] == 4
        assert st["freeHosts"] == 6
        assert st["generation"] == "h100"
        assert "j-1" in st["slices"]


class TestGangClaims:
    def test_whole_gang_is_one_apply(self):
        got = []
        for pkg in tc.PKGS:
            kv = pkg.kv.CountingKV(pkg.kv.MemoryKV())
            sched = pkg.pod.PodScheduler(make_pod(pkg, kv), kv)
            txn = pkg.txn.StoreTxn(kv)
            base = kv.snapshot()
            grants = sched.apply_slices([(f"g#{k}", 8, "") for k in range(4)],
                                        txn=txn)
            before = pkg.kv.CountingKV.delta(base, kv.snapshot())
            txn.commit()
            after = pkg.kv.CountingKV.delta(base, kv.snapshot())
            sched2 = pkg.pod.PodScheduler(make_pod(pkg, kv), kv)
            got.append(([g.to_dict() for g in grants], before, after,
                        [sched2.get_grant(f"g#{k}").to_dict()
                         for k in range(4)]))
        assert got[1] == got[0]
        grants, before, after, _ = got[1]
        assert [len(g["hosts"]) for g in grants] == [2, 2, 2, 2]
        assert before == {} and after == {"apply": 1}

    def test_infeasible_member_releases_whole_gang(self):
        def script(w):
            r = raises(w, "ChipNotEnough", w.sched.apply_slices,
                       [("g#0", 16, ""), ("g#1", 16, ""), ("g#2", 16, "")])
            return r, [w.sched.get_grant(f"g#{k}") for k in range(3)], \
                w.sched.apply_slice(n_chips=32, owner="whole").n_chips
        _, (_, grants, n) = both(script)
        assert grants == [None] * 3 and n == 32

    def test_duplicate_owner_mid_batch_releases_earlier_members(self):
        def script(w):
            w.sched.apply_slice(n_chips=4, owner="taken")
            r = raises(w, "ContainerExisted", w.sched.apply_slices,
                       [("fresh", 4, ""), ("taken", 4, "")])
            return r, w.sched.get_grant("fresh"), \
                w.sched.apply_slice(n_chips=4, owner="fresh").n_chips
        _, (_, g, n) = both(script)
        assert g is None and n == 4

    def test_txn_failure_persists_nothing(self):
        got = []
        for pkg in tc.PKGS:
            kv = pkg.kv.MemoryKV()
            sched = pkg.pod.PodScheduler(make_pod(pkg, kv), kv)
            txn = pkg.txn.StoreTxn(kv)
            with pytest.raises(pkg.errors.ChipNotEnough):
                sched.apply_slices([("g#0", 16, ""), ("g#1", 16, ""),
                                    ("g#2", 16, "")], txn=txn)
            left = kv.range_prefix("")
            sched2 = pkg.pod.PodScheduler(make_pod(pkg, kv), kv)
            got.append((left, sched2.apply_slice(n_chips=32,
                                                  owner="all").n_chips))
        assert got[1] == got[0] == ({}, 32)


class TestJobService:
    def test_run_multi_host_job(self):
        def script(w):
            info = w.svc.run_job(w.js.JobRun(
                image_name="train:gpu", job_name="train", chip_count=16,
                cmd=["python", "train.py"], binds=["/nfs/ckpt:/ckpt"]))
            envs = [member_env(w, p) for p in info["processes"]]
            binds = [w.pod.hosts[p["hostId"]].runtime.container_inspect(
                p["container"]).spec.binds for p in info["processes"]]
            return info, envs, binds
        w, (info, envs, binds) = both(script)
        assert info["name"] == "train-0" and len(info["processes"]) == 4
        p0 = w.pod.hosts[info["processes"][0]["hostId"]].address
        for proc, env, b in zip(info["processes"], envs, binds):
            assert env == {"master": f"{p0}:{info['coordinatorPort']}",
                           "member": proc["processId"], "members": 4,
                           "gpus": 4}
            assert "/nfs/ckpt:/ckpt" in b
        assert len({p["hostId"] for p in info["processes"]}) == 4
        # the port's own variables: one container a host, 4 ranks in it
        ci = w.pod.hosts[info["processes"][1]["hostId"]].runtime \
            .container_inspect(info["processes"][1]["container"])
        env = dict(e.split("=", 1) for e in ci.spec.env)
        assert (env["WORLD_SIZE"], env["NODE_RANK"],
                env["LOCAL_WORLD_SIZE"]) == ("16", "1", "4")
        assert "RANK" not in env
        assert len(ci.spec.gpu_uuids) == 4

    def test_multislice_job(self):
        def script(w):
            info = w.svc.run_job(w.js.JobRun(image_name="i", job_name="ms",
                                             chip_count=16, num_slices=2))
            p0 = info["processes"][0]
            ci0 = w.pod.hosts[p0["hostId"]].runtime.container_inspect(
                p0["container"])
            bound = sorted(pb.host_port for pb in ci0.spec.port_bindings)
            return info, [member_env(w, p) for p in info["processes"]], bound
        _, (info, envs, bound) = both(script)
        assert info["numSlices"] == 2 and len(info["processes"]) == 4
        assert {p["sliceId"] for p in info["processes"]} == {0, 1}
        # one world over both slices
        assert {e["members"] for e in envs} == {4}
        assert info["coordinatorPort"] in bound
        assert info["megascalePort"] in bound

    def test_multislice_rescale_and_delete_free_all_slices(self):
        def script(w):
            w.svc.run_job(w.js.JobRun(image_name="i", job_name="ms",
                                      chip_count=8, num_slices=2))
            free = sum(len(h.chips.free_chips) for h in w.pod.hosts.values())
            info = w.svc.patch_job_chips("ms-0",
                                         w.js.JobPatchChips(chip_count=16))
            w.svc.delete_job("ms-1", w.js.JobDelete(
                force=True, del_state_and_version_record=True))
            return free, info, sum(len(h.chips.free_chips)
                                   for h in w.pod.hosts.values())
        _, (free, info, after) = both(script)
        assert free == 24 and after == 32
        assert (info["numSlices"], info["chipCount"]) == (2, 16)

    def test_multislice_indivisible_chip_count_rejected(self):
        both(lambda w: raises(w, "BadRequest", w.svc.run_job, w.js.JobRun(
            image_name="i", job_name="bad", chip_count=10, num_slices=3)))

    def test_multislice_accelerator_type_rejected(self):
        both(lambda w: raises(w, "BadRequest", w.svc.run_job, w.js.JobRun(
            image_name="i", job_name="bad", accelerator_type="h100-4",
            num_slices=2)))

    def test_process_bounds_match_host_block(self):
        def script(w):
            info = w.svc.run_job(w.js.JobRun(image_name="i", job_name="j",
                                             chip_count=32))
            return info, [member_env(w, p) for p in info["processes"]]
        _, (info, envs) = both(script)
        assert [e["member"] for e in envs] == list(range(8))
        assert {e["members"] for e in envs} == {8}

    def test_single_host_job(self):
        def script(w):
            info = w.svc.run_job(w.js.JobRun(image_name="i", job_name="small",
                                             chip_count=2))
            return info, member_env(w, info["processes"][0])
        w, (info, env) = both(script)
        assert len(info["processes"]) == 1
        assert env["members"] == 1 and env["gpus"] == 2

    def test_accelerator_type_ask(self):
        _, info = both(lambda w: w.svc.run_job(w.js.JobRun(
            image_name="i", job_name="j", accelerator_type="h100-32")))
        assert info["chipCount"] == 32 and len(info["processes"]) == 8

    def test_duplicate_job_rejected(self):
        def script(w):
            w.svc.run_job(w.js.JobRun(image_name="i", job_name="j",
                                      chip_count=4))
            return raises(w, "ContainerExisted", w.svc.run_job, w.js.JobRun(
                image_name="i", job_name="j", chip_count=4))
        both(script)

    def test_rolling_rescale_grows(self):
        def script(w):
            w.svc.run_job(w.js.JobRun(image_name="i", job_name="t",
                                      chip_count=8, binds=["/nfs/ckpt:/ckpt"]))
            info = w.svc.patch_job_chips("t", w.js.JobPatchChips(
                chip_count=16))
            old = w.svc.store.get_job("t-0")
            p0 = info["processes"][0]
            ci = w.pod.hosts[p0["hostId"]].runtime.container_inspect(
                p0["container"])
            return (info, old.to_dict(), w.sched.get_grant("t-0"),
                    w.sched.get_grant("t-1") is not None, ci.spec.binds)
        _, (info, old, g0, g1, binds) = both(script)
        assert info["name"] == "t-1" and info["chipCount"] == 16
        assert old["desired_running"] is False
        assert g0 is None and g1
        assert "/nfs/ckpt:/ckpt" in binds

    def test_rescale_noop(self):
        def script(w):
            w.svc.run_job(w.js.JobRun(image_name="i", job_name="t",
                                      chip_count=8))
            return raises(w, "NoPatchRequired", w.svc.patch_job_chips, "t",
                          w.js.JobPatchChips(chip_count=8))
        both(script)

    def test_rescale_uses_freed_capacity(self):
        def script(w):
            w.svc.run_job(w.js.JobRun(image_name="i", job_name="t",
                                      chip_count=16))
            return w.svc.patch_job_chips("t", w.js.JobPatchChips(
                chip_count=32))
        _, info = both(script)
        assert info["chipCount"] == 32

    def test_rescale_version_check(self):
        def script(w):
            w.svc.run_job(w.js.JobRun(image_name="i", job_name="t",
                                      chip_count=8))
            return raises(w, "VersionNotMatch", w.svc.patch_job_chips, "t-7",
                          w.js.JobPatchChips(chip_count=16))
        both(script)

    def test_stop_restart(self):
        def script(w):
            info = w.svc.run_job(w.js.JobRun(image_name="i", job_name="t",
                                             chip_count=8))

            def running():
                return [w.pod.hosts[p["hostId"]].runtime.container_inspect(
                    p["container"]).running for p in info["processes"]]
            w.svc.stop_job("t")
            stopped = running()
            w.svc.restart_job("t")
            return stopped, running()
        _, (stopped, restarted) = both(script)
        assert not any(stopped) and all(restarted)

    def test_delete_frees_everything(self):
        def script(w):
            w.svc.run_job(w.js.JobRun(image_name="i", job_name="t",
                                      chip_count=16))
            w.svc.patch_job_chips("t", w.js.JobPatchChips(chip_count=8))
            w.svc.delete_job("t", w.js.JobDelete(
                force=True, del_state_and_version_record=True))
            return w.svc.versions.get("t")
        w, res = both(script)
        assert res is None
        for host in w.pod.hosts.values():
            assert len(host.chips.free_chips) == 4
            assert host.ports.status()["usedPorts"] == []
            assert host.runtime.container_list() == []

    def test_job_info_live_state(self):
        def script(w):
            w.svc.run_job(w.js.JobRun(image_name="i", job_name="t",
                                      chip_count=8))
            live = w.svc.get_job_info("t")
            w.svc.stop_job("t")
            return live, w.svc.get_job_info("t")
        _, (live, stopped) = both(script)
        assert all(p["running"] for p in live["processes"])
        assert not any(p["running"] for p in stopped["processes"])

    def test_rescale_fast_path_frees_old_slice(self):
        def script(w):
            w.svc.run_job(w.js.JobRun(image_name="i", job_name="t",
                                      chip_count=8))
            info = w.svc.patch_job_chips("t", w.js.JobPatchChips(
                chip_count=16))
            return (info, w.sched.get_grant("t-0"),
                    w.sched.get_grant("t-1") is not None,
                    w.svc.get_job_info("t-0"))
        _, (info, g0, g1, old) = both(script)
        assert info["chipCount"] == 16 and g0 is None and g1
        assert old["desiredRunning"] is False
        assert not any(p["running"] for p in old["processes"])

    def test_unsatisfiable_rescale_leaves_job_untouched(self):
        def script(w):
            info = w.svc.run_job(w.js.JobRun(image_name="i", job_name="t",
                                             chip_count=8))
            errs = [raises(w, exc, w.svc.patch_job_chips, "t",
                           w.js.JobPatchChips(chip_count=n))
                    for exc, n in (("BadRequest", 6), ("ChipNotEnough", 64),
                                   ("BadRequest", 24))]
            return errs, w.svc.get_job_info("t")["name"], [
                w.pod.hosts[p["hostId"]].runtime.container_inspect(
                    p["container"]).running for p in info["processes"]]
        _, (_, name, running) = both(script)
        assert name == "t-0" and all(running)

    def test_rescale_swap_failure_resumes_old(self):
        def script(w):
            w.svc.run_job(w.js.JobRun(image_name="i", job_name="t",
                                      chip_count=8))
            orig = w.svc._start_members
            calls = {"n": 0}

            def exploding_start(st):
                calls["n"] += 1
                if calls["n"] == 1:
                    raise RuntimeError("docker daemon away")
                return orig(st)

            w.svc._start_members = exploding_start
            with pytest.raises(RuntimeError):
                w.svc.patch_job_chips("t", w.js.JobPatchChips(chip_count=16))
            w.svc._start_members = orig
            info = w.svc.get_job_info("t")
            mid = (info, w.sched.get_grant("t-0") is not None,
                   w.sched.get_grant("t-1"))
            return mid, w.svc.patch_job_chips(
                "t", w.js.JobPatchChips(chip_count=16))["chipCount"]
        _, ((info, g0, g1), n) = both(script)
        assert info["name"] == "t-0" and g0 and g1 is None
        assert all(p["running"] for p in info["processes"])
        assert n == 16

    def test_heterogeneous_pod_rejected(self):
        for pkg in tc.PKGS:
            lst = list(make_pod(pkg, pkg.kv.MemoryKV()).hosts.values())
            lst[0].topology = pkg.topo.HostTopology.build("h100-8")
            with pytest.raises(ValueError, match="heterogeneous"):
                pkg.pod.Pod(pkg.topo.GENERATIONS["h100"], (2, 2, 2), lst)

    def test_duplicate_host_id_rejected(self):
        for pkg in tc.PKGS:
            lst = list(make_pod(pkg, pkg.kv.MemoryKV(),
                                grid=(2, 1, 1)).hosts.values())
            lst[1].host_id = lst[0].host_id
            with pytest.raises(ValueError, match="duplicate host ids"):
                pkg.pod.Pod(pkg.topo.GENERATIONS["h100"], (2, 1, 1), lst)

    def test_bad_job_names_rejected(self):
        both(lambda w: [raises(w, "BadRequest", w.svc.run_job, w.js.JobRun(
            image_name="i", job_name=bad, chip_count=4))
            for bad in ("", "a/b", "a b", "a-b")])

    def test_daemon_local_host_shares_chip_accounting(self):
        got = []
        for pkg in tc.PKGS:
            cfg = pkg.config.Config(
                port=0, runtime_backend="fake", accelerator_type="h100-4",
                health_watch_interval=0, pod_hosts=[
                    {"host_id": "me", "address": "10.0.0.1",
                     "grid_coord": [0, 0, 0], "local": True},
                    {"host_id": "h1", "address": "10.0.0.2",
                     "grid_coord": [1, 0, 0], "runtime_backend": "fake"}])
            prg = pkg.daemon.Program(cfg)
            prg._discover_topology = lambda p=pkg: tc.topology(p, "h100-4")
            prg.init()
            try:
                assert prg.pod.hosts["me"].chips is prg.chip_scheduler
                assert prg.pod.hosts["me"].runtime is prg.runtime
                prg.container_svc.run_container(pkg.c.ContainerRun(
                    image_name="i", container_name="c", chip_count=3))
                with pytest.raises(pkg.errors.ChipNotEnough):
                    prg.job_svc.run_job(pkg.js.JobRun(
                        image_name="i", job_name="j", chip_count=8))
                info = prg.job_svc.run_job(pkg.js.JobRun(
                    image_name="i", job_name="j2", chip_count=4))
                got.append((info, tc.job_world(prg)))
            finally:
                prg.stop()
        assert got[1] == got[0]
        assert got[1][0]["processes"][0]["hostId"] == "h1"

    def test_create_failure_rolls_back(self):
        def script(w):
            w.pod.hosts["h0"].runtime.container_create(
                w.pkg.spec.ContainerSpec(name="boom-0-p0", image="x"))
            r = raises(w, "ContainerExisted", w.svc.run_job, w.js.JobRun(
                image_name="i", job_name="boom", chip_count=32))
            return r, w.sched.get_grant("boom-0"), w.svc.versions.get("boom")
        w, (_, g, v) = both(script)
        assert g is None and v is None
        assert all(len(h.chips.free_chips) == 4 for h in w.pod.hosts.values())


def test_config_pod_host_names_gpus_by_index_in_the_docker_body(tmp_path):
    """A [[pod_hosts]] host the daemon cannot probe names its GPUs by NVML
    index: the engine's create body asks for ``DeviceIDs`` ["2", "3"] and
    the member sees them as ``CUDA_VISIBLE_DEVICES=0,1`` (the NVIDIA
    runtime's numbering inside a container); a made-up UUID would be
    refused by a real engine."""
    from tpu_docker_api_torch.runtime.docker_http import DockerRuntime
    from tpu_docker_api_torch.runtime.fake_engine import FakeEngine

    engine = FakeEngine(str(tmp_path / "docker.sock"),
                        known_images=("i", "i:latest"))
    try:
        cfg = tc.tconfig.Config(
            store_backend="memory", runtime_backend="fake",
            health_watch_interval=0, job_supervise_interval=0,
            host_probe_interval_s=0, pod_hosts=[
                {"host_id": "r", "address": "10.0.0.9",
                 "grid_coord": [0, 0, 0], "accelerator_type": "h100-4"}])
        prg = tc.tdaemon.Program(
            cfg, kv=tc.tkv.MemoryKV(), runtime=tc.tfake.FakeRuntime(),
            pod_runtimes={"r": DockerRuntime(engine.docker_host)})
        prg._discover_topology = lambda: tc.topology(tc.PORT, "h100-4")
        prg.init()
        try:
            prg.job_svc.run_job(tc.tjobschema.JobRun(
                image_name="i", job_name="a", chip_count=2))
            info = prg.job_svc.run_job(tc.tjobschema.JobRun(
                image_name="i", job_name="b", chip_count=2))
            assert info["processes"][0]["chipIds"] == [2, 3]
        finally:
            prg.stop()
        creates = [b for m, path, q, b in engine.requests
                   if (m, path) == ("POST", "/containers/create")
                   and q.get("name") == "b-0-p0"]
        assert len(creates) == 1
        assert creates[0]["HostConfig"]["DeviceRequests"] == [{
            "Driver": "nvidia", "Count": 0, "DeviceIDs": ["2", "3"],
            "Capabilities": [["gpu"]]}]
        env = dict(e.split("=", 1) for e in creates[0]["Env"])
        assert env["CUDA_VISIBLE_DEVICES"] == "0,1"
        assert (env["MASTER_ADDR"], env["RANK"] if "RANK" in env else None,
                env["NODE_RANK"], env["LOCAL_WORLD_SIZE"]) == (
            "10.0.0.9", None, "0", "2")
    finally:
        engine.close()
