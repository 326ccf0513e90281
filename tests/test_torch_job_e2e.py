"""The port's job service output boots a real distributed run (the port's
counterpart of ``tests/test_job_distributed_e2e.py``): ``POST /api/v1/jobs``
on a 2-host fake pod of 2-GPU hosts, read back the environment the job
service put into each host's member container, and launch each member from
it verbatim through ``workload.torchenv.launch_workers``: a member holds 2
GPUs, so it starts 2 ranks, ``NODE_RANK·2 + i`` of a world of 4, which
meet at the rendered ``MASTER_ADDR:MASTER_PORT`` (process 0's host,
loopback here) as gloo ranks on the CPU and agree on one ``all_reduce``.
The same ask through JAX's job service renders the same rendezvous and
member numbering."""

import json
import os
import pathlib
import socket
import subprocess
import sys
import time
import urllib.request

import pytest

import torch_control as tc
from tpu_docker_api_torch.workload.torchenv import free_port

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
TESTS = pathlib.Path(__file__).resolve().parent

LAUNCH = ("import sys; from tpu_docker_api_torch.workload.torchenv import "
          "launch_workers, workers_wanted; sys.exit(launch_workers("
          "'torch_job_rank', [], workers_wanted('cpu', 1), 'cpu'))")


def free_range(n: int = 8) -> int:
    """The first of ``n`` consecutive TCP ports on localhost that were all
    free a moment ago: the job claims its ports from the start of the
    range, and its master port must be one the test can bind."""
    for _ in range(50):
        base = free_port()
        socks = []
        try:
            for p in range(base, base + n):
                s = socket.socket()
                socks.append(s)
                s.bind(("127.0.0.1", p))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError("no free port range")


def pod_config(pkg, start_port):
    return pkg.config.Config(
        port=0, store_backend="memory", runtime_backend="fake",
        accelerator_type="h100-2", start_port=start_port,
        end_port=start_port + 19, health_watch_interval=0,
        reconcile_on_start=False, pod_hosts=[
            {"host_id": "h0", "address": "127.0.0.1",
             "grid_coord": [0, 0, 0], "local": True},
            {"host_id": "h1", "address": "127.0.0.2",
             "grid_coord": [1, 0, 0], "runtime_backend": "fake"}])


def member_envs(prg, job) -> list[list[str]]:
    out = []
    for hid in sorted(prg.pod.hosts):
        rt = prg.pod.hosts[hid].runtime
        for name in rt.container_list():
            if name.startswith(job + "-"):
                out.append(rt.container_inspect(name).spec.env)
    return sorted(out, key=lambda e: tc.dist_env(e)["member"])


@pytest.fixture(scope="module")
def posted():
    """The port's daemon, serving, after ``POST /api/v1/jobs`` of 4 GPUs
    (2 hosts × 2), and JAX's job service given the same ask."""
    start = free_range()
    prg = tc.tdaemon.Program(pod_config(tc.PORT, start), host="127.0.0.1")
    prg._discover_topology = lambda: tc.topology(tc.PORT, "h100-2")
    prg.init()
    prg.start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{prg.api_server.port}/api/v1/jobs",
            method="POST",
            data=json.dumps({"imageName": "workload", "jobName": "jd",
                             "chipCount": 4}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req) as resp:
            out = json.loads(resp.read())
        envs = member_envs(prg, "jd")
    finally:
        prg.stop()
    with tc.jax_knows_h100():
        jprg = tc.jdaemon.Program(pod_config(tc.JAX, start),
                                  kv=tc.jkv.MemoryKV(),
                                  runtime=tc.jfake.FakeRuntime())
        jprg._discover_topology = lambda: tc.topology(tc.JAX, "h100-2")
        jprg.init()
        jinfo = jprg.job_svc.run_job(tc.jjobschema.JobRun(
            image_name="workload", job_name="jd", chip_count=4))
        jenvs = member_envs(jprg, "jd")
        jprg.wq.close()
    return out, envs, jinfo, jenvs


def test_post_jobs_renders_one_member_a_host_with_two_ranks(posted):
    out, envs, jinfo, jenvs = posted
    assert out["code"] == 200, out
    assert out["data"] == jinfo
    assert [tc.dist_env(e) for e in envs] == [tc.dist_env(e) for e in jenvs]
    master = f"127.0.0.1:{out['data']['coordinatorPort']}"
    for pid, env in enumerate(envs):
        e = dict(x.split("=", 1) for x in env)
        assert f"{e['MASTER_ADDR']}:{e['MASTER_PORT']}" == master
        assert (e["WORLD_SIZE"], e["NODE_RANK"],
                e["LOCAL_WORLD_SIZE"]) == ("4", str(pid), "2")
        assert "RANK" not in e
        assert len(e["CUDA_VISIBLE_DEVICES"].split(",")) == 2
    # the local host names its GPUs by UUID, the [[pod_hosts]] one by index
    visible = [dict(x.split("=", 1) for x in env)["CUDA_VISIBLE_DEVICES"]
               for env in envs]
    assert visible[0].startswith("GPU-") and visible[1] == "0,1"


def test_member_envs_launch_four_gloo_ranks_that_agree(posted, tmp_path):
    """Each member's environment, verbatim, starts its 2 ranks through
    ``launch_workers``; the 4 ranks meet at the rendered master and one
    ``all_reduce`` sums 1 + 2 + 3 + 4 on every rank."""
    _, envs, _, _ = posted
    procs = []
    for env in envs:
        penv = {k: v for k, v in os.environ.items()
                if k not in ("RANK", "LOCAL_RANK", "WORLD_SIZE", "NODE_RANK",
                             "LOCAL_WORLD_SIZE", "MASTER_ADDR",
                             "MASTER_PORT")}
        penv.update(dict(x.split("=", 1) for x in env))
        penv["JOB_RANK_OUT"] = str(tmp_path)
        penv["PYTHONPATH"] = os.pathsep.join(
            [str(REPO_ROOT), str(TESTS), os.environ.get("PYTHONPATH", "")])
        procs.append(subprocess.Popen(
            [sys.executable, "-c", LAUNCH], env=penv, cwd=str(REPO_ROOT),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        deadline = time.monotonic() + 120
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
            out = p.stdout.read()
            assert p.returncode == 0, out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    seen = sorted((json.loads(f.read_text()) for f in tmp_path.glob("*.json")),
                  key=lambda s: s["rank"])
    master = {dict(x.split("=", 1) for x in envs[0])["MASTER_ADDR"]}
    assert [s["rank"] for s in seen] == [0, 1, 2, 3]
    assert {s["world"] for s in seen} == {4}
    assert {s["sum"] for s in seen} == {10.0}
    assert {s["master"].split(":")[0] for s in seen} == master
