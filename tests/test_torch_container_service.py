"""The port's ``service/container.py`` ``ContainerService`` and
``service/volume.py`` ``VolumeService`` against the JAX package's on the
CPU: each package's services on its own fake runtime, memory store and an
HGX line of 8 GPUs are fed the same seeded script (run, exec, patch GPUs,
patch volume, stop, restart, commit, history, rollback, delete; volume
create, resize with data, history, rollback, delete). Names, versions,
stored specs, ports, grants, history, the runtime's call log, the files a
volume copy moved and error classes must be equal — apart from how a
grant is attached (JAX: ``/dev/accel*`` and ``TPU_*``; the port:
``gpu_uuids`` and ``CUDA_VISIBLE_DEVICES``), which is checked on its own."""

import json
import os
import re
import types

import numpy as np
import pytest

from tpu_docker_api.runtime import fake as jfake
from tpu_docker_api.scheduler import ports as jports
from tpu_docker_api.scheduler import slices as jslices
from tpu_docker_api.scheduler import topology as jtopo
from tpu_docker_api.schemas import container as jcontainer
from tpu_docker_api.schemas import volume as jvolume
from tpu_docker_api.service import container as jcsvc
from tpu_docker_api.service import volume as jvsvc
from tpu_docker_api.state import keys as jkeys
from tpu_docker_api.state import kv as jkv
from tpu_docker_api.state import store as jstore
from tpu_docker_api.state import version as jversion
from tpu_docker_api.state import workqueue as jwq
from tpu_docker_api_torch.runtime import fake as tfake
from tpu_docker_api_torch.scheduler import ports as tports
from tpu_docker_api_torch.scheduler import slices as tslices
from tpu_docker_api_torch.scheduler import topology as ttopo
from tpu_docker_api_torch.schemas import container as tcontainer
from tpu_docker_api_torch.schemas import volume as tvolume
from tpu_docker_api_torch.service import container as tcsvc
from tpu_docker_api_torch.service import volume as tvsvc
from tpu_docker_api_torch.state import keys as tkeys
from tpu_docker_api_torch.state import kv as tkv
from tpu_docker_api_torch.state import store as tstore
from tpu_docker_api_torch.state import version as tversion
from tpu_docker_api_torch.state import workqueue as twq

JAX = types.SimpleNamespace(
    fake=jfake, ports=jports, slices=jslices, c=jcontainer, v=jvolume,
    csvc=jcsvc, vsvc=jvsvc, keys=jkeys, kv=jkv, store=jstore,
    version=jversion, wq=jwq)
PORT = types.SimpleNamespace(
    fake=tfake, ports=tports, slices=tslices, c=tcontainer, v=tvolume,
    csvc=tcsvc, vsvc=tvsvc, keys=tkeys, kv=tkv, store=tstore,
    version=tversion, wq=twq)
H100 = ttopo.GENERATIONS["h100"]
#: how each package attaches a grant: left out of the comparison
_ATTACH_KEYS = ("devices", "gpu_uuids")
_ATTACH_ENV = ("TPU_", "CLOUD_TPU_", "CUDA_VISIBLE_DEVICES=")
_HEX = re.compile(r"\b[0-9a-f]{12,64}\b")


def _topology(pkg):
    top = ttopo.HostTopology.build("h100-8")
    if pkg is PORT:
        return top
    gen = jtopo.Generation(H100.name, H100.cores_per_chip, H100.host_mesh,
                           H100.hbm_bytes_per_chip, H100.peak_bf16_flops,
                           H100.torus_dims)
    return jtopo.HostTopology(gen, top.mesh_shape, dict(top.coords))


def _strip(obj, root):
    """Drop the attachment artifacts, the runtime root and random ids."""
    if isinstance(obj, dict):
        return {k: _strip(v, root) for k, v in obj.items()
                if k not in _ATTACH_KEYS}
    if isinstance(obj, (list, tuple)):
        return [_strip(v, root) for v in obj
                if not (isinstance(v, str) and v.startswith(_ATTACH_ENV))]
    if isinstance(obj, str):
        if obj.startswith("{"):
            try:
                return _strip(json.loads(obj), root)
            except ValueError:
                pass
        return _HEX.sub("<id>", obj.replace(root, "<root>"))
    return obj


class World:
    def __init__(self, pkg, root):
        self.pkg, self.root = pkg, root
        self.kv = pkg.kv.MemoryKV()
        self.runtime = pkg.fake.FakeRuntime(root=root)
        self.chips = pkg.slices.ChipScheduler(_topology(pkg), self.kv)
        self.ports = pkg.ports.PortScheduler(self.kv, 40000, 40011)
        self.wq = pkg.wq.WorkQueue(self.kv, backoff_base_s=0.0)
        self.wq.start()
        store = pkg.store.StateStore(self.kv)
        self.csvc = pkg.csvc.ContainerService(
            self.runtime, store, self.chips, self.ports,
            pkg.version.VersionMap(self.kv, pkg.keys.VERSIONS_CONTAINER_KEY),
            self.wq)
        self.vsvc = pkg.vsvc.VolumeService(
            self.runtime, store,
            pkg.version.VersionMap(self.kv, pkg.keys.VERSIONS_VOLUME_KEY),
            self.wq)

    def do(self, op):
        c, v = self.pkg.c, self.pkg.v
        kind, name, n, m = op
        if kind == "run":
            return self.csvc.run_container(c.ContainerRun(
                image_name="img", container_name=name, chip_count=n,
                binds=[c.Bind("/data/a", "/a")], env=[f"N={n}"],
                container_ports=[c.ContainerPort(80 + i) for i in range(m)]))
        if kind == "exec":
            return self.csvc.execute_container(
                name, c.ContainerExecute(cmd=["echo", str(n)]))
        if kind == "chips":
            return self.csvc.patch_container_chips(
                name, c.ContainerPatchChips(chip_count=n))
        if kind == "bind":
            return self.csvc.patch_container_volume(
                name, c.ContainerPatchVolume(
                    old_bind=c.Bind("/data/a", "/a"),
                    new_bind=c.Bind("/data/b", "/a")) if n % 2 else
                c.ContainerPatchVolume(old_bind=c.Bind("/data/b", "/a"),
                                       new_bind=c.Bind("/data/a", "/a")))
        if kind == "stop":
            return self.csvc.stop_container(name)
        if kind == "restart":
            return self.csvc.restart_container(name)
        if kind == "commit":
            return self.csvc.commit_container(
                name, c.ContainerCommit(new_image_name=f"img:{n}"))
        if kind == "info":
            return self.csvc.get_container_info(name)
        if kind == "history":
            return self.csvc.get_container_history(name)
        if kind == "rollback":
            return self.csvc.rollback_container(name, c.ContainerRollback(
                version=n, data_from="target" if m else "latest"))
        if kind == "delete":
            return self.csvc.delete_container(name, c.ContainerDelete(
                force=True, del_etcd_info_and_version_record=bool(m)))
        if kind == "vcreate":
            return self.vsvc.create_volume(v.VolumeCreate(
                volume_name=name, size=f"{n + 1}MB"))
        if kind == "vwrite":
            d = self.runtime.volume_data_dir(name)
            with open(os.path.join(d, f"f{n}.bin"), "wb") as f:
                f.write(np.random.default_rng(n).bytes(1000 * (m + 1)))
            return sorted(os.listdir(d))
        if kind == "vresize":
            return self.vsvc.patch_volume_size(name, v.VolumeSize(
                size=f"{n + 1}MB"))
        if kind == "vhistory":
            return self.vsvc.get_volume_history(name)
        if kind == "vinfo":
            return self.vsvc.get_volume_info(name)
        if kind == "vrollback":
            return self.vsvc.rollback_volume(name, v.VolumeRollback(
                version=n, data_from="target" if m else "latest"))
        if kind == "vdelete":
            return self.vsvc.delete_volume(name, v.VolumeDelete(
                del_etcd_info_and_version_record=bool(m)))
        raise AssertionError(kind)

    def files(self):
        out = {}
        for name in sorted(self.runtime._volumes):
            d = self.runtime.volume_data_dir(name)
            out[name] = {f: open(os.path.join(d, f), "rb").read().hex()[:32]
                         for f in sorted(os.listdir(d))}
        return out


#: the script's operations, the common ones twice
KINDS = ["run", "run", "exec", "chips", "chips", "bind", "stop", "restart",
         "commit", "info", "history", "rollback", "delete", "vcreate",
         "vwrite", "vwrite", "vresize", "vhistory", "vinfo", "vrollback",
         "vdelete"]


def _script(seed, n_ops=70):
    rng = np.random.default_rng(seed)
    kinds = KINDS
    # every family exists first, so most of the script acts on live ones
    ops = [("run", "a", 2, 1), ("run", "b", 1, 2), ("run", "c", 0, 0),
           ("vcreate", "v", 2, 0), ("vcreate", "w", 3, 0)]
    for _ in range(n_ops):
        kind = str(rng.choice(kinds))
        base = str(rng.choice(["a", "b", "c"] if kind[0] != "v"
                              else ["v", "w"]))
        name = base
        if rng.random() < 0.25:
            name = f"{base}-{int(rng.integers(0, 3))}"
        ops.append((kind, name, int(rng.integers(0, 5)),
                    int(rng.integers(0, 3))))
    return ops


def _run(pkg, root, script):
    w = World(pkg, root)
    out = []
    for op in script:
        try:
            res = w.do(op)
        except Exception as e:  # noqa: BLE001 — the class is the outcome
            res = type(e).__name__
        w.wq.drain()
        out.append((op, res, w.chips.free_chips,
                    w.ports.status()["usedPorts"]))
    chips = w.chips.status()
    for c in chips["chips"]:
        c.pop("uuid", None)
    out.append(chips)
    out.append(w.ports.status())
    out.append(w.kv.range_prefix(pkg.keys.PREFIX))
    out.append(w.runtime.calls)
    out.append({n: (i.running, i.status, i.spec.to_dict())
                for n, i in sorted(w.runtime._containers.items())})
    out.append(w.files())
    out.append(w.wq.dead_letter_view())
    w.wq.close()
    return _strip(out, root), w


@pytest.mark.parametrize("seed", range(6))
def test_service_scripts_match_jax(seed, tmp_path):
    script = _script(seed)
    want, _ = _run(JAX, str(tmp_path / "jax"), script)
    got, world = _run(PORT, str(tmp_path / "port"), script)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, (i, script[i] if i < len(script) else "final")
    assert len(got) == len(want)
    # the port's attachment: each spec's GPUs by UUID, in both places
    top = ttopo.HostTopology.build("h100-8")
    for info in world.runtime._containers.values():
        uuids = top.uuids_for(info.spec.chip_ids)
        assert info.spec.gpu_uuids == uuids
        cvd = [e for e in info.spec.env
               if e.startswith("CUDA_VISIBLE_DEVICES=")]
        assert cvd == ([f"CUDA_VISIBLE_DEVICES={','.join(uuids)}"]
                       if uuids else [])
        assert info.spec.devices == []


def test_scripts_reach_every_flow():
    """The seeded scripts cover the flows and their refusals."""
    seen = set()
    for seed in range(6):
        for op in _script(seed):
            seen.add(op[0])
    assert seen == set(KINDS)


def test_resize_copies_data_and_history_lists_versions(tmp_path):
    """A volume's files survive a resize bit for bit in ``v-1``, a
    replaced container's history lists every version, in both packages."""
    outs = []
    for pkg, tag in ((JAX, "jax"), (PORT, "port")):
        w = World(pkg, str(tmp_path / tag))
        w.do(("vcreate", "v", 3, 0))
        data = np.random.default_rng(7).bytes(1 << 20)
        with open(os.path.join(w.runtime.volume_data_dir("v-0"), "x"),
                  "wb") as f:
            f.write(data)
        w.do(("vresize", "v-0", 4, 0))
        w.do(("run", "c", 1, 1))
        w.do(("bind", "c", 1, 0))
        w.do(("bind", "c-1", 2, 0))
        w.wq.drain()
        with open(os.path.join(w.runtime.volume_data_dir("v-1"), "x"),
                  "rb") as f:
            assert f.read() == data
        outs.append(_strip([w.do(("vhistory", "v", 0, 0)),
                            w.do(("history", "c", 0, 0)),
                            w.ports.status()], w.root))
        w.wq.close()
    assert outs[0] == outs[1]
    assert [v["name"] for v in outs[1][1]["versions"]] == ["c-0", "c-1",
                                                           "c-2"]
    assert outs[1][2]["usedCount"] == 1
