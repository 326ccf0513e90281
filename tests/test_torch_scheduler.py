"""The port's schedulers against the JAX package's on the CPU:
``scheduler/topology.py`` (shapes, meshes, accelerator types, the HGX
line of NVML indices), ``scheduler/slices.py`` ``ChipScheduler`` and
``scheduler/ports.py`` ``PortScheduler`` driven by the same seeded
scripts give the same grants, error classes, statuses and persisted
strings; and the card's peaks come from one seam."""

import json

import numpy as np
import pytest
import torch

import chip_smoke
from tpu_docker_api import errors as jerrors
from tpu_docker_api.scheduler import ports as jports
from tpu_docker_api.scheduler import slices as jslices
from tpu_docker_api.scheduler import topology as jtopo
from tpu_docker_api.state import keys as jkeys
from tpu_docker_api.state import kv as jkv
from tpu_docker_api.telemetry import trace as jtrace
from tpu_docker_api_torch import errors as terrors
from tpu_docker_api_torch.infer import servebench
from tpu_docker_api_torch.scheduler import ports as tports
from tpu_docker_api_torch.scheduler import slices as tslices
from tpu_docker_api_torch.scheduler import topology as ttopo
from tpu_docker_api_torch.state import keys as tkeys
from tpu_docker_api_torch.state import kv as tkv
from tpu_docker_api_torch.telemetry import trace as ttrace

H100 = ttopo.GENERATIONS["h100"]


def _jax_gen(gen: ttopo.Generation) -> jtopo.Generation:
    """The JAX package's Generation with the port's part's figures."""
    return jtopo.Generation(gen.name, gen.cores_per_chip, gen.host_mesh,
                            gen.hbm_bytes_per_chip, gen.peak_bf16_flops,
                            gen.torus_dims)


@pytest.fixture
def jax_gpu_parts(monkeypatch):
    for name, gen in ttopo.GENERATIONS.items():
        monkeypatch.setitem(jtopo.GENERATIONS, name, _jax_gen(gen))


@pytest.mark.parametrize("mesh", [(8, 1, 1), (8, 2, 1), (8, 4, 1), (4, 1, 1),
                                  (2, 4, 1), (2, 2, 4), (16, 1, 1)])
def test_candidate_shapes_match_jax(mesh):
    for n in range(1, 33):
        assert (tslices.candidate_shapes(n, mesh)
                == jslices.candidate_shapes(n, mesh)), n


def test_default_mesh_is_a_line_of_hosts_as_jax_gives_it():
    jgen = _jax_gen(H100)
    got = {n: ttopo.default_mesh_shape(H100, n) for n in range(1, 41)}
    assert got == {n: jtopo.default_mesh_shape(jgen, n) for n in got}
    assert got[8] == (8, 1, 1) and got[16] == (8, 2, 1)
    assert got[5] == (5, 1, 1) and got[12] == (12, 1, 1)


@pytest.mark.parametrize("shape", ["2", "2x2", "1x8", "2x2x4", "4x2x1", "8",
                                   "0", "2x", "a", "1x1x1x1", "3X1"])
def test_parse_slice_shape_matches_jax(shape):
    outcomes = []
    for mod in (jtopo, ttopo):
        try:
            outcomes.append(mod.parse_slice_shape(shape))
        except ValueError:
            outcomes.append("ValueError")
    assert outcomes[0] == outcomes[1]


@pytest.mark.parametrize("acc", ["h100-8", "h100-16", "h100-1", "a100-4",
                                 "h100-0", "h100-x", "b200-8", "h100",
                                 "a100-16"])
def test_parse_accelerator_type_and_build_match_jax(jax_gpu_parts, acc):
    outcomes = []
    for mod in (jtopo, ttopo):
        try:
            gen, n = mod.parse_accelerator_type(acc)
            topo = mod.HostTopology.build(acc)
            outcomes.append((gen.name, n, topo.mesh_shape, topo.coords,
                             topo.chip_at((1, 0, 0))))
        except ValueError:
            outcomes.append("ValueError")
    assert outcomes[0] == outcomes[1]


def test_build_gives_stable_uuids_and_from_chips_keeps_them():
    topo = ttopo.HostTopology.build("h100-16")
    assert topo.uuids[0] == "GPU-00000000-0000-0000-0000-000000000000"
    assert topo.uuids[11] == "GPU-00000000-0000-0000-0000-000000000011"
    assert topo.coords[11] == (3, 1, 0)
    again = ttopo.HostTopology.from_chips(H100, topo.coords, topo.uuids)
    assert again == topo
    assert ttopo.HostTopology.from_chips(H100, {}).n_chips == 0
    with pytest.raises(ValueError, match="v5e-8"):  # a TPU type: not a part
        ttopo.parse_accelerator_type("v5e-8")


@pytest.mark.parametrize("name,want", [
    ("NVIDIA H100 80GB HBM3", "h100"), ("NVIDIA H100 PCIe", "h100"),
    ("NVIDIA A100-SXM4-80GB", "a100"), ("NVIDIA L4", None), ("", None)])
def test_generation_for_reads_the_device_name(monkeypatch, name, want):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: name)
    gen = ttopo.generation_for(torch.device("cuda"))
    assert (gen.name if gen else None) == want
    assert ttopo.generation_for_name(name) is gen
    assert ttopo.peak_bf16_flops_for("cuda:0") == (
        gen.peak_bf16_flops if gen else None)
    assert ttopo.generation_for("cpu") is None
    assert ttopo.peak_bf16_flops_for(torch.device("cpu")) is None


def test_card_peaks_come_from_one_seam(monkeypatch):
    """``chip_smoke.py`` and ``infer/servebench.py`` read the card's
    bf16 peak and HBM rate from ``generation_for``: the H100 data sheet's
    989 TFLOP/s and 3.35 TB/s."""
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(chip_smoke, "PEAK_BYTES", chip_smoke.PEAK_BYTES)
    monkeypatch.setattr(chip_smoke, "PEAK_FLOPS", dict(chip_smoke.PEAK_FLOPS))
    chip_smoke.read_card_peaks(torch.device("cuda"))
    assert chip_smoke.PEAK_FLOPS[torch.bfloat16] == H100.peak_bf16_flops \
        == 989e12
    assert chip_smoke.PEAK_BYTES == servebench._hbm_bw("cuda") == 3.35e12
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA L4")
    assert servebench._hbm_bw("cuda") is None
    with pytest.raises(AssertionError, match="NVIDIA L4"):
        chip_smoke.read_card_peaks(torch.device("cuda"))


def _chip_script(seed: int, n_chips: int, steps: int = 60) -> list[tuple]:
    rng = np.random.default_rng(seed)
    owners = ["c0", "c1", "c2", ""]
    ops = []
    for _ in range(steps):
        owner = owners[rng.integers(len(owners))]
        ids = sorted({int(c) for c in rng.integers(0, n_chips + 1,
                                                   rng.integers(1, 4))})
        kind = rng.choice(["apply", "shape", "claim", "bulk", "restore",
                           "restore_any", "owned", "reload"],
                          p=[.3, .1, .12, .08, .2, .08, .07, .05])
        if kind == "apply":
            ops.append(("apply", int(rng.integers(0, 6)), owner))
        elif kind == "shape":
            ops.append(("shape", ["2", "1x2", "4", "2x2", "3x1x1", "2x1x2"][
                rng.integers(6)], owner))
        elif kind == "bulk":
            ops.append(("bulk", [(o, sorted({int(c) for c in rng.integers(
                0, n_chips, 2)})) for o in owners[:2]]))
        else:
            ops.append((kind, ids, owner))
    return ops


def _run_chips(mod_slices, topo, kv, script) -> list:
    sched = mod_slices.ChipScheduler(topo, kv)
    out = []
    for op in script:
        try:
            if op[0] == "apply":
                res = sched.apply_chips(op[1], owner=op[2])
            elif op[0] == "shape":
                res = sched.apply_chips(0, shape=op[1], owner=op[2])
            elif op[0] == "claim":
                res = sched.try_claim_chips(op[1], op[2])
            elif op[0] == "bulk":
                res = sched.try_claim_chips_bulk(op[1])
            elif op[0] == "restore":
                res = sched.restore_chips(op[1], owner=op[2])
            elif op[0] == "restore_any":
                res = sched.restore_chips(op[1])
            elif op[0] == "owned":
                res = (sched.owned_chips(op[2]), sched.free_chips)
            else:
                sched = mod_slices.ChipScheduler(topo, kv)  # a restart
                sched.reload_from_store()
                res = None
        except Exception as e:  # noqa: BLE001 — the class is the outcome
            res = type(e).__name__
        out.append((res, kv.get_or(mod_slices.keys.SCHEDULER_CHIPS_KEY)))
    out.append(sched.status())
    return out


@pytest.mark.parametrize("n_chips", [8, 16])
@pytest.mark.parametrize("seed", range(5))
def test_chip_scheduler_scripts_match_jax(n_chips, seed):
    """Same grants, error classes, statuses and persisted JSON, JAX's
    scheduler fed the same line of NVML indices."""
    ttop = ttopo.HostTopology.build(f"h100-{n_chips}")
    jtop = jtopo.HostTopology(_jax_gen(H100), ttop.mesh_shape,
                              dict(ttop.coords))
    script = _chip_script(seed, n_chips)
    want = _run_chips(jslices, jtop, jkv.MemoryKV(), script)
    got = _run_chips(tslices, ttop, tkv.MemoryKV(), script)
    # the port's view adds each GPU's UUID (JAX's has no such key)
    assert [c.pop("uuid") for c in got[-1]["chips"]] == [
        ttop.uuids[c] for c in sorted(ttop.coords)]
    assert got == want
    outcomes = {r[0] if isinstance(r[0], str) else type(r[0]).__name__
                for r in want[:-1]}
    assert "ChipNotEnough" in outcomes and "tuple" in outcomes
    assert tslices.keys is tkeys
    assert tkeys.SCHEDULER_CHIPS_KEY == jkeys.SCHEDULER_CHIPS_KEY


def test_grant_restores_after_restart_from_sqlite(tmp_path):
    """A grant survives a restart on the same file, as JAX's does; a
    store that names a GPU the topology lost is repaired on boot."""
    outcomes = []
    for mod_slices, mod_kv, tag, topo in (
            (jslices, jkv, "jax", jtopo.HostTopology(
                _jax_gen(H100), (8, 1, 1),
                dict(ttopo.HostTopology.build("h100-8").coords))),
            (tslices, tkv, "port", ttopo.HostTopology.build("h100-8"))):
        path = str(tmp_path / f"{tag}.db")
        kv = mod_kv.SqliteKV(path)
        first = mod_slices.ChipScheduler(topo, kv)
        grants = [first.apply_chips(3, owner="a"), first.apply_chips(2)]
        kv.put(mod_slices.keys.SCHEDULER_CHIPS_KEY, json.dumps(
            {**json.loads(kv.get(mod_slices.keys.SCHEDULER_CHIPS_KEY)),
             "12": "ghost"}))
        kv.close()
        kv = mod_kv.SqliteKV(path)
        again = mod_slices.ChipScheduler(topo, kv)
        outcomes.append((grants, again.status(), again.owned_chips("a"),
                         kv.get(mod_slices.keys.SCHEDULER_CHIPS_KEY)))
        with pytest.raises(Exception) as exc:
            again.apply_chips(4)
        assert type(exc.value).__name__ == "ChipNotEnough"
        kv.close()
    # the port's view adds each GPU's UUID (JAX's has no such key)
    assert [c.pop("uuid") for c in outcomes[1][1]["chips"]] == [
        ttopo.fake_uuid(i) for i in range(8)]
    assert outcomes[0] == outcomes[1]
    assert outcomes[1][0] == [([0, 1, 2], True), ([3, 4], True)]
    assert "ghost" not in outcomes[1][3]


def test_uuids_of_maps_grants_to_the_topology_uuids():
    sched = tslices.ChipScheduler(ttopo.HostTopology.build("h100-8"),
                                  tkv.MemoryKV())
    ids, contiguous = sched.apply_chips(2, owner="x")
    assert (ids, contiguous) == ([0, 1], True)
    assert sched.uuids_of(ids) == [ttopo.fake_uuid(0), ttopo.fake_uuid(1)]
    assert sched.uuids_of([5, 2]) == [ttopo.fake_uuid(5), ttopo.fake_uuid(2)]
    bare = ttopo.HostTopology.from_chips(H100, {0: (0, 0, 0), 1: (1, 0, 0)})
    with pytest.raises(terrors.TopologyUnknown, match=r"\[1\]"):
        tslices.ChipScheduler(bare, tkv.MemoryKV()).uuids_of([1])


def _traced_claims(mod_trace, mod_slices, topo, kv) -> list:
    tracer = mod_trace.Tracer()
    sched = mod_slices.ChipScheduler(topo, kv)
    with tracer.span("req") as root:
        sched.apply_chips(2, owner="a")
        sched.try_claim_chips_bulk([("b", [5])])
    return [(s["name"], s["status"])
            for s in tracer.trace_view(root.trace_id)["spans"]]


def test_scheduler_spans_match_jax():
    ttop = ttopo.HostTopology.build("h100-8")
    jtop = jtopo.HostTopology(_jax_gen(H100), ttop.mesh_shape,
                              dict(ttop.coords))
    want = _traced_claims(jtrace, jslices, jtop, jkv.MemoryKV())
    assert _traced_claims(ttrace, tslices, ttop, tkv.MemoryKV()) == want
    assert [n for n, _ in want] == ["req", "sched.chips.claim",
                                    "sched.chips.claim_bulk"]


def _port_script(seed: int, steps: int = 60) -> list[tuple]:
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(steps):
        owner = ["s0", "s1", ""][rng.integers(3)]
        ports = sorted({int(p) for p in rng.integers(39998, 40018, 3)})
        kind = rng.choice(["apply", "claim", "bulk", "restore", "restore_any",
                           "reload"], p=[.35, .15, .1, .25, .1, .05])
        if kind == "apply":
            ops.append(("apply", int(rng.integers(0, 7)), owner))
        elif kind == "bulk":
            ops.append(("bulk", [("s0", ports[:1]), ("s1", ports[1:])]))
        else:
            ops.append((kind, ports, owner))
    return ops


def _run_ports(mod, kv, script) -> list:
    sched = mod.PortScheduler(kv, 40000, 40015)
    out = []
    for op in script:
        try:
            if op[0] == "apply":
                res = sched.apply_ports(op[1], owner=op[2])
            elif op[0] == "claim":
                res = sched.try_claim_ports(op[1], op[2])
            elif op[0] == "bulk":
                res = sched.try_claim_ports_bulk(op[1])
            elif op[0] == "restore":
                res = sched.restore_ports(op[1], owner=op[2])
            elif op[0] == "restore_any":
                res = sched.restore_ports(op[1])
            else:
                sched = mod.PortScheduler(kv, 40000, 40015)
                sched.reload_from_store()
                res = sched.n_free
        except Exception as e:  # noqa: BLE001 — the class is the outcome
            res = type(e).__name__
        out.append((res, kv.get_or(mod.keys.SCHEDULER_PORTS_KEY)))
    out.append(sched.status())
    return out


@pytest.mark.parametrize("seed", range(4))
def test_port_scheduler_scripts_match_jax(seed):
    script = _port_script(seed)
    want = _run_ports(jports, jkv.MemoryKV(), script)
    assert _run_ports(tports, tkv.MemoryKV(), script) == want
    assert "PortNotEnough" in {r[0] for r in want[:-1]
                               if isinstance(r[0], str)}
    assert tports.keys is tkeys
    assert tkeys.SCHEDULER_PORTS_KEY == jkeys.SCHEDULER_PORTS_KEY


def test_port_scheduler_reads_the_legacy_layout_as_jax():
    raw = json.dumps({"used": [40001, 40003, 50000], "cursor": 70000})
    outcomes = []
    for mod, kv_mod in ((jports, jkv), (tports, tkv)):
        kv = kv_mod.MemoryKV()
        kv.put(mod.keys.SCHEDULER_PORTS_KEY, raw)
        sched = mod.PortScheduler(kv, 40000, 40010)
        outcomes.append((sched.status(), sched.apply_ports(2, "x")))
    assert outcomes[0] == outcomes[1]
    with pytest.raises(ValueError):
        tports.PortScheduler(tkv.MemoryKV(), 2, 1)
    assert jerrors.PortNotEnough.code == terrors.PortNotEnough.code
