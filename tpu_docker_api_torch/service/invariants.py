"""Control-plane consistency invariants (docs/robustness.md).

The chaos suite's oracle: after crash → restart → reconcile, a consistent
control plane satisfies, for every container family,

1. the latest version pointer has a persisted spec;
2. at most one version is running, and it is the latest;
3. declarative liveness matches the runtime (desired_running ⇔ running);
4. scheduler chip ownership is exactly the latest spec's chips when the
   family wants to run, and empty otherwise (zero leaks, zero double-binds);
5. the same for host ports;
6. every chip/port owner maps to a known family.

It returns human-readable violations (empty list = consistent) rather than
raising, so tests can assert on the whole set and operators can surface it
verbatim.

The port's copy of ``tpu_docker_api/service/invariants.py`` with
``check_invariants`` alone: the job, service and workflow oracles come with
their services (ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

from tpu_docker_api_torch import errors
from tpu_docker_api_torch.runtime.base import ContainerRuntime
from tpu_docker_api_torch.runtime.spec import ContainerSpec
from tpu_docker_api_torch.scheduler.ports import PortScheduler
from tpu_docker_api_torch.scheduler.slices import ChipScheduler
from tpu_docker_api_torch.state.keys import (
    job_owner_base,
    split_versioned_name,
    versioned_name,
)
from tpu_docker_api_torch.state.store import StateStore
from tpu_docker_api_torch.state.version import VersionMap


def check_invariants(
    runtime: ContainerRuntime,
    store: StateStore,
    versions: VersionMap,
    chips: ChipScheduler,
    ports: PortScheduler,
    ignore_owners: set[str] | None = None,
    job_versions: VersionMap | None = None,
) -> list[str]:
    problems: list[str] = []
    families = versions.snapshot()
    ignore = (ignore_owners or set()) | {""}
    if job_versions is not None:
        # job families share the local chip/port pools; their (versioned)
        # owners are not leaks
        ignore |= set(job_versions.snapshot())

    members: dict[str, list[str]] = {}
    for name in runtime.container_list():
        base, version = split_versioned_name(name)
        if version is not None:
            members.setdefault(base, []).append(name)

    for base, latest in sorted(families.items()):
        latest_name = versioned_name(base, latest)
        try:
            state = store.get_container(latest_name)
        except errors.NotExistInStore:
            problems.append(f"{base}: latest pointer v{latest} has no stored spec")
            continue
        spec = ContainerSpec.from_dict(state.spec)

        running = [n for n in members.get(base, [])
                   if runtime.container_inspect(n).running]
        if len(running) > 1:
            problems.append(f"{base}: {len(running)} running versions {running}")
        if running and latest_name not in running:
            problems.append(
                f"{base}: running version {running[0]} is not latest {latest_name}")
        if state.desired_running and latest_name not in running:
            problems.append(f"{base}: desired running but {latest_name} is dead")
        if not state.desired_running and latest_name in running:
            problems.append(f"{base}: desired stopped but {latest_name} runs")

        expected_chips = set(spec.chip_ids) if state.desired_running else set()
        owned_chips = set(chips.owned_chips(base))
        if owned_chips - expected_chips:
            problems.append(
                f"{base}: leaked chips {sorted(owned_chips - expected_chips)}")
        if expected_chips - owned_chips:
            problems.append(
                f"{base}: unclaimed chips {sorted(expected_chips - owned_chips)}")

        # only scheduler-range ports: explicit out-of-range host ports are
        # never pool-allocated (reconcile.py _scheduled_ports)
        expected_ports = ({pb.host_port for pb in spec.port_bindings
                           if pb.host_port
                           and ports.start_port <= pb.host_port <= ports.end_port}
                          if state.desired_running else set())
        owned_ports = {p for p, o in ports.status()["owners"].items()
                       if o == base}
        if owned_ports - expected_ports:
            problems.append(
                f"{base}: leaked ports {sorted(owned_ports - expected_ports)}")
        if expected_ports - owned_ports:
            problems.append(
                f"{base}: unclaimed ports {sorted(expected_ports - owned_ports)}")

    known = set(families) | ignore
    for c in chips.status()["chips"]:
        if (c["used"] and c["owner"] not in known
                and job_owner_base(c["owner"]) not in known):
            problems.append(
                f"chip {c['chipId']} owned by unknown {c['owner']!r}")
    for p, o in sorted(ports.status()["owners"].items()):
        if o not in known and job_owner_base(o) not in known:
            problems.append(f"port {p} owned by unknown {o!r}")
    return problems

