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

``check_job_invariants`` is the distributed-job analog over a whole pod:

1. the latest job pointer has a persisted ``JobState`` with a legal phase;
2. a ``running`` job's members ALL run, on one single version (gang
   atomicity — a half-restarted gang is a violation);
3. a ``failed``/``stopped``-undesired job has no member running, and a
   ``failed`` job owns ZERO slices and ZERO ports across every host;
4. a live job's slice grants and host-port claims match its placements
   exactly; retired versions own nothing;
5. every slice grant maps to a known job family.

Both return human-readable violations (empty list = consistent) rather than
raising, so tests can assert on the whole set and operators can surface it
verbatim.

The port's copy of ``tpu_docker_api/service/invariants.py``, whole: the
container, job, service and workflow oracles.
"""

from __future__ import annotations

from tpu_docker_api_torch import errors
from tpu_docker_api_torch.runtime.base import ContainerRuntime
from tpu_docker_api_torch.runtime.spec import ContainerSpec
from tpu_docker_api_torch.scheduler.ports import PortScheduler
from tpu_docker_api_torch.scheduler.slices import ChipScheduler
from tpu_docker_api_torch.schemas.job import DORMANT_PHASES, JOB_PHASES
from tpu_docker_api_torch.state.keys import (
    Resource,
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


def check_service_invariants(
    store: StateStore,
    service_versions: VersionMap,
    job_versions: VersionMap,
) -> list[str]:
    """Replicated-service oracle (service/serving.py):

    1. the latest service pointer has a persisted ``ServiceState`` with a
       legal phase;
    2. an ``active`` service owns exactly replica gang families
       ``0..replicas-1`` — none missing, none surplus (a converged fleet,
       never half-scaled);
    3. every replica-marked job family (``SERVICE_OWNER_ENV`` in its
       stored env) maps to a known service — a deleted service never
       strands an orphan fleet;
    4. a ``deleting`` service is a violation at rest: the reconciler must
       have finished the sweep (the phase only exists mid-teardown).
    """
    from tpu_docker_api_torch.schemas.service import (
        SERVICE_PHASES,
        owner_from_env,
    )
    from tpu_docker_api_torch.service.serving import split_replica_base

    problems: list[str] = []
    families = service_versions.snapshot()

    def job_owner(job_base: str) -> str | None:
        if split_replica_base(job_base) is None:
            return None
        latest = job_versions.get(job_base)
        if latest is None:
            return None
        try:
            jst = store.get_job(versioned_name(job_base, latest))
        except errors.NotExistInStore:
            return None
        return owner_from_env(jst.env)

    owned: dict[str, list[tuple[int, str]]] = {}
    for jb in job_versions.snapshot():
        owner = job_owner(jb)
        if owner is not None:
            owned.setdefault(owner, []).append(
                (split_replica_base(jb)[1], jb))

    for base, latest in sorted(families.items()):
        latest_name = versioned_name(base, latest)
        try:
            st = store.get_service(latest_name)
        except errors.NotExistInStore:
            problems.append(
                f"service {base}: latest pointer v{latest} has no stored "
                f"record")
            continue
        if st.phase not in SERVICE_PHASES:
            problems.append(f"service {base}: unknown phase {st.phase!r}")
        if st.phase == "deleting":
            problems.append(
                f"service {base}: stuck in phase deleting (teardown "
                f"unfinished)")
            continue
        have = {idx for idx, _ in owned.get(base, [])}
        missing = sorted(set(range(st.replicas)) - have)
        if missing:
            problems.append(
                f"service {base}: missing replica gang(s) {missing} "
                f"(want {st.replicas})")
        surplus = sorted(i for i in have if i >= st.replicas)
        if surplus:
            problems.append(
                f"service {base}: surplus replica gang(s) {surplus} "
                f"(want {st.replicas})")

    for owner in sorted(set(owned) - set(families)):
        problems.append(
            f"replica gang(s) {sorted(jb for _, jb in owned[owner])} owned "
            f"by unknown service {owner!r}")
    return problems


def check_workflow_invariants(
    store: StateStore,
    workflow_versions: VersionMap,
    job_versions: VersionMap,
) -> list[str]:
    """Durable-workflow oracle (service/workflow.py):

    1. the latest workflow pointer has a persisted ``WorkflowState`` with
       a legal phase, and every step status a legal state;
    2. a ``deleting`` workflow is a violation at rest — the reconciler
       must have finished the teardown sweep;
    3. a terminal (``succeeded``/``failed``) workflow owns ZERO step gang
       families — exactly-once settlement frees everything;
    4. a ``running`` workflow's step gangs exist only for steps in state
       ``launching``/``running``, and only for the CURRENT run — a
       pending/succeeded step holding a gang is a leak, a stale cron
       run's gang is an orphan;
    5. every workflow-marked job family (``WORKFLOW_OWNER_ENV`` in its
       stored env) maps to a known workflow — a deleted workflow never
       strands a gang.
    """
    from tpu_docker_api_torch.schemas.workflow import (
        STEP_STATES,
        WORKFLOW_PHASES,
        owner_from_env,
        run_from_env,
    )
    from tpu_docker_api_torch.service.workflow import split_step_base, step_base

    problems: list[str] = []
    families = workflow_versions.snapshot()

    def job_owner(job_base: str) -> tuple[str, int] | None:
        if split_step_base(job_base) is None:
            return None
        latest = job_versions.get(job_base)
        if latest is None:
            return None
        try:
            jst = store.get_job(versioned_name(job_base, latest))
        except errors.NotExistInStore:
            return None
        owner = owner_from_env(jst.env)
        if owner is None:
            return None
        run = run_from_env(jst.env)
        return (owner, run if run is not None else 0)

    owned: dict[str, list[tuple[int, str]]] = {}
    for jb in job_versions.snapshot():
        owner = job_owner(jb)
        if owner is not None:
            owned.setdefault(owner[0], []).append((owner[1], jb))

    for base, latest in sorted(families.items()):
        latest_name = versioned_name(base, latest)
        try:
            st = store.get_workflow(latest_name)
        except errors.NotExistInStore:
            problems.append(
                f"workflow {base}: latest pointer v{latest} has no stored "
                f"record")
            continue
        if st.phase not in WORKFLOW_PHASES:
            problems.append(f"workflow {base}: unknown phase {st.phase!r}")
        if st.phase == "deleting":
            problems.append(
                f"workflow {base}: stuck in phase deleting (teardown "
                f"unfinished)")
            continue
        for sname, stat in sorted(st.step_status.items()):
            if stat.get("state") not in STEP_STATES:
                problems.append(
                    f"workflow {base}: step {sname} has unknown state "
                    f"{stat.get('state')!r}")
        gangs = owned.get(base, [])
        if st.phase in ("succeeded", "failed"):
            if gangs:
                problems.append(
                    f"workflow {base}: terminal {st.phase} but owns step "
                    f"gang(s) {sorted(jb for _, jb in gangs)}")
            continue
        # running: gangs exist exactly for launching/running steps of the
        # current run ("launching" may legitimately have no gang yet)
        allowed = set()
        for idx, step in enumerate(st.spec_steps()):
            if st.step_status[step.name]["state"] in ("launching",
                                                      "running"):
                allowed.add(step_base(base, st.run, idx))
        for run, jb in sorted(gangs):
            if run != st.run:
                problems.append(
                    f"workflow {base}: stale run-{run} step gang {jb} "
                    f"(current run {st.run})")
            elif jb not in allowed:
                problems.append(
                    f"workflow {base}: step gang {jb} exists but its step "
                    f"is not launching/running")

    for owner in sorted(set(owned) - set(families)):
        problems.append(
            f"step gang(s) {sorted(jb for _, jb in owned[owner])} owned "
            f"by unknown workflow {owner!r}")
    return problems


def check_job_invariants(
    pod,
    slices,
    store: StateStore,
    versions: VersionMap,
) -> list[str]:
    """Gang-consistency oracle over a pod (``pod``: scheduler.pod.Pod,
    ``slices``: the PodScheduler whose grants back the jobs)."""
    problems: list[str] = []
    families = versions.snapshot()

    # family → resources actually held anywhere in the pod
    slice_owners: dict[str, list[str]] = {}
    for owner in slices.status()["slices"]:
        slice_owners.setdefault(job_owner_base(owner), []).append(owner)
    port_owners: dict[str, list[tuple[str, int]]] = {}  # base → (host, port)
    for host_id, host in pod.hosts.items():
        for p, o in host.ports.status()["owners"].items():
            port_owners.setdefault(job_owner_base(o), []).append((host_id, p))

    for base, latest in sorted(families.items()):
        latest_name = versioned_name(base, latest)
        try:
            st = store.get_job(latest_name)
        except errors.NotExistInStore:
            problems.append(
                f"job {base}: latest pointer v{latest} has no stored state")
            continue
        if st.phase not in JOB_PHASES:
            problems.append(f"job {base}: unknown phase {st.phase!r}")
        if st.phase in ("scaling_down", "scaling_up"):
            # like a service stuck "deleting": the phase only exists
            # mid-resize — at rest the reconciler/supervisor must have
            # finished the resize forward (or parked/failed the gang)
            problems.append(
                f"job {base}: stuck in phase {st.phase} (resize "
                f"unfinished)")
        if st.draining and st.phase not in DORMANT_PHASES:
            # the gateway drain marker only exists between mark and the
            # stopped write — at rest the reconciler must have finished
            # the stop the marker recorded (a half-drained replica would
            # sit unroutable yet holding its slice forever)
            problems.append(
                f"job {base}: draining marker at rest (quiesce "
                f"unfinished)")
        if st.elastic:
            floor = max(st.min_members, 1)
            if st.placements and len(st.placements) < floor:
                problems.append(
                    f"job {base}: elastic gang below minMembers "
                    f"({len(st.placements)} < {floor})")
            if (st.members_desired
                    and len(st.placements) > st.members_desired):
                problems.append(
                    f"job {base}: elastic gang above membersDesired "
                    f"({len(st.placements)} > {st.members_desired})")

        # queued/preempted are dormant like failed/stopped: no member may
        # run (the capacity-market quiesce is complete or never started)
        live = st.desired_running and st.phase not in DORMANT_PHASES
        member_running: dict[str, bool] = {}
        for host_id, cname, *_ in st.placements:
            host = pod.hosts.get(host_id)
            if host is None:
                member_running[cname] = False
                if live:
                    problems.append(
                        f"job {base}: member {cname} placed on missing "
                        f"host {host_id}")
                continue
            try:
                member_running[cname] = host.runtime.container_inspect(
                    cname).running
            except errors.ContainerNotExist:
                member_running[cname] = False
                if live:
                    problems.append(f"job {base}: member {cname} missing")
            except errors.HOST_PATH_ERRORS:
                # state unknown, not provably dead — but a live gang with a
                # member behind a dead engine is not converged either: it
                # awaits migration (host down) or recovery (blip)
                member_running[cname] = False
                if live:
                    problems.append(
                        f"job {base}: member {cname} on unreachable "
                        f"host {host_id}")

        if live and st.phase == "running":
            dead = sorted(c for c, r in member_running.items() if not r)
            if dead:
                problems.append(
                    f"job {base}: running phase but dead members {dead}")
        if not live:
            up = sorted(c for c, r in member_running.items() if r)
            if up:
                problems.append(
                    f"job {base}: phase {st.phase} but members {up} run")

        # gang atomicity: no member of any OTHER version may run
        for version in store.history(Resource.JOBS, base):
            if version == latest:
                continue
            vname = versioned_name(base, version)
            try:
                vst = store.get_job(vname)
            except errors.NotExistInStore:
                continue
            for host_id, cname, *_ in vst.placements:
                host = pod.hosts.get(host_id)
                if host is None:
                    continue
                try:
                    if host.runtime.container_inspect(cname).running:
                        problems.append(
                            f"job {base}: retired version member {cname} "
                            f"is running alongside latest v{latest}")
                except (errors.ContainerNotExist, *errors.HOST_PATH_ERRORS):
                    # unreachable: unverifiable — a retired member stranded
                    # behind a dead engine is quiesced when the host
                    # returns, never a live-gang violation from here
                    pass

        # resource accounting: failed owns nothing; live owns exactly the
        # latest version's grants/ports; retired versions own nothing
        held_slices = slice_owners.get(base, [])
        held_ports = port_owners.get(base, [])
        if st.phase in ("failed", "preempted", "queued"):
            # failed is terminal; preempted was released to make room for
            # a higher-priority gang; queued never claimed anything —
            # all three must own ZERO slices and ports across every host
            if held_slices:
                problems.append(
                    f"job {base}: {st.phase} but owns slices "
                    f"{sorted(held_slices)}")
            if held_ports:
                problems.append(
                    f"job {base}: {st.phase} but owns ports "
                    f"{sorted(held_ports)}")
            continue
        expected_owners = {
            latest_name if st.num_slices == 1 else f"{latest_name}#s{k}"
            for k in range(st.num_slices)}
        stale = sorted(set(held_slices) - expected_owners)
        if stale:
            problems.append(f"job {base}: stale slice grants {stale}")
        expected_ports: set[tuple[str, int]] = set()
        for host_id, cname, pid, _, member_port in st.placements:
            expected_ports.add((host_id, member_port))
            if pid == 0:
                expected_ports.add((host_id, st.coordinator_port))
                if st.megascale_port:
                    expected_ports.add((host_id, st.megascale_port))
        extra_p = sorted(set(held_ports) - expected_ports)
        if extra_p:
            problems.append(f"job {base}: leaked ports {extra_p}")
        if live:
            # a live gang must hold its full claim; a stopped job may hold
            # either its grant (stop_job retains for resume) or nothing
            # (delete_job kept the spec for re-run) — but never more
            missing_grants = sorted(expected_owners - set(held_slices))
            if missing_grants:
                problems.append(
                    f"job {base}: missing slice grants {missing_grants}")
            missing_p = sorted(expected_ports - set(held_ports))
            if missing_p:
                problems.append(f"job {base}: unclaimed ports {missing_p}")

    for base in sorted(set(slice_owners) - set(families)):
        problems.append(
            f"slice grants {sorted(slice_owners[base])} owned by unknown "
            f"job {base!r}")
    return problems
