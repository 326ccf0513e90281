"""Job lifecycle phases.

The port's copy of the two phase tuples of ``tpu_docker_api/schemas/job.py``
that the reconciler and the invariants name. The job DTOs (``JobRun``,
``JobState`` and the rest) come with the job service (ROADMAP Queue 1 item
10).
"""

#: a gang's lifecycle: ``running``; ``restarting`` / ``migrating`` — a
#: whole-gang restart or a host-fault migration in flight; ``failed`` /
#: ``stopped``; ``queued`` / ``preempted`` — the capacity market holds it;
#: ``scaling_down`` / ``scaling_up`` — an elastic resize in flight. The
#: in-flight phases are persisted first, so a daemon death mid-recovery is
#: adoptable and never survives at rest.
JOB_PHASES = ("running", "restarting", "migrating", "failed", "stopped",
              "queued", "preempted", "scaling_down", "scaling_up")

#: phases with no runtime footprint: members must not run, and — except
#: ``stopped``, which retains its grant for resume — the job owns nothing.
#: Supervision, gang recovery and liveness classification all skip them.
DORMANT_PHASES = ("failed", "stopped", "queued", "preempted")
