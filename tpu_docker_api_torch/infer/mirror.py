"""One serving engine over the ranks of a mesh (no counterpart file in
the JAX package, whose server is one process that XLA spreads over the
chips).

The port runs one process per device. Rank 0 answers HTTP and runs the
engine's scheduling; every other rank runs the same engine on its own
shards, step for step. At the top of each engine step rank 0 broadcasts
what came in since the last one (the requests to admit, prefix
registrations and removals) over a host-side gloo group; every rank then
applies it and runs the step. The engine's decisions depend on nothing
else (its seeds are host counters, the sampled tokens come from logits
that the tp all-reduce makes the same on every rank), so the ranks issue
the same forwards, and so the same collectives, in the same order.

A rank that falls out breaks rank 0's next broadcast (gloo reports the
closed connection, or times out), which fails the engine; the launcher
(workload/torchenv.py) stops the job when any rank exits with an error.
"""

from __future__ import annotations

import queue


class Mirror:
    """The broadcast channel of one engine. Every rank makes it at the
    same point (its group is made collectively)."""

    def __init__(self, timeout_s: float = 600.0):
        import datetime

        import torch.distributed as dist

        self.rank = dist.get_rank()
        self.group = dist.new_group(
            backend="gloo", timeout=datetime.timedelta(seconds=timeout_s))
        #: (op name, args, reply queue) from rank 0's other threads
        self.ops: queue.SimpleQueue = queue.SimpleQueue()
        self.stopped = False

    @property
    def leads(self) -> bool:
        return self.rank == 0

    def broadcast(self, msg):
        """Rank 0's ``msg``, on every rank."""
        import torch.distributed as dist

        box = [msg if self.leads else None]
        dist.broadcast_object_list(box, src=0, group=self.group)
        return box[0]

    def call(self, engine, name: str, *args):
        """Run engine op ``name`` on every rank at the next step (rank 0,
        from any thread); returns its result on rank 0."""
        reply: queue.SimpleQueue = queue.SimpleQueue()
        self.ops.put((name, args, reply))
        engine._wake.set()
        ok, val = reply.get(timeout=600)
        if not ok:
            raise val
        return val

    def drain_ops(self) -> list:
        out = []
        while True:
            try:
                out.append(self.ops.get_nowait())
            except queue.Empty:
                return out

    def stop(self) -> None:
        """Rank 0: release the other ranks (their engine's ``follow`` or
        the server's ``follow`` returns)."""
        if self.leads and not self.stopped:
            self.stopped = True
            self.broadcast({"stop": True})
