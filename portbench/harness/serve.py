"""The serving drivers: a closed loop of clients and an open loop of
arrivals, both against the port's ``SlotEngine`` through ``submit`` and
``Handle.stream``.

One engine thread runs ``SlotEngine.step`` (the loop ``start()`` would
run) and opens the traced window; one client thread (the caller's)
sends the requests and watches the handles. Every time is read from the
host's clock (``time.perf_counter``); a handle's ``first_token_at`` and
``completed_at`` are stamped when the token reaches the host, which is
when a client sees it.
"""

from __future__ import annotations

import dataclasses
import heapq
import sys
import threading
import time

import numpy as np
import torch

from portbench.harness import check
from portbench.harness import model as hm
from portbench.harness import traffic as tr
from portbench.harness.trace import Window


@dataclasses.dataclass
class Sent:
    req: tr.Request
    handle: object
    due_at: float            # perf_counter at which the request was due
    tokens: list = dataclasses.field(default_factory=list)
    failed: bool = False


def prefill_buckets(mix: dict) -> list[int]:
    """The engine's default prefill buckets that the mix's prompts fall
    in (powers of two from 32, then ``max_seq``)."""
    from tpu_docker_api_torch.infer.slots import _default_buckets

    buckets = _default_buckets(int(mix["max_seq"]))
    lo, hi = int(mix["prompt"]["lo"]), int(mix["prompt"]["hi"])
    return sorted({next(b for b in buckets if b >= n)
                   for n in range(lo, hi + 1)})


class PrefillLog:
    """Records the token rows of every whole-prompt prefill forward the
    engine runs (the capacity rule of a MoE couples a forward's rows)."""

    def __init__(self):
        self.calls: list = []

    def wrap(self, fwd):
        def recording(params, tokens, cfg, k_cache, v_cache, start_pos,
                      last_only=False, kv_limit=None):
            if type(start_pos) is int and start_pos == 0:
                self.calls.append(tokens)
            return fwd(params, tokens, cfg, k_cache, v_cache, start_pos,
                       last_only=last_only, kv_limit=kv_limit)
        return recording

    def group_of(self, prompt: list[int]):
        """(rows (R, S) on the device, row index) of the forward that
        prefilled ``prompt``, or None."""
        n = len(prompt)
        want = torch.tensor(prompt)
        for rows in reversed(self.calls):
            if rows.shape[1] < n:
                continue
            host = rows.cpu()
            hit = (host[:, :n] == want).all(dim=1).nonzero()
            if len(hit):
                return rows, int(hit[0])
        return None


def build_engine(cfg, params, mix: dict, seed: int, log: PrefillLog | None):
    """The engine at the mix's slots, cache length and chunk, warmed up
    on the prefill buckets and row groups the mix uses."""
    from tpu_docker_api_torch.infer import slots as slots_mod

    orig = slots_mod.cached_forward_fn
    if log is not None:
        slots_mod.cached_forward_fn = lambda c: log.wrap(orig(c))
    t0 = time.perf_counter()
    try:
        eng = slots_mod.SlotEngine(
            cfg, params, slots=int(mix["slots"]), max_seq=int(mix["max_seq"]),
            chunk=int(mix["chunk"]), cache_dtype=cfg.dtype, seed=seed)
    finally:
        slots_mod.cached_forward_fn = orig
    t1 = time.perf_counter()
    eng.warmup(buckets=prefill_buckets(mix), rows=tuple(mix["warm_rows"]))
    if log is not None:
        log.calls.clear()
    print(f"set-up: engine {t1 - t0:.2f} s, warm-up "
          f"{time.perf_counter() - t1:.2f} s", file=sys.stderr)
    return eng


class Driver:
    """Runs ``eng.step()`` on the calling thread (the loop ``start()``
    would run in a thread of its own) and traces ``[trace_at,
    trace_end)``, perf_counter times, when they are set."""

    def __init__(self, eng):
        self.eng = eng
        self.trace_at: float | None = None
        self.trace_end: float | None = None
        self.window: Window | None = None
        self.launches: dict = {}
        self._win = None
        self._before: dict = {}

    def until(self, done) -> None:
        """Step the engine until ``done()``."""
        from tpu_docker_api_torch.ops import flash

        while True:
            now = time.perf_counter()
            if (self._win is None and self.window is None
                    and self.trace_at is not None and now >= self.trace_at):
                self._before = dict(flash.launch_count)
                self._win = Window().__enter__()
            if self._win is not None and now >= self.trace_end:
                self._win.__exit__(None, None, None)
                self.launches = {k: flash.launch_count[k] - self._before[k]
                                 for k in self._before}
                self.window, self._win = self._win, None
            if done():
                return
            if not self.eng.step():
                time.sleep(0.0005)


def _drain(sent: Sent) -> None:
    """Take every token the stream holds now, without waiting."""
    try:
        for t in sent.handle.stream(timeout=0):
            sent.tokens.append(t)
    except TimeoutError:
        pass
    except Exception:  # noqa: BLE001 — the request failed
        sent.failed = True


def _submit(eng, req: tr.Request, due_at: float) -> Sent:
    try:
        h = eng.submit(req.prompt, req.max_new, stream=True)
    except Exception:  # noqa: BLE001 — a refused request is a failed one
        return Sent(req, None, due_at, failed=True)
    return Sent(req, h, due_at)


def closed_loop(eng, queues, seconds: float, t0: float,
                poll_s: float = 0.005) -> list[Sent]:
    """Each client sends its next request as soon as its last completes;
    the first at its ramp offset. Sending stops at ``t0 + seconds``."""
    end = t0 + seconds
    due = [(t0 + q[0].due, c) for c, q in enumerate(queues)]
    heapq.heapify(due)
    nxt = [0] * len(queues)
    active: dict[int, Sent] = {}
    sent: list[Sent] = []
    while (now := time.perf_counter()) < end:
        while due and due[0][0] <= now:
            at, c = heapq.heappop(due)
            s = _submit(eng, queues[c][nxt[c]], at)
            nxt[c] += 1
            sent.append(s)
            active[c] = s
        for c in [c for c, s in active.items()
                  if s.handle is None or s.handle.done()]:
            del active[c]
            if nxt[c] < len(queues[c]):
                heapq.heappush(due, (now, c))
        time.sleep(poll_s)
    return sent


def open_loop(eng, reqs, t0: float) -> list[Sent]:
    """Each request sent at ``t0 + due``, whatever the engine's state."""
    sent = []
    for r in reqs:
        due = t0 + r.due
        while (lag := due - time.perf_counter()) > 0:
            time.sleep(min(lag, 0.002))
        sent.append(_submit(eng, r, due))
    return sent


def window(cfg, conf: dict, params, mix: dict, seed: int, seconds: float,
           trace: bool, on_window=None, rows_coupled: bool = False) -> dict:
    """One serving window. ``on_window()`` is called as it opens (the
    end of set-up). The engine steps on this thread, the clients send
    from another. ``rows_coupled``: record each prefill forward's rows,
    which the check then runs whole. Returns the records the metric
    readers and the check take."""
    closed = mix["kind"] == "closed_serve"
    log = PrefillLog() if rows_coupled else None
    eng = build_engine(cfg, params, mix, seed, log)
    if params["embed"]["tokens"].is_cuda:
        torch.cuda.synchronize()
    vocab = conf["vocab_size"]
    work = (tr.closed_mix(mix, seed, vocab) if closed
            else tr.open_mix(mix, seconds, seed, vocab))
    drv = Driver(eng)
    stats0 = dict(eng.stats)
    if on_window is not None:
        on_window()
    t0 = time.perf_counter()
    t_end = t0 + seconds
    if trace:
        drv.trace_at, drv.trace_end = t_end - float(mix["trace_s"]), t_end
    sent: list[Sent] = []
    errors: list = []

    def client():
        try:
            sent.extend(closed_loop(eng, work, seconds, t0) if closed
                        else open_loop(eng, work, t0))
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)

    th = threading.Thread(target=client, name="portbench-client")
    th.start()
    try:
        drv.until(lambda: time.perf_counter() >= t_end)
        stats1 = dict(eng.stats)
        th.join(timeout=30)
        for s in sent:
            if s.handle is not None:
                _drain(s)
        window_tokens = {id(s): len(s.tokens) for s in sent}
        if not closed:
            deadline = t_end + float(mix.get("grace_s", 60.0))
            drv.until(lambda: time.perf_counter() >= deadline or all(
                s.handle is None or s.handle.done() for s in sent))
    finally:
        th.join(timeout=30)
    if th.is_alive() or errors:
        raise RuntimeError(f"client failed: {errors!r}")
    for s in sent:
        if s.handle is None:
            continue
        _drain(s)
        if s.handle.done():
            try:
                s.tokens = list(s.handle.result(0)["tokens"])
            except Exception:  # noqa: BLE001 — the request failed
                s.failed = True
        elif not closed:
            s.failed = True
    eng.close()
    return {"sent": sent, "t0": t0, "t_end": t_end, "seconds": seconds,
            "window_tokens": window_tokens, "stats0": stats0,
            "stats1": stats1, "chunk": int(mix["chunk"]), "log": log,
            "window": drv.window, "launches": drv.launches,
            "closed": closed}


def summarize(rec: dict) -> dict:
    """The host-clock numbers of a serving window: tokens delivered in
    it, TTFT from due and time per output token of each request."""
    t0, t_end = rec["t0"], rec["t_end"]
    sent = rec["sent"]
    delivered = sum(rec["window_tokens"].values())
    ttft, tpot, failed = [], [], 0
    for s in sent:
        h = s.handle
        ok = (h is not None and not s.failed and h.done()
              and h.first_token_at is not None)
        if rec["closed"]:
            if s.failed or h is None:
                failed += 1
            continue
        if not ok or len(s.tokens) != s.req.max_new:
            failed += 1
            ttft.append(float("inf"))
            tpot.append(float("inf"))
            continue
        ttft.append((h.first_token_at - s.due_at) * 1e3)
        n = len(s.tokens)
        if n > 1:
            tpot.append((h.completed_at - h.first_token_at) / (n - 1) * 1e3)
    completed = [s for s in sent if s.handle is not None and s.handle.done()
                 and s.handle.completed_at is not None
                 and s.handle.completed_at <= t_end and not s.failed]
    return {"delivered": delivered, "completed_in_window": len(completed),
            "attempted": len(sent), "failed": failed,
            "ttft_ms": ttft, "tpot_ms": tpot,
            "window_s": t_end - t0}


def sample(rec: dict, k: int, seed: int) -> list[Sent]:
    """The check's sample: the finished request with the most served
    tokens, and ``k - 1`` more finished ones drawn by the seed."""
    done = [s for s in rec["sent"] if s.handle is not None and not s.failed
            and s.handle.done() and len(s.tokens) == s.req.max_new]
    if not done:
        return []
    done.sort(key=lambda s: s.req.index)
    longest = max(done, key=lambda s: (len(s.tokens), -s.req.index))
    rest = [s for s in done if s is not longest]
    pick = tr.rng(seed, 5).permutation(len(rest))[:max(0, k - 1)]
    return [longest] + [rest[i] for i in sorted(pick)]


def flops_in_window(conf: dict, rec: dict) -> float:
    """Model operations of every prompt whose first token came in the
    window and of every output token delivered in it (its context the
    prompt and the tokens before it)."""
    from portbench.harness.roofline import forward_flops, prefill_flops

    total = 0.0
    for s in rec["sent"]:
        n_win = rec["window_tokens"].get(id(s), 0)
        if n_win == 0:
            continue
        L = len(s.req.prompt)
        total += prefill_flops(conf, L)
        total += sum(forward_flops(conf, L + j) for j in range(1, n_win))
    return total


def decode_contexts(rec: dict) -> np.ndarray:
    """The attended length of every decode token delivered in the
    window."""
    out = []
    for s in rec["sent"]:
        n_win = rec["window_tokens"].get(id(s), 0)
        L = len(s.req.prompt)
        out.extend(L + j for j in range(1, n_win))
    return np.asarray(out, dtype=np.float64)


def drive(run, controls: bool = False) -> dict:
    """A serving cell's run (``drivers/closed_serve.py`` and
    ``drivers/open_serve.py``): weights from the seed, the window, then
    the check on a sample of the finished requests once the program's
    state is freed."""
    conf, mix, device = run.conf, run.mix, run.device
    cfg = hm.port_config(conf, remat=False, portbench=run.portbench)
    t_w = time.perf_counter()
    params = hm.make_params(cfg, run.seed, device)
    print(f"set-up: process to weights {t_w - run.t_start:.2f} s, weights "
          f"{time.perf_counter() - t_w:.2f} s", file=sys.stderr)
    opened = {}
    rec = window(cfg, conf, params, mix, run.seed, run.seconds, run.traced,
                 on_window=lambda: opened.setdefault("t", time.perf_counter()),
                 rows_coupled=hm.family(conf, run.portbench).ROWS_COUPLED)
    run.setup_s = opened["t"] - run.t_start
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    run.rec = rec
    run.serve = summarize(rec)
    run.trace = rec["window"].summary if rec["window"] else None
    run.launches = rec["launches"]
    picks = sample(rec, int(mix["check_requests"]), run.seed)
    hm.free(device)
    if picks:
        readings = check.served_gaps(conf, hm.flat(params), picks,
                                     rec["log"], device, control=controls,
                                     families=run.portbench / "reference"
                                     / "families")
    else:
        readings = {k: float("inf") for k in check.SERVED}
    del params
    extra = {"control": readings.pop("control", None),
             "tokens": readings.pop("tokens", 0),
             "spread": readings.pop("spread", None)}
    return {"readings": readings, "attempted": run.serve["attempted"],
            "failed": run.serve["failed"], "peak": peak, "extra": extra}

