"""Checkpoint and resume of the training state (counterpart of
``tpu_docker_api/train/checkpoint.py``, no orbax).

A checkpoint is one directory a step, ``<dir>/<step>/``, holding

- ``params.safetensors``: the param tree, leaves named by their path
  (``layers/attn/wq``);
- ``opt_state.safetensors``: every tensor of the optimizer state, named
  by its path through the state's tuples and named tuples
  (``1/mu_q/layers/attn/wq``);
- ``meta.json``, written last: the step, the state's host integers
  (each transform's ``count``) and the params' paths in the tree's own
  order, which a restore keeps: the optimizer and the global norm walk
  the tree in that order, so a reordered tree would sum in another
  order and round otherwise.

Both files use the port's own safetensors writer and reader
(``models/import_weights.py``), so a params-only restore maps the params
file and never opens the optimizer's.

Saves are asynchronous. ``save`` records an event on the current stream
after the step's kernels and hands references to the state's tensors to
a writer thread; the step loop goes on at once. The step is functional
(every step returns new tensors), so the saved tensors stay as they
were, and the references keep the allocator from handing their memory
out again before they are copied. The writer copies them to the host on
a stream of its own that waits for the event, lets them go, writes the
files into a hidden temporary directory, and makes it visible by one
rename once complete: a half-written step is never ``latest_step``,
and the first save of a manager clears such leftovers. An
error in the writer is raised at the next ``save`` or ``wait``. One save
is in flight at a time: a new ``save`` first waits for the last.
Retention deletes only complete step directories.

The files carry no device: a checkpoint written on the card restores on
the CPU and the other way round.

Sharded states (the mesh path: DTensor leaves) keep the one format, so
a checkpoint written on any mesh restores on one device, or on another
mesh, and the other way round (the JAX rescale contract). The save is
then made in the caller's thread: every rank gathers the leaves one at
a time, in the writer's order, and rank 0 streams each to the file as
it comes, so host memory holds one whole leaf at a time. A restore onto
a mesh maps the files and copies each rank's own slice of every leaf.
An int8 moment's scales, ``(*lead, blocks)`` on a mesh, are the
``(rows, blocks)`` of one device on disk.
"""

from __future__ import annotations

import json
import os
import queue
import shutil
import threading
import time
from typing import Any

import torch

from tpu_docker_api_torch.models import param_dtypes, param_shapes
from tpu_docker_api_torch.models import model_fns
from tpu_docker_api_torch.models.import_weights import (SafeTensorsFile,
                                                        save_file,
                                                        write_order)
from tpu_docker_api_torch.parallel import sharding
from tpu_docker_api_torch.train.optim import tree_map
from tpu_docker_api_torch.train.trainer import (TrainState,
                                                create_train_state,
                                                default_optimizer)

PARAMS_FILE = "params.safetensors"
OPT_FILE = "opt_state.safetensors"
META_FILE = "meta.json"
_TMP_PREFIX = ".tmp-"
_FORMAT = "tpu_docker_api_torch.checkpoint/1"


def _flatten(tree, prefix: str, tensors: dict, ints: dict) -> None:
    """Leaves of nested dicts, tuples and named tuples by their path."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, tuple):
        items = zip(getattr(tree, "_fields", None) or map(str, range(len(
            tree))), tree)
    elif isinstance(tree, torch.Tensor):
        tensors[prefix] = tree
        return
    elif isinstance(tree, int):
        ints[prefix] = tree
        return
    else:
        raise TypeError(f"checkpoint: cannot store {type(tree).__name__} "
                        f"at {prefix!r}")
    for key, sub in items:
        _flatten(sub, f"{prefix}/{key}" if prefix else str(key), tensors,
                 ints)


def _fill(target, prefix: str, read, ints: dict):
    """``target``'s structure with every leaf read back by its path:
    tensors through ``read(path, like)``, integers from ``ints``."""
    def at(key):
        return f"{prefix}/{key}" if prefix else str(key)

    if isinstance(target, dict):
        return {k: _fill(v, at(k), read, ints) for k, v in target.items()}
    if isinstance(target, tuple) and hasattr(target, "_fields"):
        return type(target)(*(_fill(getattr(target, f), at(f), read, ints)
                              for f in target._fields))
    if isinstance(target, tuple):
        return tuple(_fill(v, at(i), read, ints)
                     for i, v in enumerate(target))
    if isinstance(target, torch.Tensor):
        return read(prefix, target)
    if isinstance(target, int):
        if prefix not in ints:
            raise ValueError(f"checkpoint has no integer {prefix!r}: it "
                             f"was written by another optimizer")
        return int(ints[prefix])
    raise TypeError(f"checkpoint: cannot restore {type(target).__name__} "
                    f"at {prefix!r}")


def _nest(flat: dict) -> dict:
    tree: dict = {}
    for path, leaf in flat.items():
        *parents, last = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return tree


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _is_dt(t) -> bool:
    return type(t).__name__ == "DTensor"


def _file_shape(path: str, t) -> tuple:
    """A leaf's shape on disk: an int8 moment's scales are (rows,
    blocks) whatever the mesh keeps."""
    if _is_dt(t) and t.ndim > 2 and ("mu_scale/" in path
                                     or "nu_scale/" in path):
        return (t.numel() // t.shape[-1], t.shape[-1])
    return tuple(t.shape)


class _Gathered:
    """A DTensor leaf that ``save_file`` brings to the host whole: the
    gather runs when the writer reaches it (``detach``)."""

    def __init__(self, t, shape):
        self.t, self.shape, self.dtype = t, torch.Size(shape), t.dtype

    def element_size(self) -> int:
        return self.t.element_size()

    def numel(self) -> int:
        return self.t.numel()

    def detach(self) -> torch.Tensor:
        return self.t.full_tensor().reshape(self.shape).cpu()


def _local_of(full: torch.Tensor, like) -> torch.Tensor:
    """This rank's slice of ``full`` (reshaped to ``like``'s global
    shape) under DTensor ``like``'s placements."""
    full = full.reshape(like.shape)
    mesh = like.device_mesh
    coord = mesh.get_coordinate()
    out = full
    for i, pl in enumerate(like.placements):
        if pl.is_shard() and mesh.size(i) > 1:
            n = out.shape[pl.dim] // mesh.size(i)
            out = out.narrow(pl.dim, coord[i] * n, n)
    return out


class _Job:
    def __init__(self, step, params, opt, ints, ready, device):
        self.step, self.params, self.opt, self.ints = step, params, opt, ints
        self.ready, self.device = ready, device
        self.done = threading.Event()
        self.record: dict = {"step": step}


class CheckpointManager:
    """Asynchronous checkpoints of a ``TrainState`` in one directory."""

    def __init__(self, directory: str | os.PathLike, max_to_keep: int = 3,
                 save_interval_steps: int = 1):
        if max_to_keep < 1 or save_interval_steps < 1:
            raise ValueError(f"max_to_keep {max_to_keep} and "
                             f"save_interval_steps {save_interval_steps} "
                             f"must be >= 1")
        self.directory = os.path.abspath(os.fspath(directory))
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps
        os.makedirs(self.directory, exist_ok=True)
        self._queue: queue.Queue = queue.Queue()
        self._thread: threading.Thread | None = None
        self._job: _Job | None = None
        self._error: BaseException | None = None
        self._error_step: int | None = None
        self._stream = None
        self._sharded_last: int | None = None
        #: one record per completed save: step, blocked_s (the caller's
        #: time in ``save``), d2h_s, write_s (the writer's time), bytes
        self.history: list[dict] = []

    # ---------------------------------------------------------- saving

    def save(self, state: TrainState, step: int | None = None) -> bool:
        """Start an asynchronous save; False when the interval gate or a
        step already saved (or being saved) at or past ``step`` declines
        it, as orbax does."""
        t0 = time.perf_counter()
        self._raise_error()
        step = int(state.step) if step is None else int(step)
        params, opt, ints = {}, {}, {}
        _flatten(state.params, "", params, ints)
        if _is_dt(next(iter(params.values()))):
            if not self._should_save_sharded(step):
                return False
            _flatten(state.opt_state, "", opt, ints)
            self._save_sharded(step, params, opt, ints, t0)
            return True
        if not self._should_save(step):
            return False
        self.wait()  # one save in flight: at most one extra state held
        _flatten(state.opt_state, "", opt, ints)
        device = next(iter(params.values())).device
        ready = None
        if device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(device))
        job = _Job(step, params, opt, ints, ready, device)
        if self._thread is None:
            # this manager writes here now: clear what a writer that died
            # midway left (a manager that only reads never does)
            for name in os.listdir(self.directory):
                if name.startswith(_TMP_PREFIX):
                    shutil.rmtree(os.path.join(self.directory, name),
                                  ignore_errors=True)
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="checkpoint-writer")
            self._thread.start()
        self._job = job
        job.record["blocked_s"] = time.perf_counter() - t0
        self._queue.put(job)
        return True

    def _save_sharded(self, step, params, opt, ints, t0) -> None:
        """The mesh save (module docstring): rank 0 writes, gathering
        one leaf at a time; the other ranks join the same gathers."""
        import torch.distributed as dist

        trees = [{k: _Gathered(t, _file_shape(k, t)) for k, t in tree.items()}
                 for tree in (params, opt)]
        job = _Job(step, trees[0], trees[1], ints, None,
                   torch.device("cpu"))
        if dist.get_rank() == 0:
            if self._thread is None:
                for name in os.listdir(self.directory):
                    if name.startswith(_TMP_PREFIX):
                        shutil.rmtree(os.path.join(self.directory, name),
                                      ignore_errors=True)
            self._write(job)
            job.record["blocked_s"] = time.perf_counter() - t0
            self.history.append(job.record)
        else:
            for tree in trees:
                for name in write_order(tree):
                    tree[name].t.full_tensor()
        job.done.set()
        self._job = job
        self._sharded_last = step

    def _should_save_sharded(self, step: int) -> bool:
        """``_should_save`` for the mesh save, which every rank must
        decide alike: the directory is read once, before this manager
        writes (rank 0 may rename a step while another rank decides),
        and then the steps this manager saved count."""
        if self._sharded_last is None:
            last = self.latest_step()
            self._sharded_last = -1 if last is None else last
            first = last is None
        else:
            first = False
        if self._sharded_last >= step:
            return False
        return first or step % self.save_interval_steps == 0

    def _should_save(self, step: int) -> bool:
        # the job's state first, the directory second: a job that finishes
        # between the two reads is then on disk when the directory is
        # listed (read the other way round, neither read sees its step)
        job = self._job
        in_flight = job is not None and not job.done.is_set()
        last = self.latest_step()
        if in_flight:
            last = max(last if last is not None else -1, job.step)
        if last is not None and last >= step:
            return False
        if last is None:
            return True
        return step % self.save_interval_steps == 0

    def _run(self) -> None:
        while True:
            job = self._queue.get()
            if job is None:
                return
            try:
                self._write(job)
                self.history.append(job.record)
            except Exception as e:  # noqa: BLE001 — raised at wait()
                self._error, self._error_step = e, job.step
            finally:
                job.params = job.opt = None
                job.done.set()

    def _to_host(self, job: _Job) -> tuple[dict, dict]:
        if job.device.type != "cuda":
            return job.params, job.opt
        if self._stream is None:
            self._stream = torch.cuda.Stream(job.device)
        with torch.cuda.stream(self._stream):
            self._stream.wait_event(job.ready)
            host = [{k: t.to("cpu") for k, t in tree.items()}
                    for tree in (job.params, job.opt)]
        return host[0], host[1]

    def _write(self, job: _Job) -> None:
        t0 = time.perf_counter()
        params, opt = self._to_host(job)
        job.params = job.opt = None  # the device tensors may go now
        t1 = time.perf_counter()
        tmp = os.path.join(self.directory,
                           f"{_TMP_PREFIX}{job.step}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        try:
            nbytes = save_file(params, os.path.join(tmp, PARAMS_FILE))
            nbytes += save_file(opt, os.path.join(tmp, OPT_FILE))
            meta = json.dumps({"format": _FORMAT, "step": job.step,
                               "ints": job.ints,
                               "params": list(params)}).encode()
            with open(os.path.join(tmp, META_FILE), "wb") as f:
                f.write(meta)
                f.flush()
                os.fsync(f.fileno())
            nbytes += len(meta)
            _fsync_dir(tmp)
            os.rename(tmp, self._step_dir(job.step))
            _fsync_dir(self.directory)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(self._step_dir(old), ignore_errors=True)
        job.record.update(d2h_s=t1 - t0, write_s=time.perf_counter() - t0,
                          bytes=nbytes)

    def _raise_error(self) -> None:
        if self._error is not None:
            err, step = self._error, self._error_step
            self._error = self._error_step = None
            raise RuntimeError(f"checkpoint save of step {step} to "
                               f"{self.directory} failed: {err!r}") from err

    def wait(self) -> None:
        """Block until the save in flight is on disk; raise the writer's
        error if it failed."""
        if self._job is not None:
            self._job.done.wait()
        self._raise_error()

    def close(self) -> None:
        try:
            self.wait()
        finally:
            if self._thread is not None:
                self._queue.put(None)
                self._thread.join()
                self._thread = None

    def __enter__(self) -> "CheckpointManager":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # --------------------------------------------------------- reading

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def all_steps(self) -> list[int]:
        """Complete steps on disk, ascending (a directory counts once its
        ``meta.json`` is there; temporary ones never do)."""
        steps = []
        for name in os.listdir(self.directory):
            if name.isdigit() and os.path.isfile(
                    os.path.join(self.directory, name, META_FILE)):
                steps.append(int(name))
        return sorted(steps)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _resolve(self, step: int | None) -> int:
        self.wait()  # a save in flight lands before it is read
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(
                f"no checkpoint steps in {self.directory}")
        if not os.path.isfile(os.path.join(self._step_dir(step),
                                           META_FILE)):
            raise FileNotFoundError(f"no complete checkpoint of step "
                                    f"{step} in {self.directory}")
        return step

    def restore_params(self, step: int | None = None,
                       device: str | torch.device = "cuda", mesh=None,
                       rules=None) -> dict:
        """The params tree of ``step`` (latest if None) on ``device``,
        whichever optimizer wrote it: only the params file is read, no
        optimizer byte. On a ``mesh`` each leaf is this rank's slice
        under ``rules``, as a DTensor."""
        d = self._step_dir(self._resolve(step))
        f = SafeTensorsFile(os.path.join(d, PARAMS_FILE))
        with open(os.path.join(d, META_FILE)) as fh:
            order = json.load(fh)["params"]
        if mesh is None:
            return _nest({k: f.tensor(k).to(device, copy=True)
                          for k in order})
        out = {}
        for k in order:
            full = f.tensor(k)
            spec = sharding.spec_for(k, rules)
            out[k] = sharding.to_dtensor(
                sharding.local_slice(full, spec, mesh).to(device, copy=True)
                .contiguous(), spec, mesh, full.shape)
        return _nest(out)

    def restore(self, cfg, optimizer, step: int | None = None,
                device: str | torch.device = "cuda",
                mesh=None, rules=None) -> TrainState:
        """The ``TrainState`` of ``step`` (latest if None) on ``device``;
        the params must fit ``cfg`` and the optimizer state ``optimizer``
        (its structure comes from ``optimizer.init`` on meta tensors, or,
        on a ``mesh``, on the restored shards, placed by ``rules``: the
        family's if None)."""
        step = self._resolve(step)
        params = self.restore_params(step, device, mesh,
                                     rules or model_fns(cfg)[2])
        check_params(params, cfg, f"checkpoint step {step}")
        if mesh is None:
            opt_target = optimizer.init(tree_map(
                lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"),
                params))
        else:
            opt_target = optimizer.init(params)
        meta_step, opt_state = self._restore_opt(step, opt_target, device)
        return TrainState(meta_step, params, opt_state)

    def restore_with_target(self, target: TrainState,
                            step: int | None = None,
                            device: str | torch.device = "cuda"
                            ) -> TrainState:
        """The ``TrainState`` of ``step`` (latest if None) on ``device``
        in ``target``'s structure: its params and optimizer state as meta
        tensors (only shapes and dtypes are read). The seam for a state
        no model config describes, such as LoRA's adapter-only one
        (train/lora.py ``lora_abstract_state``)."""
        step = self._resolve(step)
        params = self.restore_params_with_target(target.params, step,
                                                 device)
        meta_step, opt_state = self._restore_opt(step, target.opt_state,
                                                 device)
        return TrainState(meta_step, params, opt_state)

    def restore_params_with_target(self, target: dict,
                                   step: int | None = None,
                                   device: str | torch.device = "cuda"
                                   ) -> dict:
        """The params of ``step`` (latest if None) in ``target``'s
        structure, whichever optimizer wrote them: every params tensor on
        disk must be in ``target`` with its shape and dtype."""
        step = self._resolve(step)
        d = self._step_dir(step)
        with open(os.path.join(d, META_FILE)) as fh:
            on_disk = json.load(fh)["params"]
        want: dict = {}
        _flatten(target, "", want, {})
        if set(on_disk) != set(want):
            raise ValueError(f"checkpoint step {step}: params "
                             f"{sorted(set(on_disk) ^ set(want))} differ "
                             f"from the target's")
        return _fill(target, "", _reader(
            SafeTensorsFile(os.path.join(d, PARAMS_FILE)), step, "params",
            device), {})

    def _restore_opt(self, step: int, target, device) -> tuple[int, Any]:
        """(the step of ``meta.json``, the optimizer state of ``step`` in
        ``target``'s structure)."""
        d = self._step_dir(step)
        with open(os.path.join(d, META_FILE)) as fh:
            meta = json.load(fh)
        read = _reader(SafeTensorsFile(os.path.join(d, OPT_FILE)), step,
                       "optimizer", device)
        return int(meta["step"]), _fill(target, "", read, meta["ints"])


def _reader(f: SafeTensorsFile, step: int, what: str, device):
    """``read(path, like)`` for ``_fill``: the tensor at ``path`` on
    ``device``, refused unless it is there with ``like``'s shape and
    dtype."""
    def read(path, like):
        if path not in f:
            raise ValueError(f"checkpoint step {step} has no {what} tensor "
                             f"{path!r}: it was written by another "
                             f"optimizer or model")
        got = f.tensor(path)
        if _is_dt(like):
            if (got.numel() != like.numel() or got.dtype != like.dtype
                    or tuple(got.shape) != _file_shape(path, like)):
                raise ValueError(f"{what} tensor {path!r}: "
                                 f"{got.dtype}{tuple(got.shape)} on disk, "
                                 f"{like.dtype}{tuple(like.shape)} expected")
            return like.__class__.from_local(
                _local_of(got, like).to(device, copy=True).contiguous(),
                like.device_mesh, like.placements, run_check=False,
                shape=like.shape, stride=like.stride())
        if got.shape != like.shape or got.dtype != like.dtype:
            raise ValueError(f"{what} tensor {path!r}: "
                             f"{got.dtype}{tuple(got.shape)} on disk, "
                             f"{like.dtype}{tuple(like.shape)} expected")
        return got.to(device, copy=True)

    return read


def check_params(params: dict, cfg, what: str) -> None:
    """Raise unless ``params`` has exactly ``cfg``'s leaves, shapes and
    dtypes (``models.param_dtypes``: the MoE router is f32)."""
    got: dict = {}
    _flatten(params, "", got, {})
    expected: dict = {}
    _collect_leaves(param_shapes(cfg), "", expected, tuple)
    dtypes: dict = {}
    _collect_leaves(param_dtypes(cfg), "", dtypes, lambda d: d)
    if set(got) != set(expected):
        raise ValueError(f"{what}: leaves {sorted(set(got) ^ set(expected))}"
                         f" differ from the config's")
    for path, t in got.items():
        if tuple(t.shape) != expected[path] or t.dtype != dtypes[path]:
            raise ValueError(f"{what}: {path} is {t.dtype}"
                             f"{tuple(t.shape)}, the config wants "
                             f"{dtypes[path]}{expected[path]}")


def _collect_leaves(tree, prefix: str, out: dict, leaf) -> None:
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            _collect_leaves(v, path, out, leaf)
        else:
            out[path] = leaf(v)


def restore_model_params(directory, cfg, device: str | torch.device = "cuda",
                         mesh=None) -> tuple[dict, int]:
    """(params, step) of the latest checkpoint in ``directory``,
    params-only, checked against ``cfg``: what serving's ``--ckpt-dir``
    and the export CLI load (on a ``mesh``: this rank's shards). Raises
    FileNotFoundError for a missing or empty directory."""
    if not os.path.isdir(directory):
        raise FileNotFoundError(f"no checkpoint directory {directory}")
    mgr = CheckpointManager(directory)
    step = mgr._resolve(None)
    params = mgr.restore_params(step, device, mesh, model_fns(cfg)[2])
    check_params(params, cfg, f"checkpoint step {step} in {directory}")
    return params, step


def resume_or_init(
    directory: str | os.PathLike,
    cfg,
    device: str | torch.device,
    generator: torch.Generator | None = None,
    optimizer=None,
    max_to_keep: int = 3,
    mesh=None,
    rules=None,
) -> tuple[TrainState, Any, CheckpointManager]:
    """Restore the latest step of ``directory`` if there is one, else
    start fresh from ``generator``: the entry point a restarted trainer
    boots through (on a ``mesh``, whatever mesh wrote the step; its
    leaves placed by ``rules``, the family's if None)."""
    optimizer = optimizer or default_optimizer()
    mgr = CheckpointManager(directory, max_to_keep=max_to_keep)
    if mgr.latest_step() is not None:
        return (mgr.restore(cfg, optimizer, device=device, mesh=mesh,
                            rules=rules), optimizer, mgr)
    state, optimizer = create_train_state(cfg, device, generator, optimizer,
                                          mesh=mesh, rules=rules)
    return state, optimizer, mgr
