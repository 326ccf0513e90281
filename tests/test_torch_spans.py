"""The model path's named ranges and counters (telemetry/profile.py
``span`` and ``ms_by_range``; the slot engines' ranges, ``decode_launch_s``
and ``Handle.admitted_at``; the train step's ranges; the loader's
``wait_count``), on the CPU at the tiny size."""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from tpu_docker_api_torch.data import loader
from tpu_docker_api_torch.infer.paged import PagedSlotEngine
from tpu_docker_api_torch.infer.slots import (ADMIT_RANGE,
                                              DECODE_LAUNCH_RANGE,
                                              PROCESS_RANGE, SlotEngine)
from tpu_docker_api_torch.models import llama as tl
from tpu_docker_api_torch.telemetry.profile import ms_by_range, span
from tpu_docker_api_torch.telemetry.trace import NOOP
from tpu_docker_api_torch.train.optim import adamw_int8
from tpu_docker_api_torch.train.trainer import (STEP_RANGES, TrainState,
                                                make_train_step)

MAX_SEQ = 64
ENGINE_RANGES = {ADMIT_RANGE, DECODE_LAUNCH_RANGE, PROCESS_RANGE}


@pytest.fixture(scope="module")
def model():
    cfg = dataclasses.replace(tl.llama_presets()["tiny"],
                              dtype=torch.float32)
    return cfg, tl.llama_init(cfg, torch.Generator().manual_seed(0))


ENGINES = {
    "dense": lambda cfg, p: SlotEngine(cfg, p, slots=4, chunk=4,
                                       max_seq=MAX_SEQ,
                                       cache_dtype=torch.float32),
    "segments": lambda cfg, p: SlotEngine(cfg, p, slots=4, chunk=4,
                                          max_seq=MAX_SEQ, prefill_chunk=8,
                                          cache_dtype=torch.float32),
    "paged": lambda cfg, p: PagedSlotEngine(cfg, p, page_size=16, slots=4,
                                            chunk=4, max_seq=MAX_SEQ,
                                            cache_dtype=torch.float32),
}


def _serve(eng, n=6, max_new=7):
    """``n`` requests of 3-20 tokens, stepped to completion."""
    rng = np.random.default_rng(3)
    hs = [eng.submit(rng.integers(1, 256, int(rng.integers(3, 21))).tolist(),
                     max_new) for _ in range(n)]
    for _ in range(10_000):
        if all(h.done() for h in hs):
            break
        eng.step()
    assert all(h.done() for h in hs)
    return hs


def _host_names(prof) -> set:
    return {e.name for e in prof.events() if e.device_type == DeviceType.CPU}


def test_span_is_the_shared_noop_without_a_profiler():
    assert span("anything") is NOOP
    with profile(activities=[ProfilerActivity.CPU]):
        assert span("anything") is not NOOP
    assert span("anything") is NOOP


@pytest.mark.parametrize("kind", sorted(ENGINES))
def test_engine_step_records_its_three_ranges(model, kind):
    eng = ENGINES[kind](*model)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _serve(eng)
    assert ENGINE_RANGES <= _host_names(prof)


@pytest.mark.parametrize("kind", sorted(ENGINES))
def test_admission_is_stamped_between_submit_and_first_token(model, kind):
    for h in _serve(ENGINES[kind](*model)):
        assert h.submitted_at <= h.admitted_at <= h.first_token_at


@pytest.mark.parametrize("kind", sorted(ENGINES))
def test_decode_launch_seconds_grow_with_chunks_and_survive_warmup(model,
                                                                   kind):
    eng = ENGINES[kind](*model)
    assert eng.stats["decode_launch_s"] == 0.0
    eng.warmup(buckets=(32,), rows=(1, 2))
    assert eng.stats["decode_launch_s"] == 0.0
    assert eng.stats["decode_chunks"] == 0
    _serve(eng, n=2)
    first = (eng.stats["decode_chunks"], eng.stats["decode_launch_s"])
    assert first[0] > 0 and first[1] > 0
    _serve(eng, n=2)
    assert eng.stats["decode_chunks"] > first[0]
    assert eng.stats["decode_launch_s"] > first[1]


def test_train_step_records_its_three_ranges(model):
    cfg, params = model
    opt = adamw_int8(lr=1e-3)
    step = make_train_step(cfg, opt)
    state = TrainState(0, params, opt.init(params))
    batch = torch.randint(0, cfg.vocab_size, (2, 17),
                          generator=torch.Generator().manual_seed(1))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, batch)
    assert set(STEP_RANGES) <= _host_names(prof)


@pytest.mark.parametrize("native", [False, True], ids=["numpy", "native"])
def test_wait_count_counts_a_batch_a_call(tmp_path, monkeypatch, native):
    monkeypatch.setenv("TPU_DOCKER_API_NATIVE_DATA", "1" if native else "0")
    path = loader.write_token_file(
        np.random.default_rng(0).integers(0, 256, 4000), tmp_path / "t.bin")
    fn = loader.make_batch_fn(loader.open_token_files(path, window=17), 4,
                              seed=1)
    assert isinstance(fn, loader._NativeBatcher) is native
    before = dict(loader.wait_count)
    for s in range(5):
        fn(s)
    assert loader.wait_count["batches"] == before["batches"] + 5
    assert loader.wait_count["wait_s"] > before["wait_s"]


def _event(name, start, end, *, device=DeviceType.CPU, id=0, thread=1):
    return SimpleNamespace(
        name=name, device_type=device, id=id, thread=thread,
        is_user_annotation=False,
        time_range=SimpleNamespace(start=start, end=end,
                                   elapsed_us=lambda: end - start))


def test_ms_by_range_gives_a_launch_on_another_thread_to_the_open_range():
    """The backward range is open on thread 1; autograd's thread 2
    launches the kernels. A kernel belongs to the range open when its
    CUDA API call (of its own id) ran: one launched inside a range nested
    in backward to the inner one; one whose id a framework op also
    carries (the two are counted apart) by its CUDA API call; one with no
    CUDA API call, or launched after both ranges closed, to none."""
    cuda = DeviceType.CUDA
    events = [
        _event("train_step.backward", 10, 100),
        _event("aten::mm", 20, 30, id=7, thread=2),
        _event("cudaLaunchKernel", 22, 23, id=501, thread=2),
        _event("gemm", 40, 60, device=cuda, id=501),
        _event("ste", 50, 70, thread=2),
        _event("aten::add", 54, 58, id=503, thread=2),
        _event("cuLaunchKernelEx", 55, 56, id=502, thread=2),
        _event("gemm", 60, 65, device=cuda, id=502),
        _event("cudaLaunchKernel", 80, 81, id=503, thread=2),
        _event("add_kernel", 95, 99, device=cuda, id=503),
        _event("orphan_kernel", 96, 97, device=cuda, id=600),
        _event("cudaLaunchKernel", 150, 151, id=504),
        _event("late_kernel", 155, 160, device=cuda, id=504),
    ]
    got = ms_by_range(events, ("train_step.backward", "ste"))
    assert got == {"train_step.backward": pytest.approx(0.024),
                   "ste": pytest.approx(0.005)}
    assert ms_by_range(events, ("absent",)) == {"absent": 0.0}
