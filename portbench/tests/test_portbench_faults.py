"""The check fails what it must: each fault a cell can have, planted
under the timed path, and the control (the reference in float8 put in
the program's place) come out as not correct. At the tiny sizes on the
CPU; ``test_control_on_the_card`` reads the control at a cell's own
size on the card."""

import json
import time

import pytest
import torch

from portbench.harness import spec
from portbench.harness.runner import run_cell

SEED = 2**31 + 41


def run(tiny_bench, name, **kw):
    root, pb = tiny_bench
    cell = spec.find_cell(name, root=root, portbench=pb)
    return cell, run_cell(cell, SEED, 3.0, False, torch.device("cpu"),
                          time.perf_counter(), portbench=pb, **kw)


@pytest.mark.parametrize("name", ["moe-tiny.chat", "tiny.rag"])
def test_a_token_altered_where_it_is_produced(tiny_bench, monkeypatch, name):
    from tpu_docker_api_torch.infer.slots import SlotEngine

    orig = SlotEngine._sample

    def altered(logits, temp, generator):
        return (orig(logits, temp, generator) + 1) % logits.shape[-1]

    monkeypatch.setattr(SlotEngine, "_sample", staticmethod(altered))
    _, out = run(tiny_bench, name)
    assert out["correct"] is False
    assert out["checks"]["served_gap"]["value"] > \
        out["checks"]["served_gap"]["limit"]


def test_a_step_that_returns_its_state_unchanged(tiny_bench, monkeypatch):
    from tpu_docker_api_torch.train import trainer

    orig = trainer.make_train_step

    def frozen(*a, **kw):
        step = orig(*a, **kw)

        def same(state, batch):
            _, metrics = step(state, batch)
            return state, metrics
        return same

    monkeypatch.setattr(trainer, "make_train_step", frozen)
    _, out = run(tiny_bench, "tiny.train")
    assert out["correct"] is False
    assert out["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_of_the_batch_left_out(tiny_bench, monkeypatch):
    import tpu_docker_api_torch.models as models

    orig = models.llama_loss

    def half(params, tokens, cfg, mesh=None):
        return orig(params, tokens[: tokens.shape[0] // 2], cfg, mesh)

    monkeypatch.setattr(models, "llama_loss", half)
    _, out = run(tiny_bench, "tiny.train")
    assert out["correct"] is False


@pytest.mark.parametrize("name", ["moe-tiny.chat", "tiny.train"])
def test_the_control_is_not_correct(tiny_bench, name):
    cell, out = run(tiny_bench, name, controls=True)
    assert out["correct"] is True
    ctl = out["controls"]
    assert any(ctl["control"][k] > cell.limits[k] for k in cell.limits)
    if "half_batch" in ctl:
        assert any(ctl["half_batch"][k] > cell.limits[k]
                   for k in cell.limits)


CARD_SEEDS = (2**31 + 101, 2**31 + 102, 2**31 + 103)


@pytest.mark.gpu
@pytest.mark.parametrize("workload", [
    "mixtral-8x7b-l16.chat-closed128", "mistral-7b-v0.3-l16.train-4k"])
def test_control_on_the_card(cuda_device, workload):
    """At the cell's own size, on three seeds: the control fails one of
    the cell's numbers on each, and the program passes them all."""
    cell = spec.find_cell(workload)
    seconds = 30.0 if cell.traffic["kind"] == "closed_serve" else 10.0
    for seed in CARD_SEEDS:
        out = run_cell(cell, seed, seconds, False, cuda_device,
                       time.perf_counter(), controls=True)
        ctl = out["controls"]
        print(json.dumps({"seed": seed, "checks": out["checks"],
                          "controls": ctl}))
        assert out["correct"]
        assert any(ctl["control"][k] > cell.limits[k] for k in cell.limits)
