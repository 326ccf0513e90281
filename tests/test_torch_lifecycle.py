"""``chip_smoke.py``'s lifecycle phase at the tiny preset on the CPU:
train → checkpoint → resume → SIGTERM quiesce → export → serve, through
the command-line entry points in process. The phase's own checks hold
here as on the card (a resumed and a quiesced-and-restarted run equal an
uninterrupted one bit for bit; the ``--hf-ckpt`` and ``--ckpt-dir``
servers answer with the greedy tokens of the restored params in
memory); only the launch counts stay 0, since on the CPU the wrappers
run the kernels' plain versions."""

import pytest
import torch

import chip_smoke


def test_lifecycle_phase_on_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)  # the phase writes under ./build
    res = chip_smoke.phase_lifecycle(torch.device("cpu"), "tiny", 2, 32)
    assert res["B_vs_A"]["bit_equal"] and res["C_vs_A"]["bit_equal"]
    # 12 params leaves, and for each the int8 mu and nu and their scales
    assert res["B_vs_A"]["leaves"] == 12 * 5
    assert res["losses_equal"]
    assert res["losses"]["A"][2:] == res["losses"]["B"][2:]
    assert res["quiesce"] == {"event": "quiesced", "step": 2}
    assert [s["step"] for s in res["saves"]] == [4, 2, 4, 2, 4]
    assert all(s["bytes"] > 0 for s in res["saves"])
    assert res["serve_ckpt"]["step"] == 4
    assert res["serve_hf"]["model"] == "export"
    assert len(res["greedy_tokens"]) == chip_smoke.LIFECYCLE_MAX_NEW
    assert set(res["launches"].values()) == {0}
    # the trainers read through the native batcher, numpy's batches
    assert res["loader"]["native"] and res["loader"]["dtype"] == "uint16"
    assert res["loader"]["run_a_lookahead_hits"] >= 1
    assert res["loader"]["trainer_hits"] >= res["loader"][
        "run_a_lookahead_hits"]
    assert not (tmp_path / "build" / "lifecycle").exists()  # cleaned up
    assert '"phase": "lifecycle"' in capsys.readouterr().out


def test_lifecycle_phase_at_a_cut_depth_on_cpu(tmp_path, monkeypatch):
    """The card's run cuts llama3-1b to 8 of its layers: every entry
    point in process resolves the cut preset at the preset's width with
    fewer layers, and the phase's checks hold as at full depth."""
    from tpu_docker_api_torch.models import llama_presets, resolve_preset

    monkeypatch.chdir(tmp_path)
    res = chip_smoke.phase_lifecycle(torch.device("cpu"), "tiny", 2, 32, 1)
    full = llama_presets()["tiny"]
    assert res["preset"] == "tiny@1" and res["layers"] == 1 < full.n_layers
    assert res["B_vs_A"]["bit_equal"] and res["C_vs_A"]["bit_equal"]
    assert res["losses_equal"] and res["serve_ckpt"]["step"] == 4
    assert res["serve_hf"]["model"] == "export"
    # the cut is scoped to the phase
    assert resolve_preset("tiny")[1] == full
    with pytest.raises(KeyError):
        resolve_preset("tiny@1")
