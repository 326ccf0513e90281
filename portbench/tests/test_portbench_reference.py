"""The plain reference (portbench/reference) agrees with the port at the
tiny sizes on the CPU in float32, where both compute the same equations
in the same precision."""

import dataclasses

import numpy as np
import pytest
import torch

from portbench.harness import model as hm
from portbench.reference.decoder import Decoder, served_logits
from portbench.reference.train import AdamInt8, TrainReference
from portbench.reference.train import batch as ref_batch
from portbench.tests.tiny import CONFIGS


def port(name):
    return hm.port_config(CONFIGS[name], remat=False)


@pytest.mark.parametrize("name", ["tiny", "moe-tiny"])
def test_forward_logits(name):
    from tpu_docker_api_torch.models import llama_forward, moe_forward

    cfg = port(name)
    params = hm.make_params(cfg, 7, torch.device("cpu"))
    tokens = torch.randint(0, 256, (3, 40), generator=torch.Generator()
                           .manual_seed(0))
    if name == "tiny":
        want = llama_forward(params, tokens, cfg)
    else:
        want, _ = moe_forward(params, tokens, cfg)
    got, _ = Decoder(CONFIGS[name], hm.flat(params)).forward(
        tokens, capacity=name == "moe-tiny")
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_capacity_drops_in_both():
    """A forward whose tokens crowd one expert drops choices in the port
    and the reference alike."""
    from tpu_docker_api_torch.models import moe_forward

    conf = {**CONFIGS["moe-tiny"], "assumed": {"capacity_factor": 0.5}}
    cfg = hm.port_config(conf, remat=False)
    params = hm.make_params(cfg, 3, torch.device("cpu"))
    tokens = torch.zeros((2, 24), dtype=torch.long)
    tokens[:, :5] = torch.arange(1, 6)
    want, _ = moe_forward(params, tokens, cfg)
    free, _ = Decoder(conf, hm.flat(params)).forward(tokens)
    got, _ = Decoder(conf, hm.flat(params)).forward(tokens, capacity=True)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert (got - free).abs().max() > 1e-2


@pytest.mark.parametrize("name", ["tiny", "moe-tiny"])
def test_served_logits_follow_the_cache(name):
    """Prefill then one token a step through the port's cache, against
    the reference's prompt-then-continuation."""
    from tpu_docker_api_torch.models import cached_forward_fn

    cfg = port(name)
    params = hm.make_params(cfg, 11, torch.device("cpu"))
    fwd = cached_forward_fn(cfg)
    prompt = list(range(3, 20))
    shape = (cfg.n_layers, 1, 32, cfg.n_kv_heads, cfg.head_dim)
    kc, vc = torch.zeros(shape), torch.zeros(shape)
    logits, kc, vc = fwd(params, torch.tensor([prompt]), cfg, kc, vc, 0,
                         last_only=True)
    rows, tok = [logits[0, -1]], int(logits[0, -1].argmax())
    served = [tok]
    for i in range(5):
        logits, kc, vc = fwd(params, torch.tensor([[tok]]), cfg, kc, vc,
                             torch.tensor([len(prompt) + i]))
        tok = int(logits[0, -1].argmax())
        rows.append(logits[0, -1])
        served.append(tok)
    got = served_logits(Decoder(CONFIGS[name], hm.flat(params)), prompt,
                        served)
    torch.testing.assert_close(got, torch.stack(rows[:len(served)]),
                               rtol=1e-4, atol=1e-4)


def test_loss_and_gradients():
    from tpu_docker_api_torch.models import llama_loss

    cfg = port("tiny")
    params = hm.make_params(cfg, 5, torch.device("cpu"))
    tokens = torch.randint(0, 256, (2, 33), generator=torch.Generator()
                           .manual_seed(1))
    live = {k: v.clone().requires_grad_() for k, v in hm.flat(params).items()}
    tree = {}
    for path, t in live.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = t
    want = llama_loss(tree, tokens, cfg)
    want_g = torch.autograd.grad(want, list(live.values()))
    mine = {k: v.detach().clone().requires_grad_() for k, v in live.items()}
    ref = TrainReference(CONFIGS["tiny"], mine, block=8)
    got = ref.loss(mine, tokens)
    got_g = torch.autograd.grad(got, list(mine.values()))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    for a, b in zip(got_g, want_g):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def test_adam_int8_is_the_ports_update():
    from tpu_docker_api_torch.train.optim import adamw_int8

    g = torch.Generator().manual_seed(2)
    p = {"a": torch.randn(4, 512, generator=g) * 0.02,
         "b": torch.randn(300, generator=g) * 0.02}
    opt = adamw_int8(lr=3e-4, weight_decay=0.1, clip_norm=1.0)
    state = opt.init(p)
    ref = AdamInt8({k: v.clone() for k, v in p.items()}, lr=3e-4, b1=0.9,
                   b2=0.95, eps=1e-8, weight_decay=0.1, clip_norm=1.0)
    mine = {k: v.clone() for k, v in p.items()}
    for step in range(3):
        grads = {k: torch.randn(v.shape, generator=g) * (3.0 if step else .1)
                 for k, v in p.items()}
        upd, state = opt.update(grads, state, p)
        p = {k: p[k] + upd[k] for k in p}
        ref.step(mine, dict(grads))
    for k in p:
        torch.testing.assert_close(mine[k], p[k], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("native", ["0", "1"])
def test_batches_are_the_loaders(tmp_path, monkeypatch, native):
    from tpu_docker_api_torch.data.loader import (make_batch_fn,
                                                  open_token_files)

    monkeypatch.setenv("TPU_DOCKER_API_NATIVE_DATA", native)
    toks = np.random.default_rng(0).integers(0, 32768, 20000,
                                             dtype=np.uint16)
    path = tmp_path / "c.bin"
    toks.tofile(path)
    seed = 2**31 + 11
    fn = make_batch_fn(open_token_files(path, window=65), 4, seed=seed)
    for step in (0, 1, 2, 77):
        np.testing.assert_array_equal(ref_batch(toks, 65, 4, seed, step),
                                      fn(step))


def test_weights_are_a_function_of_the_seed():
    cfg = dataclasses.replace(port("moe-tiny"))
    a = hm.flat(hm.make_params(cfg, 2**31 + 3, torch.device("cpu")))
    b = hm.flat(hm.make_params(cfg, 2**31 + 3, torch.device("cpu")))
    c = hm.flat(hm.make_params(cfg, 4, torch.device("cpu")))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["layers/attn/wq"], c["layers/attn/wq"])
