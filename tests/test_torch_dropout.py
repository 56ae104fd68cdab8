"""Dropout in the port (``gpt._dropout``, drawn by ``paddle_tpu_torch/rng.py``)
held by law: ``jax.random``'s streams cannot be matched, so the port's
masks are checked for what the JAX package's dropout promises.

* rate 0, or no key (eval), is bit-equal to a model without dropout;
* the kept share is within 4 sigma of ``1 - rate``, and kept values are
  exactly ``x / keep``;
* the masks of every layer, site (attention projection, FFN), micro-batch
  and key differ: two of them agree on a share within 4 sigma of keep^2 +
  rate^2, as independent masks do; the same key draws the same mask;
* with dropout on, the grads under each remat policy are bit-equal to the
  grads without remat: the recompute draws the forward's masks again;
* the server's Gumbel noise, which moved into ``rng.py``, is the same
  function of (key, counter, element) it was.
"""
import dataclasses
import itertools
import math

import numpy as np
import pytest
import torch

from paddle_tpu_torch import rng
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.text import gpt, gpt_hybrid

RATE = 0.1
KEEP = 1.0 - RATE
CFG = gpt.GPTConfig(vocab_size=64, hidden_size=128, num_layers=2,
                    num_heads=4, max_seq_len=32, dtype=torch.float32,
                    dropout=RATE)
TOKENS = torch.from_numpy(np.random.default_rng(0).integers(0, 64, (2, 17)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _grads(cfg, key, params=None):
    params = params or gpt.init_master_params(cfg, seed=3, device="cpu")
    return gpt_hybrid.value_and_grad(
        lambda p, t: gpt.loss_fn(p, t, cfg, key=key), params, TOKENS)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _equal(a, b):
    (la, ga), (lb, gb) = a, b
    return torch.equal(la, lb) and all(
        torch.equal(x, y) for (_, x), (_, y) in zip(_leaves(ga), _leaves(gb)))


def test_rate_zero_or_no_key_is_no_dropout():
    off = _grads(dataclasses.replace(CFG, dropout=0.0), None)
    assert _equal(_grads(dataclasses.replace(CFG, dropout=0.0), 7), off)
    assert _equal(_grads(CFG, None), off)
    assert not _equal(_grads(CFG, 7), off)


def test_kept_share_and_scale():
    x = torch.rand(1000, 1000) + 0.5           # no zeros of its own
    y = gpt._dropout(x, RATE, rng.seed_key(1))
    kept = y != 0
    n = x.numel()
    sigma = math.sqrt(KEEP * RATE / n)
    assert abs(kept.float().mean().item() - KEEP) < 4 * sigma
    assert torch.equal(y[kept], x[kept] / KEEP)
    assert torch.equal(gpt._dropout(x, RATE, rng.seed_key(1)), y)
    assert y.dtype == x.dtype
    xb = x.to(torch.bfloat16)
    yb = gpt._dropout(xb, RATE, rng.seed_key(1))
    assert torch.equal(yb != 0, kept) and torch.equal(yb[kept], xb[kept]
                                                      / KEEP)


def _recorded_masks(monkeypatch, run):
    """(key, mask) of every dropout call ``run()`` makes, in order."""
    calls = []
    plain = gpt._dropout

    def record(x, rate, key):
        y = plain(x, rate, key)
        calls.append((int(key), (y != 0) | (x == 0)))
        return y

    monkeypatch.setattr(gpt, "_dropout", record)
    run()
    return calls


def test_masks_differ_across_layers_sites_microbatches_and_keys(
        monkeypatch):
    """Two train steps (keys 1 and 2) at accum 2: 2 keys x 2 micro-batches
    x 2 layers x 2 sites = 16 masks of [1, 16, 128], pairwise agreeing as
    independent masks do; the same step again draws the same masks."""
    opt = AdamW(learning_rate=1e-3)
    init_fn, step_fn, _ = gpt_hybrid.build_gpt_train_step(
        CFG, opt, accum=2, device="cpu")

    def run():
        for key in (1, 2):
            step_fn(init_fn(0), TOKENS, key, 1e-3)

    calls = _recorded_masks(monkeypatch, run)
    assert len(calls) == 16
    assert len({k for k, _ in calls}) == 16
    want = KEEP ** 2 + RATE ** 2
    n = calls[0][1].numel()
    sigma = math.sqrt(want * (1 - want) / n)
    for (_, a), (_, b) in itertools.combinations(calls, 2):
        agree = (a == b).float().mean().item()
        assert abs(agree - want) < 4 * sigma, agree
    again = _recorded_masks(monkeypatch, run)
    assert all(ka == kb and torch.equal(a, b)
               for (ka, a), (kb, b) in zip(calls, again))


def test_layer_and_site_keys_follow_the_schedule(monkeypatch):
    """Layer l draws under fold_in(key, l), its sites under fold_in(that,
    0) and fold_in(that, 1); micro-batch i of a step under fold_in(key,
    i)."""
    calls = _recorded_masks(monkeypatch, lambda: _grads(CFG, 5))
    want = [rng.fold_in(rng.fold_in(5, l), s) for l in range(2)
            for s in (0, 1)]
    assert [k for k, _ in calls] == want
    key = torch.tensor(5)
    tensor_calls = _recorded_masks(monkeypatch, lambda: _grads(CFG, key))
    assert [k for k, _ in tensor_calls] == want
    assert all(torch.equal(a, b) for (_, a), (_, b) in
               zip(calls, tensor_calls))


@pytest.mark.parametrize("policy", [None, "dots", "dots_no_batch",
                                    "everything"])
def test_grads_under_remat_are_bit_equal(policy):
    ref = _grads(CFG, 11)
    got = _grads(dataclasses.replace(CFG, remat=True, remat_policy=policy),
                 11)
    assert _equal(got, ref)


def test_server_gumbel_noise_is_unchanged():
    """The hash the server's sampling uses, written out: the same noise,
    bit for bit — the uniform on 2^23 midpoints, inside (0, 1) in
    float32, so the noise is finite everywhere."""
    M = 0xFFFFFFFF

    def mix(h):
        h = h ^ (h >> 16)
        h = (h * 0x7FEB352D) & M
        h = h ^ (h >> 15)
        h = (h * 0x5BD1E995) & M
        return h ^ (h >> 16)

    key = torch.tensor([rng.seed_key(3), (5 << 32) + 17])
    c = key[1]
    h = mix(mix(key[0] ^ (c & M)) ^ ((c >> 32) & M))
    idx = torch.arange(6 * 50, dtype=torch.int64).reshape(6, 50)
    bits = mix(mix(idx ^ h) ^ 0x3C6EF372)
    u = ((bits >> 9).to(torch.float32) + 0.5) * (1.0 / (1 << 23))
    assert torch.equal(rng.gumbel(key, (6, 50), "cpu"),
                       -torch.log(-torch.log(u)))
