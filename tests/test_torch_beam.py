"""Beam search in the port (paddle_tpu_torch/text/generate.py
``beam_search``, the Engine's ``beam`` kind) against the JAX package, on
the CPU — the cases of ``tests/test_generate.py``'s ``TestBeamSearch`` on
fp32 models in both packages:

* one beam is greedy ``generate``;
* a search of V ** m beams is exhaustive: it returns the best path by
  brute force (its score within 1e-5 of the path's summed log-probs);
* a beam that emits ``eos_id`` stays finished (an eos-padded tail);
* more beams never lower the best score;
* tokens exactly JAX's, scores within 1e-5, over widths, eos and a
  length penalty — the tie rule included: the duplicate beams' -1e30
  candidates tie at the first expansion, and the port's stable sort
  keeps ``jax.lax.top_k``'s lower-index-first order.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.text import generate as JG
from paddle_tpu.text import gpt as jgpt
from paddle_tpu_torch import convert
from paddle_tpu_torch.text import engine
from paddle_tpu_torch.text import generate as G


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _pair(V, seed, **over):
    jcfg = jgpt.GPTConfig(vocab_size=V, hidden_size=32, num_layers=2,
                          num_heads=4, max_seq_len=16, dtype=jnp.float32,
                          **over)
    jp = jax.device_get(jgpt.init_params(jcfg, jax.random.PRNGKey(seed)))
    return jcfg, jp, convert.config_from_jax(jcfg), \
        convert.params_from_jax(jp)


def _beam(params, cfg, prompt, **kw):
    toks, score = G.beam_search(params, cfg, prompt, device="cpu", **kw)
    engine.ENGINE.purge(cfg)
    return toks.numpy(), score.numpy()


def test_beam_one_equals_greedy():
    _, _, cfg, params = _pair(16, 0)
    prompt = np.asarray([[3, 7, 1], [5, 2, 9]])
    greedy = G.generate(params, cfg, prompt, 6, device="cpu").numpy()
    toks, _ = _beam(params, cfg, prompt, max_new_tokens=6, num_beams=1)
    np.testing.assert_array_equal(toks, greedy)


def test_exhaustive_width_finds_optimum():
    """num_beams = V ** max_new makes the search exhaustive: the result is
    the true best path, checked by brute force over the port's decode
    steps."""
    _, _, cfg, params = _pair(4, 1)
    prompt, V, m = [2, 0], 4, 2

    def path_score(seq):
        cache = G.init_cache(cfg, 1, 16, "cpu")
        feed = prompt + list(seq)
        score = 0.0
        for pos, tok in enumerate(feed[:-1]):
            lg, _ = G.decode_step(params, cache, torch.tensor([tok]), pos,
                                  cfg)
            if pos >= len(prompt) - 1:
                score += float(torch.log_softmax(lg[0], -1)[feed[pos + 1]])
        return score

    scores = {(a, b): path_score((a, b)) for a in range(V) for b in range(V)}
    best = max(scores, key=scores.get)
    toks, sc = _beam(params, cfg, np.asarray([prompt]), max_new_tokens=m,
                     num_beams=V ** m)
    assert tuple(toks[0, len(prompt):]) == best
    np.testing.assert_allclose(float(sc[0]), scores[best], atol=1e-5)


def test_eos_freezes_finished_beams():
    _, _, cfg, params = _pair(8, 2)
    toks, _ = _beam(params, cfg, np.asarray([[3, 1]]), max_new_tokens=10,
                    num_beams=4, eos_id=2)
    out = list(toks[0, 2:])
    if 2 in out:
        i = out.index(2)
        assert all(t == 2 for t in out[i:]), out


def test_beam_width_monotone():
    _, _, cfg, params = _pair(6, 3)
    prompt = np.asarray([[1, 4]])
    prev = None
    for W in (1, 2, 8):
        _, sc = _beam(params, cfg, prompt, max_new_tokens=3, num_beams=W)
        if prev is not None:
            assert float(sc[0]) >= prev - 1e-5, (W, float(sc[0]), prev)
        prev = float(sc[0])


@pytest.mark.parametrize("V,seed,prompt,kw", [
    (16, 0, [[3, 7, 1], [5, 2, 9]], dict(max_new_tokens=6, num_beams=4)),
    (4, 1, [[2, 0]], dict(max_new_tokens=2, num_beams=16)),
    (8, 2, [[3, 1]], dict(max_new_tokens=10, num_beams=4, eos_id=2)),
    (12, 4, [[1, 4, 9, 2]], dict(max_new_tokens=8, num_beams=3,
                                 length_penalty=0.7, eos_id=5)),
    (16, 5, [[7]], dict(max_new_tokens=5, num_beams=2))],
    ids=["w4", "exhaustive", "eos", "penalty_eos", "one_token_prompt"])
def test_beam_matches_jax(V, seed, prompt, kw):
    """The port's tokens are JAX's exactly and its scores within 1e-5."""
    jcfg, jp, cfg, params = _pair(V, seed)
    jt, js = JG.beam_search(jp, jcfg, np.asarray(prompt, np.int32), **kw)
    toks, sc = _beam(params, cfg, np.asarray(prompt), **kw)
    np.testing.assert_array_equal(toks, np.asarray(jt))
    np.testing.assert_allclose(sc, np.asarray(js), atol=1e-5, rtol=0)


def test_beam_refuses_bad_arguments():
    _, _, cfg, params = _pair(8, 0)
    with pytest.raises(ValueError, match="num_beams"):
        G.beam_search(params, cfg, [[1]], 4, num_beams=0, device="cpu")
    with pytest.raises(ValueError, match="max_seq_len"):
        G.beam_search(params, cfg, [[1]], 16, device="cpu")
