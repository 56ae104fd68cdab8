"""Offline speculative decoding in the port (paddle_tpu_torch/text/
generate.py: ``verify_chunk``, ``verify_chunk_batched``,
``kv_pool.paged_verify_chunk_batched``, ``speculative_generate``,
``_filtered_probs``) against the JAX package, on the CPU — the cases of
``tests/test_speculative.py`` held to JAX on the same numpy inputs:

* verify logits: row j of a K-token chunk equals the stepwise decode
  step's logits after the same prefix (fp32: 1e-5), MHA and GQA, and
  equals JAX's ``verify_chunk`` within 1e-5; the batched verify at
  per-slot positions, contiguous and paged, equals JAX's per-slot
  ``verify_chunk`` (logits and every written row within 1e-5; rows it
  does not write untouched);
* greedy: the output is exactly the target's greedy generation and the
  JAX package's ``speculative_generate`` with a good draft (the target
  itself), a bad one (random init) and a smaller architecture, on the
  trained ``markov_gpt`` computed in fp32;
* sampled: ``_filtered_probs`` equals JAX's (1e-12) and matches the
  port's device sampler by chi-square; the second generated token of
  sampled speculation follows the target's exact two-step law (computed
  by the port, equal to JAX's within 1e-6) — plain, under top-p and
  under top-k — by chi-square; one key gives one output.  The port's
  host streams are not ``jax.random``'s, so sampled paths are held by
  law, as the JAX suite holds its own.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.text import generate as JG
from paddle_tpu.text import gpt as jgpt
from paddle_tpu_torch import convert
from paddle_tpu_torch.text import generate as G
from paddle_tpu_torch.text import gpt, kv_pool


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny steps: one intra-op thread runs them far faster than a pool
    contending for a shared CPU."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _pair(seed, **over):
    """The reference suite's random model (vocab 32, 2 layers), fp32 in
    both packages: (jcfg, jparams, cfg, params)."""
    kw = dict(vocab_size=32, hidden_size=32, num_layers=2, num_heads=4,
              max_seq_len=64, dtype=jnp.float32)
    kw.update(over)
    jcfg = jgpt.GPTConfig(**kw)
    jp = jax.device_get(jgpt.init_params(jcfg, jax.random.PRNGKey(seed)))
    return jcfg, jp, convert.config_from_jax(jcfg), \
        convert.params_from_jax(jp)


@pytest.fixture(scope="module")
def markov(markov_gpt):
    """The trained ``markov_gpt``, computed in fp32 by both packages."""
    jcfg, jparams = markov_gpt
    return (dataclasses.replace(jcfg, dtype=jnp.float32), jparams,
            dataclasses.replace(convert.config_from_jax(jcfg),
                                dtype=torch.float32),
            convert.params_from_jax(jparams))


def _stepwise(params, cfg, seq, upto, rows=16):
    """The port's decode_step logits at every position >= ``upto`` after
    feeding ``seq`` token by token, and a cache holding rows [0, upto)."""
    cache = G.init_cache(cfg, 1, rows, "cpu")
    want = []
    for pos, tok in enumerate(seq):
        lg, _ = G.decode_step(params, cache, torch.tensor([tok]), pos, cfg)
        if pos >= upto:
            want.append(lg[0])
    part = G.init_cache(cfg, 1, rows, "cpu")
    for pos in range(upto):
        G.decode_step(params, part, torch.tensor([seq[pos]]), pos, cfg)
    return (torch.stack(want) if want else None), part


@pytest.mark.parametrize("over,seq,pos0", [
    ({}, [5, 3, 9, 1, 7, 4], 2),
    (dict(num_kv_heads=2), [5, 3, 9, 1], 0),
    (dict(num_kv_heads=1, pos_embed="rope", norm="rmsnorm",
          activation="swiglu"), [5, 3, 9, 1, 7], 1)],
    ids=["mha", "gqa", "rope_mqa"])
def test_verify_chunk_matches_stepwise_and_jax(over, seq, pos0):
    """Row j of verify_chunk == the decode step's logits after the same
    prefix (fp32, 1e-5), and == JAX's verify_chunk on the same weights;
    the chunk's rows are the stepwise rows."""
    jcfg, jp, cfg, params = _pair(1, **over)
    want, part = _stepwise(params, cfg, seq, pos0)
    _, full = _stepwise(params, cfg, seq, len(seq))
    got, part = G.verify_chunk(params, part, torch.tensor([seq[pos0:]]),
                               pos0, cfg)
    np.testing.assert_allclose(got[0].numpy(), want.numpy(), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(part["k"][:, :, :len(seq)].numpy(),
                               full["k"][:, :, :len(seq)].numpy(), atol=1e-5,
                               rtol=0)
    jcache = JG.init_cache(jcfg, 1, 16)
    for pos in range(pos0):
        _, jcache = JG.decode_step(jp, jcache,
                                   jnp.asarray([seq[pos]], jnp.int32), pos,
                                   jcfg)
    jl, _ = JG.verify_chunk(jp, jcache, jnp.asarray([seq[pos0:]], jnp.int32),
                            jnp.asarray(pos0), jcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(jl), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_batched_verify_at_per_slot_positions_matches_jax(layout):
    """Three slots at positions 3, 9 and 5 over a randomly filled cache,
    K = 4: the batched verify's logits and written rows equal JAX's
    per-slot ``verify_chunk`` on the same cache (1e-5); every row it
    does not write keeps its bits.  Paged: the same through shuffled
    block tables (block size 8, so slot 1's rows 9..12 and slot 2's
    5..8 cross a block boundary), the pool's live blocks compared."""
    jcfg, jp, cfg, params = _pair(2, num_kv_heads=2)
    B, T, K = 3, 24, 4
    pos = np.array([3, 9, 5], np.int32)
    rng = np.random.default_rng(0)
    shape = (cfg.num_layers, B, T, cfg.kv_heads, cfg.head_dim)
    fill = {n: rng.standard_normal(shape).astype(np.float32)
            for n in ("k", "v")}
    tokens = rng.integers(0, 32, (B, K))
    jrows, jlogits = {}, []
    for b in range(B):
        jc = {n: jnp.asarray(v[:, b:b + 1]) for n, v in fill.items()}
        jl, jc = JG.verify_chunk(jp, jc, jnp.asarray(tokens[b:b + 1],
                                                     jnp.int32),
                                 jnp.asarray(int(pos[b])), jcfg)
        jlogits.append(np.asarray(jl)[0])
        for n in jc:
            jrows.setdefault(n, []).append(np.asarray(jc[n])[:, 0])
    want = {n: np.stack(v, 1) for n, v in jrows.items()}
    if layout == "contiguous":
        cache = {n: torch.from_numpy(v.copy()) for n, v in fill.items()}
        logits, cache = G.verify_chunk_batched(
            params, cache, torch.from_numpy(tokens), torch.from_numpy(pos),
            cfg)
        got = {n: v.numpy() for n, v in cache.items()}
    else:
        bs, nmax = 8, T // 8
        cache = G.init_cache(cfg, B, T, "cpu", layout="paged", block_size=bs,
                             num_blocks=B * nmax)
        perm = torch.randperm(B * nmax,
                              generator=torch.Generator().manual_seed(1))
        cache["tables"][:] = perm.reshape(B, nmax).to(torch.int32)
        for n, v in fill.items():
            for b in range(B):
                for j in range(nmax):
                    cache[n][:, perm[b * nmax + j]] = torch.from_numpy(
                        v[:, b, j * bs:(j + 1) * bs])
        logits, cache = kv_pool.paged_verify_chunk_batched(
            params, cache, torch.from_numpy(tokens), torch.from_numpy(pos),
            cfg)
        got = {n: np.stack([np.concatenate(
            [cache[n][:, perm[b * nmax + j]].numpy() for j in range(nmax)],
            axis=1) for b in range(B)], 1) for n in ("k", "v")}
    np.testing.assert_allclose(logits.numpy(), np.stack(jlogits), atol=1e-5,
                               rtol=0)
    for n in ("k", "v"):
        np.testing.assert_allclose(got[n], want[n], atol=1e-5, rtol=0)
        for b in range(B):
            outside = np.ones(T, bool)
            outside[pos[b]:pos[b] + K] = False
            assert np.array_equal(got[n][:, b, outside],
                                  fill[n][:, b, outside])


def _target_greedy(params, cfg, prompt, max_new):
    out = G.generate(params, cfg, [prompt], max_new, device="cpu")
    return out[0, len(prompt):].tolist()


def _jax_spec(jtp, jtcfg, jdp, jdcfg, prompt, max_new, k):
    return [int(t) for t in JG.speculative_generate(
        jtp, jtcfg, jdp, jdcfg, prompt, max_new_tokens=max_new, k=k)]


@pytest.mark.parametrize("draft", ["good", "bad", "smaller"])
def test_speculative_equals_target_greedy_and_jax(markov, draft):
    """Greedy speculation is exactly the target's greedy generation,
    whatever the draft — itself (every proposal accepted), a random-init
    model (almost every proposal rejected) or a smaller architecture —
    and exactly the JAX package's output on the same weights."""
    jcfg, jparams, cfg, params = markov
    if draft == "good":
        jdcfg, jdp, dcfg, dparams = jcfg, jparams, cfg, params
        prompt, max_new, k = [2, 7], 10, 4
    elif draft == "bad":
        jdp = jax.device_get(jgpt.init_params(jcfg, jax.random.PRNGKey(99)))
        jdcfg, dcfg, dparams = jcfg, cfg, convert.params_from_jax(jdp)
        prompt, max_new, k = [2, 7], 10, 4
    else:
        jdcfg = jgpt.GPTConfig(vocab_size=cfg.vocab_size, hidden_size=32,
                               num_layers=1, num_heads=2, max_seq_len=32,
                               dtype=jnp.float32)
        jdp = jax.device_get(jgpt.init_params(jdcfg, jax.random.PRNGKey(5)))
        dcfg, dparams = (convert.config_from_jax(jdcfg),
                         convert.params_from_jax(jdp))
        prompt, max_new, k = [11], 8, 3
    want = _target_greedy(params, cfg, prompt, max_new)
    got = G.speculative_generate(params, cfg, dparams, dcfg, prompt,
                                 max_new_tokens=max_new, k=k, device="cpu")
    assert got == want
    assert got == _jax_spec(jparams, jcfg, jdp, jdcfg, prompt, max_new, k)


# ---------------------------------------------------------------------------
# sampled speculation: the output law is the target's
# ---------------------------------------------------------------------------


def _law_after(params, cfg, prompt, temperature, top_k, top_p):
    """The port target's exact filtered next-token law after ``prompt``."""
    cache = G.init_cache(cfg, 1, cfg.max_seq_len, "cpu")
    for pos, tok in enumerate(prompt):
        lg, _ = G.decode_step(params, cache, torch.tensor([tok]), pos, cfg)
    return G._filtered_probs(lg[0].numpy(), temperature, top_k, top_p)


def _second_token_law(params, cfg, prompt, temperature, top_k, top_p):
    """Exact marginal of generated token #2 (enumerable at vocab 12)."""
    p0 = _law_after(params, cfg, prompt, temperature, top_k, top_p)
    law = np.zeros_like(p0)
    for t1 in np.nonzero(p0 > 0)[0]:
        law += p0[t1] * _law_after(params, cfg, prompt + [int(t1)],
                                   temperature, top_k, top_p)
    return law


def _chi2(counts, law, n):
    keep = law * n >= 5          # the chi-square validity threshold
    o = np.concatenate([counts[keep], [counts[~keep].sum()]])
    e = np.concatenate([law[keep] * n, [law[~keep].sum() * n]])
    e = np.maximum(e, 1e-12)
    return float(((o - e) ** 2 / e).sum()), int(keep.sum())


@pytest.fixture(scope="module")
def law_models():
    """The sampled cases' target (seed 3) and draft (seed 9), vocab 12."""
    return (_pair(3, vocab_size=12, max_seq_len=16),
            _pair(9, vocab_size=12, max_seq_len=16))


def test_filtered_probs_matches_jax_and_the_device_sampler(law_models):
    """The host law equals JAX's ``_filtered_probs`` (float64, 1e-12) on
    the same logits, and the port's ``generate`` draws by it (chi-square
    over 400 draws, support respected)."""
    (jcfg, jp, cfg, params), _ = law_models
    prompt = [4, 7]
    n = 400
    logits = np.random.default_rng(0).standard_normal(12) * 3
    for temperature, top_k, top_p in ((1.3, 0, 1.0), (0.9, 0, 0.7),
                                      (1.0, 4, 1.0)):
        np.testing.assert_allclose(
            G._filtered_probs(logits, temperature, top_k, top_p),
            JG._filtered_probs(logits, temperature, top_k, top_p),
            atol=1e-12, rtol=0)
        law = _law_after(params, cfg, prompt, temperature, top_k, top_p)
        gen = torch.Generator().manual_seed(0)
        toks = [int(G.generate(params, cfg, [prompt], 1,
                               temperature=temperature, top_k=top_k,
                               top_p=top_p, generator=gen,
                               device="cpu")[0, -1]) for _ in range(n)]
        counts = np.bincount(toks, minlength=12).astype(float)
        stat, df = _chi2(counts, law, n)
        assert stat < 3 * max(df, 1) + 10, (temperature, top_k, top_p, stat)
        assert counts[law == 0].sum() == 0


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (1.3, 0, 1.0), (0.9, 0, 0.7), (1.0, 3, 1.0)],
    ids=["plain", "top_p", "top_k"])
def test_speculative_sampling_matches_target_law(law_models, temperature,
                                                 top_k, top_p):
    """Chi-square: the second generated token (the first the accept /
    resample rule produces) follows the target's exact marginal — with a
    same-architecture draft from another init, so rejections and
    residual draws really happen — and the port's law is JAX's."""
    (jcfg, jp, cfg, params), (_, _, _, dparams) = law_models
    prompt = [4, 7]
    n = 300
    law = _second_token_law(params, cfg, prompt, temperature, top_k, top_p)
    from test_speculative import _second_token_law as jax_law
    np.testing.assert_allclose(
        law, jax_law(jp, jcfg, prompt, temperature, top_k, top_p),
        atol=1e-6, rtol=0)
    toks = [G.speculative_generate(params, cfg, dparams, cfg, prompt,
                                   max_new_tokens=4, k=3,
                                   temperature=temperature, top_k=top_k,
                                   top_p=top_p, key=1000 + i,
                                   device="cpu")[1] for i in range(n)]
    counts = np.bincount(toks, minlength=12).astype(float)
    stat, df = _chi2(counts, law, n)
    assert stat < 3 * max(df, 1) + 10, stat
    assert counts[law == 0].sum() == 0


def test_speculative_sampling_deterministic_per_key(law_models):
    (_, _, cfg, params), (_, _, _, dparams) = law_models
    cfg32 = dataclasses.replace(cfg, max_seq_len=32)
    a, b, c = (G.speculative_generate(params, cfg32, dparams, cfg32, [4, 7],
                                      max_new_tokens=10, k=4,
                                      temperature=1.1, key=key,
                                      device="cpu")
               for key in (5, 5, 6))
    assert a == b and len(a) == 10
    assert all(0 <= t < 12 for t in c)
