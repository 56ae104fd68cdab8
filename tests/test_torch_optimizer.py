"""The port's optimizers (paddle_tpu_torch/optimizer) against the JAX
package's: the same parameter tree, the same numpy gradients, five steps
of ``apply_gradients``.

Tolerances: fp32 state — parameters and moments within 1e-6 per step (the
update is fp32 elementwise math in the same order; ``b ** t`` may round
one ulp apart between the libraries).  bf16 state — moments within one
bf16 step (2^-8 relative: a moment may round to the other neighbour
after a one-ulp fp32 difference), parameters within 1e-5.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu import optimizer as jopt
from paddle_tpu_torch import convert
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.optimizer.optimizer import keystr

SHAPES = {"wte": (16, 8), "ln_f_g": (8,),
          "blocks": {"qkv_w": (2, 3, 8, 8), "qkv_b": (2, 3, 8),
                     "ln1_g": (2, 8)}}


def _tree(fn, shapes=SHAPES, path=()):
    if isinstance(shapes, dict):
        return {k: _tree(fn, v, path + (k,)) for k, v in shapes.items()}
    return fn(shapes)


def _np_tree(rng, scale=1.0):
    return _tree(lambda s: (scale * rng.standard_normal(s)).astype(np.float32))


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _to_jax(t):
    return jax.tree_util.tree_map(jnp.asarray, t)


def _compare(tp, jp, tol, rtol=0.0):
    for path, t in _leaves(tp):
        np.testing.assert_allclose(t.float().numpy(),
                                   np.asarray(_get(jp, path), np.float32),
                                   atol=tol, rtol=rtol, err_msg=str(path))


def _run(make_j, make_t, grad_dtype=np.float32, steps=5, lr=1e-2):
    rng = np.random.default_rng(0)
    p0 = _np_tree(rng)
    jo, to = make_j(), make_t()
    jp, tp = _to_jax(p0), convert.params_from_jax(p0)
    js, ts = jo.init_state(jp), to.init_state(tp)
    for step in range(1, steps + 1):
        g = _np_tree(rng, 0.1)
        jg = jax.tree_util.tree_map(lambda a: jnp.asarray(a, grad_dtype), g)
        tg = convert.params_from_jax(jax.device_get(jg))
        jp, js = jo.apply_gradients(jg, jp, js, lr=lr, step=step)
        tp, ts = to.apply_gradients(tg, tp, ts, lr=lr, step=step)
        yield step, jp, js, tp, ts


@pytest.mark.parametrize("name,kw", [
    ("Adam", {}),
    ("Adam", dict(weight_decay=0.1)),         # coupled L2 into the grad
    ("AdamW", {}),
    ("AdamW", dict(weight_decay=0.05, beta1=0.8, beta2=0.99, epsilon=1e-6)),
])
def test_matches_jax_over_five_steps(name, kw):
    """Parameters and both moments, every step, fp32 state."""
    for _, jp, js, tp, ts in _run(
            lambda: getattr(jopt, name)(learning_rate=1e-2, **kw),
            lambda: getattr(topt, name)(learning_rate=1e-2, **kw)):
        _compare(tp, jp, 1e-6)
        for path, (m, v) in _leaves(ts):
            jm, jv = _get(js, path)
            np.testing.assert_allclose(m.numpy(), np.asarray(jm), atol=1e-6,
                                       rtol=1e-6)
            np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=1e-6,
                                       rtol=1e-6)


@pytest.mark.parametrize("grad_dtype", [np.float32, jnp.bfloat16])
def test_bf16_state_within_one_bf16_step(grad_dtype):
    """``state_dtype=bfloat16`` (the 1.3B rung's setting), with fp32 grads
    and with the bf16 grads an accumulating step hands over."""
    for _, jp, js, tp, ts in _run(
            lambda: jopt.AdamW(learning_rate=1e-2, weight_decay=0.01,
                               state_dtype=jnp.bfloat16),
            lambda: topt.AdamW(learning_rate=1e-2, weight_decay=0.01,
                               state_dtype=torch.bfloat16),
            grad_dtype=grad_dtype):
        _compare(tp, jp, 1e-5)
        for path, (m, v) in _leaves(ts):
            assert m.dtype == v.dtype == torch.bfloat16
            jm, jv = _get(js, path)
            for a, b in ((m, jm), (v, jv)):
                b = np.asarray(b, np.float32)
                np.testing.assert_allclose(a.float().numpy(), b, atol=0,
                                           rtol=2.0 ** -8)


def test_apply_decay_param_fun_sees_keystr_names():
    """The decay predicate receives the JAX ``keystr`` names, so one user
    function decides the same leaves in both packages (here: no decay on
    gains, biases or the embedding)."""
    seen = {"jax": [], "torch": []}

    def make(which, mod):
        def fn(name):
            seen[which].append(name)
            return not (name.endswith("_g']") or name.endswith("_b']")
                        or name == "['wte']")
        return lambda: mod.AdamW(learning_rate=1e-2, weight_decay=0.5,
                                 apply_decay_param_fun=fn)

    for _, jp, _, tp, _ in _run(make("jax", jopt), make("torch", topt),
                                steps=2):
        _compare(tp, jp, 1e-6)
    assert sorted(seen["jax"]) == sorted(seen["torch"])
    assert "['blocks']['qkv_w']" in seen["torch"]
    paths = jax.tree_util.tree_flatten_with_path(_to_jax(_np_tree(
        np.random.default_rng(0))))[0]
    assert sorted(jax.tree_util.keystr(p) for p, _ in paths) \
        == sorted(keystr(p) for p, _ in _leaves(SHAPES))


def test_opt_state_from_jax_resumes():
    """A JAX AdamW state carried across mid-run: the next step equals
    JAX's."""
    rng = np.random.default_rng(1)
    p0, g1, g2 = _np_tree(rng), _np_tree(rng, 0.1), _np_tree(rng, 0.1)
    jo = jopt.AdamW(learning_rate=1e-2, state_dtype=jnp.bfloat16)
    to = topt.AdamW(learning_rate=1e-2, state_dtype=torch.bfloat16)
    jp = _to_jax(p0)
    jp, js = jo.apply_gradients(_to_jax(g1), jp, jo.init_state(jp), lr=1e-2,
                                step=1)
    tp = convert.params_from_jax(jax.device_get(jp))
    ts = convert.opt_state_from_jax(jax.device_get(js))
    for path, (m, v) in _leaves(ts):
        jm, _ = _get(js, path)
        assert m.dtype == torch.bfloat16
        np.testing.assert_array_equal(m.float().numpy(),
                                      np.asarray(jm, np.float32))
    jp, js = jo.apply_gradients(_to_jax(g2), jp, js, lr=1e-2, step=2)
    tp, ts = to.apply_gradients(convert.params_from_jax(g2), tp, ts, lr=1e-2,
                                step=2)
    _compare(tp, jp, 1e-6)


def test_none_grad_leaves_leaf_alone():
    o = topt.Adam(learning_rate=0.1)
    p = {"a": torch.ones(3), "b": torch.ones(2)}
    s = o.init_state(p)
    new_p, new_s = o.apply_gradients({"a": torch.ones(3), "b": None}, p, s,
                                     step=1)
    assert new_p["b"] is p["b"] and new_s["b"] is s["b"]
    assert not torch.equal(new_p["a"], p["a"])


@pytest.mark.parametrize("kw,match", [
    (dict(grad_clip=object()), "clipping"),
    (dict(parameters=[torch.ones(1)]), "step"),
    (dict(lazy_mode=True), "lazy_mode"),
])
def test_unported_options_raise(kw, match):
    with pytest.raises(NotImplementedError, match=match):
        topt.Adam(**kw)
