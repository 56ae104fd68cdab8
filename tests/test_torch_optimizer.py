"""The port's optimizers (paddle_tpu_torch/optimizer), clips
(paddle_tpu_torch/nn/clip.py), decay objects and LR schedulers
(paddle_tpu_torch/optimizer/lr.py) against the JAX package's: the same
parameter tree, the same numpy gradients, five steps of
``apply_gradients``.

Tolerances: fp32 state — parameters and every state array within 1e-6
per step (the update is fp32 math in the same order; ``b ** t``, ``rsqrt``
and the norms' sums may round one ulp apart between the libraries).  bf16
state — moments within one bf16 step (2^-8 relative: a moment may round
to the other neighbour after a one-ulp fp32 difference), parameters
within 1e-5.  Schedulers are pure Python in both packages: their lr
sequences are equal exactly.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu import regularizer as jreg
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch import convert, nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import regularizer as treg
from paddle_tpu_torch.optimizer import lr as tlr
from paddle_tpu_torch.optimizer.optimizer import keystr

SHAPES = {"wte": (16, 8), "ln_f_g": (8,),
          "blocks": {"qkv_w": (2, 3, 8, 8), "qkv_b": (2, 3, 8),
                     "ln1_g": (2, 8)}}
# Adafactor factors the last two axes when both are >= 128: the matrices
# here are factored, the stacked vectors (ln1_g [L, D], qkv_b [L, 3, D])
# and the narrow wte keep full moments
WIDE = {"wte": (16, 128), "ln_f_g": (128,),
        "blocks": {"qkv_w": (2, 3, 128, 128), "qkv_b": (2, 3, 128),
                   "ln1_g": (2, 128), "fc_w": (2, 128, 256)}}


def _tree(fn, shapes=SHAPES, path=()):
    if isinstance(shapes, dict):
        return {k: _tree(fn, v, path + (k,)) for k, v in shapes.items()}
    return fn(shapes)


def _np_tree(rng, scale=1.0, shapes=SHAPES):
    return _tree(lambda s: (scale * rng.standard_normal(s)).astype(
        np.float32), shapes)


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


def _run(make_j, make_t, grad_dtype=np.float32, steps=5, lr=1e-2,
         shapes=SHAPES):
    rng = np.random.default_rng(0)
    p0 = _np_tree(rng, shapes=shapes)
    jo, to = make_j(), make_t()
    jp, tp = _to_jax(p0), convert.params_from_jax(p0)
    js, ts = jo.init_state(jp), to.init_state(tp)
    for step in range(1, steps + 1):
        g = _np_tree(rng, 0.1, shapes)
        jg = jax.tree_util.tree_map(lambda a: jnp.asarray(a, grad_dtype), g)
        tg = convert.params_from_jax(jax.device_get(jg))
        jp, js = jo.apply_gradients(jg, jp, js, lr=lr, step=step)
        tp, ts = to.apply_gradients(tg, tp, ts, lr=lr, step=step)
        yield step, jp, js, tp, ts


def _compare_state(ts, js):
    """Every array of every leaf's state tuple, shapes included."""
    for path, st in _leaves(ts):
        jst = _get(js, path)
        assert len(st) == len(jst), path
        for a, b in zip(st, jst):
            assert tuple(a.shape) == tuple(b.shape), path
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                       rtol=1e-6, err_msg=str(path))


@pytest.mark.parametrize("name,kw", [
    ("Adam", {}),
    ("Adam", dict(weight_decay=0.1)),         # coupled L2 into the grad
    ("AdamW", {}),
    ("AdamW", dict(weight_decay=0.05, beta1=0.8, beta2=0.99, epsilon=1e-6)),
    ("SGD", {}),
    ("SGD", dict(weight_decay=0.1)),
    ("Momentum", {}),
    ("Momentum", dict(momentum=0.8, use_nesterov=True, weight_decay=0.05)),
    ("Adadelta", {}),
    ("Adadelta", dict(rho=0.9, epsilon=1e-5)),
    ("Adamax", {}),
    ("Adagrad", dict(initial_accumulator_value=0.1)),
    ("RMSProp", {}),
    ("RMSProp", dict(momentum=0.9, centered=True)),
    ("Lamb", {}),
    ("Lamb", dict(lamb_weight_decay=0.1, exclude_from_weight_decay_fn=(
        lambda name: name.endswith("_g']")))),
    ("Lars", {}),
    ("Lars", dict(lars_coeff=0.01, lars_weight_decay=0.001)),
    ("Adafactor", dict(shapes=SHAPES)),                 # no leaf factored
    ("Adafactor", dict(shapes=SHAPES, beta1=0.9)),
    ("Adafactor", dict(shapes=WIDE)),                   # matrices factored
    ("Adafactor", dict(shapes=WIDE, beta1=0.9, clip_threshold=0.5)),
])
def test_matches_jax_over_five_steps(name, kw):
    """Parameters and every state array, every step, fp32 state."""
    kw = dict(kw)
    shapes = kw.pop("shapes", SHAPES)
    for _, jp, js, tp, ts in _run(
            lambda: getattr(jopt, name)(learning_rate=1e-2, **kw),
            lambda: getattr(topt, name)(learning_rate=1e-2, **kw),
            shapes=shapes):
        _compare(tp, jp, 1e-6)
        _compare_state(ts, js)
    if name == "Adafactor":      # factored leaves keep row/column vectors
        st = _get(ts, ("blocks", "qkv_w"))
        moments = [tuple(a.shape) for a in st[:len(st) - ("beta1" in kw)]]
        assert moments == ([(2, 3, 128), (2, 3, 128)] if shapes is WIDE
                           else [(2, 3, 8, 8)])


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


@pytest.mark.parametrize("decay", ["L2Decay", "L1Decay"])
@pytest.mark.parametrize("name", ["Momentum", "Adam"])
def test_decay_objects_match_jax(name, decay):
    """``weight_decay=`` an L2Decay or L1Decay object, each package its
    own: the same steps as JAX's.  L1Decay's coefficient acts as coupled
    L2 decay in both, so it equals the float ``weight_decay``."""
    for _, jp, js, tp, ts in _run(
            lambda: getattr(jopt, name)(
                learning_rate=1e-2, weight_decay=getattr(jreg, decay)(0.1)),
            lambda: getattr(topt, name)(
                learning_rate=1e-2, weight_decay=getattr(treg, decay)(0.1))):
        _compare(tp, jp, 1e-6)
        _compare_state(ts, js)
    floats = list(_run(
        lambda: getattr(jopt, name)(learning_rate=1e-2),
        lambda: getattr(topt, name)(learning_rate=1e-2, weight_decay=0.1)))
    for path, t in _leaves(floats[-1][3]):
        assert torch.equal(t, _get(tp, path))


CLIPS = [("ClipGradByValue", (0.05,)), ("ClipGradByValue", (0.1, -0.02)),
         ("ClipGradByNorm", (0.3,)), ("ClipGradByGlobalNorm", (0.5,)),
         ("ClipGradByGlobalNorm", (100.0,))]        # the last clips nothing


@pytest.mark.parametrize("grad_dtype", [np.float32, jnp.bfloat16])
@pytest.mark.parametrize("name,args", CLIPS)
def test_clips_match_apply_pytree(name, args, grad_dtype):
    g = _np_tree(np.random.default_rng(2), 0.1)
    jg = jax.tree_util.tree_map(lambda a: jnp.asarray(a, grad_dtype), g)
    ref = getattr(jnn, name)(*args).apply_pytree(jg)
    got = getattr(tnn, name)(*args).apply_pytree(
        convert.params_from_jax(jax.device_get(jg)))
    for path, t in _leaves(got):
        r = np.asarray(_get(ref, path))
        assert t.dtype == convert.params_from_jax({"x": r})["x"].dtype
        np.testing.assert_allclose(
            t.float().numpy(), r.astype(np.float32), rtol=0,
            atol=1e-7 if grad_dtype == np.float32 else 2.0 ** -9)


@pytest.mark.parametrize("name,args", CLIPS[::2])
def test_grad_clip_runs_first_in_apply_gradients(name, args):
    """``grad_clip=`` on an optimizer: the JAX package's steps."""
    for _, jp, js, tp, ts in _run(
            lambda: jopt.Adam(learning_rate=1e-2,
                              grad_clip=getattr(jnn, name)(*args)),
            lambda: topt.Adam(learning_rate=1e-2,
                              grad_clip=getattr(tnn, name)(*args))):
        _compare(tp, jp, 1e-6)
        _compare_state(ts, js)


def _schedulers(m):
    """The 14 schedulers of ``m`` (either package's lr module)."""
    return {
        "NoamDecay": m.NoamDecay(d_model=64, warmup_steps=8),
        "PiecewiseDecay": m.PiecewiseDecay([5, 12], [0.1, 0.05, 0.01]),
        "NaturalExpDecay": m.NaturalExpDecay(0.1, gamma=0.1),
        "InverseTimeDecay": m.InverseTimeDecay(0.1, gamma=0.2),
        "PolynomialDecay": m.PolynomialDecay(0.1, decay_steps=7,
                                             power=2.0, cycle=True),
        "LinearWarmup": m.LinearWarmup(
            m.CosineAnnealingDecay(0.1, T_max=20), warmup_steps=5,
            start_lr=0.0, end_lr=0.1),
        "ExponentialDecay": m.ExponentialDecay(0.1, gamma=0.9),
        "MultiStepDecay": m.MultiStepDecay(0.1, milestones=[4, 9, 20]),
        "StepDecay": m.StepDecay(0.1, step_size=6, gamma=0.5),
        "LambdaDecay": m.LambdaDecay(0.1, lambda e: 0.95 ** e),
        "ReduceOnPlateau": m.ReduceOnPlateau(0.1, patience=2, cooldown=1),
        "CosineAnnealingDecay": m.CosineAnnealingDecay(0.1, T_max=13),
        "OneCycleLR": m.OneCycleLR(0.1, total_steps=25),
        "CyclicLR": m.CyclicLR(0.01, 0.1, step_size_up=4,
                               mode="triangular2"),
    }


@pytest.mark.parametrize("name", list(_schedulers(jlr)))
def test_scheduler_sequence_equals_jax(name):
    """30 steps: the value, ``lr_at`` of each step, and an optimizer
    built on the scheduler (``get_lr``), all exactly the JAX package's.
    ReduceOnPlateau is fed a loss that stalls."""
    js, ts = _schedulers(jlr)[name], _schedulers(tlr)[name]
    jo = jopt.SGD(learning_rate=js)
    to = topt.SGD(learning_rate=ts)
    metrics = [1.0 / (1 + i) if i < 8 else 0.2 for i in range(30)]
    seq = []
    for i in range(30):
        assert ts() == js() and to.get_lr() == jo.get_lr()
        if name != "ReduceOnPlateau":
            assert ts.lr_at(i) == js.lr_at(i)
        seq.append(ts())
        if name == "ReduceOnPlateau":
            js.step(metrics[i])
            ts.step(metrics[i])
        else:
            js.step()
            ts.step()
    assert len(set(seq)) > 1, seq


def test_scheduler_drives_apply_gradients():
    """With no ``lr`` passed, ``apply_gradients`` reads the scheduler; a
    passed ``lr`` overrides it — both as in the JAX package."""
    def pair(lr_mod, opt_mod):
        return opt_mod.Adam(learning_rate=lr_mod.LinearWarmup(
            0.05, warmup_steps=3, start_lr=0.0, end_lr=0.05))

    rng = np.random.default_rng(4)
    p0 = _np_tree(rng)
    jo, to = pair(jlr, jopt), pair(tlr, topt)
    jp, tp = _to_jax(p0), convert.params_from_jax(p0)
    js, ts = jo.init_state(jp), to.init_state(tp)
    for step in range(1, 6):
        g = _np_tree(rng, 0.1)
        lr = 1e-3 if step == 4 else None
        jp, js = jo.apply_gradients(_to_jax(g), jp, js, lr=lr, step=step)
        tp, ts = to.apply_gradients(convert.params_from_jax(g), tp, ts,
                                    lr=lr, step=step)
        _compare(tp, jp, 1e-6)
        jo._lr.step()
        to._lr.step()


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


@pytest.mark.parametrize("name,kw,shapes", [
    ("Momentum", dict(use_nesterov=True), SHAPES),
    ("Adafactor", dict(beta1=0.9), WIDE),       # 3-tuples and 2-tuples
    ("Adafactor", {}, WIDE),                    # 2-tuples and 1-tuples
    ("Lamb", {}, SHAPES),
    ("SGD", {}, SHAPES),                        # empty tuples
])
def test_other_states_resume_from_jax(name, kw, shapes):
    """Every state leaf these optimizers make carries across
    (``opt_state_from_jax``), and the next steps equal JAX's."""
    rng = np.random.default_rng(1)
    p0 = _np_tree(rng, shapes=shapes)
    gs = [_np_tree(rng, 0.1, shapes) for _ in range(3)]
    jo = getattr(jopt, name)(learning_rate=1e-2, **kw)
    to = getattr(topt, name)(learning_rate=1e-2, **kw)
    jp = _to_jax(p0)
    jp, js = jo.apply_gradients(_to_jax(gs[0]), jp, jo.init_state(jp),
                                lr=1e-2, step=1)
    tp = convert.params_from_jax(jax.device_get(jp))
    ts = convert.opt_state_from_jax(jax.device_get(js))
    _compare_state(ts, js)
    for step, g in ((2, gs[1]), (3, gs[2])):
        jp, js = jo.apply_gradients(_to_jax(g), jp, js, lr=1e-2, step=step)
        tp, ts = to.apply_gradients(convert.params_from_jax(g), tp, ts,
                                    lr=1e-2, step=step)
    _compare(tp, jp, 1e-6)
    _compare_state(ts, js)


def test_none_grad_leaves_leaf_alone():
    o = topt.Adam(learning_rate=0.1)
    p = {"a": torch.ones(3), "b": torch.ones(2)}
    s = o.init_state(p)
    new_p, new_s = o.apply_gradients({"a": torch.ones(3), "b": None}, p, s,
                                     step=1)
    assert new_p["b"] is p["b"] and new_s["b"] is s["b"]
    assert not torch.equal(new_p["a"], p["a"])


@pytest.mark.parametrize("kw,match", [
    (dict(grad_clip=tnn.ClipGradByValue(0.01)), "clipping"),
    (dict(parameters=[torch.ones(1)]), "step"),
    (dict(lazy_mode=True), "lazy_mode"),
])
def test_unported_options_raise(kw, match):
    """Options not ported raise NotImplementedError.  Gradient clipping
    (the "clipping" case) is ported: the optimizer takes it, and its step
    is the unclipped optimizer's step on the clipped gradients."""
    if match == "clipping":
        p = {"a": torch.ones(3)}
        g = {"a": torch.tensor([0.5, -0.005, -2.0])}
        o, plain = topt.Adam(**kw), topt.Adam()
        got, _ = o.apply_gradients(g, p, o.init_state(p), step=1)
        want, _ = plain.apply_gradients(
            {"a": torch.tensor([0.01, -0.005, -0.01])}, p,
            plain.init_state(p), step=1)
        assert torch.equal(got["a"], want["a"])
        return
    with pytest.raises(NotImplementedError, match=match):
        topt.Adam(**kw)
