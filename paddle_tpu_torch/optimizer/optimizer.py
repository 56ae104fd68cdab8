"""Optimizers: the pure update API a train step uses.

Counterpart of ``paddle_tpu/optimizer/optimizer.py``, the slice the
single-card train step needs: :meth:`Optimizer.init_state` and
:meth:`Optimizer.apply_gradients` (optimizer.py:86-117) with ``Adam`` and
``AdamW`` (:441-505).  As there, an optimizer is two per-leaf functions
(``_init_leaf``, ``_update_leaf``) mapped over a parameter tree — here a
tree of nested dicts of tensors, the GPT parameter tree's form — and
``apply_gradients`` returns new trees instead of mutating.

Leaf names are the JAX ``keystr`` form (``"['blocks']['qkv_w']"``), so the
same ``apply_decay_param_fun`` decides the same leaves in both packages.
The eager ``step()`` surface, gradient clipping, LR schedulers and the
other optimizers (Adafactor, Lamb, ...) are not ported yet.
"""
from __future__ import annotations

import numbers

import torch


def keystr(path) -> str:
    """``jax.tree_util.keystr`` of a path of dict keys."""
    return "".join(f"[{k!r}]" for k in path)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        if parameters is not None:
            raise NotImplementedError(
                "the eager step() surface is not ported; pass trees to "
                "init_state / apply_gradients")
        if grad_clip is not None:
            raise NotImplementedError("gradient clipping is not ported yet")
        if not isinstance(learning_rate, numbers.Real):
            raise NotImplementedError("LR schedulers are not ported yet")
        self._lr = float(learning_rate)
        self._wd = float(weight_decay or 0.0)
        self._decoupled_wd = False  # True for AdamW
        self._apply_decay_fun = None  # name -> bool (apply_decay_param_fun)

    def _should_decay(self, name) -> bool:
        if self._apply_decay_fun is None:
            return True
        return bool(self._apply_decay_fun(name if name is not None else ""))

    # -- functional core (override in subclasses) ---------------------------
    def _init_leaf(self, p):
        return ()

    def _update_leaf(self, g, p, state, lr, step):
        raise NotImplementedError

    # -- pure tree API (used by train steps) --------------------------------
    def init_state(self, params):
        """params: tree of tensors -> tree of per-leaf state tuples."""
        with torch.no_grad():
            return _map(self._init_leaf, params)

    def apply_gradients(self, grads, params, state, lr=None, step=0):
        """Pure update of matching trees -> (new_params, new_state).  A
        ``None`` gradient leaves its parameter and state as they are."""
        lr = self._lr if lr is None else lr
        with torch.no_grad():
            return self._apply(grads, params, state, lr, step, ())

    def _apply(self, g, p, s, lr, step, path):
        if isinstance(p, dict):
            new_p, new_s = {}, {}
            for k in p:
                new_p[k], new_s[k] = self._apply(g[k], p[k], s[k], lr, step,
                                                 path + (k,))
            return new_p, new_s
        if g is None:
            return p, s
        if self._wd and not self._decoupled_wd:   # coupled L2: into the grad
            g = g + self._wd * p
        np_, ns_ = self._update_leaf(g, p, s, lr, step)
        if self._decoupled_wd and self._wd and self._should_decay(
                keystr(path)):
            np_ = np_ - lr * self._wd * p
        return np_, ns_


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 state_dtype=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        if lazy_mode:
            raise NotImplementedError("lazy_mode (sparse rows) is not "
                                      "ported yet")
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        # m/v storage dtype (fp32 by default; bf16 halves optimizer memory).
        # The update math is always fp32.
        self._state_dtype = state_dtype or torch.float32

    def _init_leaf(self, p):
        return (torch.zeros_like(p, dtype=self._state_dtype),
                torch.zeros_like(p, dtype=self._state_dtype))

    def _update_leaf(self, g, p, state, lr, step):
        m, v = state
        g32 = g.float()
        b1, b2 = self._beta1, self._beta2
        m2 = b1 * m.float() + (1 - b1) * g32
        v2 = b2 * v.float() + (1 - b2) * g32 * g32
        t = torch.as_tensor(step, dtype=torch.float32, device=p.device)
        mhat = m2 / (1 - b1 ** t)
        vhat = v2 / (1 - b2 ** t)
        upd = lr * mhat / (torch.sqrt(vhat) + self._eps)
        sd = self._state_dtype
        return (p.float() - upd).to(p.dtype), (m2.to(sd), v2.to(sd))


class AdamW(Adam):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 multi_precision=False, state_dtype=None, name=None):
        if lr_ratio is not None:
            raise NotImplementedError("lr_ratio is not ported yet")
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, state_dtype=state_dtype,
                         name=name)
        self._decoupled_wd = True
        self._apply_decay_fun = apply_decay_param_fun

