"""Optimizers: the pure update API a train step uses.

Counterpart of ``paddle_tpu/optimizer/optimizer.py``: the optimizer zoo
(``SGD``, ``Momentum``, ``Adam``, ``AdamW``, ``Adadelta``, ``Adamax``,
``Adagrad``, ``RMSProp``, ``Lamb``, ``Adafactor``, ``Lars``), the
``L2Decay``/``L1Decay`` weight-decay objects, gradient clipping
(``nn/clip.py``, applied first) and LR schedulers (``optimizer/lr.py``),
behind :meth:`Optimizer.init_state` and :meth:`Optimizer.apply_gradients`
(optimizer.py:86-117).  As there, an optimizer is two per-leaf functions
(``_init_leaf``, ``_update_leaf``) mapped over a parameter tree — here a
tree of nested dicts of tensors, the GPT parameter tree's form — and
``apply_gradients`` returns new trees instead of mutating.

Leaf names are the JAX ``keystr`` form (``"['blocks']['qkv_w']"``), so the
same ``apply_decay_param_fun`` (and Lamb's exclusion function) decides the
same leaves in both packages.  The eager ``step()``/``clear_grad()``/
``state_dict()`` surface, ``lr_ratio``, sparse (lazy) updates and
``apply_gradients_bucketed`` are not ported yet.
"""
from __future__ import annotations

import torch

from .lr import LRScheduler


def keystr(path) -> str:
    """``jax.tree_util.keystr`` of a path of dict keys."""
    return "".join(f"[{k!r}]" for k in path)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _f32(x, like):
    """``x`` (a number or a tensor) as fp32 on ``like``'s device."""
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        if parameters is not None:
            raise NotImplementedError(
                "the eager step() surface is not ported; pass trees to "
                "init_state / apply_gradients")
        self._lr = learning_rate
        self._grad_clip = grad_clip
        if weight_decay is None:
            self._wd = 0.0
        elif isinstance(weight_decay, (float, int)):
            self._wd = float(weight_decay)
        else:
            # an L2Decay/L1Decay object: its coefficient, applied as the
            # reference applies it — coupled L2 for both (an L1Decay too)
            self._wd = float(getattr(weight_decay, "_coeff",
                                     getattr(weight_decay, "coeff", 0.0)))
        self._decoupled_wd = False  # True for AdamW
        self._apply_decay_fun = None  # name -> bool (apply_decay_param_fun)
        self._current_param_name = None  # set around each _update_leaf call

    def _should_decay(self, name) -> bool:
        if self._apply_decay_fun is None:
            return True
        return bool(self._apply_decay_fun(name if name is not None else ""))

    # -- lr ------------------------------------------------------------------
    def get_lr(self) -> float:
        if isinstance(self._lr, LRScheduler):
            return float(self._lr())
        return float(self._lr)

    def set_lr(self, value):
        self._lr = float(value)

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

    def apply_gradients(self, grads, params, state, lr=None, step=0,
                        sum_squares=None):
        """Pure update of matching trees -> (new_params, new_state): the
        gradient clip first, then coupled weight decay into the
        gradients, then each leaf's update (and AdamW's decoupled decay).
        ``lr`` overrides the optimizer's own (:meth:`get_lr`).  A ``None``
        gradient leaves its parameter and state as they are.
        ``sum_squares``: a sharded step's reduction for a norm clip
        (``nn/clip.py``); the update itself is per element."""
        lr = self.get_lr() if lr is None else lr
        with torch.no_grad():
            if self._grad_clip is not None:
                grads = (self._grad_clip.apply_pytree(grads)
                         if sum_squares is None else
                         self._grad_clip.apply_pytree(grads, sum_squares))
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
        name = keystr(path)
        self._current_param_name = name
        try:
            np_, ns_ = self._update_leaf(g, p, s, lr, step)
        finally:
            self._current_param_name = None
        if self._decoupled_wd and self._wd and self._should_decay(name):
            np_ = np_ - lr * self._wd * p
        return np_, ns_


class SGD(Optimizer):
    def _update_leaf(self, g, p, state, lr, step):
        return p - lr * g.to(p.dtype), state


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _init_leaf(self, p):
        return (torch.zeros_like(p),)

    def _update_leaf(self, g, p, state, lr, step):
        (v,) = state
        g = g.to(p.dtype)
        v2 = self._momentum * v + g
        upd = g + self._momentum * v2 if self._nesterov else v2
        return p - lr * upd, (v2,)


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
        t = _f32(step, p)
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



class Adadelta(Optimizer):
    """Accumulated squared gradients and squared updates (the reference's
    adadelta_op)."""

    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._eps, self._rho = epsilon, rho

    def _init_leaf(self, p):
        return (torch.zeros_like(p, dtype=torch.float32),
                torch.zeros_like(p, dtype=torch.float32))

    def _update_leaf(self, g, p, state, lr, step):
        avg_sq_g, avg_sq_u = state
        g32 = g.float()
        r = self._rho
        avg_sq_g = r * avg_sq_g + (1 - r) * g32 * g32
        upd = torch.sqrt(avg_sq_u + self._eps) \
            / torch.sqrt(avg_sq_g + self._eps) * g32
        avg_sq_u = r * avg_sq_u + (1 - r) * upd * upd
        return (p.float() - lr * upd).to(p.dtype), (avg_sq_g, avg_sq_u)


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def _init_leaf(self, p):
        return (torch.zeros_like(p, dtype=torch.float32),
                torch.zeros_like(p, dtype=torch.float32))

    def _update_leaf(self, g, p, state, lr, step):
        m, u = state
        g32 = g.float()
        b1 = self._beta1
        m2 = b1 * m + (1 - b1) * g32
        u2 = torch.maximum(self._beta2 * u, torch.abs(g32))
        t = _f32(step, p)
        upd = lr / (1 - b1 ** t) * m2 / (u2 + self._eps)
        return (p.float() - upd).to(p.dtype), (m2, u2)


class Adagrad(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._eps = epsilon
        self._init_acc = initial_accumulator_value

    def _init_leaf(self, p):
        return (torch.full_like(p, self._init_acc, dtype=torch.float32),)

    def _update_leaf(self, g, p, state, lr, step):
        (acc,) = state
        g32 = g.float()
        acc2 = acc + g32 * g32
        upd = lr * g32 / (torch.sqrt(acc2) + self._eps)
        return (p.float() - upd).to(p.dtype), (acc2,)


class RMSProp(Optimizer):
    def __init__(self, learning_rate=0.001, rho=0.95, epsilon=1e-6,
                 momentum=0.0, centered=False, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._rho, self._eps = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _init_leaf(self, p):
        # mean square, mean gradient, momentum
        return tuple(torch.zeros_like(p, dtype=torch.float32)
                     for _ in range(3))

    def _update_leaf(self, g, p, state, lr, step):
        ms, mg, mom = state
        g32 = g.float()
        rho = self._rho
        ms2 = rho * ms + (1 - rho) * g32 * g32
        if self._centered:
            mg2 = rho * mg + (1 - rho) * g32
            denom = torch.sqrt(ms2 - mg2 * mg2 + self._eps)
        else:
            mg2 = mg
            denom = torch.sqrt(ms2 + self._eps)
        mom2 = self._momentum * mom + lr * g32 / denom
        return (p.float() - mom2).to(p.dtype), (ms2, mg2, mom2)


class Lamb(Optimizer):
    """LAMB (the reference's lamb_op): the Adam update rescaled by the
    trust ratio ||w|| / ||update|| of each leaf."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._lamb_wd = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn

    def _init_leaf(self, p):
        return (torch.zeros_like(p, dtype=torch.float32),
                torch.zeros_like(p, dtype=torch.float32))

    def _update_leaf(self, g, p, state, lr, step):
        m, v = state
        g32 = g.float()
        b1, b2 = self._beta1, self._beta2
        m2 = b1 * m + (1 - b1) * g32
        v2 = b2 * v + (1 - b2) * g32 * g32
        t = _f32(step, p)
        mhat = m2 / (1 - b1 ** t)
        vhat = v2 / (1 - b2 ** t)
        p32 = p.float()
        wd = self._lamb_wd
        if self._exclude_fn is not None and self._exclude_fn(
                self._current_param_name or ""):
            wd = 0.0
        r = mhat / (torch.sqrt(vhat) + self._eps) + wd * p32
        w_norm = torch.sqrt(torch.sum(p32 * p32))
        r_norm = torch.sqrt(torch.sum(r * r))
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            torch.ones_like(w_norm))
        return (p32 - lr * trust * r).to(p.dtype), (m2, v2)


class Adafactor(Optimizer):
    """Adafactor (Shazeer & Stern 2018): factored second moments.

    Leaves whose last two axes are both at least 128 long ([..., R, C],
    stacked layer axes leading) keep row and column EMAs of g^2 over the
    LAST TWO axes; every other leaf — vectors, and stacked per-layer
    vectors such as ``ln1_g`` [L, D] or ``qkv_b`` [L, 3, D] — keeps a full
    second moment.  The update follows the paper and the JAX package:
    beta2_t = 1 - t^-0.8, the R x C / mean(R) reconstruction of vhat, and
    the RMS clip of the unscaled update at ``clip_threshold`` over the
    whole (stacked) leaf.  ``beta1=None`` (the default) keeps no first
    moment.
    """

    def __init__(self, learning_rate=0.01, beta1=None, beta2_exponent=0.8,
                 epsilon=1e-30, clip_threshold=1.0, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1 = beta1
        self._b2_exp = float(beta2_exponent)
        self._eps1 = epsilon
        self._clip = float(clip_threshold)

    @staticmethod
    def _factored(p) -> bool:
        return p.dim() >= 2 and min(p.shape[-2:]) >= 128

    def _init_leaf(self, p):
        f32 = dict(dtype=torch.float32, device=p.device)
        if self._factored(p):
            st = (torch.zeros(p.shape[:-1], **f32),                  # rows
                  torch.zeros(p.shape[:-2] + p.shape[-1:], **f32))   # cols
        else:
            st = (torch.zeros_like(p, dtype=torch.float32),)
        if self._beta1 is not None:
            st = st + (torch.zeros_like(p, dtype=torch.float32),)
        return st

    def _update_leaf(self, g, p, state, lr, step):
        g32 = g.float()
        t = torch.clamp_min(_f32(step, p), 1.0)
        b2t = 1.0 - t ** (-self._b2_exp)
        gsq = g32 * g32 + self._eps1
        if self._factored(p):
            vr, vc = state[0], state[1]
            vr2 = b2t * vr + (1 - b2t) * torch.mean(gsq, dim=-1)
            vc2 = b2t * vc + (1 - b2t) * torch.mean(gsq, dim=-2)
            # low-rank vhat = R x C / mean(R): exact when g^2 is rank-1
            r = vr2 / torch.clamp_min(torch.mean(vr2, dim=-1, keepdim=True),
                                      self._eps1)
            u = g32 * torch.rsqrt(r[..., None] + self._eps1) \
                * torch.rsqrt(vc2[..., None, :] + self._eps1)
            new_v = (vr2, vc2)
        else:
            v2 = b2t * state[0] + (1 - b2t) * gsq
            u = g32 * torch.rsqrt(v2 + self._eps1)
            new_v = (v2,)
        # RMS clip of the unscaled update (the paper's d = 1.0 threshold)
        rms_u = torch.sqrt(torch.mean(u * u))
        u = u / torch.clamp_min(rms_u / self._clip, 1.0)
        if self._beta1 is not None:
            m2 = self._beta1 * state[-1] + (1 - self._beta1) * u
            u, new_state = m2, new_v + (m2,)
        else:
            new_state = new_v
        return (p.float() - lr * u).to(p.dtype), new_state


class Lars(Momentum):
    """LARS (the reference's lars_momentum_op): layer-wise adaptive rate
    scaling, one trust ratio per leaf."""

    def __init__(self, learning_rate=0.001, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, parameters=None, grad_clip=None,
                 exclude_from_weight_decay=None, epsilon=1e-9, name=None):
        super().__init__(learning_rate, momentum, parameters, False, None,
                         grad_clip, name)
        self._lars_coeff = lars_coeff
        self._lars_wd = lars_weight_decay
        self._lars_eps = epsilon

    def _update_leaf(self, g, p, state, lr, step):
        (v,) = state
        g32 = g.float()
        p32 = p.float()
        w_norm = torch.sqrt(torch.sum(p32 * p32))
        g_norm = torch.sqrt(torch.sum(g32 * g32))
        local_lr = torch.where(
            (w_norm > 0) & (g_norm > 0),
            self._lars_coeff * w_norm
            / (g_norm + self._lars_wd * w_norm + self._lars_eps),
            torch.ones_like(w_norm))
        upd = g32 + self._lars_wd * p32
        v2 = self._momentum * v + lr * local_lr * upd
        return (p32 - v2).to(p.dtype), (v2,)


class L2Decay:
    """The reference's ``regularizer.L2Decay``: a coefficient that
    :class:`Optimizer` applies as coupled L2 decay."""

    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)

    def __call__(self, coeff=None):
        return self._coeff


class L1Decay:
    """The reference's ``regularizer.L1Decay``.  Its coefficient is applied
    as coupled **L2** decay (``g + coeff * p``), as the JAX package's
    ``Optimizer.__init__`` reads it — kept for parity (ROADMAP C)."""

    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)
