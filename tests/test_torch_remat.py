"""Remat in the port (``paddle_tpu_torch/ops/remat_policies.py``,
``GPTConfig.remat`` / ``remat_policy``) against the JAX package's.

* For each policy (full, "dots", "dots_no_batch", "everything"), with the
  fused LayerNorm and CE flags off and on: the loss and the grads are
  bit-equal to the port's without remat (the recompute runs the same
  deterministic CPU ops on the same inputs), and within 1e-5 of
  ``jax.value_and_grad`` of the JAX model under the same remat config
  (fp32, 2 layers, hidden 128 — the JAX fused LN takes its Pallas path,
  in interpret mode, only at F % 128 == 0).
* What each policy keeps: the bytes of the tensors the forward creates
  and leaves alive for the backward (activations, the selective policies'
  cached matmul outputs, the loss) are strictly ordered full <
  dots_no_batch <= dots < everything, and "everything" keeps what no remat
  keeps.  They are counted by storage: a ``TorchDispatchMode`` records the
  storage of every op's output during the forward, and the storages still
  alive after it are summed.  (``saved_tensors_hooks`` cannot see this: a
  checkpoint's own hooks take precedence inside it, and a selective
  checkpoint caches its matmul outputs outside any hook.)
* An unknown policy raises the reference's ``ValueError``;
  ``PADDLE_TPU_REMAT_POLICY`` is read only when the config sets no policy.
"""
import dataclasses
import functools
import gc
import weakref

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

import jax
import jax.numpy as jnp

from paddle_tpu.ops import fused_norm as jfused_norm
from paddle_tpu.ops import remat_policies as jremat
from paddle_tpu.text import gpt as jgpt
from paddle_tpu_torch import convert
from paddle_tpu_torch.ops import remat_policies
from paddle_tpu_torch.text import gpt, gpt_hybrid

TOL = 1e-5
POLICIES = [None, "dots", "dots_no_batch", "everything"]
TOKENS = np.random.default_rng(0).integers(0, 64, (2, 17))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _jcfg(**kw):
    base = dict(vocab_size=64, hidden_size=128, num_layers=2, num_heads=4,
                max_seq_len=32, dtype=jnp.float32)
    base.update(kw)
    return jgpt.GPTConfig(**base)


def _flags(monkeypatch, fused):
    monkeypatch.setenv("PADDLE_TPU_FUSED_LN", fused)
    monkeypatch.setenv("PADDLE_TPU_FUSED_CE", fused)


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


@functools.lru_cache(maxsize=None)
def _jax_params():
    return jax.device_get(jgpt.init_params(_jcfg(), jax.random.PRNGKey(1)))


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(policy, fused):
    """JAX's value_and_grad under ``remat_policy=policy`` with the fused
    flags set to ``fused`` (read at trace time), compiled once each."""
    jcfg = _jcfg(remat=True, remat_policy=policy)
    with pytest.MonkeyPatch.context() as mp:
        _flags(mp, fused)
        mp.setattr(jfused_norm, "_INTERPRET", True)
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p, t: jgpt.loss_fn(p, t, jcfg)))(
                jax.tree_util.tree_map(jnp.asarray, _jax_params()),
                jnp.asarray(TOKENS))
        return float(loss), jax.device_get(grads)


def _port(cfg):
    params = convert.params_from_jax(_jax_params())
    return gpt_hybrid.value_and_grad(
        lambda p, t: gpt.loss_fn(p, t, cfg), params,
        torch.from_numpy(TOKENS))


@pytest.mark.parametrize("fused", ["0", "1"])
@pytest.mark.parametrize("policy", POLICIES)
def test_remat_grads_bit_equal_and_match_jax(policy, fused, monkeypatch):
    _flags(monkeypatch, fused)
    cfg = convert.config_from_jax(_jcfg(remat=True, remat_policy=policy))
    assert cfg.remat and cfg.remat_policy == policy
    loss, grads = _port(cfg)
    ref_loss, ref_grads = _port(dataclasses.replace(cfg, remat=False))
    assert torch.equal(loss, ref_loss)
    for path, g in _leaves(grads):
        assert torch.equal(g, _get(ref_grads, path)), path
    j_loss, j_grads = _jax_loss_and_grads(policy, fused)
    assert abs(loss.item() - j_loss) < TOL
    for path, g in _leaves(grads):
        np.testing.assert_allclose(g.numpy(), _get(j_grads, path),
                                   atol=TOL, rtol=0, err_msg=str(path))


class _AliveBytes(TorchDispatchMode):
    """Records the storage of every op output while active; ``bytes()``
    sums those still alive, but for the ``skip`` storages (parameters)."""

    def __init__(self, skip):
        super().__init__()
        self.skip = skip
        self.refs = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                s = t.untyped_storage()
                if s.data_ptr() not in self.skip:
                    self.refs.append(weakref.ref(s))
        return out

    def bytes(self):
        # by address among the living: a freed storage's address is reused
        gc.collect()
        alive = {s.data_ptr(): s.nbytes() for r in self.refs
                 if (s := r()) is not None}
        return sum(alive.values())


def _kept_bytes(cfg):
    """Bytes the forward of ``loss_fn`` leaves alive for the backward."""
    params = convert.params_from_jax(_jax_params())
    leaves = {path: t.requires_grad_(True) for path, t in _leaves(params)}
    skip = {t.untyped_storage().data_ptr() for t in leaves.values()}
    mode = _AliveBytes(skip)
    with mode:
        loss = gpt.loss_fn(params, torch.from_numpy(TOKENS), cfg)
    kept = mode.bytes()
    loss.backward()        # the graph runs: nothing was lost
    return kept


@pytest.mark.parametrize("fused", ["0", "1"])
def test_policies_keep_ordered_bytes(fused, monkeypatch):
    _flags(monkeypatch, fused)
    cfg = convert.config_from_jax(_jcfg())
    kept = {p: _kept_bytes(dataclasses.replace(cfg, remat=True,
                                               remat_policy=p))
            for p in POLICIES}
    none = _kept_bytes(cfg)
    assert kept[None] < kept["dots_no_batch"] <= kept["dots"] \
        < kept["everything"] == none, (kept, none)


def test_unknown_policy_raises_the_reference_error():
    with pytest.raises(ValueError) as ref:
        jremat.canonical("bogus")
    for call in (lambda: remat_policies.canonical("bogus"),
                 lambda: gpt.GPTConfig(remat=True, remat_policy="bogus"),
                 lambda: convert.config_from_jax(
                     _jcfg(remat=True, remat_policy="bogus"))):
        with pytest.raises(ValueError) as got:
            call()
        assert str(got.value) == str(ref.value)


def test_aliases_resolve_as_the_reference():
    for name in [k for k in jremat._ALIASES if k is not None] + [None]:
        assert remat_policies.canonical(name) == jremat.canonical(name)
    ident = remat_policies.resolve("everything_saveable")(_leaves)
    assert ident is _leaves


def test_env_policy_only_when_the_config_sets_none(monkeypatch):
    """With ``remat_policy=None`` the flag picks the policy (here "dots",
    seen by the bytes kept); an explicit policy ("full") wins over it, and
    an invalid flag value raises only where it is read."""
    cfg = convert.config_from_jax(_jcfg())
    dots = _kept_bytes(dataclasses.replace(cfg, remat=True,
                                           remat_policy="dots"))
    full = _kept_bytes(dataclasses.replace(cfg, remat=True))
    monkeypatch.setenv("PADDLE_TPU_REMAT_POLICY", "dots")
    assert _kept_bytes(dataclasses.replace(cfg, remat=True)) == dots
    assert _kept_bytes(dataclasses.replace(cfg, remat=True,
                                           remat_policy="full")) == full
    monkeypatch.setenv("PADDLE_TPU_REMAT_POLICY", "bogus")
    with pytest.raises(ValueError, match="unknown recompute/remat policy"):
        _kept_bytes(dataclasses.replace(cfg, remat=True))
    gpt._remat_wrap(dataclasses.replace(cfg, remat=True, remat_policy="dots"))
