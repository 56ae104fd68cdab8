"""Multi-tenant adapter serving: batched multi-LoRA decode and constrained
(grammar / JSON) decoding.

Counterpart of ``paddle_tpu/text/adapters.py``.  One ``DecodeServer``
batch serves N products over ONE base model, each with its own LoRA
weights and output contract:

* **AdapterPool** — up to ``max_adapters`` LoRA pairs held as stacked
  float32 leaves on the base's device (``<name>_lora_a`` [A, L, ..., in,
  r] / ``<name>_lora_b`` [A, L, ..., r, out], ``text/lora.py``'s names,
  one row an adapter).  Row 0 is the base model and stays zero.  The
  stacks are allocated at their full [max_adapters + 1, ...] shape once
  and :meth:`AdapterPool.register` writes its row in place (``copy_`` into
  the same storage), so a graph captured over the stacks reads a row
  registered after ``warmup()`` at its next replay, with no capture.

* **The per-slot delta** — the adapter steps below take per-slot int64 ids
  [B] and hand the decode, verify and admission math of ``generate.py`` /
  ``kv_pool.py`` a params tree carrying each targeted weight's stacks as
  ``<name>_lora_sa`` / ``_lora_sb`` ([L, A, ...] views) and the ids as
  ``lora_ids``; ``woq.mm`` / ``mm_stacked`` then add ``(h @ A[ids]) @
  B[ids]`` to the base product.  The base matmul runs once for the batch
  on its usual route (the W4 kernel included) and attention stays on the
  decode kernels; only the rank-r term is per slot — the JAX package's
  merged product ``h @ (W + a_b @ b_b)``, re-associated.  Admission under
  one slot's adapter takes the same low-rank form with B = 1.  Id 0
  gathers the zero row, so its delta is exactly +0.0.

* **Constrained decoding** — ``submit(..., constraint=)`` takes a
  :class:`TokenSetConstraint`, a :class:`RegexConstraint` (regex -> NFA ->
  lazy token-level DFA) or a :class:`JsonSchemaConstraint` (JSON schema ->
  regex -> the same engine).  The automaton advances on the host from
  fetched tokens; its allowed set becomes an additive [B, V] float32 mask
  (0 allowed, ``NEG_INF`` banned) fed to the sampling step.  Tree
  speculation prunes banned branches with :func:`constraint_lookahead`.
  This half is host numpy, a copy of the JAX module's.

:func:`stacked_pool_specs` places the stacks under tensor parallel
(``DecodeServer(mesh=, adapter_pool=)``): each rank holds its block of
every stack, and a register writes the new row's blocks to the ranks of
every sharded server the pool serves.
"""
from __future__ import annotations

import json
import weakref
from typing import Any, Iterable

import numpy as np
import torch

from . import generate, gpt, kv_pool, lora, serving, woq
from .. import telemetry as _telemetry

__all__ = [
    "AdapterPool", "TokenSetConstraint", "RegexConstraint",
    "JsonSchemaConstraint", "compile_constraint", "constraint_lookahead",
    "mask_logits", "apply_constraint_host", "NEG_INF",
    "adapter_decode_step_batched", "adapter_sample_step_batched",
    "adapter_decode_block_batched", "adapter_spec_verify_batched",
    "adapter_prefill_slot", "adapter_prefill_slot_chunk",
    "adapter_paged_prefill_chunk",
]

# additive mask value for banned tokens: large-negative instead of true
# -inf so a fully-banned row still softmaxes to a number; 1e30 underflows
# to exactly 0 probability in fp32 against any in-support logit
NEG_INF = -1e30


# ---------------------------------------------------------------------------
# adapter-aware step math: the per-slot rank-r term beside the base matmul
# ---------------------------------------------------------------------------

def slot_params(params: dict, stacks: dict, ids) -> dict:
    """``params`` with the pool's stacks beside their target weights, as
    ``woq.mm`` reads them: ``<name>_lora_sa`` / ``_lora_sb`` [L, A, ...]
    (views of the [A, L, ...] stacks, so ``gpt.layer`` slices a layer's
    [A, ...] rows) and ``lora_ids`` [L, B] (the per-slot ids, int64 [B],
    broadcast over the layers)."""
    blocks = dict(params["blocks"])
    ids = ids.reshape(-1).long()
    L = None
    for leaf, s in stacks.items():
        tag = "_lora_sa" if leaf.endswith(lora._SUFFIX_A) else "_lora_sb"
        blocks[leaf[: -len(lora._SUFFIX_A)] + tag] = s.movedim(0, 1)
        L = s.shape[1]
    blocks["lora_ids"] = ids.reshape(1, -1).expand(L, ids.shape[0])
    return dict(params, blocks=blocks)


def adapter_decode_step_batched(params, cache, stacks, ids, token, pos,
                                cfg: gpt.GPTConfig):
    """``serving.decode_step_batched`` with per-slot adapters: token [B],
    pos int32 [B], ids int [B] (0 = base) -> (logits [B, V] float32,
    cache), either layout."""
    return serving.decode_step_batched(slot_params(params, stacks, ids),
                                       cache, token, pos, cfg)


def adapter_sample_step_batched(params, cache, stacks, ids, tok, pos, key,
                                temp, topk, topp, mask,
                                cfg: gpt.GPTConfig):
    """Adapter-aware ``sample_step_batched`` under the constraint mask
    [B, V] float32 additive (all zero = unconstrained; None skips it):
    greedy slots (temp 0) take the argmax of the masked logits, so one
    step serves constrained greedy and constrained sampled slots."""
    return serving.sample_step_batched(slot_params(params, stacks, ids),
                                       cache, tok, pos, key, temp, topk,
                                       topp, cfg, mask=mask)


def adapter_decode_block_batched(params, cache, stacks, ids, tok, pos,
                                 k: int, cfg: gpt.GPTConfig):
    """Adapter-aware ``decode_block_batched``: ``k`` greedy steps on the
    device, each gathering the slots' rows again -> (tokens [B, k],
    cache)."""
    return serving.decode_block_batched(slot_params(params, stacks, ids),
                                        cache, tok, pos, k, cfg)


def adapter_spec_verify_batched(params, cache, stacks, ids, tokens, pos,
                                cfg: gpt.GPTConfig):
    """Adapter-aware ``spec_verify_batched``: the verify pass gathers the
    same per-slot adapter the decode step does, so accepted draft tokens
    are the adapted target's tokens -> (logits [B, K, V], cache)."""
    return serving.spec_verify_batched(slot_params(params, stacks, ids),
                                       cache, tokens, pos, cfg)


def _one(aid):
    """A slot's adapter id (an int, or a 0-d / [1] int tensor) as the
    [1] ids of a B = 1 admission."""
    if isinstance(aid, torch.Tensor):
        return aid.reshape(1)
    return torch.tensor([int(aid)], dtype=torch.int64)


def adapter_prefill_slot(params, cache, stacks, aid, tokens, length, slot,
                         cfg: gpt.GPTConfig):
    """``generate.prefill_slot`` under one slot's adapter ``aid`` (the
    low-rank form at B = 1, so the prompt's cache rows are the adapted
    model's)."""
    ids = _one(aid).to(tokens.device)
    return generate.prefill_slot(slot_params(params, stacks, ids), cache,
                                 tokens, length, slot, cfg)


def adapter_prefill_slot_chunk(params, cache, stacks, aid, tokens, pos0,
                               length, slot, cfg: gpt.GPTConfig):
    """``generate.prefill_slot_chunk`` under one slot's adapter."""
    ids = _one(aid).to(tokens.device)
    return generate.prefill_slot_chunk(slot_params(params, stacks, ids),
                                       cache, tokens, pos0, length, slot,
                                       cfg)


def adapter_paged_prefill_chunk(params, cache, stacks, aid, tokens, pos0,
                                length, slot, cfg: gpt.GPTConfig):
    """``kv_pool.paged_prefill_chunk`` under one slot's adapter."""
    ids = _one(aid).to(tokens.device)
    return kv_pool.paged_prefill_chunk(slot_params(params, stacks, ids),
                                       cache, tokens, pos0, length, slot,
                                       cfg)


# ---------------------------------------------------------------------------
# AdapterPool — the registry the server gathers from
# ---------------------------------------------------------------------------

class AdapterPool:
    """Fixed-capacity registry of LoRA adapters as stacked device leaves.

    Stacks are preallocated zero at [max_adapters + 1, ...] float32 on the
    device of ``params`` (row 0 = the base model, always zero), so every
    step key derived from :meth:`pool_key` is fixed at construction and a
    register is a row write into the same storage: registering adapter #3
    after ``warmup()`` captures nothing, and the next replay reads it.

        pool = AdapterPool(params, cfg, rank=8, max_adapters=4)
        pool.register("product-a", lora.split_lora(adapted)[1])
        srv = DecodeServer(params, cfg, ..., adapter_pool=pool)
        srv.submit(prompt, adapter="product-a")

    ``targets`` follows ``lora.lora_init``'s default (the attention
    projections); only targets present in ``params["blocks"]`` get stacks,
    and every registered adapter must carry exactly that target set at
    this pool's rank."""

    def __init__(self, params: dict, cfg: gpt.GPTConfig, rank: int = 8,
                 max_adapters: int = 8,
                 targets: tuple = ("qkv_w", "q_w", "kv_w", "proj_w")):
        if rank < 1:
            raise ValueError(f"rank must be >= 1, got {rank}")
        if max_adapters < 1:
            raise ValueError(
                f"max_adapters must be >= 1, got {max_adapters}")
        blocks = params["blocks"]
        self.cfg = cfg
        self.rank = int(rank)
        self.max_adapters = int(max_adapters)
        self.targets = tuple(t for t in targets if t in blocks)
        if not self.targets:
            raise ValueError(
                f"none of targets {targets} present in params['blocks'] "
                f"(names: {sorted(blocks)[:8]}...)")
        A = self.max_adapters + 1                   # row 0 = base (zeros)
        self.device = blocks[self.targets[0]].device
        self._stacks = {}
        for t in self.targets:
            shp = woq.logical_shape(blocks, t)       # [L, ..., in, out]
            self._stacks[t + lora._SUFFIX_A] = torch.zeros(
                (A,) + shp[:-1] + (self.rank,), dtype=torch.float32,
                device=self.device)
            self._stacks[t + lora._SUFFIX_B] = torch.zeros(
                (A,) + shp[:-2] + (self.rank, shp[-1]), dtype=torch.float32,
                device=self.device)
        self._ids: dict[str, int] = {}              # name -> row (>= 1)
        self._tenant_default: dict[Any, str] = {}
        # tensor-parallel servers holding blocks of the stacks on their
        # ranks (``tp_serving.ShardedBinding``): a register writes there too
        self._mirrors = weakref.WeakSet()

    # -- registration -------------------------------------------------

    def register(self, name: str, adapters: dict) -> int:
        """Write one adapter into the pool; returns its id (>= 1).
        ``adapters`` is ``lora.split_lora(tree)[1]`` ({"qkv_w_lora_a":
        [L, ..., r], ...}: tensors or arrays), or a full adapted tree (its
        ``blocks`` lora leaves are taken).  Re-registering a name
        overwrites its row in place."""
        if not name or not isinstance(name, str):
            raise ValueError(f"adapter name must be a non-empty string, "
                             f"got {name!r}")
        if isinstance(adapters, dict) and "blocks" in adapters:
            adapters = lora.split_lora(adapters)[1]
        want = set(self._stacks)
        got = set(adapters)
        if got != want:
            raise ValueError(
                f"adapter {name!r} target/leaf mismatch: pool holds "
                f"{sorted(want)}, adapter has {sorted(got)} (same "
                f"rank/targets across the pool — see lora.stack_adapters)")
        rows = {}
        for leaf, stack in self._stacks.items():
            arr = adapters[leaf]
            if not isinstance(arr, torch.Tensor):
                arr = torch.from_numpy(np.array(arr))
            if tuple(arr.shape) != tuple(stack.shape[1:]):
                raise ValueError(
                    f"adapter {name!r} leaf {leaf}: shape "
                    f"{tuple(arr.shape)} != pool row {tuple(stack.shape[1:])}"
                    f" (rank {self.rank})")
            rows[leaf] = arr
        i = self._ids.get(name)
        if i is None:
            if len(self._ids) >= self.max_adapters:
                raise ValueError(
                    f"adapter pool full ({self.max_adapters}); evict or "
                    f"size the pool for the product set")
            i = len(self._ids) + 1
        for leaf, stack in self._stacks.items():
            # in place: graphs captured over the stacks read the new row
            stack[i].copy_(rows[leaf].to(stack.device, torch.float32))
        for m in list(self._mirrors):
            m.adapter_row(i, {leaf: s[i] for leaf, s in self._stacks.items()})
        self._ids[name] = i
        if _telemetry.enabled():
            _telemetry.count("adapters.registered")
        return i

    # -- lookups ------------------------------------------------------

    def resolve(self, name: str | None) -> int:
        """Adapter id for ``name`` (None -> 0, the base model)."""
        if name is None:
            return 0
        i = self._ids.get(name)
        if i is None:
            raise ValueError(f"unknown adapter {name!r} "
                             f"(registered: {sorted(self._ids)})")
        return i

    def names(self) -> list:
        return sorted(self._ids)

    def name_of(self, aid: int) -> str:
        for n, i in self._ids.items():
            if i == aid:
                return n
        return "base"

    def stacks(self) -> dict:
        """The live stacked leaves (device tensors, written in place by
        :meth:`register`)."""
        return dict(self._stacks)

    def pool_key(self) -> tuple:
        """Step-key fragment: the pool GEOMETRY (capacity, rank, targets)
        — everything that shapes the stacks.  Which adapters are
        registered is left out: a row write must not split a step."""
        return ("adapters", self.max_adapters + 1, self.rank, self.targets)

    # -- tenancy ------------------------------------------------------

    def set_tenant_default(self, tenant, name: str | None) -> None:
        """Map a tenant to its default adapter: ``submit(tenant=...)``
        without an explicit ``adapter=`` resolves through this."""
        if name is not None:
            self.resolve(name)                      # validate now
        if name is None:
            self._tenant_default.pop(tenant, None)
        else:
            self._tenant_default[tenant] = name

    def default_for(self, tenant) -> str | None:
        return self._tenant_default.get(tenant)


def stacked_pool_specs(pool: AdapterPool, mp: str = "mp") -> dict:
    """The specs of the pool's stacked ``[A, ...]`` leaves under tensor
    parallel, as the JAX package derives them from each target's Megatron
    spec (``gpt.param_shardings``) with the leading stack axis replicated:
    ``*_lora_a`` ``[A, ..., in, r]`` keeps the base spec's dims up to the
    input dim and replicates the rank dim; ``*_lora_b`` ``[A, ..., r,
    out]`` replicates the rank dim and keeps the base output dim's spec.
    A column-parallel target gets a replicated ``a`` and an out-split
    ``b`` — the gathered delta lands split like the base product's output;
    a row-parallel target mirrors that on the input side, its partial
    delta summed by the product's own all-reduce."""
    base = gpt.param_shardings(pool.cfg, mp=mp)["blocks"]
    specs = {}
    for t in pool.targets:
        dims = tuple(base[t])
        specs[t + lora._SUFFIX_A] = (None, *dims[:-1], None)
        specs[t + lora._SUFFIX_B] = (None, *dims[:-2], None, dims[-1])
    return specs


# ---------------------------------------------------------------------------
# constrained decoding: regex -> NFA -> lazy token-level DFA
# ---------------------------------------------------------------------------

class _Regex:
    """Thompson-NFA compiler for the regex subset constraints need:
    literals, ``\\`` escapes, ``.``, ``[...]`` classes (ranges,
    negation), grouping, ``|``, ``* + ?``.  Char-level moves run through
    a lazily built subset-construction DFA (frozenset states, cached
    per (state, char)) — no dependency, no backtracking, O(len) per
    token walk."""

    def __init__(self, pattern: str):
        self._pat = pattern
        self._trans: list = []   # per state: [(pred, dst), ...]
        self._eps: list = []     # per state: [dst, ...]
        self._pos = 0
        s, e = self._parse_alt()
        if self._pos != len(pattern):
            raise ValueError(f"regex {pattern!r}: trailing input at "
                             f"{self._pos}")
        self._start, self._accept = s, e
        self.start_state = frozenset(self._closure({s}))
        self._moves: dict = {}

    # -- NFA construction ---------------------------------------------

    def _new(self) -> int:
        self._trans.append([])
        self._eps.append([])
        return len(self._trans) - 1

    def _peek(self):
        return self._pat[self._pos] if self._pos < len(self._pat) else None

    def _parse_alt(self):
        frags = [self._parse_cat()]
        while self._peek() == "|":
            self._pos += 1
            frags.append(self._parse_cat())
        if len(frags) == 1:
            return frags[0]
        s, e = self._new(), self._new()
        for fs, fe in frags:
            self._eps[s].append(fs)
            self._eps[fe].append(e)
        return s, e

    def _parse_cat(self):
        frags = []
        while self._peek() is not None and self._peek() not in "|)":
            frags.append(self._parse_rep())
        if not frags:
            s = self._new()
            return s, s                              # empty match
        s, e = frags[0]
        for fs, fe in frags[1:]:
            self._eps[e].append(fs)
            e = fe
        return s, e

    def _parse_rep(self):
        s, e = self._parse_atom()
        c = self._peek()
        if c == "*":
            self._pos += 1
            ns, ne = self._new(), self._new()
            self._eps[ns] += [s, ne]
            self._eps[e] += [s, ne]
            return ns, ne
        if c == "+":
            self._pos += 1
            ne = self._new()
            self._eps[e] += [s, ne]
            return s, ne
        if c == "?":
            self._pos += 1
            ns, ne = self._new(), self._new()
            self._eps[ns] += [s, ne]
            self._eps[e].append(ne)
            return ns, ne
        return s, e

    def _parse_atom(self):
        c = self._peek()
        if c is None:
            raise ValueError(f"regex {self._pat!r}: unexpected end")
        if c == "(":
            self._pos += 1
            s, e = self._parse_alt()
            if self._peek() != ")":
                raise ValueError(f"regex {self._pat!r}: unclosed group")
            self._pos += 1
            return s, e
        if c == "[":
            return self._parse_class()
        if c == "\\":
            self._pos += 2
            if self._pos > len(self._pat):
                raise ValueError(f"regex {self._pat!r}: dangling escape")
            return self._lit(("char", self._pat[self._pos - 1]))
        if c == ".":
            self._pos += 1
            return self._lit(("any",))
        if c in "*+?|)":
            raise ValueError(f"regex {self._pat!r}: unexpected {c!r} at "
                             f"{self._pos}")
        self._pos += 1
        return self._lit(("char", c))

    def _parse_class(self):
        self._pos += 1                               # consume '['
        neg = self._peek() == "^"
        if neg:
            self._pos += 1
        chars, ranges = set(), []
        first = True
        while True:
            c = self._peek()
            if c is None:
                raise ValueError(f"regex {self._pat!r}: unclosed class")
            if c == "]" and not first:
                self._pos += 1
                break
            first = False
            if c == "\\":
                self._pos += 2
                c = self._pat[self._pos - 1]
            else:
                self._pos += 1
            if self._peek() == "-" and self._pos + 1 < len(self._pat) \
                    and self._pat[self._pos + 1] != "]":
                self._pos += 1
                hi = self._peek()
                if hi == "\\":
                    self._pos += 1
                    hi = self._peek()
                self._pos += 1
                ranges.append((c, hi))
            else:
                chars.add(c)
        return self._lit(("class", frozenset(chars), tuple(ranges), neg))

    def _lit(self, pred):
        s, e = self._new(), self._new()
        self._trans[s].append((pred, e))
        return s, e

    # -- simulation ---------------------------------------------------

    @staticmethod
    def _match(pred, ch: str) -> bool:
        kind = pred[0]
        if kind == "any":
            return True
        if kind == "char":
            return ch == pred[1]
        _, chars, ranges, neg = pred
        hit = ch in chars or any(lo <= ch <= hi for lo, hi in ranges)
        return hit != neg

    def _closure(self, states: set) -> set:
        stack, seen = list(states), set(states)
        while stack:
            for nxt in self._eps[stack.pop()]:
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append(nxt)
        return seen

    def move(self, dstate: frozenset, ch: str) -> frozenset:
        """One char step of the lazy DFA (cached)."""
        key = (dstate, ch)
        out = self._moves.get(key)
        if out is None:
            nxt = set()
            for s in dstate:
                for pred, dst in self._trans[s]:
                    if self._match(pred, ch):
                        nxt.add(dst)
            out = frozenset(self._closure(nxt)) if nxt else frozenset()
            self._moves[key] = out
        return out

    def accepting(self, dstate: frozenset) -> bool:
        return self._accept in dstate

    def walk(self, dstate: frozenset, text: str) -> frozenset:
        for ch in text:
            if not dstate:
                return dstate
            dstate = self.move(dstate, ch)
        return dstate


class _TokenMachine:
    """Token-level transition table over a char regex: per DFA state,
    which token ids keep the automaton alive (prefix-viable — every NFA
    state Thompson builds can reach accept, so a viable prefix always
    completes), and where each allowed token lands.  Built lazily per
    state and cached on the SPEC (shared across requests/servers)."""

    def __init__(self, rx: _Regex, vocab: list, eos_id: int | None):
        self.rx = rx
        self.vocab = [str(t) for t in vocab]
        self.eos_id = eos_id
        self._table: dict = {}   # dstate -> (mask np.bool_[V], {tid: nxt})

    def table(self, dstate: frozenset):
        ent = self._table.get(dstate)
        if ent is None:
            V = len(self.vocab)
            mask = np.zeros(V, bool)
            nxt = {}
            for tid, text in enumerate(self.vocab):
                if tid == self.eos_id:
                    continue                         # handled below
                if not text:
                    continue                         # empty token: stall
                land = self.rx.walk(dstate, text)
                if land:
                    mask[tid] = True
                    nxt[tid] = land
            if self.eos_id is not None and self.rx.accepting(dstate):
                mask[self.eos_id] = True
            ent = (mask, nxt)
            self._table[dstate] = ent
        return ent


class Constraint:
    """Base class for ``submit(..., constraint=)`` specs.  A spec is a
    compiled, shareable TEMPLATE; :meth:`start` mints the per-request
    state machine the server advances from fetched tokens."""

    def start(self, vocab_size: int) -> "ConstraintState":
        raise NotImplementedError


class ConstraintState:
    """One request's live automaton position.

    ``allowed_mask()`` -> np.bool_[V] (True = allowed next token);
    ``advance(t)`` moves past an appended token; ``exhausted`` means no
    continuation exists (finished language, or eos consumed) — the
    server retires the slot."""

    def __init__(self, mask, machine: _TokenMachine | None,
                 state: frozenset | None, eos_id: int | None):
        self._fixed = mask                           # token-set form
        self._m = machine
        self._state = state
        self._eos = eos_id
        self.exhausted = False

    def allowed_mask(self) -> np.ndarray:
        if self._m is None:
            return self._fixed
        mask, _ = self._m.table(self._state)
        return mask

    def advance(self, t: int) -> None:
        if self.exhausted:
            return
        if self._eos is not None and int(t) == self._eos:
            self.exhausted = True
            return
        if self._m is None:
            return
        _, nxt = self._m.table(self._state)
        land = nxt.get(int(t))
        if land is None:
            # the model emitted a banned token (only possible if the
            # caller bypassed the mask); die closed rather than emit
            # invalid output forever
            self.exhausted = True
            return
        self._state = land
        mask, _ = self._m.table(self._state)
        if not mask.any():
            self.exhausted = True                    # finished language


class ConstraintLookahead:
    """A NON-MUTATING cursor over a :class:`ConstraintState`'s automaton
    — the tree-speculation primitive.  Pruning a proposed token tree
    needs the DFA advanced down *several* branches from the request's
    current position without committing any of them; ``child(t)`` mints
    an independently-advanced cursor (die-closed exactly like
    ``ConstraintState.advance``), so one cursor per live tree node walks
    the whole trie while the request's real state stays untouched until
    acceptance.  The per-state token table is the machine's lazy cache,
    shared with the live state — lookahead costs no extra table builds
    beyond states the walk actually visits.

    Duck-types ``allowed_mask()``/``exhausted`` with ConstraintState, so
    :func:`apply_constraint_host` masks accept-time logit rows through a
    cursor unchanged."""

    __slots__ = ("_fixed", "_m", "_state", "_eos", "exhausted")

    def __init__(self, fixed, machine, state, eos_id, exhausted=False):
        self._fixed = fixed
        self._m = machine
        self._state = state
        self._eos = eos_id
        self.exhausted = exhausted

    def allowed_mask(self) -> np.ndarray:
        if self._m is None:
            return self._fixed
        mask, _ = self._m.table(self._state)
        return mask

    def allows(self, t: int) -> bool:
        """Would the automaton accept ``t`` here?  (eos rides the mask:
        allowed exactly when the current state admits ending.)"""
        if self.exhausted:
            return False
        return bool(self.allowed_mask()[int(t)])

    def child(self, t: int) -> "ConstraintLookahead":
        """A NEW cursor advanced past ``t`` — ``self`` is untouched, so
        sibling branches each get their own continuation."""
        if self.exhausted:
            return self
        if self._eos is not None and int(t) == self._eos:
            return ConstraintLookahead(self._fixed, self._m, self._state,
                                       self._eos, exhausted=True)
        if self._m is None:
            return self                              # token-set: static
        _, nxt = self._m.table(self._state)
        land = nxt.get(int(t))
        if land is None:                             # banned: die closed
            return ConstraintLookahead(self._fixed, self._m, self._state,
                                       self._eos, exhausted=True)
        mask, _ = self._m.table(land)
        return ConstraintLookahead(self._fixed, self._m, land, self._eos,
                                   exhausted=not mask.any())


def constraint_lookahead(cst: ConstraintState) -> ConstraintLookahead:
    """Mint a lookahead cursor positioned at a live request state."""
    return ConstraintLookahead(cst._fixed, cst._m, cst._state, cst._eos,
                               exhausted=cst.exhausted)


class TokenSetConstraint(Constraint):
    """Raw allowed-token-set escape hatch: every generated token must be
    in ``allowed`` (``eos_id``, when given, is always allowed so the
    request can end)."""

    def __init__(self, allowed: Iterable[int], eos_id: int | None = None):
        self.allowed = sorted({int(t) for t in allowed})
        if not self.allowed:
            raise ValueError("empty allowed-token set")
        self.eos_id = eos_id

    def start(self, vocab_size: int) -> ConstraintState:
        if self.allowed[-1] >= vocab_size or self.allowed[0] < 0:
            raise ValueError(
                f"allowed token ids {self.allowed[0]}..{self.allowed[-1]} "
                f"out of vocab range [0, {vocab_size})")
        mask = np.zeros(vocab_size, bool)
        mask[self.allowed] = True
        if self.eos_id is not None:
            mask[self.eos_id] = True
        return ConstraintState(mask, None, None, self.eos_id)


class RegexConstraint(Constraint):
    """Regex-automaton constraint: ``vocab[i]`` is token i's decoded
    text; generated text must stay a viable prefix of ``pattern``, and
    eos (when the server has one) is allowed exactly at accepting
    states.  The token table is built lazily per automaton state and
    shared across every request using this spec."""

    def __init__(self, pattern: str, vocab: list,
                 eos_id: int | None = None):
        self.pattern = pattern
        self._machine = _TokenMachine(_Regex(pattern), vocab, eos_id)
        self.eos_id = eos_id

    @property
    def vocab_size(self) -> int:
        return len(self._machine.vocab)

    def start(self, vocab_size: int) -> ConstraintState:
        if self.vocab_size != vocab_size:
            raise ValueError(
                f"constraint vocab has {self.vocab_size} entries, model "
                f"vocab is {vocab_size}")
        st = ConstraintState(None, self._machine,
                             self._machine.rx.start_state, self.eos_id)
        if not st.allowed_mask().any():
            raise ValueError(
                f"pattern {self.pattern!r}: no vocab token is a viable "
                f"first step")
        return st


def _rx_escape(text: str) -> str:
    return "".join("\\" + c if c in r"\.[]()|*+?^{}-" else c
                   for c in text)


def _schema_to_regex(schema: dict) -> str:
    """JSON schema -> regex over the COMPACT serialization (no
    whitespace — ``json.dumps(..., separators=(',', ':'))`` form).

    Supported: object (all listed properties required, in listing
    order), string (escape-free), integer, number, boolean, null, enum
    (any JSON-dumpable values), array-of-items.  That is the product-
    output-contract subset; anything else raises."""
    if not isinstance(schema, dict):
        raise ValueError(f"schema must be a dict, got {type(schema)}")
    if "enum" in schema:
        opts = [_rx_escape(json.dumps(v, separators=(",", ":")))
                for v in schema["enum"]]
        return "(" + "|".join(opts) + ")"
    t = schema.get("type")
    if t == "object":
        props = schema.get("properties", {})
        body = ",".join(
            _rx_escape(json.dumps(k)) + ":" + _schema_to_regex(v)
            for k, v in props.items())
        return r"\{" + body + r"\}"
    if t == "array":
        item = _schema_to_regex(schema.get("items", {"type": "integer"}))
        return r"\[(" + item + "(," + item + r")*)?\]"
    if t == "string":
        return r'"[^"\\]*"'
    if t == "integer":
        return r"-?(0|[1-9][0-9]*)"
    if t == "number":
        return r"-?(0|[1-9][0-9]*)(\.[0-9]+)?"
    if t == "boolean":
        return "(true|false)"
    if t == "null":
        return "null"
    raise ValueError(f"unsupported schema node: {schema!r}")


class JsonSchemaConstraint(RegexConstraint):
    """JSON-schema constraint — the common product contract: compiles
    the schema to a regex over the compact serialization and rides the
    regex automaton engine.  Decoded output (``"".join(vocab[t] for t
    in tokens)``) is guaranteed parseable JSON matching the schema's
    shape once the automaton reaches accept (finite schemas — enums,
    booleans, bounded objects — are guaranteed to terminate; string/
    number fields terminate when the model closes them)."""

    def __init__(self, schema: dict, vocab: list,
                 eos_id: int | None = None):
        self.schema = schema
        super().__init__(_schema_to_regex(schema), vocab, eos_id)


def compile_constraint(spec, vocab_size: int) -> ConstraintState:
    """Normalize a ``submit(constraint=)`` argument to a per-request
    state: a :class:`Constraint` spec, or a bare iterable of token ids
    (sugar for :class:`TokenSetConstraint` without eos)."""
    if isinstance(spec, Constraint):
        return spec.start(vocab_size)
    if isinstance(spec, ConstraintState):
        raise ValueError(
            "constraint= takes the spec, not a started state (states are "
            "per-request)")
    try:
        return TokenSetConstraint(spec).start(vocab_size)
    except (TypeError, ValueError) as e:
        raise ValueError(
            f"constraint= must be a Constraint or an iterable of token "
            f"ids: {e}") from None


# ---------------------------------------------------------------------------
# host-side mask builders (the telemetry-counted constraint hot path)
# ---------------------------------------------------------------------------

def mask_logits(constraints: dict, batch: int, vocab_size: int):
    """Build the per-tick additive mask [batch, vocab] float32 from
    {slot: ConstraintState} (slots absent = unconstrained, row stays
    zero).  0 = allowed, NEG_INF = banned; counts
    ``constraint.masked_tokens`` (banned vocab entries this tick — the
    Prometheus counter operators watch for constraint pressure)."""
    m = np.zeros((batch, vocab_size), np.float32)
    banned = 0
    for b, st in constraints.items():
        a = st.allowed_mask()
        m[b, ~a] = NEG_INF
        banned += int(vocab_size - a.sum())
    if banned and _telemetry.enabled():
        _telemetry.count("constraint.masked_tokens", banned)
    return m


def apply_constraint_host(logits_row: np.ndarray,
                          state: ConstraintState) -> np.ndarray:
    """Mask ONE host-side logits row (the admission first-token draw
    happens on host, before any device mask exists); counts
    ``constraint.masked_tokens`` like the batched builder."""
    a = state.allowed_mask()
    if _telemetry.enabled():
        _telemetry.count("constraint.masked_tokens",
                         int(a.size - a.sum()))
    return np.where(a, logits_row, np.float32(NEG_INF))
