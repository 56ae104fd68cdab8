"""The port's constraint engine (paddle_tpu_torch/text/adapters.py, the
host half) against the JAX package's (paddle_tpu/text/adapters.py), on
the same vocabularies:

* the regex NFA / lazy DFA: acceptance and viable prefixes of the same
  strings, and the same parse errors;
* the token machine: the allowed mask and the landing state of every
  token, state by state along walks;
* JSON schema -> regex for each supported node, and the unsupported one;
* lookahead cursors: ``allows`` / ``child`` / ``exhausted`` along a trie,
  leaving the live state where it was;
* ``compile_constraint``'s forms and refusals, ``mask_logits`` and
  ``apply_constraint_host`` with the ``constraint.masked_tokens`` counter.

Host numpy only: no model runs here.
"""
import json

import numpy as np
import pytest

from paddle_tpu import telemetry as jtl
from paddle_tpu.framework import monitor
from paddle_tpu.text import adapters as JA
from paddle_tpu_torch import telemetry as tl
from paddle_tpu_torch.text import adapters as A

# a char-level vocabulary: token i decodes to VOCAB[i]
VOCAB = list('{}":,truefalsokgb0123456789-') + ["?", "!", "#", "~"]
# multi-char tokens too, so a token can cross automaton states
WORDS = VOCAB[:20] + ["true", "false", '{"', '":', "ok", "12", "-0", "",
                      "null", ",\"", "\"}", "a"]

PATTERNS = ["(ab|ba)+", "a*b?c", "[a-c]+x", "[^ab]z", r"\{\"k\":-?[0-9]+\}",
            "(true|false)", "x.y", "a(b|c)*d?"]
STRINGS = ["", "a", "ab", "ba", "abba", "abab", "aab", "c", "bc", "abc",
           "aaacx", "zz", "cz", "{\"k\":-12}", "{\"k\":", "true", "fals",
           "xqy", "abcbd", "ad"]

SCHEMAS = [{"type": "object",
            "properties": {"ok": {"type": "boolean"},
                           "tag": {"enum": ["a", "b"]}}},
           {"type": "array", "items": {"type": "integer"}},
           {"type": "array"},
           {"type": "string"}, {"type": "number"}, {"type": "null"},
           {"enum": [1, "x", None, True]},
           {"type": "object", "properties": {
               "n": {"type": "number"},
               "xs": {"type": "array", "items": {"type": "boolean"}}}}]


def _walk(rx, s):
    return rx.walk(rx.start_state, s)


@pytest.mark.parametrize("pattern", PATTERNS)
def test_regex_matches_jax(pattern):
    """Same viable-prefix and acceptance verdicts on every string."""
    rx, jrx = A._Regex(pattern), JA._Regex(pattern)
    for text in STRINGS:
        d, jd = _walk(rx, text), _walk(jrx, text)
        assert bool(d) == bool(jd), (pattern, text)
        assert rx.accepting(d) == jrx.accepting(jd), (pattern, text)


@pytest.mark.parametrize("bad", ["(ab", "a)", "*a", "[ab", "a|*", "\\"])
def test_regex_errors_match_jax(bad):
    with pytest.raises(ValueError) as mine:
        A._Regex(bad)
    with pytest.raises(ValueError) as theirs:
        JA._Regex(bad)
    assert str(mine.value) == str(theirs.value)


@pytest.mark.parametrize("vocab", [VOCAB, WORDS], ids=["chars", "words"])
@pytest.mark.parametrize("pattern", [r"\{\"ok\":(true|false)\}",
                                     "-?(0|[1-9][0-9]*)", "(ab|ba)+"])
def test_token_machine_matches_jax(vocab, pattern):
    """The allowed mask of every state a greedy walk visits, and where
    each allowed token lands, are the JAX machine's (eos at the last
    index is allowed exactly at accepting states)."""
    eos = len(vocab) - 1
    m = A._TokenMachine(A._Regex(pattern), vocab, eos)
    jm = JA._TokenMachine(JA._Regex(pattern), vocab, eos)
    st, jst = m.rx.start_state, jm.rx.start_state
    rng = np.random.default_rng(0)
    for _ in range(12):
        mask, nxt = m.table(st)
        jmask, jnxt = jm.table(jst)
        np.testing.assert_array_equal(mask, jmask)
        assert sorted(nxt) == sorted(jnxt)
        live = sorted(nxt)
        if not live:
            break
        t = live[int(rng.integers(len(live)))]
        st, jst = nxt[t], jnxt[t]
        assert m.rx.accepting(st) == jm.rx.accepting(jst)


@pytest.mark.parametrize("schema", SCHEMAS, ids=range(len(SCHEMAS)))
def test_schema_to_regex_matches_jax(schema):
    assert A._schema_to_regex(schema) == JA._schema_to_regex(schema)
    assert A._rx_escape(json.dumps(schema)) == JA._rx_escape(
        json.dumps(schema))


def test_unsupported_schema_raises_as_jax():
    for bad in ({"type": "martian"}, ["not", "a", "dict"]):
        with pytest.raises(ValueError) as mine:
            A._schema_to_regex(bad)
        with pytest.raises(ValueError) as theirs:
            JA._schema_to_regex(bad)
        assert str(mine.value) == str(theirs.value)


def _states(pkg, spec_args, n):
    """A started state advanced by a fixed token walk, with the masks
    it allowed at each step."""
    mod = A if pkg == "torch" else JA
    kind, args = spec_args
    st = getattr(mod, kind)(*args).start(n)
    out = []
    rng = np.random.default_rng(1)
    for _ in range(10):
        a = st.allowed_mask().copy()
        out.append((a, st.exhausted))
        if st.exhausted or not a.any():
            break
        live = np.flatnonzero(a)
        st.advance(int(live[rng.integers(len(live))]))
    return out


@pytest.mark.parametrize("spec_args", [
    ("TokenSetConstraint", ([3, 7, 11], 31)),
    ("RegexConstraint", ("(ab|ba)+", list("ab") + ["~"] * 30, 31)),
    ("JsonSchemaConstraint", (SCHEMAS[0], VOCAB, 31)),
    ("JsonSchemaConstraint", ({"type": "object", "properties": {
        "n": {"type": "integer"}}}, VOCAB, None))],
    ids=["tokenset", "regex", "json-object", "json-integer"])
def test_states_advance_as_jax(spec_args):
    """Masks and exhaustion along the same walk, in both packages."""
    mine, theirs = _states("torch", spec_args, 32), \
        _states("jax", spec_args, 32)
    assert len(mine) == len(theirs)
    for (a, ex), (ja, jex) in zip(mine, theirs):
        np.testing.assert_array_equal(a, ja)
        assert ex == jex


def test_lookahead_matches_jax_and_leaves_the_state():
    """Cursors walk a trie from the live state without moving it:
    allows / child / exhausted equal to the JAX cursors, die-closed on a
    banned token, eos ending the walk."""
    spec = A.JsonSchemaConstraint(SCHEMAS[0], VOCAB, eos_id=31)
    jspec = JA.JsonSchemaConstraint(SCHEMAS[0], VOCAB, eos_id=31)
    st, jst = spec.start(32), jspec.start(32)
    text = '{"ok":true'
    for ch in text[:3]:
        st.advance(VOCAB.index(ch))
        jst.advance(VOCAB.index(ch))
    before = st.allowed_mask().copy()
    cur, jcur = A.constraint_lookahead(st), JA.constraint_lookahead(jst)
    for ch in text[3:] + "!":
        t = VOCAB.index(ch)
        assert cur.allows(t) == jcur.allows(t), ch
        cur, jcur = cur.child(t), jcur.child(t)
        assert cur.exhausted == jcur.exhausted, ch
        np.testing.assert_array_equal(cur.allowed_mask(),
                                      jcur.allowed_mask())
    assert cur.exhausted               # "!" is banned: die closed
    np.testing.assert_array_equal(st.allowed_mask(), before)
    # eos at an accepting state ends the walk
    done = A.JsonSchemaConstraint(SCHEMAS[0], VOCAB, eos_id=31).start(32)
    for ch in '{"ok":true,"tag":"a"}':
        done.advance(VOCAB.index(ch))
    c = A.constraint_lookahead(done)
    assert c.allows(31) and c.child(31).exhausted
    assert not c.child(31).allows(0)


def test_compile_constraint_forms_and_errors_as_jax():
    """A spec, an iterable of ids, a started state (refused), an empty
    set and out-of-range ids: the JAX verdicts and messages."""
    np.testing.assert_array_equal(
        A.compile_constraint([1, 4], 8).allowed_mask(),
        JA.compile_constraint([1, 4], 8).allowed_mask())
    for bad, n in (([], 8), ([9], 8), (A.TokenSetConstraint([1]).start(8),
                                       8), (5, 8)):
        jbad = (JA.TokenSetConstraint([1]).start(8)
                if isinstance(bad, A.ConstraintState) else bad)
        with pytest.raises(ValueError) as mine:
            A.compile_constraint(bad, n)
        with pytest.raises(ValueError) as theirs:
            JA.compile_constraint(jbad, n)
        assert str(mine.value) == str(theirs.value)
    with pytest.raises(ValueError, match="empty"):
        A.TokenSetConstraint([])
    rx = A.RegexConstraint("zz", list("ab") + ["~"] * 30)
    with pytest.raises(ValueError, match="viable"):
        rx.start(32)
    with pytest.raises(ValueError, match="vocab"):
        A.RegexConstraint("a", list("ab")).start(16)


def test_mask_logits_and_host_mask_count_as_jax():
    """The [B, V] additive mask (0 allowed, NEG_INF banned; absent slots
    zero) equals the JAX builder's, and both packages count the banned
    entries into ``constraint.masked_tokens``; the host row mask too."""
    tl.reset()
    jtl.reset()
    j0 = int(monitor.get_stat("constraint.masked_tokens").get()) \
        if "constraint.masked_tokens" in monitor.stats() else 0
    cons = {0: A.compile_constraint([3, 7], 16),
            2: A.RegexConstraint("(ab)+", list("ab") + ["~"] * 14)
            .start(16)}
    jcons = {0: JA.compile_constraint([3, 7], 16),
             2: JA.RegexConstraint("(ab)+", list("ab") + ["~"] * 14)
             .start(16)}
    m = A.mask_logits(cons, 3, 16)
    jm = JA.mask_logits(jcons, 3, 16)
    np.testing.assert_array_equal(m, jm)
    assert m.dtype == np.float32 and not m[1].any()
    assert A.NEG_INF == JA.NEG_INF
    row = np.linspace(-1, 1, 16).astype(np.float32)
    np.testing.assert_array_equal(A.apply_constraint_host(row, cons[0]),
                                  JA.apply_constraint_host(row, jcons[0]))
    want = (16 - 2) + (16 - 1) + (16 - 2)
    assert tl.counter("constraint.masked_tokens") == want
    if jtl.enabled():
        assert int(monitor.get_stat("constraint.masked_tokens").get()) \
            - j0 == want
