"""The port's speculative decode against the JAX package's, on the CPU.

Covers ``serving/speculative.py`` (``SpecConfig``, ``CacheTable``,
``accept_chunk``, ``speculative_generate``, ``SpeculativeDecoder``),
``models/decode.py``'s ``decode_steps`` / ``kv_trim`` and the engine's
``spec=`` path, at ``repro.testing.tiny_config`` of the dense LMs.

What is held, and how tightly:
  * the table, the acceptance walk, the key tokens and the loop over a
    numpy oracle give ``repro``'s outputs and counters exactly, on the same
    seeded inputs (pure Python on both sides);
  * ``decode_steps`` is within ``CONFORMANCE_TOL`` (3e-5 float32) of
    ``repro``'s, logits and caches (the packages sum in different orders;
    ``repro``'s scheduled steps run on its ``backend="xla"``, which its
    own tests hold equal to its Pallas kernel);
  * the port's ``decode_steps`` gives its OWN sequential chain's bits,
    logits and caches, for every dense arch, schedule and dtype: the claim
    speculation rests on (``kv_trim`` likewise);
  * the engine's speculative tokens equal the port's sequential tokens and
    ``repro``'s engine's, token by token;
  * ``speculative_generate`` over the port's ``rnn_decode_step`` (float,
    ``ap_fixed<16,6>``, native ``ap_fixed<8,3>``) equals sequential greedy.
Hypothesis tests run with ``deadline=None``.
"""

import dataclasses

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.schedule import KernelSchedule as JSchedule  # noqa: E402
from repro.models import decode as jdecode  # noqa: E402
from repro.registry import get_config as jget_config  # noqa: E402
from repro.serving import LMServingEngine as JLMEngine  # noqa: E402
from repro.serving import speculative as jspec  # noqa: E402
from repro.testing import tiny_config  # noqa: E402

from repro_torch.config import FixedPointConfig  # noqa: E402
from repro_torch.configs import LMS  # noqa: E402
from repro_torch.core.quant.fixed_point import (is_native_int,  # noqa: E402
                                                quantize_np)
from repro_torch.core.rnn.cells import initial_state  # noqa: E402
from repro_torch.kernels import cuda  # noqa: E402
from repro_torch.kernels.decode_step import rnn_decode_step  # noqa: E402
from repro_torch.kernels.schedule import KernelSchedule  # noqa: E402
from repro_torch.models import decode as tdecode  # noqa: E402
from repro_torch.serving import (CacheTable, LMServingEngine,  # noqa: E402
                                 SpecConfig, accept_chunk,
                                 speculative_generate)
from repro_torch.serving import speculative as tspec  # noqa: E402

from test_torch_lm import close, port_config, setup  # noqa: E402

#: every dense LM the port carries (the other families:
#: tests/test_torch_families.py)
ARCHS = tuple(sorted(k for k, c in LMS.items() if c.family == "dense"))


@pytest.fixture(scope="module")
def lm():
    return setup("stablelm-3b")


def schedules(R, backend="auto"):
    """The same schedule in both packages; ``repro``'s on its plain
    ``xla`` backend (its Pallas kernel in interpret mode is far slower, and
    its own tests hold the two equal)."""
    return (JSchedule(reuse_factor=R, block_batch=8, backend="xla"),
            KernelSchedule(reuse_factor=R, block_batch=8, backend=backend))


# ---------------------------------------------------------------------------
# SpecConfig, CacheTable, accept_chunk: equal to repro's, exactly
# ---------------------------------------------------------------------------


def spec_pair(**kw):
    """One SpecConfig in both packages (``draft`` given as a reuse factor
    on the ``xla`` backend)."""
    r = kw.pop("draft", None)
    j = jspec.SpecConfig(**kw, draft=None if r is None else JSchedule(
        reuse_factor=r, block_batch=8, backend="xla"))
    t = SpecConfig(**kw, draft=None if r is None else KernelSchedule(
        reuse_factor=r, block_batch=8, backend="xla"))
    return j, t


@pytest.mark.parametrize("kw", [
    {}, {"k": 0}, {"k": 2, "ngram_n": 5}, {"k": 4, "trim": True},
    {"k": 2, "draft": 8}, {"k": 3, "draft": 4, "trim": True}],
    ids=["default", "k0", "ngram5", "trim", "draftR8", "draftR4-trim"])
def test_spec_config_key_token_equals_repro(kw):
    j, t = spec_pair(**kw)
    assert t.key_token() == j.key_token()
    assert "-" not in t.key_token()
    assert dataclasses.asdict(t).keys() == dataclasses.asdict(j).keys()
    full = KernelSchedule(reuse_factor=1).key() + "-" + t.key_token()
    assert KernelSchedule.from_key(full).key() == \
        KernelSchedule(reuse_factor=1).key()


@pytest.mark.parametrize("bad", [{"k": -1}, {"ngram_n": 0},
                                 {"capacity": 0}, {"lru_size": 0}])
def test_spec_config_validation_equals_repro(bad):
    with pytest.raises(ValueError):
        jspec.SpecConfig(**bad)
    with pytest.raises(ValueError):
        SpecConfig(**bad)


def table_state(t):
    return (len(t), t.hits, t.misses, t.evictions,
            [(k, list(v)) for k, v in t._table.items()])


def replay_table(cls, ops, **kw):
    """Run ``ops`` on a fresh table of ``cls``; the answers and the end
    state."""
    t = cls(**kw)
    out = []
    for op, args in ops:
        out.append(getattr(t, op)(*args))
    return out, table_state(t)


def table_ops(seed, n_ops, n):
    rnd = np.random.RandomState(seed)
    ops = []
    for _ in range(n_ops):
        ctx = [int(x) for x in rnd.randint(0, 4, size=n)]
        kind = rnd.randint(0, 5)
        if kind == 0:
            ops.append(("insert", (ctx, int(rnd.randint(0, 6)))))
        elif kind == 1:
            ops.append(("lookup", (ctx,)))
        elif kind == 2:
            ops.append(("candidates", (ctx,)))
        elif kind == 3:
            stream = [int(x) for x in rnd.randint(0, 4, size=12)]
            ops.append(("observe", (stream, int(rnd.randint(0, 6)))))
        else:
            stream = [int(x) for x in rnd.randint(0, 4, size=6)]
            ops.append(("draft", (stream, int(rnd.randint(0, 5)))))
    return ops


@settings(max_examples=25, deadline=None)
@given(capacity=st.integers(1, 6), lru=st.integers(1, 3),
       n=st.integers(1, 3), seed=st.integers(0, 10_000),
       n_ops=st.integers(1, 40))
def test_cache_table_replays_repro(capacity, lru, n, seed, n_ops):
    """A seeded op sequence (insert, lookup, candidates, observe, draft)
    gives repro's answers, counters and LRU order, and the invariants
    hold: size <= capacity, no duplicate candidates, rows <= lru_size."""
    ops = table_ops(seed, n_ops, n)
    kw = dict(n=n, capacity=capacity, lru_size=lru)
    got, gstate = replay_table(CacheTable, ops, **kw)
    want, wstate = replay_table(jspec.CacheTable, ops, **kw)
    assert got == want and gstate == wstate
    assert gstate[0] <= capacity
    for _, row in gstate[4]:
        assert len(row) == len(set(row)) <= lru


def test_cache_table_units():
    """repro's unit cases: promotion, LRU eviction, a cycle drafted from
    its suffix, bad parameters, short contexts."""
    t = CacheTable(n=3, capacity=8, lru_size=2)
    t.insert([1, 2, 3], 7)
    assert t.lookup([1, 2, 3]) == 7
    t.insert([1, 2, 3], 9)
    t.insert([1, 2, 3], 7)
    assert t.candidates([1, 2, 3]) == [7, 9]
    t.insert([1, 2, 3], 5)
    assert t.candidates([1, 2, 3]) == [5, 7]
    t = CacheTable(n=2, capacity=3, lru_size=2)
    for i in (1, 2, 3):
        t.insert([i, i], i)
    assert t.lookup([1, 1]) == 1
    t.insert([4, 4], 4)
    assert t.lookup([2, 2]) is None and t.evictions == 1 and len(t) == 3
    t = CacheTable(n=3, capacity=64, lru_size=4)
    stream = [1, 2, 3, 4, 5] * 4
    t.observe(stream)
    assert t.draft(stream, 5) == [1, 2, 3, 4, 5]
    with pytest.raises(ValueError):
        CacheTable(n=0)
    t = CacheTable(n=3)
    t.insert([1, 2], 9)
    assert len(t) == 0 and t.draft([5], 3) == [5, 5, 5]


ACCEPT_CASES = [
    ([1, 5, 6], [5, 6, 7], [3, 1], 2, 1, 16, 1 << 30),
    ([1, 9, 9], [5, 6, 7], [3, 1], 2, 1, 16, 1 << 30),
    ([4, 7, 2, 9], [1, 1, 1, 8], [4, 7, 2, 9], 4, 0, 16, 1 << 30),
    ([1, 5, 6], [5, 6, 7], [3, 1], 2, 1, 1, 1 << 30),
    ([1, 5, 6], [5, 6, 7], [3, 1], 2, 1, 16, 3),
]


@pytest.mark.parametrize("case", range(len(ACCEPT_CASES)))
def test_accept_chunk_cases_equal_repro(case):
    inputs, greedy, toks, plen, pos, max_new, max_seq = ACCEPT_CASES[case]
    kw = dict(tokens=toks, plen=plen, pos=pos, max_new=max_new,
              max_seq=max_seq)
    got = accept_chunk(inputs, greedy, **kw)
    want = jspec.accept_chunk(inputs, greedy, **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 10_000), k=st.integers(0, 5),
       plen=st.integers(1, 4), max_new=st.integers(1, 6),
       max_seq=st.integers(2, 12))
def test_accept_chunk_equals_repro(seed, k, plen, max_new, max_seq):
    """Arbitrary chunks: the same RowAdvance as repro's, and drafted ==
    accepted + rejected."""
    rnd = np.random.RandomState(seed)
    toks = [int(x) for x in rnd.randint(0, 8, size=plen + rnd.randint(3))]
    pos = int(rnd.randint(0, len(toks)))
    S = k + 1
    inputs = [toks[pos + i] if pos + i < len(toks) else int(rnd.randint(8))
              for i in range(S)]
    greedy = [int(x) for x in rnd.randint(0, 8, size=S)]
    kw = dict(tokens=toks, plen=plen, pos=pos, max_new=max_new,
              max_seq=max_seq)
    got = accept_chunk(inputs, greedy, **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(
        jspec.accept_chunk(inputs, greedy, **kw))
    assert got.drafted == got.accepted + got.rejected
    assert got.advanced >= 1 and len(got.emitted) <= S


# ---------------------------------------------------------------------------
# speculative_generate over oracles
# ---------------------------------------------------------------------------


def numpy_oracle(vocab=12, seed=0):
    """A stateless next-token oracle in numpy: logits from a hash of the
    last three tokens, with a loop in it (so n-gram drafts hit)."""
    table = np.random.RandomState(seed).randn(vocab ** 3, vocab)

    def step_fn(ctx):
        a, b, c = ([0, 0] + list(ctx))[-3:]
        return table[(a * vocab + b) * vocab + c]

    return step_fn


def sequential_greedy(step_fn, prompt, max_new):
    toks = list(prompt)
    for _ in range(max_new):
        toks.append(int(np.argmax(tspec._host(step_fn(toks)))))
    return toks[len(prompt):]


@pytest.mark.parametrize("k", [0, 1, 3, 5])
@pytest.mark.parametrize("seed", [0, 1])
def test_speculative_generate_equals_repro(k, seed):
    """Tokens, counters and the n-gram table's state equal repro's; the
    tokens are sequential greedy's."""
    step_fn = numpy_oracle(seed=seed)
    prompt = [3, 1, 3, 1, 4]
    tt, jt = CacheTable(), jspec.CacheTable()
    got, gstats = speculative_generate(step_fn, prompt, 20, k=k, table=tt)
    want, wstats = jspec.speculative_generate(step_fn, prompt, 20, k=k,
                                              table=jt)
    assert got == want == sequential_greedy(step_fn, prompt, 20)
    assert gstats == wstats
    assert gstats["drafted"] == gstats["accepted"] + gstats["rejected"]
    assert table_state(tt) == table_state(jt)


def test_speculative_generate_draft_fns_and_max_seq():
    step_fn = numpy_oracle(seed=2)
    prompt = [2, 5, 2]

    def oracle_draft(toks, k):          # accept-all: the true greedy
        out, cur = [], list(toks)
        for _ in range(k):
            cur.append(int(np.argmax(step_fn(cur))))
            out.append(cur[-1])
        return out

    def wrong_draft(toks, k):           # reject-all
        return [(t + 1) % 12 for t in oracle_draft(toks, k)]

    for fn in (oracle_draft, wrong_draft):
        got, stats = speculative_generate(step_fn, prompt, 8, k=3,
                                          draft_fn=fn, max_seq=9)
        want, wstats = jspec.speculative_generate(step_fn, prompt, 8, k=3,
                                                  draft_fn=fn, max_seq=9)
        assert (got, stats) == (want, wstats)
    got, stats = speculative_generate(step_fn, prompt, 8, k=3,
                                      draft_fn=oracle_draft)
    assert got == sequential_greedy(step_fn, prompt, 8)
    assert stats["rejected"] == 0 and stats["accepted"] == 6
    got, stats = speculative_generate(step_fn, prompt, 6, k=3,
                                      draft_fn=wrong_draft)
    assert stats["accepted"] == 0 and stats["rejected"] == stats["drafted"]


def rnn_oracle(fp, schedule, vocab=12, hidden=8, seed=0):
    """A stateless toy LM over the port's ``rnn_decode_step``: one-hot
    embedding, the scheduled LSTM step over the context (the native int8
    step where ``fp`` is integral on a kernel schedule), h onto the
    vocab (as repro's test_speculative.py builds it)."""
    rng = np.random.RandomState(seed)

    def weight(*shape):
        w = rng.randn(*shape).astype(np.float32) * .4
        return quantize_np(w, fp) if fp else w

    W, U = weight(vocab, 4 * hidden), weight(hidden, 4 * hidden)
    b = np.zeros((4 * hidden,), np.float32)
    E = rng.randn(hidden, vocab).astype(np.float32)
    Wt, Ut, bt, Et = map(torch.from_numpy, (W, U, b, E))

    def step_fn(ctx):
        state = initial_state("lstm", 1, hidden, torch.float32, "cpu")
        for t in ctx:
            x = torch.zeros(1, vocab)
            x[0, int(t)] = 1.0
            h, state = rnn_decode_step("lstm", x, state, Wt, Ut, bt,
                                       schedule=schedule, fp=fp)
        return (h @ Et)[0]

    return step_fn


@pytest.mark.parametrize("fp,R", [
    (None, None), (FixedPointConfig(16, 6), None),
    (FixedPointConfig(8, 3), 2)], ids=["float", "ap16_6", "native-ap8_3"])
@pytest.mark.parametrize("k", [2, 4])
def test_speculative_generate_exact_over_rnn_decode_step(fp, R, k):
    sched = None if R is None else KernelSchedule(reuse_factor=R,
                                                  block_batch=8)
    if sched is not None:
        assert is_native_int(fp)        # the native step runs
    step_fn = rnn_oracle(fp, sched)
    prompt = [3, 1, 3, 1]
    got, stats = speculative_generate(step_fn, prompt, 8, k=k)
    assert got == sequential_greedy(step_fn, prompt, 8)
    assert stats["drafted"] == stats["accepted"] + stats["rejected"]
    assert stats["rounds"] >= 1


# ---------------------------------------------------------------------------
# decode_steps / kv_trim
# ---------------------------------------------------------------------------


def chain(cfg, params, cache, toks, pos0, sched):
    """S sequential decode_steps: (logits [B, S, V], cache)."""
    outs = []
    for i in range(toks.shape[1]):
        li, cache = tdecode.decode_step(cfg, params, cache,
                                        toks[:, i:i + 1], pos0 + i,
                                        schedule=sched)
        outs.append(li)
    return torch.cat(outs, 1), cache


SCHEDS = {"einsum": None, "R1": KernelSchedule(reuse_factor=1),
          "R2": KernelSchedule(reuse_factor=2),
          "R4-xla": KernelSchedule(reuse_factor=4, backend="xla")}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sched", list(SCHEDS))
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_bits_equal_own_sequential_chain(arch, sched, dtype):
    """One pass over S = 5 tokens a row gives the bits of 5 sequential
    decode_steps, logits and caches, at ragged start positions over a
    cache holding stale entries: the exactness speculation rests on."""
    cfg = port_config(tiny_config(jget_config(arch))).replace(
        param_dtype=dtype, compute_dtype=dtype)
    from repro_torch.models.model import build_model

    params = build_model(cfg).init(torch.Generator().manual_seed(1), "cpu")
    s = SCHEDS[sched]
    S = 5
    rng = np.random.RandomState(4)
    # B = 2: a [B, S, d] unembedding rounds otherwise than S [B, 1, d] ones
    # on MKL; B = 3: ragged start positions
    for pos0 in (torch.tensor([0, 7]), torch.tensor([0, 3, 9])):
        B = len(pos0)
        toks = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, S)))
        cache = tdecode.init_cache(cfg, B, 16, "float32", "cpu")
        cache = {k: torch.from_numpy(rng.randn(*v.shape).astype(np.float32))
                 for k, v in cache.items()}     # stale entries everywhere
        want, wcache = chain(cfg, params, dict(cache), toks, pos0, s)
        before = dict(cuda.LAUNCHES)
        got, gcache = tdecode.decode_steps(cfg, params, dict(cache), toks,
                                           pos0, schedule=s)
        assert cuda.LAUNCHES == before
        assert got.dtype == want.dtype and torch.equal(got, want), B
        for k in wcache:
            assert torch.equal(gcache[k], wcache[k]), (B, k)


@pytest.mark.parametrize("R", [None, 1, 2], ids=["einsum", "R1", "R2"])
@pytest.mark.parametrize("arch", ["gemma-2b", "stablelm-3b"])
def test_decode_steps_match_repro(arch, R):
    jcfg, tcfg, jparams, tparams = setup(arch)
    js, ts = (None, None) if R is None else schedules(R)
    B, S = 2, 3
    toks = np.random.RandomState(0).randint(0, jcfg.vocab_size, (B, S))
    pos0 = np.array([0, 3])
    jc = {k: jnp.zeros(s.shape, jnp.dtype(s.dtype))
          for k, s in jdecode.cache_specs(jcfg, B, 16, "float32").items()}
    tc = tdecode.init_cache(tcfg, B, 16, "float32", "cpu")
    jl, jc = jdecode.decode_steps(jcfg, jparams, jc, jnp.asarray(toks),
                                  jnp.asarray(pos0, jnp.int32), schedule=js)
    tl, tc = tdecode.decode_steps(tcfg, tparams, tc, torch.from_numpy(toks),
                                  torch.from_numpy(pos0), schedule=ts)
    close(tl.numpy(), np.asarray(jl))
    for k in jc:
        close(tc[k].numpy(), np.asarray(jc[k]))


@pytest.mark.parametrize("R", [None, 1], ids=["einsum", "R1"])
def test_kv_trim_equals_repro_and_the_sequential_prefix(lm, R):
    """Wrong-branch writes past the accepted prefix, then kv_trim: the
    cache of the clean prefix bit for bit, repro's kv_trim of the same
    cache bit for bit, and decoding on from it gives the same logits."""
    _, cfg, _, params = lm
    s = None if R is None else KernelSchedule(reuse_factor=R)
    B = 2
    toks = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab_size, (B, 6)))
    pos0 = torch.tensor([0, 2])
    zero = tdecode.init_cache(cfg, B, 16, "float32", "cpu")
    _, clean = chain(cfg, params, dict(zero), toks[:, :3], pos0, s)
    _, dirty = tdecode.decode_steps(cfg, params, dict(clean), toks[:, 3:],
                                    pos0 + 3, schedule=s)
    assert not torch.equal(dirty["cache/k"], clean["cache/k"])
    trimmed = tdecode.kv_trim(dirty, pos0 + 3)
    jtrim = jdecode.kv_trim({k: jnp.asarray(v.numpy())
                             for k, v in dirty.items()},
                            jnp.asarray(pos0.numpy() + 3, jnp.int32))
    for k in clean:
        assert torch.equal(trimmed[k], clean[k]), k
        np.testing.assert_array_equal(trimmed[k].numpy(),
                                      np.asarray(jtrim[k]))
    l1, _ = tdecode.decode_step(cfg, params, trimmed, toks[:, 3:4],
                                pos0 + 3, schedule=s)
    l2, _ = tdecode.decode_step(cfg, params, clean, toks[:, 3:4], pos0 + 3,
                                schedule=s)
    assert torch.equal(l1, l2)
    extra = dict(dirty, other=torch.ones(3))
    assert tdecode.kv_trim(extra, pos0)["other"] is extra["other"]


# ---------------------------------------------------------------------------
# the engine: speculative tokens == sequential tokens == repro's
# ---------------------------------------------------------------------------


def serve(eng_cls, cfg, params, prompts, max_new, schedule=None, spec=None,
          **kw):
    eng = eng_cls(cfg, params, max_batch=len(prompts) + 1, max_seq=64,
                  schedule=schedule, spec=spec, **kw)
    ids = [eng.add_request(list(p), max_new=max_new) for p in prompts]
    out = eng.run_to_completion()
    return [list(out[i]) for i in ids], eng


ENGINE_CASES = {
    "ngram-default-k3": (None, {"k": 3}),
    "ngram-R1-k2": (1, {"k": 2}),
    "ngram-R4-k4-trim": (4, {"k": 4, "trim": True}),
    "draftR8-R1-k2": (1, {"k": 2, "draft": 8}),
    "draftR8-default-k3": (None, {"k": 3, "draft": 8}),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_speculative_tokens_equal_sequential_and_repro(lm, case):
    """repro's five (schedule, spec) cases: the port's speculative tokens
    equal its sequential key's and repro's speculative engine's, token by
    token; exact accounting equal to repro's; one verify executor, at
    most one draft executor."""
    jcfg, tcfg, jparams, tparams = lm
    R, kw = ENGINE_CASES[case]
    js, ts = (None, None) if R is None else schedules(R)
    jsp, tsp = spec_pair(**kw)
    rng = np.random.RandomState(2)
    prompts = [list(rng.randint(0, jcfg.vocab_size, size=4))
               for _ in range(3)]
    plain, _ = serve(LMServingEngine, tcfg, tparams, prompts, 10,
                     schedule=ts, device="cpu")
    got, eng = serve(LMServingEngine, tcfg, tparams, prompts, 10,
                     schedule=ts, spec=tsp, device="cpu")
    want, jeng = serve(JLMEngine, jcfg, jparams, prompts, 10, schedule=js,
                       spec=jsp)
    assert got == plain == [[int(t) for t in w] for w in want]
    acc = eng.verify_spec_accounting()
    (key,) = acc
    assert acc[key]["drafted"] == acc[key]["accepted"] + acc[key]["rejected"]
    (jkey,) = jeng.verify_spec_accounting()
    assert acc[key] == jeng.verify_spec_accounting()[jkey]
    sd = eng._decoders[key].spec_dec
    assert sd.verify_traces == 1 and sd.draft_traces <= 1
    assert eng.trace_count(key) == 1
    assert key.endswith("-" + tsp.key_token())


def test_engine_k0_disables_speculation(lm):
    _, cfg, _, params = lm
    eng = LMServingEngine(cfg, params, max_batch=2, max_seq=32,
                          spec=SpecConfig(k=0), device="cpu")
    assert eng.keys() == ["default"]
    rid = eng.add_request([3, 1, 4], max_new=4)
    out = eng.run_to_completion()
    plain, _ = serve(LMServingEngine, cfg, params, [[3, 1, 4]], 4,
                     device="cpu")
    assert list(out[rid]) == plain[0]
    assert eng.verify_spec_accounting() == {}
    rep = eng.serve_report()["default"]
    assert rep["accept_rate"] is None and rep["spec"] is None
    assert rep["draft_traces"] == 0
    eng2 = LMServingEngine(cfg, params, max_batch=2, max_seq=32,
                           spec=SpecConfig(k=2), device="cpu")
    eng2.add_request([3, 1, 4], max_new=4, spec=SpecConfig(k=0))
    assert "default" in eng2.keys()
    with pytest.raises(ValueError, match="k >= 1"):
        tspec.SpeculativeDecoder(cfg, "x", None, SpecConfig(k=0),
                                 max_batch=1, max_seq=8,
                                 cache_dtype="float32", params=params,
                                 device="cpu")


def test_engine_spec_key_isolated_from_plain_traffic(lm):
    _, cfg, _, params = lm
    eng = LMServingEngine(cfg, params, max_batch=2, max_seq=32,
                          device="cpu")
    r1 = eng.add_request([5, 2], max_new=3)
    r2 = eng.add_request([5, 2], max_new=3, spec=SpecConfig(k=2))
    out = eng.run_to_completion()
    assert list(out[r1]) == list(out[r2])
    assert eng.keys() == ["default", "default-spec[k2_ngram3]"]
    assert eng._decoders["default"].cache is not \
        eng._decoders["default-spec[k2_ngram3]"].cache


def test_engine_spec_slot_reuse_and_queue_full(lm):
    _, cfg, _, params = lm
    eng = LMServingEngine(cfg, params, max_batch=2, max_seq=32,
                          spec=SpecConfig(k=2), device="cpu")
    a = eng.add_request([1, 2], max_new=2)
    b = eng.add_request([3, 4], max_new=2)
    assert eng.add_request([5, 6], max_new=2) is None
    out = eng.run_to_completion()
    assert set(out) == {a, b}
    c = eng.add_request([5, 6], max_new=2)
    assert c is not None
    out2 = eng.run_to_completion()
    ref, _ = serve(LMServingEngine, cfg, params, [[5, 6]], 2, device="cpu")
    assert list(out2[c]) == ref[0]


def test_engine_spec_serve_report_has_repro_fields(lm):
    """The report row and its spec column carry repro's field set;
    tokens/s counts accepted tokens; tampering breaks the accounting."""
    jcfg, cfg, jparams, params = lm
    rng = np.random.RandomState(3)
    prompts = [list(rng.randint(0, cfg.vocab_size, size=3))
               for _ in range(2)]
    for R, kw in ((None, {"k": 3}), (1, {"k": 2, "draft": 4})):
        js, ts = (None, None) if R is None else schedules(R)
        jsp, tsp = spec_pair(**kw)
        _, eng = serve(LMServingEngine, cfg, params, prompts, 6,
                       schedule=ts, spec=tsp, device="cpu")
        _, jeng = serve(JLMEngine, jcfg, jparams, prompts, 6, schedule=js,
                        spec=jsp)
        (key,) = eng.keys()
        (jkey,) = jeng.keys()
        rep, jrep = eng.serve_report()[key], jeng.serve_report()[jkey]
        assert set(jrep) <= set(rep)
        assert set(rep["spec"]) == set(jrep["spec"])
        assert rep["spec"] == {**jrep["spec"], "draft": rep["spec"]["draft"]}
        sd = rep["spec"]
        assert sd["drafted"] == sd["accepted"] + sd["rejected"]
        assert sd["rounds"] > 0 and sd["verify_traces"] == 1
        assert rep["accept_rate"] == sd["accept_rate"]
        assert rep["draft_traces"] == (0 if tsp.draft is None else 1)
        m = rep["measured"]
        assert m["served"] == 2 and m["tokens"] <= 2 * 6
        assert m["ticks"] == sd["rounds"] and m["tick_latency_p50_s"] > 0
        assert (rep["analytical"] is None) == (R is None)
    eng._decoders[key].spec_dec.rejected += 1
    with pytest.raises(AssertionError, match="accounting broken"):
        eng.verify_spec_accounting()


def test_engine_spec_prewarm_readies_verify_and_draft(lm):
    """prewarm of a speculative key readies its verify and draft executors
    (cold, once), leaves the KV cache untouched and launches nothing; the
    ticks then build nothing more."""
    _, cfg, _, params = lm
    spec = SpecConfig(k=2, draft=KernelSchedule(reuse_factor=4))
    sched = KernelSchedule(reuse_factor=1)
    eng = LMServingEngine(cfg, params, max_batch=2, max_seq=32,
                          device="cpu")
    before = dict(cuda.LAUNCHES)
    pre = eng.prewarm([sched], spec=spec)
    (key,) = pre
    assert key == sched.key() + "-" + spec.key_token()
    assert pre[key]["verify"]["status"] == "cold"
    assert pre[key]["draft"]["status"] == "cold"
    dec = eng._decoders[key]
    assert all(float(v.abs().max()) == 0.0 for v in dec.cache.values())
    assert eng.prewarm([sched], spec=spec)[key]["verify"]["status"] == "hot"
    eng.add_request([1, 2, 3], max_new=5, schedule=sched, spec=spec)
    eng.run_to_completion()
    sd = dec.spec_dec
    assert (sd.verify_traces, sd.draft_traces) == (1, 1)
    assert cuda.LAUNCHES == before
    assert eng.serve_report()[key]["compile"]["cold"] == 2.0
