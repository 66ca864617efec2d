"""The port's moe, ssm, hybrid, audio enc-dec and vlm decode path against
the JAX package's, on the CPU.

Covers ``config.py`` (the family sub-configs and counts), the six configs
(qwen2-moe-a2.7b, qwen3-moe-30b-a3b, mamba2-780m, recurrentgemma-9b,
whisper-medium, phi-3-vision-4.2b), ``models/{moe,ssm,rglru}.py``,
``attention.decode_attention_masked``, ``transformer.param_specs``,
``models/decode.py`` (cache specs, the ring buffer, ``decode_step`` /
``decode_steps`` of every family), ``models/init.py``'s sliced draw and
``serving/lm_engine.py`` / ``speculative.py`` on these families, at
``repro.testing.tiny_config`` sizes.  Parameters are drawn with numpy from
a seed and carried to both packages (to the port by
``lm_params_from_jax``); ``repro``'s decode step runs under ``jax.jit``
and its scheduled keys on its plain ``xla`` backend (its own tests hold
that equal to its Pallas kernel).

Tolerances, times max(1, max |reference|): 3e-5 for float32 and 2e-2 for
bfloat16 compute (``CONFORMANCE_TOL``).  Tokens are compared exactly; a
verify pass is held bit for bit to the port's own sequential chain.
"""

import dataclasses
import functools
import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.schedule import KernelSchedule as JSchedule  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import decode as jdecode  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.registry import get_config as jget_config  # noqa: E402
from repro.serving.lm_engine import LMServingEngine as JLMEngine  # noqa: E402
from repro.testing import CONFORMANCE_TOL, tiny_config  # noqa: E402

from repro_torch.configs import LMS, TAGGERS, get_config  # noqa: E402
from repro_torch.kernels import cuda  # noqa: E402
from repro_torch.kernels.schedule import KernelSchedule  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import decode as tdecode  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import rglru as trglru  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.init import init_params  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving import LMServingEngine, SpecConfig  # noqa: E402
from repro_torch.serving.speculative import SpeculativeDecoder  # noqa: E402

from test_torch_lm import port_config  # noqa: E402

FAMILIES = ("qwen2-moe-a2.7b", "qwen3-moe-30b-a3b", "mamba2-780m",
            "recurrentgemma-9b", "whisper-medium", "phi-3-vision-4.2b")
RECURRENT = ("mamba2-780m", "recurrentgemma-9b")


def close(got, want, dtype="float32"):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= CONFORMANCE_TOL[dtype] * scale, err


def numpy_params(jcfg, seed=0):
    """Every parameter of ``repro``'s spec tree for ``jcfg``, drawn with
    numpy: zeros / ones as the spec says, else a normal at the spec's
    spread (lecun: scale / sqrt(fan in); embed: scale), clipped at 2 std,
    rounded to the spec's dtype as ``jnp.asarray`` rounds it."""
    rng = np.random.RandomState(seed)
    out = {}
    for k, s in sorted(jtf.param_specs(jcfg).items()):
        if s.init in ("zeros", "ones"):
            a = (np.zeros if s.init == "zeros" else np.ones)(s.shape)
        else:
            fan = s.shape[0] if len(s.shape) == 1 else math.prod(s.shape[:-1])
            std = s.scale if s.init == "embed" else s.scale / math.sqrt(fan)
            a = np.clip(rng.standard_normal(s.shape), -2, 2) * std
        out[k] = np.asarray(jnp.asarray(a.astype(np.float32),
                                        jnp.dtype(s.dtype)))
    return out


@functools.lru_cache(maxsize=None)
def setup(arch, dtype="float32"):
    """(repro config, port config, repro params, port params) at the tiny
    config of ``arch`` in ``dtype`` (params and compute)."""
    jcfg = tiny_config(jget_config(arch)).replace(param_dtype=dtype,
                                                  compute_dtype=dtype)
    np_params = numpy_params(jcfg)
    jparams = {k: jnp.asarray(v) for k, v in np_params.items()}
    return (jcfg, port_config(jcfg), jparams,
            tdecode.lm_params_from_jax(np_params, "cpu"))


@functools.lru_cache(maxsize=None)
def jstep(multi=False):
    """repro's decode_step (or decode_steps) under jit, the config and the
    schedule static."""
    fn = jdecode.decode_steps if multi else jdecode.decode_step
    return jax.jit(lambda cfg, p, c, t, pos, s: fn(cfg, p, c, t, pos,
                                                    schedule=s),
                   static_argnums=(0, 5))


def caches(jcfg, tcfg, B, S, seed=1):
    """Zero caches of both packages; an enc-dec model's cache/xk and
    cache/xv filled from ``seed`` (the encoder is prefill)."""
    jc = {k: np.zeros(s.shape, np.dtype(s.dtype))
          for k, s in jdecode.cache_specs(jcfg, B, S, "float32").items()}
    if jcfg.enc_dec:
        rng = np.random.RandomState(seed)
        for k in ("cache/xk", "cache/xv"):
            jc[k] = rng.randn(*jc[k].shape).astype(np.float32)
    tc = {k: torch.from_numpy(v.copy()) for k, v in jc.items()}
    return {k: jnp.asarray(v) for k, v in jc.items()}, tc


def layer0(params, prefix):
    """Layer 0 of a stacked group, in either package's arrays."""
    return {k: v[0] for k, v in params.items() if k.startswith(prefix)}


# ---------------------------------------------------------------------------
# Configs, counts, specs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(LMS))
def test_counts_equal_repro_for_every_lm(name):
    got, want = get_config(name), jget_config(name)
    assert got.param_count() == want.param_count()
    assert got.active_param_count() == want.active_param_count()
    t_tiny, j_tiny = port_config(tiny_config(want)), tiny_config(want)
    assert t_tiny.param_count() == j_tiny.param_count()
    assert t_tiny.active_param_count() == j_tiny.active_param_count()
    if want.rglru is not None:
        assert got._pattern_for_layers() == want._pattern_for_layers()


def test_configs_of_the_families_set_bf16_compute():
    for name in FAMILIES:
        cfg = get_config(name)
        assert cfg.compute_dtype == cfg.param_dtype == "bfloat16", name
    assert set(FAMILIES) | {"gemma-2b", "stablelm-3b", "deepseek-coder-33b",
                            "nemotron-4-340b"} == set(LMS)
    assert not set(LMS) & set(TAGGERS)


@pytest.mark.parametrize("tiny", [True, False], ids=["tiny", "full"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_param_and_cache_specs_equal_repro(arch, tiny):
    jcfg = jget_config(arch)
    jcfg = tiny_config(jcfg) if tiny else jcfg
    tcfg = port_config(jcfg)
    want, got = jtf.param_specs(jcfg), ttf.param_specs(tcfg)
    assert sorted(got) == sorted(want)
    for k, s in want.items():
        assert got[k].shape == s.shape and got[k].dtype == s.dtype, k
        assert got[k].init == s.init and got[k].scale == s.scale, k
    for max_len in (8, 64):
        want = jdecode.cache_specs(jcfg, 3, max_len, "bfloat16")
        got = tdecode.cache_specs(tcfg, 3, max_len, "bfloat16")
        assert sorted(got) == sorted(want)
        for k, s in want.items():
            assert got[k].shape == s.shape and got[k].dtype == s.dtype, k
    assert tdecode.decode_schedulable(tcfg) == jdecode.decode_schedulable(
        jcfg)


# ---------------------------------------------------------------------------
# Modules against repro
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("t", [3, 16], ids=["cap=t", "drops"])
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "qwen3-moe-30b-a3b"])
def test_moe_tokens_match_repro(arch, t, train):
    """Routing, capacity (at t = 16 each expert keeps 8 tokens at eval
    and 5 in training, so routed tokens are dropped), the shared-expert
    gate (qwen2-moe) and the aux losses."""
    jcfg, tcfg, jp, tp = setup(arch)
    m = jcfg.moe
    cf = m.capacity_factor if train else m.eval_capacity_factor
    cap = min(max(int(t * m.top_k * cf / m.n_experts), 4), t)
    assert (cap < t) == (t == 16)
    b, s = (3, 1) if t == 3 else (4, 4)         # t = b * s tokens
    x = np.random.RandomState(t).randn(b, s, jcfg.d_model).astype(
        np.float32)
    jo, ja = jmoe._moe_tokens(jcfg, jnp.asarray(x),
                              layer0(jp, "decoder/moe"), "decoder/moe",
                              train=train)
    to, ta = tmoe._moe_tokens(tcfg, torch.from_numpy(x),
                              layer0(tp, "decoder/moe"), "decoder/moe",
                              train=train)
    close(to, jo)
    assert sorted(ta) == sorted(ja)
    for k in ja:
        close(ta[k], ja[k])
    # the same call again: the same bits (the combine accumulates nothing)
    assert torch.equal(to, tmoe._moe_tokens(
        tcfg, torch.from_numpy(x), layer0(tp, "decoder/moe"),
        "decoder/moe", train=train)[0])
    jb, _ = jmoe.moe_block(jcfg, jnp.asarray(x), layer0(jp, "decoder/moe"),
                           "decoder/moe", train=train)
    tb, _ = tmoe.moe_block(tcfg, torch.from_numpy(x),
                           layer0(tp, "decoder/moe"), "decoder/moe",
                           train=train)
    close(tb, jb)


def test_moe_top_k_ties_take_the_lowest_index():
    x = torch.tensor([[0.5, 1.0, 0.5, 1.0, 0.0, 0.5]])
    vals, idx = tmoe.top_k(x, 4)
    jv, ji = jax.lax.top_k(jnp.asarray(x.numpy()), 4)
    assert idx.tolist() == np.asarray(ji).tolist() == [[1, 3, 0, 2]]
    assert vals.tolist() == np.asarray(jv).tolist()


def test_moe_capacity_drops_depend_on_the_batch():
    """At t > cap a row's output depends on the other rows (repro's
    semantics, kept): one token alone and in a batch of 16 differ."""
    _, tcfg, _, tp = setup("qwen3-moe-30b-a3b")
    x = torch.from_numpy(np.random.RandomState(9).randn(
        16, 1, tcfg.d_model).astype(np.float32))
    p = layer0(tp, "decoder/moe")
    full = tmoe._moe_tokens(tcfg, x, p, "decoder/moe", train=False)[0]
    alone = torch.cat([tmoe._moe_tokens(tcfg, x[i:i + 1], p, "decoder/moe",
                                        train=False)[0] for i in range(16)])
    assert not torch.equal(full, alone)


def test_ssm_decode_step_matches_repro():
    jcfg, tcfg, jp, tp = setup("mamba2-780m")
    d_in, h, conv_dim = tssm.ssm_dims(tcfg)
    assert (d_in, h, conv_dim) == jssm.ssm_dims(jcfg)
    s = jcfg.ssm
    rng = np.random.RandomState(2)
    B = 3
    st = rng.randn(B, h, s.head_dim, s.d_state).astype(np.float32)
    cv = rng.randn(B, s.d_conv - 1, conv_dim).astype(np.float32)
    jst, jcv, tst, tcv = jnp.asarray(st), jnp.asarray(cv), \
        torch.from_numpy(st), torch.from_numpy(cv)
    for step in range(4):
        x = rng.randn(B, 1, jcfg.d_model).astype(np.float32)
        jo, (jst, jcv) = jssm.ssm_decode_step(
            jcfg, jnp.asarray(x), layer0(jp, "decoder/ssm"), "decoder/ssm",
            jst, jcv)
        to, (tst, tcv) = tssm.ssm_decode_step(
            tcfg, torch.from_numpy(x), layer0(tp, "decoder/ssm"),
            "decoder/ssm", tst, tcv)
        close(to, jo)
        close(tst, jst)
        close(tcv, jcv)


def test_rglru_decode_step_matches_repro():
    jcfg, tcfg, jp, tp = setup("recurrentgemma-9b")
    w = jcfg.rglru.lru_width
    rng = np.random.RandomState(3)
    B = 3
    st = rng.randn(B, w).astype(np.float32)
    cv = rng.randn(B, jcfg.rglru.conv_width - 1, w).astype(np.float32)
    jst, jcv, tst, tcv = jnp.asarray(st), jnp.asarray(cv), \
        torch.from_numpy(st), torch.from_numpy(cv)
    for step in range(4):
        x = rng.randn(B, 1, jcfg.d_model).astype(np.float32)
        jo, (jst, jcv) = jrglru.rglru_decode_step(
            jcfg, jnp.asarray(x), layer0(jp, "hyb0/mix"), "hyb0/mix", jst,
            jcv)
        to, (tst, tcv) = trglru.rglru_decode_step(
            tcfg, torch.from_numpy(x), layer0(tp, "hyb0/mix"), "hyb0/mix",
            tst, tcv)
        close(to, jo)
        close(tst, jst)
        close(tcv, jcv)
        assert tst.dtype == torch.float32


def test_decode_attention_masked_matches_repro():
    rng = np.random.RandomState(4)
    B, S, h, hk, d = 3, 10, 4, 2, 16
    q = rng.randn(B, 1, h, d).astype(np.float32)
    k = rng.randn(B, S, hk, d).astype(np.float32)
    v = rng.randn(B, S, hk, d).astype(np.float32)
    valid = rng.rand(B, S) > 0.4
    valid[2] = False                    # a row with no valid slot
    want = jattn.decode_attention_masked(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), jnp.asarray(valid))
    got = tattn.decode_attention_masked(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(valid))
    close(got, want)


def test_local_attn_decode_across_the_ring_wrap():
    """window = 8 over a ring of 8 slots, 20 steps: every slot is written
    two and a half times; output, ring and slot positions match repro's
    at every step."""
    jcfg, tcfg, jp, tp = setup("recurrentgemma-9b")
    jcfg = jcfg.replace(rglru=dataclasses.replace(jcfg.rglru, window=8))
    tcfg = tcfg.replace(rglru=dataclasses.replace(tcfg.rglru, window=8))
    B, W, hk, hd = 2, 8, jcfg.n_kv_heads, jcfg.head_dim
    jck = jcv = jnp.zeros((B, W, hk, hd))
    jpos = jnp.zeros((B, W), jnp.int32)
    tck = tcv = torch.zeros(B, W, hk, hd)
    tpos = torch.zeros(B, W, dtype=torch.int32)
    rng = np.random.RandomState(5)
    start = np.array([0, 3])
    for step in range(20):
        x = rng.randn(B, 1, jcfg.d_model).astype(np.float32)
        pos = start + step
        jo, jck, jcv, jpos = jdecode._local_attn_decode(
            jcfg, jnp.asarray(x), layer0(jp, "hyb2/attn"), "hyb2/attn",
            jck, jcv, jpos, jnp.asarray(pos, jnp.int32), 8)
        to, tck, tcv, tpos = tdecode._local_attn_decode(
            tcfg, torch.from_numpy(x), layer0(tp, "hyb2/attn"), "hyb2/attn",
            tck, tcv, tpos, torch.from_numpy(pos), 8)
        close(to, jo)
        close(tck, jck)
        close(tcv, jcv)
        assert tpos.dtype == torch.int32
        np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    assert int(tpos.max()) == 3 + 19 + 1 and int(tpos.min()) > 8


# ---------------------------------------------------------------------------
# decode_step / decode_steps
# ---------------------------------------------------------------------------


FAMILY_SCHEDS = [(a, None) for a in FAMILIES] + [
    ("phi-3-vision-4.2b", 1), ("phi-3-vision-4.2b", 4),
    ("qwen2-moe-a2.7b", 4)]


@pytest.mark.parametrize("arch,R", FAMILY_SCHEDS,
                         ids=[f"{a}-{r or 'einsum'}" for a, r in
                              FAMILY_SCHEDS])
def test_decode_step_matches_repro_over_12_steps(arch, R):
    """12 chained steps from a zero cache (whisper: seeded cross-attention
    caches), ragged positions: logits and every cache entry within 3e-5.
    A schedule on a family that is not decode-schedulable changes
    nothing; on vlm it runs decode_matmul's plain version."""
    jcfg, tcfg, jp, tp = setup(arch)
    B, S = 3, 16
    js = None if R is None else JSchedule(reuse_factor=R, block_batch=8,
                                          backend="xla")
    ts = None if R is None else KernelSchedule(reuse_factor=R, block_batch=8)
    jc, tc = caches(jcfg, tcfg, B, S)
    toks = np.random.RandomState(6).randint(0, jcfg.vocab_size, (B, 12))
    start = np.array([0, 2, 3])
    before = dict(cuda.LAUNCHES)
    for t in range(12):
        pos = start + t
        jl, jc = jstep()(jcfg, jp, jc, jnp.asarray(toks[:, t:t + 1]),
                         jnp.asarray(pos, jnp.int32), js)
        tl, tc = tdecode.decode_step(tcfg, tp, tc,
                                     torch.from_numpy(toks[:, t:t + 1]),
                                     torch.from_numpy(pos), schedule=ts)
        assert tl.shape == (B, 1, ttf.padded_vocab(tcfg))
        close(tl, jl)
        assert sorted(tc) == sorted(jc)
        for k in jc:
            close(tc[k], jc[k])
    assert cuda.LAUNCHES == before           # CPU tensors: plain versions


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_step_bf16_matches_repro(arch):
    """The families' own dtypes (bf16 params and compute) at tiny widths:
    four steps within 2e-2."""
    jcfg, tcfg, jp, tp = setup(arch, "bfloat16")
    B, S = 2, 8
    jc, tc = caches(jcfg, tcfg, B, S)
    toks = np.random.RandomState(7).randint(0, jcfg.vocab_size, (B, 4))
    for t in range(4):
        pos = np.full((B,), t)
        jl, jc = jstep()(jcfg, jp, jc, jnp.asarray(toks[:, t:t + 1]),
                         jnp.asarray(pos, jnp.int32), None)
        tl, tc = tdecode.decode_step(tcfg, tp, tc,
                                     torch.from_numpy(toks[:, t:t + 1]),
                                     torch.from_numpy(pos))
        assert tl.dtype == torch.bfloat16
        close(tl, np.asarray(jl, np.float32), "bfloat16")


def chain(cfg, params, cache, toks, pos, schedule):
    """S sequential decode_steps."""
    out = []
    for i in range(toks.shape[1]):
        li, cache = tdecode.decode_step(cfg, params, cache, toks[:, i:i + 1],
                                        pos + i, schedule=schedule)
        out.append(li)
    return torch.cat(out, 1), cache


@pytest.mark.parametrize("arch,R", [(a, None) for a in FAMILIES] + [
    ("phi-3-vision-4.2b", 1), ("phi-3-vision-4.2b", 4)])
def test_decode_steps_equal_the_sequential_chain(arch, R):
    """One verify pass over S = 5 tokens a row gives the bits of 5
    sequential steps (logits and every cache entry), and repro's pass
    within 3e-5: vlm under a kernel schedule on its chunked pass, the
    other families unrolled."""
    jcfg, tcfg, jp, tp = setup(arch)
    s = None if R is None else KernelSchedule(reuse_factor=R, block_batch=8)
    js = None if R is None else JSchedule(reuse_factor=R, block_batch=8,
                                          backend="xla")
    B, S = 2, 5
    rng = np.random.RandomState(8)
    toks = rng.randint(0, tcfg.vocab_size, (B, S))
    pos = np.array([0, 4])
    jc, tc = caches(jcfg, tcfg, B, 16)
    want, wcache = chain(tcfg, tp, dict(tc), torch.from_numpy(toks),
                         torch.from_numpy(pos), s)
    got, gcache = tdecode.decode_steps(tcfg, tp, dict(tc),
                                       torch.from_numpy(toks),
                                       torch.from_numpy(pos), schedule=s)
    assert torch.equal(got, want)
    for k in wcache:
        assert torch.equal(gcache[k], wcache[k]), k
    jl, jcache = jstep(True)(jcfg, jp, jc, jnp.asarray(toks),
                             jnp.asarray(pos, jnp.int32), js)
    close(got, jl)
    for k in jcache:
        close(gcache[k], jcache[k])


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


PROMPTS = ([5, 7, 11], [3, 1, 4, 1, 5], [9])


@pytest.mark.parametrize("arch", FAMILIES)
def test_engine_serves_repro_tokens_on_every_key(arch):
    """The same prompts on the default key, a scheduled key (R = 2) and,
    where speculation is exact, an n-gram speculative key decode repro's
    engine's tokens; one executor a key; a scheduled key of a family that
    is not decode-schedulable packs nothing and has no FPGA estimate."""
    jcfg, tcfg, jp, tp = setup(arch)
    jeng = JLMEngine(jcfg, jp, max_batch=3, max_seq=16)
    jids = [jeng.add_request(p, max_new=4, now=0.0) for p in PROMPTS]
    want = jeng.run_to_completion(now=1.0)
    want = [want[i] for i in jids]
    eng = LMServingEngine(tcfg, tp, max_batch=3, max_seq=16, device="cpu")
    sched = KernelSchedule(reuse_factor=2, block_batch=8)
    keys = {"default": (None, None), "R2": (sched, None)}
    if arch not in RECURRENT:
        keys["spec"] = (sched, SpecConfig(k=4))
    ids = {k: [eng.add_request(p, max_new=4, now=0.0, schedule=s, spec=sp)
               for p in PROMPTS] for k, (s, sp) in keys.items()}
    got = eng.run_to_completion(now=1.0)
    for k, v in ids.items():
        assert [got[i] for i in v] == want, k
    assert all(eng.trace_count(k) == 1 for k in eng.keys())
    assert len(eng.keys()) == len(keys)
    schedulable = tdecode.decode_schedulable(tcfg)
    assert (eng._decoders[sched.key()].packed is not None) == schedulable
    rep = eng.serve_report()
    assert (rep[sched.key()]["analytical"] is not None) == schedulable
    if "spec" in keys:
        acc = eng.verify_spec_accounting()
        assert len(acc) == 1 and list(acc.values())[0]["rounds"] > 0


@pytest.mark.parametrize("arch", RECURRENT)
def test_speculation_is_refused_on_recurrent_state(arch):
    """ssm and hybrid decode state absorbs every token: spec= raises at
    the engine, on a request and in SpeculativeDecoder; k = 0 (no
    speculation) still serves."""
    _, tcfg, _, tp = setup(arch)
    spec = SpecConfig(k=4)
    with pytest.raises(ValueError, match="cannot be rolled back"):
        LMServingEngine(tcfg, tp, max_batch=1, max_seq=8, device="cpu",
                        spec=spec)
    eng = LMServingEngine(tcfg, tp, max_batch=1, max_seq=8, device="cpu")
    with pytest.raises(ValueError, match="cannot be rolled back"):
        eng.add_request([1, 2], spec=spec)
    with pytest.raises(ValueError, match="cannot be rolled back"):
        SpeculativeDecoder(tcfg, "k", None, spec, max_batch=1, max_seq=8,
                           cache_dtype="float32", params=tp, device="cpu")
    assert eng.keys() == ["default"]
    r = eng.add_request([1, 2], max_new=2, spec=SpecConfig(k=0))
    assert len(eng.run_to_completion()[r]) == 4


# ---------------------------------------------------------------------------
# Seeded init: rank >= 3 slice by slice, rank <= 2 as before
# ---------------------------------------------------------------------------


def parent_draw(spec, gen):
    """The parent's draw of one parameter: the whole tensor in float32
    from ``gen``, then cast."""
    dtype = getattr(torch, spec.dtype)
    if spec.init in ("zeros", "ones"):
        return (torch.zeros if spec.init == "zeros" else torch.ones)(
            spec.shape, dtype=dtype)
    if spec.init == "embed":
        return (torch.randn(spec.shape, generator=gen) * spec.scale).to(dtype)
    if spec.init == "rnn_ortho":
        rows, cols = spec.shape[-2], spec.shape[-1]
        n = max(rows, cols)
        q, _ = torch.linalg.qr(torch.randn(spec.shape[:-2] + (n, n),
                                           generator=gen))
        return (q[..., :rows, :cols] * spec.scale).to(dtype)
    fan = spec.shape[0] if len(spec.shape) == 1 else math.prod(
        spec.shape[:-1])
    std = spec.scale / math.sqrt(max(fan, 1))
    v = torch.empty(spec.shape)
    torch.nn.init.trunc_normal_(v, 0.0, std, -2.0 * std, 2.0 * std,
                                generator=gen)
    return v.to(dtype)


def test_sliced_init_keeps_rank_2_draws_and_slices_the_rest():
    # a tagger (every tensor of rank <= 2): the parent's values, bit for bit
    tag = build_model(get_config("quickdraw-lstm"))
    got = tag.init(torch.Generator().manual_seed(3), "cpu")
    gen = torch.Generator().manual_seed(3)
    for k, s in sorted(tag.param_specs().items()):
        assert torch.equal(got[k], parent_draw(s, gen)), k
    # an LM: the rank <= 2 tensors are the parent's formula over the seed's
    # stream (embed/table, the untied unembedding, img_proj), the stacked
    # ones come slice by slice from their own stream
    cfg = port_config(tiny_config(jget_config("phi-3-vision-4.2b"))
                      ).replace(param_dtype="bfloat16")
    model = build_model(cfg)
    specs = model.param_specs()
    a = model.init(torch.Generator().manual_seed(3), "cpu")
    gen = torch.Generator().manual_seed(3)
    for k, s in sorted(specs.items()):
        if len(s.shape) <= 2:
            assert torch.equal(a[k], parent_draw(s, gen)), k
    assert {"embed/table", "unembed/w", "img_proj/w"} <= {
        k for k, s in specs.items() if len(s.shape) <= 2}
    b = init_params(specs, torch.Generator().manual_seed(3), "cpu")
    c = model.init(torch.Generator().manual_seed(4), "cpu")
    for k, s in specs.items():
        assert tuple(a[k].shape) == s.shape and a[k].dtype == torch.bfloat16
        assert torch.equal(a[k], b[k]), k
        if len(s.shape) >= 3 and s.init == "lecun":
            std = s.scale / math.sqrt(math.prod(s.shape[:-1]))
            assert float(a[k].float().abs().max()) <= 2 * std * 1.01, k
            assert not torch.equal(a[k], c[k]), k
            # each slice is a draw of its own, not a copy of the first
            assert not torch.equal(a[k][0], a[k][1]), k
