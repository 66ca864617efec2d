"""The port's dense-decoder LM path against the JAX package's, on the CPU.

Covers the LM configs, ``models/{layers,attention,mlp,transformer,init,
model,decode}.py`` and ``serving/lm_engine.py`` at ``repro.testing.
tiny_config`` of gemma-2b and stablelm-3b, which differ in every axis the
path branches on (RMSNorm / LayerNorm, GeGLU / SwiGLU, MQA / MHA, tied /
untied embeddings, softcap on / off).  Parameters are ``repro``'s own,
carried over by ``lm_params_from_jax``; on a CPU tensor a kernel schedule
runs the ``decode_matmul`` CUDA kernel's plain version, and ``repro`` runs
its Pallas kernel in interpret mode.

Tolerances, times max(1, max |reference|): 3e-5 for float32 logits and
caches (the packages sum in different orders), 2e-2 for bfloat16 compute.
Sampled tokens are compared exactly.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import config as jconfig  # noqa: E402
from repro.kernels.schedule import KernelSchedule as JSchedule  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.models import decode as jdecode  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.registry import get_config as jget_config  # noqa: E402
from repro.serving.lm_engine import LMServingEngine as JLMEngine  # noqa: E402
from repro.testing import CONFORMANCE_TOL, tiny_config  # noqa: E402

from repro_torch.config import (PORT_ONLY_FIELDS, ModelConfig,  # noqa: E402
                                MoEConfig, RGLRUConfig, SSMConfig)
from repro_torch.configs import (LMS, PORT_ONLY_LMS, TAGGERS,  # noqa: E402
                                 get_config)
from repro_torch.registry import ARCHS as TARCHS  # noqa: E402
from repro_torch.registry import PORT_ONLY_ARCHS  # noqa: E402
from repro_torch.kernels import cuda, ops  # noqa: E402
from repro_torch.kernels.schedule import KernelSchedule  # noqa: E402
from repro_torch.models import decode as tdecode  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.model import Model, build_model  # noqa: E402
from repro_torch.serving import LMServingEngine  # noqa: E402
from repro_torch.serving.engine import EngineClosedError  # noqa: E402

ARCHS = ("gemma-2b", "stablelm-3b", "deepseek-coder-33b",
         "nemotron-4-340b")
#: repro's ModelConfig fields the port does not carry, none of which
#: changes a value on one device (``remat``, ``attn_chunk_q`` /
#: ``attn_chunk_kv`` and ``grad_accum`` are carried: the sequence forward
#: and the trainer read them)
NOT_PORTED = {"scan_layers", "impl", "seq_shard_residual", "probe_unroll"}


#: the port's family sub-configs, by field name
SUBCONFIGS = {"moe": MoEConfig, "ssm": SSMConfig, "rglru": RGLRUConfig}


def port_config(jcfg) -> ModelConfig:
    """The port's config with every field of ``jcfg`` it carries (the
    family sub-configs as the port's own dataclasses); the port's own
    fields at their defaults."""
    kw = {}
    for f in dataclasses.fields(ModelConfig):
        if f.name == "rnn" or f.name in PORT_ONLY_FIELDS:
            continue
        v = getattr(jcfg, f.name)
        if f.name in SUBCONFIGS and v is not None:
            v = SUBCONFIGS[f.name](**dataclasses.asdict(v))
        kw[f.name] = v
    return ModelConfig(**kw)


def close(got, want, dtype="float32"):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= CONFORMANCE_TOL[dtype] * scale, err


def setup(arch, **overrides):
    jcfg = tiny_config(jget_config(arch)).replace(**overrides)
    jparams = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = tdecode.lm_params_from_jax(
        {k: np.asarray(v) for k, v in jparams.items()}, "cpu")
    return jcfg, port_config(jcfg), jparams, tparams


# ---------------------------------------------------------------------------
# Configs and parameter specs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(LMS) + sorted(TAGGERS))
def test_configs_equal_repro_field_by_field(name):
    """Every field ``repro`` has, equal; the port's own fields
    (``PORT_ONLY_FIELDS``) at their defaults on every arch ``repro``
    has."""
    got, want = get_config(name), jget_config(name)
    for f in dataclasses.fields(ModelConfig):
        g = getattr(got, f.name)
        if f.name in PORT_ONLY_FIELDS:
            assert g == f.default, (name, f.name, g)
            continue
        w = getattr(want, f.name)
        if dataclasses.is_dataclass(g):
            g, w = dataclasses.asdict(g), dataclasses.asdict(w)
        assert g == w, (name, f.name, g, w)
    port = {f.name for f in dataclasses.fields(ModelConfig)}
    jfields = {f.name for f in dataclasses.fields(jconfig.ModelConfig)}
    assert jfields - port == NOT_PORTED
    assert port - jfields == set(PORT_ONLY_FIELDS)
    assert got.param_count() == want.param_count()
    assert got.active_param_count() == want.active_param_count()


def test_port_only_archs_are_listed_apart():
    """The port's own LMs are registered, kept out of ``LMS`` (nothing
    asks ``repro`` for them) and set the port's own fields."""
    assert set(PORT_ONLY_LMS) == set(PORT_ONLY_ARCHS) <= set(TARCHS)
    assert not set(PORT_ONLY_LMS) & (set(LMS) | set(TAGGERS))
    for name, cfg in PORT_ONLY_LMS.items():
        assert get_config(name) is cfg
        assert any(getattr(cfg, f) != getattr(ModelConfig(), f)
                   for f in PORT_ONLY_FIELDS), name


@pytest.mark.parametrize("tiny", [True, False], ids=["tiny", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_repro(arch, tiny):
    jcfg = jget_config(arch)
    jcfg = tiny_config(jcfg) if tiny else jcfg
    want = jtf.param_specs(jcfg)
    got = ttf.param_specs(port_config(jcfg))
    assert sorted(got) == sorted(want)
    for k, s in want.items():
        assert got[k].shape == s.shape and got[k].dtype == s.dtype, k
        assert got[k].init == s.init and got[k].scale == s.scale, k
    assert ttf.padded_vocab(port_config(jcfg)) == jtf.padded_vocab(jcfg)
    cs = tdecode.cache_specs(port_config(jcfg), 4, 64, "float32")
    for k, s in jdecode.cache_specs(jcfg, 4, 64, "float32").items():
        assert cs[k].shape == s.shape and cs[k].dtype == s.dtype


def test_seeded_init_is_deterministic_and_shaped():
    cfg = port_config(tiny_config(jget_config("stablelm-3b")))
    model = build_model(cfg)
    a = model.init(torch.Generator().manual_seed(3), "cpu")
    b = model.init(torch.Generator().manual_seed(3), "cpu")
    c = model.init(torch.Generator().manual_seed(4), "cpu")
    specs = model.param_specs()
    for k, s in specs.items():
        assert tuple(a[k].shape) == s.shape and torch.equal(a[k], b[k])
    assert not torch.equal(a["decoder/attn/wq"], c["decoder/attn/wq"])
    assert float(a["decoder/norm1/scale"].min()) == 1.0       # ones
    assert float(a["decoder/norm1/bias"].abs().max()) == 0.0  # zeros
    wq = a["decoder/attn/wq"]
    assert float(wq.abs().max()) <= 2 / np.sqrt(cfg.d_model) + 1e-6
    emb = a["embed/table"]
    assert abs(float(emb.std()) - 0.02) < 0.002               # embed scale


# ---------------------------------------------------------------------------
# decode_step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("R", [None, 1, 2], ids=["einsum", "R1", "R2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_repro(arch, R):
    """Three chained decode steps from an empty cache, einsum and scheduled:
    logits and both caches within 3e-5."""
    jcfg, tcfg, jparams, tparams = setup(arch)
    B, S = 2, 12
    js = None if R is None else JSchedule(reuse_factor=R, block_batch=8,
                                          backend="pallas_interpret")
    ts = None if R is None else KernelSchedule(reuse_factor=R, block_batch=8)
    jc = {k: jnp.zeros(s.shape, jnp.dtype(s.dtype))
          for k, s in jdecode.cache_specs(jcfg, B, S, "float32").items()}
    tc = tdecode.init_cache(tcfg, B, S, "float32", "cpu")
    toks = np.random.RandomState(1).randint(0, jcfg.vocab_size, (B, 3))
    before = dict(cuda.LAUNCHES)
    for t in range(3):
        jl, jc = jdecode.decode_step(jcfg, jparams, jc,
                                     jnp.asarray(toks[:, t:t + 1]),
                                     jnp.full((B,), t, jnp.int32),
                                     schedule=js)
        tl, tc = tdecode.decode_step(tcfg, tparams, tc,
                                     torch.from_numpy(toks[:, t:t + 1]),
                                     torch.full((B,), t), schedule=ts)
        assert tl.shape == (B, 1, ttf.padded_vocab(tcfg))
        close(tl.numpy(), np.asarray(jl))
        for k in jc:
            close(tc[k].numpy(), np.asarray(jc[k]))
    assert cuda.LAUNCHES == before           # CPU tensors: plain versions


def test_decode_step_bf16_compute_matches_repro():
    """gemma-2b's own dtypes (bf16 params and compute) at tiny widths, the
    scheduled step against repro's: within 2e-2."""
    jcfg, tcfg, jparams, tparams = setup("gemma-2b", param_dtype="bfloat16",
                                         compute_dtype="bfloat16")
    assert tparams["decoder/attn/wq"].dtype == torch.bfloat16
    B, S = 2, 8
    jc = {k: jnp.zeros(s.shape, jnp.dtype(s.dtype))
          for k, s in jdecode.cache_specs(jcfg, B, S, "float32").items()}
    tc = tdecode.init_cache(tcfg, B, S, "float32", "cpu")
    js = JSchedule(reuse_factor=2, block_batch=8, backend="pallas_interpret")
    ts = KernelSchedule(reuse_factor=2, block_batch=8)
    toks = np.random.RandomState(2).randint(0, jcfg.vocab_size, (B, 2))
    for t in range(2):
        jl, jc = jdecode.decode_step(jcfg, jparams, jc,
                                     jnp.asarray(toks[:, t:t + 1]),
                                     jnp.full((B,), t, jnp.int32),
                                     schedule=js)
        tl, tc = tdecode.decode_step(tcfg, tparams, tc,
                                     torch.from_numpy(toks[:, t:t + 1]),
                                     torch.full((B,), t), schedule=ts)
        assert tl.dtype == torch.bfloat16
        close(tl.float().numpy(), np.asarray(jl, np.float32), "bfloat16")


def test_pack_decode_params_is_cached_per_key_and_version():
    _, tcfg, _, tparams = setup("stablelm-3b")
    # keyed on the params' tensors and versions and the compute dtype: the
    # layout does not depend on the schedule, so one pack serves every key
    p1 = tdecode.pack_decode_params(tcfg, tparams)
    assert p1 is tdecode.pack_decode_params(tcfg, tparams)
    bf = tcfg.replace(compute_dtype="bfloat16")
    assert tdecode.pack_decode_params(bf, tparams) is not p1
    layer = p1["layers"][1]
    d, hd = tcfg.d_model, tcfg.head_dim
    assert layer["__wqkv"].shape == (d, (tcfg.n_heads + 2 * tcfg.n_kv_heads)
                                     * hd)
    assert layer["__wgu"].shape == (d, 2 * tcfg.d_ff)
    assert layer["__wdown"].shape == (tcfg.d_ff, d)
    assert "decoder/norm1/bias" in layer
    tparams["decoder/mlp/w_up"].add_(0.0)    # in place: a new version
    assert tdecode.pack_decode_params(tcfg, tparams) is not p1
    # a pack larger than the cache's byte bound is returned, not kept
    small = ops.WeightResidency(max_bytes=1024)
    n = len(small)
    small.get(tparams["embed/table"], "k", lambda: tparams["embed/table"] * 2)
    assert len(small) == n == 0


@pytest.mark.parametrize("name", sorted(LMS))
def test_non_dense_families_raise(name):
    """Every LM's sequence forward and loss run (their parity with
    ``repro``: ``tests/test_torch_prefill.py`` and
    ``tests/test_torch_lm_train.py``); ``name``'s config under a family
    the port does not know is refused by every entry point, ``Model.loss``
    and ``Model.forward`` included."""
    cfg = port_config(tiny_config(jget_config(name))).replace(
        family="unknown", name="some-lm")
    batch = {"tokens": torch.zeros(1, 4, dtype=torch.int64),
             "labels": torch.zeros(1, 4, dtype=torch.int64)}
    model = Model(cfg)
    for call in (lambda: build_model(cfg),
                 lambda: ttf.param_specs(cfg),
                 lambda: tdecode.cache_specs(cfg, 1, 8),
                 lambda: LMServingEngine(cfg, {}, device="cpu"),
                 lambda: tdecode.decode_step(cfg, {}, {}, None, None),
                 lambda: model.loss({}, batch),
                 lambda: model.forward({}, batch)):
        with pytest.raises(ValueError, match="not an LM family"):
            call()


def test_lm_params_from_jax_keeps_dtypes():
    jcfg = tiny_config(jget_config("gemma-2b")).replace(
        param_dtype="bfloat16")
    jparams = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = tdecode.lm_params_from_jax(jparams, "cpu")
    for k, v in jparams.items():
        assert str(tparams[k].dtype) == f"torch.{v.dtype}"
        np.testing.assert_array_equal(tparams[k].float().numpy(),
                                      np.asarray(v, np.float32))
    with pytest.raises(KeyError, match="not LM parameters"):
        tdecode.lm_params_from_jax({"rnn/kernel": np.zeros((2, 8))}, "cpu")


# ---------------------------------------------------------------------------
# LMServingEngine
# ---------------------------------------------------------------------------


PROMPTS = ([5, 7, 11], [3, 1, 4, 1, 5], [9])


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_serves_repro_tokens_on_every_key(arch):
    """The same prompts on the default key (einsum) and on a scheduled key
    decode the same tokens as repro's engine; one executor per key."""
    jcfg, tcfg, jparams, tparams = setup(arch)
    sched = KernelSchedule(reuse_factor=2, block_batch=8)
    jsched = JSchedule(reuse_factor=2, block_batch=8)
    jeng = JLMEngine(jcfg, jparams, max_batch=3, max_seq=16)
    eng = LMServingEngine(tcfg, tparams, max_batch=3, max_seq=16,
                          device="cpu")
    jids = [jeng.add_request(p, max_new=4, now=0.0) for p in PROMPTS]
    jids += [jeng.add_request(p, max_new=4, now=0.0, schedule=jsched)
             for p in PROMPTS]
    ids = [eng.add_request(p, max_new=4, now=0.0) for p in PROMPTS]
    ids += [eng.add_request(p, max_new=4, now=0.0, schedule=sched)
            for p in PROMPTS]
    want, got = jeng.run_to_completion(now=1.0), eng.run_to_completion(now=1.0)
    assert [got[i] for i in ids] == [want[i] for i in jids]
    assert [got[i] for i in ids[:3]] == [got[i] for i in ids[3:]]
    assert all(len(got[i]) == len(p) + 4 for i, p in zip(ids, PROMPTS * 2))
    key = sched.key()
    assert eng.keys() == ["default", key] == jeng.keys()
    assert eng.trace_count("default") == eng.trace_count(key) == 1
    assert eng.trace_count("missing") == 0
    rep = eng.serve_report()
    for k in ("default", key):
        m = rep[k]["measured"]
        assert m["served"] == 3 and m["tokens"] > 0 and m["tokens_per_s"] > 0
        assert m["ticks"] == 4 + 4 and m["tick_latency_p50_s"] > 0
        assert rep[k]["traces"] == 1 and rep[k]["fp"] is None
    assert rep[key]["schedule"] == sched and rep["default"]["schedule"] is None


def test_engine_scheduled_keys_share_one_pack():
    """The packed layout does not depend on the schedule: every scheduled
    key runs over the one pack the engine holds; the default key has
    none."""
    _, tcfg, _, tparams = setup("stablelm-3b")
    eng = LMServingEngine(tcfg, tparams, max_batch=1, max_seq=8,
                          device="cpu")
    for r in (1, 4):
        eng.add_request([1], max_new=1, schedule=KernelSchedule(reuse_factor=r))
    decs = eng._decoders
    p1 = decs[KernelSchedule(reuse_factor=1).key()].packed
    assert p1 is not None
    assert p1 is decs[KernelSchedule(reuse_factor=4).key()].packed
    assert decs["default"].packed is None


def test_engine_greedy_sampling_takes_the_first_maximum():
    """All-zero unembedding: every logit ties at 0, so greedy sampling
    must return token 0, as jnp.argmax does in repro's engine."""
    jcfg, tcfg, jparams, tparams = setup("stablelm-3b")
    jparams = dict(jparams, **{"unembed/w": jnp.zeros_like(
        jparams["unembed/w"])})
    tparams = dict(tparams, **{"unembed/w": torch.zeros_like(
        tparams["unembed/w"])})
    jeng = JLMEngine(jcfg, jparams, max_batch=1, max_seq=8)
    eng = LMServingEngine(tcfg, tparams, max_batch=1, max_seq=8,
                          device="cpu")
    jr = jeng.add_request([4, 2], max_new=3)
    r = eng.add_request([4, 2], max_new=3)
    assert eng.run_to_completion()[r] == jeng.run_to_completion()[jr] \
        == [4, 2, 0, 0, 0]


def test_engine_slots_continuous_batching_and_close():
    _, tcfg, _, tparams = setup("gemma-2b")
    eng = LMServingEngine(tcfg, tparams, max_batch=2, max_seq=6,
                          device="cpu")
    a = eng.add_request([1, 2], max_new=2)
    b = eng.add_request([3], max_new=10)          # stops at max_seq - 1
    assert eng.add_request([5], max_new=1) is None           # pool full
    assert sum(s.active for s in eng.slots) == 2
    done = eng.tick()
    assert done == {} and eng.slots[0].pos == 1
    done = {}
    for _ in range(2):
        done.update(eng.tick())
    assert list(done) == [a] and len(done[a]) == 4
    c = eng.add_request([5], max_new=1)           # joins mid-flight
    assert c is not None
    finished = eng.close()
    assert set(finished) == {b, c} and len(finished[b]) == 6
    assert eng.closed and eng.close() == {}
    with pytest.raises(EngineClosedError):
        eng.add_request([1])


def test_engine_cuda_device_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg, _, tparams = setup("gemma-2b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LMServingEngine(tcfg, tparams)           # device defaults to cuda
