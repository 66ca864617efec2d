"""The port's sharding rules, launch inputs and roofline held to ``repro``'s
on the CPU, field by field (no process group, no mesh of devices: the
meshes are bare descriptions, ``repro``'s tests' ``FakeMesh``).

  * ``ShardingContext.pspec`` of every parameter (and decode-cache) spec
    of every arch in ``ASSIGNED_ARCHS`` and the six taggers, under every
    rule family x kind, on (16, 16) and (2, 16, 16) meshes, with the
    arch's ``auto_overrides``: equal exactly (the MoE archs' experts
    padded to the model axis under the context);
  * ``auto_overrides`` over every arch x ``SHAPES`` entry (and no shape),
    ``param_bytes`` / ``Model.param_bytes``, ``cell_applicable``: equal;
  * ``batch_specs`` / ``decode_input_specs``: shapes, dtypes and pspecs
    equal (``repro``'s ``_sds`` / ``abstract_params`` recorded, since a
    ``NamedSharding`` needs a real mesh);
  * the ring cost model (``comm_analysis.CollectiveOp.wire_bytes`` and the
    totals) against ``hlo_analysis``'s on equal inputs, and
    ``model_flops`` / ``attention_model_flops`` for every arch x shape:
    equal exactly; ``analyze_record`` on one synthetic record of an f32
    arch with the same card numbers given to both: equal;
  * ``transformer._masked_rect`` / ``_sp_attention`` against ``repro``'s
    at tp 2 and 4, causal and windowed, within 3e-5 (f32), and
    ``attention_block`` taking the SP branch exactly where ``repro``
    does;
  * ``constrain``: the identity without a context and on a plain tensor,
    ``repro``'s ``ValueError`` on a rank mismatch.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import config as jconfig  # noqa: E402
from repro.launch import hlo_analysis as jhlo  # noqa: E402
from repro.launch import inputs as jinputs  # noqa: E402
from repro.launch import roofline as jroof  # noqa: E402
from repro.models import decode as jdecode  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.init import param_bytes as jparam_bytes  # noqa: E402
from repro.models.model import build_model as jbuild_model  # noqa: E402
from repro.registry import ASSIGNED_ARCHS  # noqa: E402
from repro.registry import get_config as jget_config  # noqa: E402
from repro.sharding import api as japi  # noqa: E402
from repro.sharding import auto as jauto  # noqa: E402
from repro.sharding.rules import RULE_PROFILES  # noqa: E402

from repro_torch import config as tconfig  # noqa: E402
from repro_torch.launch import comm_analysis as tcomm  # noqa: E402
from repro_torch.launch import inputs as tinputs  # noqa: E402
from repro_torch.launch import roofline as troof  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import decode as tdecode  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.init import param_bytes as tparam_bytes  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.registry import get_config  # noqa: E402
from repro_torch.sharding import api as tapi  # noqa: E402
from repro_torch.sharding import auto as tauto  # noqa: E402
from repro_torch.sharding import rules as trules  # noqa: E402

TAGGERS = [f"{d}-{c}" for d in ("top-tagging", "flavor-tagging", "quickdraw")
           for c in ("lstm", "gru")]
FAMILIES = sorted({k.split("_")[0] for k in RULE_PROFILES})
KINDS = ("train", "prefill", "decode")


class FakeMesh:
    def __init__(self, shape):
        self.axis_names = (("pod", "data", "model") if len(shape) == 3
                           else ("data", "model"))
        self.shape = dict(zip(self.axis_names, shape))


MESHES = {"single_pod": (16, 16), "multi_pod": (2, 16, 16)}


def _pspec(p):
    return tuple(p)


def test_rules_are_repros():
    assert trules.RULE_PROFILES == RULE_PROFILES
    for fam in FAMILIES:
        for kind in KINDS:
            assert trules.rules_for(fam, kind) == \
                japi.rules_for(fam, kind)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS + TAGGERS)
def test_pspec_of_every_param_spec_equals_repro(arch, mesh):
    m = FakeMesh(MESHES[mesh])
    jcfg, tcfg = jget_config(arch), get_config(arch)
    ov = jauto.auto_overrides(jcfg, m)
    assert tauto.auto_overrides(tcfg, m) == ov
    n = 0
    for fam in FAMILIES:
        for kind in KINDS:
            with japi.sharding_context(m, fam, kind, ov) as jctx, \
                    tapi.sharding_context(m, fam, kind, ov) as tctx:
                want = jbuild_model(jcfg).param_specs()
                got = build_model(tcfg).param_specs()
                if jcfg.family != "rnn":
                    want.update(jdecode.cache_specs(jcfg, 8, 64))
                    got.update(tdecode.cache_specs(tcfg, 8, 64))
                assert sorted(got) == sorted(want)
                for k, s in want.items():
                    assert got[k].shape == s.shape, k
                    assert tctx.pspec(got[k].axes) == \
                        _pspec(jctx.pspec(s.logical_axes)), (fam, kind, k)
                    n += 1
                assert tparam_bytes(got) == jparam_bytes(want)
    assert n > 0


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS + TAGGERS)
def test_auto_overrides_bytes_and_cells_equal_repro(arch, mesh):
    m = FakeMesh(MESHES[mesh])
    jcfg, tcfg = jget_config(arch), get_config(arch)
    assert tauto.dp_size(m) == jauto.dp_size(m)
    for name, shape in jconfig.SHAPES.items():
        tshape = tconfig.SHAPES[name]
        assert dataclasses.asdict(tshape) == dataclasses.asdict(shape)
        assert tauto.auto_overrides(tcfg, m, tshape) == \
            jauto.auto_overrides(jcfg, m, shape), name
        assert tconfig.cell_applicable(tcfg, tshape) == \
            jconfig.cell_applicable(jcfg, shape)
    assert build_model(tcfg).param_bytes() == jbuild_model(jcfg).param_bytes()
    assert tconfig.SUBQUADRATIC_FAMILIES == jconfig.SUBQUADRATIC_FAMILIES


def _dtype_name(t) -> str:
    return str(t.dtype).split(".")[-1]


@pytest.mark.parametrize("shape", list(jconfig.SHAPES))
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS + ["top-tagging-gru"])
def test_input_specs_equal_repro(arch, shape, monkeypatch):
    """Shapes, dtypes and pspecs of every stand-in, on the production mesh
    with the cell's overrides."""
    monkeypatch.setattr(
        jinputs, "_sds", lambda s, dt, ctx, axes:
        (tuple(s), jnp.dtype(dt).name, _pspec(ctx.pspec(axes))))
    monkeypatch.setattr(
        jinputs, "abstract_params", lambda specs, ctx:
        {k: (tuple(v.shape), jnp.dtype(v.dtype).name,
             _pspec(ctx.pspec(v.logical_axes))) for k, v in specs.items()})
    m = FakeMesh(MESHES["single_pod"])
    jcfg, tcfg = jget_config(arch), get_config(arch)
    jshape, tshape = jconfig.SHAPES[shape], tconfig.SHAPES[shape]
    ov = jauto.auto_overrides(jcfg, m, jshape)
    with japi.sharding_context(m, jcfg.family, jshape.kind, ov) as jctx, \
            tapi.sharding_context(m, tcfg.family, tshape.kind, ov) as tctx:
        if tshape.kind == "decode" and tcfg.family != "rnn":
            jc, jt, jp = jinputs.decode_input_specs(jcfg, jshape, jctx)
            tc, tt, tp = tinputs.decode_input_specs(tcfg, tshape, tctx)
            want = dict(jc, __tokens=jt, __pos=jp)
            got = dict(tc, __tokens=tt, __pos=tp)
        else:
            want = jinputs.batch_specs(jcfg, jshape, jctx)
            got = tinputs.batch_specs(tcfg, tshape, tctx)
    assert sorted(got) == sorted(want)
    for k, (s, dt, ps) in want.items():
        t = got[k]
        assert t.device.type == "meta"
        assert (tuple(t.shape), _dtype_name(t), t.pspec) == (s, dt, ps), k
    assert tinputs.WHISPER_TEXT_LEN == jinputs.WHISPER_TEXT_LEN


def test_input_specs_without_context_are_plain_meta():
    cfg = get_config("phi-3-vision-4.2b")
    b = tinputs.batch_specs(cfg, tconfig.SHAPES["train_4k"], None)
    assert b["tokens"].shape == (256, 4096 - cfg.n_frontend_tokens)
    assert b["img_embeds"].dtype == torch.bfloat16
    assert all(t.device.type == "meta" and t.pspec is None
               for t in b.values())


@pytest.mark.parametrize("kind", ["all-gather", "all-reduce",
                                  "reduce-scatter", "all-to-all",
                                  "collective-permute"])
def test_ring_cost_model_equals_hlo_analysis(kind):
    rng = np.random.RandomState(0)
    ops_j, ops_t = [], []
    for n in (1, 2, 4, 16, 256, 512):
        res, opd = (int(v) for v in rng.randint(1, 1 << 30, 2))
        cnt = int(rng.randint(1, 9))
        jop = jhlo.CollectiveOp(kind=kind, computation="c", result_bytes=res,
                                operand_bytes=opd, group_size=n, count=cnt)
        top = tcomm.CollectiveOp(kind=kind, computation="c",
                                 result_bytes=res, operand_bytes=opd,
                                 group_size=n, count=cnt)
        assert top.wire_bytes == jop.wire_bytes
        ops_j.append(jop)
        ops_t.append(top)
    ja, ta = jhlo.HloAnalysis(ops_j), tcomm.CommAnalysis(ops_t)
    assert ta.total_wire_bytes == ja.total_wire_bytes
    assert ta.by_kind() == ja.by_kind()
    assert ta.op_counts() == ja.op_counts()


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS + TAGGERS)
def test_model_flops_equal_repro(arch):
    jcfg, tcfg = jget_config(arch), get_config(arch)
    for name, shape in jconfig.SHAPES.items():
        tshape = tconfig.SHAPES[name]
        assert troof.attention_model_flops(tcfg, tshape) == \
            jroof.attention_model_flops(jcfg, shape), name
        assert troof.model_flops(tcfg, tshape) == \
            jroof.model_flops(jcfg, shape), name


def test_analyze_record_equals_repro():
    """One synthetic record of an f32 arch (no bf16 halving in repro), the
    H100's numbers given to both."""
    h = tconfig.H100
    jhw = jconfig.HardwareConfig(
        name=h.name, peak_flops_bf16=h.peak_flops_bf16, hbm_bw=h.hbm_bw,
        ici_link_bw=h.link_bw, hbm_bytes=h.hbm_bytes)
    flops, acc, wire, peak = 3.1e12, 7.7e10, 2.5e9, 9 * 2 ** 30
    base = {"arch": "top-tagging-gru", "shape": "train_4k", "kind": "train",
            "collectives": {"wire_bytes_per_device": wire}}
    jrec = dict(base, memory={"peak_bytes": peak},
                cost_raw={"flops": flops, "bytes_accessed": acc})
    trec = dict(base, memory={"peak_bytes": peak},
                cost={"flops": flops * 256, "flops_per_device": flops,
                      "bytes_accessed": acc})
    assert troof.analyze_record(trec, hw=h) == jroof.analyze_record(jrec,
                                                                    hw=jhw)
    assert troof.analyze_record({"arch": "x"}) is None
    assert h.peak_flops_bf16 == 989e12 and h.peak_flops_f32 == 67e12
    assert h.hbm_bw == 3.35e12 and h.hbm_bytes == 80 * 10 ** 9


def _attn_inputs(b=2, s=32, h=4, hk=2, d=8, seed=0):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(*shape).astype(np.float32)
                 for shape in ((b, s, h, d), (b, s, hk, d), (b, s, hk, d)))


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 6),
                                           (False, 0)])
def test_sp_attention_equals_repro(tp, causal, window):
    q, k, v = _attn_inputs()
    want = np.asarray(jtf._sp_attention(
        *(jnp.asarray(a) for a in (q, k, v)), causal=causal, window=window,
        tp=tp, chunk_kv=8))
    got = ttf._sp_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                            causal=causal, window=window, tp=tp, chunk_kv=8)
    np.testing.assert_allclose(got.numpy(), want, atol=3e-5, rtol=0)
    cq = q.shape[1] // tp
    for i in range(tp):
        qc = q[:, i * cq:(i + 1) * cq]
        w = np.asarray(jtf._masked_rect(
            jnp.asarray(qc), jnp.asarray(k), jnp.asarray(v), i * cq, causal,
            window, 8))
        g = ttf._masked_rect(torch.from_numpy(qc), torch.from_numpy(k),
                             torch.from_numpy(v), i * cq, causal, window, 8)
        np.testing.assert_allclose(g.numpy(), w, atol=3e-5, rtol=0)


@pytest.mark.parametrize("arch,mesh,sp", [
    ("gemma-2b", (4, 2), True), ("stablelm-3b", (4, 2), False),
    ("gemma-2b", (8, 1), False)])
def test_attention_block_takes_the_sp_branch_where_repro_does(
        arch, mesh, sp, monkeypatch):
    """Mode 'sp' (heads not dividing the model axis), TP > 1, causal: the
    SP branch, whose output equals the heads branch within 3e-5."""
    from repro_torch.testing import tiny_config

    cfg = tiny_config(get_config(arch)).replace(n_heads=3 if sp else 4,
                                                n_kv_heads=1)
    m = FakeMesh(mesh)
    ov = tauto.auto_overrides(cfg, m, tconfig.ShapeConfig("t", 16, 4,
                                                          "train"))
    jcfg = tiny_config(jget_config(arch)).replace(
        n_heads=cfg.n_heads, n_kv_heads=1)
    assert ov == jauto.auto_overrides(jcfg, m, jconfig.ShapeConfig(
        "t", 16, 4, "train"))
    params = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    p = {k: v[0] for k, v in params.items() if k.startswith("decoder/")}
    x = torch.randn(2, 16, cfg.d_model,
                    generator=torch.Generator().manual_seed(1))
    calls = []
    real = ttf._sp_attention
    monkeypatch.setattr(ttf, "_sp_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    plain = ttf.attention_block(cfg, x, p, "decoder/attn", causal=True)
    with tapi.sharding_context(m, cfg.family, "train", ov):
        assert ttf._attn_meta() == (ov.get("__attn_mode__", "tp"),
                                    m.shape["model"])
        got = ttf.attention_block(cfg, x, p, "decoder/attn", causal=True)
        ttf.attention_block(cfg, x, p, "decoder/attn", causal=False)
    assert len(calls) == (1 if sp else 0)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=3e-5,
                               rtol=0)


def test_constrain_is_the_identity_off_the_mesh():
    x = torch.randn(2, 3, 4)
    assert tapi.constrain(x, "batch", "seq", "embed_act") is x
    m = FakeMesh((16, 16))
    with tapi.sharding_context(m, "dense", "train") as ctx:
        assert tapi.current_context() is ctx
        assert tapi.constrain(x, "batch", "seq", "embed_act") is x
        with pytest.raises(ValueError, match="2 axes for rank-3"):
            tapi.constrain(x, "batch", "seq")
        assert tapi.logical_to_pspec(("batch", "embed")) == ("data", None)
    assert tapi.current_context() is None
    with tapi.sharding_context(None) as none:
        assert none is None


def test_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="no process group"):
        make_mesh((2, 4), ("data", "model"), device_type="cpu")
