"""The port's FPGA pricing (``repro_torch.core.hls``) against the JAX
package's (``repro.core.hls``), on the CPU.

Both are pure Python on the same integers and floats, so every estimate
is compared for exact equality, field by field: the six tagger configs
at their published widths x every point of ``SpaceSpec(reuse_factors=(1,
2, 4), iis=(0, 1))`` (plus reuse factors that do not divide the gate
dimension) x ``fp`` in {None, ap_fixed<16,6>, native ap_fixed<8,3>}; the
LM and speculative estimates at ``repro.testing.tiny_config`` of
gemma-2b; and the paper-table cases of ``tests/test_hls_model.py``
(Tables 2-5, Figs 3 and 6), which the port must reproduce as well.
"""

import dataclasses
import math

import pytest
from hypothesis import given, settings, strategies as st

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro import config as jconfig  # noqa: E402
from repro.core import hls as jhls  # noqa: E402
from repro.kernels.schedule import KernelSchedule as JSchedule  # noqa: E402
from repro.registry import get_config as jget_config  # noqa: E402
from repro.testing import tiny_config  # noqa: E402
from test_hls_model import TABLE_2, TABLE_3, TABLE_4  # noqa: E402

from repro_torch.autotune import SpaceSpec, enumerate_space  # noqa: E402
from repro_torch.autotune import lm_decode_schedules  # noqa: E402
from repro_torch.config import (PORT_ONLY_FIELDS,  # noqa: E402
                                FixedPointConfig, ModelConfig)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import hls  # noqa: E402
from repro_torch.kernels.schedule import KernelSchedule  # noqa: E402

TAGGERS = ("top-tagging-lstm", "top-tagging-gru", "flavor-tagging-lstm",
           "flavor-tagging-gru", "quickdraw-lstm", "quickdraw-gru")
SPEC = SpaceSpec(reuse_factors=(1, 2, 4), iis=(0, 1))
FPS = (None, FixedPointConfig(16, 6), FixedPointConfig(8, 3))
FP_IDS = ("float", "ap16_6", "ap8_3_native")
CLOCK = 200.0


def jsched(s: KernelSchedule) -> JSchedule:
    return JSchedule(**dataclasses.asdict(s))


def jfp(fp):
    return None if fp is None else jconfig.FixedPointConfig(
        **dataclasses.asdict(fp))


def points(name):
    """The tagger's space at SPEC, and ragged reuse requests (R = 3, 5, 7,
    clamped by ``effective_reuse``), static and hoisted."""
    extra = tuple(KernelSchedule(reuse_factor=r, block_batch=8, **kw)
                  for r in (3, 5, 7)
                  for kw in ({}, {"hoist_input": True, "hoist_reuse": r}))
    return enumerate_space(get_config(name), SPEC) + extra


@pytest.fixture(params=[(t, i) for t in TAGGERS for i in range(len(FPS))],
                ids=lambda p: f"{p[0]}-{FP_IDS[p[1]]}")
def case(request):
    """(port cfg, jax cfg, port fp, jax fp, schedules)."""
    name, i = request.param
    return (get_config(name), jget_config(name), FPS[i], jfp(FPS[i]),
            points(name))


def test_estimate_schedule_matches_repro(case):
    cfg, jcfg, fp, jf, scheds = case
    for s in scheds:
        got = hls.estimate_schedule(s, cfg.rnn, fp)
        want = jhls.estimate_schedule(jsched(s), jcfg.rnn, jf)
        assert got.report_row(CLOCK) == want.report_row(CLOCK), s.key()
        assert (got.service_s(CLOCK), got.ii_s(CLOCK)) == \
            (want.service_s(CLOCK), want.ii_s(CLOCK))
        assert hls.schedule_estimate_for(cfg, s, fp) == got


def test_estimate_decode_step_matches_repro(case):
    cfg, jcfg, fp, jf, scheds = case
    for s in scheds:
        got = hls.estimate_decode_step(s, cfg.rnn, fp).report_row(CLOCK)
        want = jhls.estimate_decode_step(jsched(s), jcfg.rnn,
                                         jf).report_row(CLOCK)
        assert got == want, s.key()


@pytest.mark.parametrize("part", ("xcku115", "u250", "vu9p_slr"))
def test_estimate_design_for_schedule_matches_repro(case, part):
    cfg, jcfg, fp, jf, scheds = case
    for s in scheds:
        got = hls.estimate_design_for_schedule(cfg, s, fp, part=part)
        want = jhls.estimate_design_for_schedule(jcfg, jsched(s), jf,
                                                 part=part)
        assert got.as_dict() == want.as_dict(), s.key()
        pt = hls.design_point_for_schedule(cfg, s, fp, part=part)
        jpt = jhls.design_point_for_schedule(jcfg, jsched(s), jf, part=part)
        assert (pt.reuse_kernel, pt.hoist_reuse, pt.mode, pt.ii) == \
            (jpt.reuse_kernel, jpt.hoist_reuse, jpt.mode, jpt.ii)


def test_price_point_matches_repro(case):
    cfg, jcfg, fp, jf, scheds = case
    priced, jpriced = [], []
    for s in scheds:
        for price, jprice in ((hls.price_point, jhls.price_point),
                              (hls.price_decode_point,
                               jhls.price_decode_point)):
            got = price(cfg, s, fp)
            want = jprice(jcfg, jsched(s), jf)
            assert got.key == want.key
            assert got.report_row() == want.report_row(), got.key
            assert got.latency_us() == want.latency_us()
            assert got.throughput_eps() == want.throughput_eps()
        priced.append(hls.price_point(cfg, s, fp))
        jpriced.append(jhls.price_point(jcfg, jsched(s), jf))
    for a, ja in zip(priced, jpriced):
        assert [a.dominates(b) for b in priced] == \
            [ja.dominates(jb) for jb in jpriced]


def test_admission_rate_and_axes_match_repro(case):
    cfg, jcfg, fp, jf, scheds = case
    gate_dim = hls.gate_count(cfg.rnn.cell) * cfg.rnn.hidden
    for s in scheds:
        est = hls.estimate_schedule(s, cfg.rnn, fp)
        jest = jhls.estimate_schedule(jsched(s), jcfg.rnn, jf)
        for u in (1.0, 0.5, 0.1):
            assert hls.admission_rate_eps(est, CLOCK, utilization=u) == \
                jhls.admission_rate_eps(jest, CLOCK, utilization=u)
        # R resolves as the port's KernelSchedule.effective_reuse does
        axes = hls.resolved_axes(s, cfg.rnn)
        assert axes == (s.effective_reuse(gate_dim),
                        math.gcd(s.hoist_reuse, gate_dim))
        assert axes == jhls.resolved_axes(jsched(s), jcfg.rnn)
    with pytest.raises(ValueError, match="utilization"):
        hls.admission_rate_eps(est, CLOCK, utilization=0.0)


@settings(max_examples=60, deadline=None)
@given(t=st.integers(0, len(TAGGERS) - 1), r=st.integers(1, 130),
       mode=st.sampled_from(("static", "nonstatic", "pipeline")),
       hoist=st.booleans(), hr=st.integers(1, 9), ii=st.integers(0, 5),
       bb=st.sampled_from((1, 8, 128)), f=st.integers(0, len(FPS) - 1))
def test_any_schedule_prices_as_repro(t, r, mode, hoist, hr, ii, bb, f):
    """Any schedule, ragged axes included, prices as in the JAX package."""
    cfg, jcfg = get_config(TAGGERS[t]), jget_config(TAGGERS[t])
    s = KernelSchedule(reuse_factor=r, mode=mode, block_batch=bb,
                       hoist_input=hoist or hr > 1, hoist_reuse=hr, ii=ii)
    fp, jf = FPS[f], jfp(FPS[f])
    assert hls.price_point(cfg, s, fp).report_row() == \
        jhls.price_point(jcfg, jsched(s), jf).report_row()
    assert hls.price_decode_point(cfg, s, fp).report_row() == \
        jhls.price_decode_point(jcfg, jsched(s), jf).report_row()


def test_catalogue_matches_repro():
    assert {k: dataclasses.asdict(v) for k, v in hls.FPGA_PARTS.items()} \
        == {k: dataclasses.asdict(v) for k, v in jhls.FPGA_PARTS.items()}
    assert (hls.gate_count("lstm"), hls.gate_count("gru")) == (4, 3)
    from repro.core.hls import resources as jres

    from repro_torch.core.hls import resources as tres
    for bits in range(1, 40):
        assert tres.mults_per_dsp(bits) == jres.mults_per_dsp(bits)


# ---------------------------------------------------------------------------
# LM decode and speculative pricing at tiny_config of gemma-2b
# ---------------------------------------------------------------------------


def lm_configs():
    jcfg = tiny_config(jget_config("gemma-2b"))
    cfg = ModelConfig(**{f.name: getattr(jcfg, f.name)
                         for f in dataclasses.fields(ModelConfig)
                         if f.name != "rnn"
                         and f.name not in PORT_ONLY_FIELDS})
    return cfg, jcfg


@pytest.mark.parametrize("i", range(len(FPS)), ids=FP_IDS)
def test_estimate_lm_decode_and_speculative_match_repro(i):
    cfg, jcfg = lm_configs()
    fp, jf = FPS[i], jfp(FPS[i])
    scheds = lm_decode_schedules(cfg, SpaceSpec(reuse_factors=None))
    assert len(scheds) > 2
    ests = {}
    for s in scheds:
        got = hls.estimate_lm_decode(s, cfg, fp)
        want = jhls.estimate_lm_decode(jsched(s), jcfg, jf)
        assert got.report_row(CLOCK) == want.report_row(CLOCK), s.key()
        ests[s.key()] = (got, want)
    keys = sorted(ests)
    for verify in keys:
        for draft in [None] + keys:
            for k in (0, 1, 2, 4, 8):
                for a in (0.0, 0.5, 0.75, 1.0):
                    d = None if draft is None else ests[draft]
                    got = hls.estimate_speculative(
                        None if d is None else d[0], ests[verify][0], k, a)
                    want = jhls.estimate_speculative(
                        None if d is None else d[1], ests[verify][1], k, a)
                    assert got.report_row(CLOCK) == want.report_row(CLOCK)
                    assert got.latency_us_per_token(CLOCK) == \
                        want.latency_us_per_token(CLOCK)
                    assert hls.expected_round_tokens(k, a) == \
                        jhls.expected_round_tokens(k, a)
    with pytest.raises(ValueError, match="k must be"):
        hls.estimate_speculative(None, ests[keys[0]][0], -1, 0.5)


# ---------------------------------------------------------------------------
# The paper's tables and figures (tests/test_hls_model.py) on the port
# ---------------------------------------------------------------------------

FP16 = FixedPointConfig(16, 6)
TABLE_CASES = (
    [(f"table2-{cell}", f"top-tagging-{cell}", FP16, rk, rr, "xcku115", v)
     for cell in ("gru", "lstm") for (rk, rr), v in TABLE_2[cell].items()]
    + [("table3", "flavor-tagging-gru", FP16, rk, rr, "xcku115", v)
       for (rk, rr), v in TABLE_3.items()]
    + [("table4", "quickdraw-gru", FixedPointConfig(26, 10), rk, rr, "u250",
        v) for (rk, rr), v in TABLE_4.items()])


def design(name, fp, *args, **kw):
    """The port's and the JAX package's HLSDesign of one design point."""
    got = hls.estimate_design(hls.RNNDesignPoint(get_config(name), fp,
                                                 *args, **kw))
    want = jhls.estimate_design(jhls.RNNDesignPoint(jget_config(name),
                                                    jfp(fp), *args, **kw))
    assert got.as_dict() == want.as_dict()
    return got


@pytest.mark.parametrize("case", TABLE_CASES,
                         ids=lambda c: f"{c[0]}-R{c[3]}_{c[4]}")
def test_paper_table_latencies_on_the_port(case):
    _, name, fp, rk, rr, part, (lo, hi) = case
    d = design(name, fp, rk, rr, part=part)
    assert d.latency_min_us == pytest.approx(lo, rel=0.12)
    assert d.latency_max_us == pytest.approx(hi, rel=0.12)


def _table_5():
    st = design("top-tagging-gru", FixedPointConfig(10, 6),
                strategy="latency", mode="static")
    ns = design("top-tagging-gru", FixedPointConfig(10, 6),
                strategy="latency", mode="nonstatic")
    assert ns.ii_cycles == 1
    assert st.ii_cycles == pytest.approx(315, rel=0.1)
    assert ns.throughput_eps / st.throughput_eps > 300
    assert ns.latency_min_us == pytest.approx(st.latency_min_us, rel=0.15)


def _fig_6():
    fits = {W: design("top-tagging-gru", FixedPointConfig(W, 6),
                      strategy="latency", mode="nonstatic").fits
            for W in (10, 16, 22)}
    assert fits[10] and not fits[16] and not fits[22]


def _fig_3():
    d12, d18, d22 = (design("top-tagging-gru", FixedPointConfig(W, 6), 6, 5)
                     for W in (12, 18, 22))
    assert d12.dsp == d18.dsp and d22.dsp == 2 * d18.dsp


def _scaling_laws():
    a = design("top-tagging-gru", FP16, 6, 5)
    b = design("top-tagging-gru", FP16, 12, 10)
    assert a.dsp == pytest.approx(2 * b.dsp, rel=0.05)
    lstm = design("top-tagging-lstm", FP16, 6, 5)
    assert 1.1 < lstm.dsp / a.dsp < 1.45
    ns = design("top-tagging-gru", FP16, 6, 5, mode="nonstatic")
    assert ns.dsp == 20 * a.dsp


def _quickdraw_throughput():
    tputs = [design("quickdraw-lstm", FixedPointConfig(26, 10), rk, rr,
                    part="u250").throughput_eps for (rk, rr) in TABLE_4]
    assert min(tputs) < 4300 * 1.3
    assert any(4300 * 0.7 <= t <= 9700 * 1.3 for t in tputs)


@pytest.mark.parametrize("check", (_table_5, _fig_6, _fig_3, _scaling_laws,
                                   _quickdraw_throughput),
                         ids=lambda f: f.__name__.strip("_"))
def test_paper_figures_on_the_port(check):
    check()
