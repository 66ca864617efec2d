"""The port's schedule keys and configs against the JAX package's.

The port keeps its own copies of ``kernels/schedule.py``, ``config.py`` and
the three paper configs; these tests hold the copies to the originals, so a
schedule key names the same design point in both packages (exact equality:
these are strings and integers).
"""

import dataclasses

import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

from repro.config import FixedPointConfig as JFixedPoint  # noqa: E402
from repro.configs import flavor_tagging as jflavor  # noqa: E402
from repro.configs import quickdraw as jquickdraw  # noqa: E402
from repro.configs import top_tagging as jtop  # noqa: E402
from repro.kernels import schedule as jsched  # noqa: E402
from repro.models import rnn_tagger as jtagger  # noqa: E402

from repro_torch.config import FixedPointConfig  # noqa: E402
from repro_torch.configs import TAGGERS, get_config  # noqa: E402
from repro_torch.kernels import schedule as tsched  # noqa: E402
from repro_torch.models import rnn_tagger as ttagger  # noqa: E402


def _schedule_variants():
    """KernelSchedule.sweep() plus the hoist, hr and ii variants, over every
    backend."""
    out = []
    for backend in jsched.BACKENDS:
        for s in jsched.KernelSchedule.sweep(backend=backend):
            out.append(s)
            out.append(s.replace(hoist_input=True))
            out.append(s.replace(hoist_input=True, hoist_reuse=2))
            out.append(s.replace(ii=3))
        out.append(jsched.KernelSchedule(mode="pipeline", ii=2,
                                         block_batch=8, backend=backend))
    return out


VARIANTS = _schedule_variants()


@pytest.mark.parametrize("js", VARIANTS, ids=[s.key() for s in VARIANTS])
def test_schedule_keys_match_repro(js):
    ts = tsched.KernelSchedule(**dataclasses.asdict(js))
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    assert ts.key() == js.key()
    for jfp, tfp in ((None, None), (JFixedPoint(16, 6), FixedPointConfig(16, 6)),
                     (JFixedPoint(8, 3, rounding="trn", saturation="wrap"),
                      FixedPointConfig(8, 3, rounding="trn",
                                       saturation="wrap"))):
        key = tsched.schedule_key(ts, tfp)
        assert key == jsched.schedule_key(js, jfp)
        assert tsched.KernelSchedule.from_key(key) == ts
        assert dataclasses.asdict(jsched.KernelSchedule.from_key(key)) \
            == dataclasses.asdict(tsched.KernelSchedule.from_key(key))
    assert ts.use_pallas == js.use_pallas
    for n in (1, 7, 12, 20, 80, 480):
        assert ts.effective_reuse(n) == js.effective_reuse(n)
        assert ts.sequential_steps(n) == js.sequential_steps(n)
        assert ts.initiation_interval(n) == js.initiation_interval(n)
    assert tsched.cache_meta(ts, None) == jsched.cache_meta(js, None)


def test_module_constants_and_default_key():
    assert tsched.MODES == jsched.MODES
    assert tsched.BACKENDS == jsched.BACKENDS
    assert tsched.DEFAULT_SCHEDULE_KEY == jsched.DEFAULT_SCHEDULE_KEY
    assert tsched.schedule_key(None) == jsched.schedule_key(None)
    assert tsched.KernelSchedule.sweep() == tuple(
        tsched.KernelSchedule(**dataclasses.asdict(s))
        for s in jsched.KernelSchedule.sweep())


@pytest.mark.parametrize("bad", ("static-R1-bb8", "static-Rx-bb8-auto",
                                 "static-R1-b8-auto", "warp-R1-bb8-auto"))
def test_from_key_rejects_malformed(bad):
    with pytest.raises(ValueError):
        jsched.KernelSchedule.from_key(bad)
    with pytest.raises(ValueError):
        tsched.KernelSchedule.from_key(bad)


JCONFIGS = {c().name: c for m in (jtop, jflavor, jquickdraw)
            for c in (m.lstm_config, m.gru_config)}


@pytest.mark.parametrize("name", sorted(TAGGERS))
def test_tagger_configs_match_repro(name):
    tcfg, jcfg = get_config(name), JCONFIGS[name]()
    assert (tcfg.name, tcfg.family, tcfg.param_dtype, tcfg.compute_dtype) \
        == (jcfg.name, jcfg.family, jcfg.param_dtype, jcfg.compute_dtype)
    assert dataclasses.asdict(tcfg.rnn) == dataclasses.asdict(jcfg.rnn)
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.rnn.kernel_schedule().key() \
        == jcfg.rnn.kernel_schedule().key()
    tspecs, jspecs = ttagger.param_specs(tcfg), jtagger.param_specs(jcfg)
    assert {k: (s.shape, s.init) for k, s in tspecs.items()} \
        == {k: (s.shape, s.init) for k, s in jspecs.items()}
    assert sum(s.shape[0] * (s.shape[1] if len(s.shape) > 1 else 1)
               for s in tspecs.values()) == tcfg.param_count()
    assert tcfg.replace(name="x").name == "x"
