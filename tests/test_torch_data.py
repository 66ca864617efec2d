"""The port's copies of ``repro``'s jax-free modules: data, registry, ft.

  * ``repro_torch.data``: each generator returns arrays byte-identical to
    ``repro``'s for the same ``(n, seed)`` (dtype, shape and bytes), and
    ``lm_token_stream`` the same batches, sharded or not;
  * ``repro_torch.registry``: the same arch ids, ``list_archs`` and
    ``ASSIGNED_ARCHS`` beside the port's own (``PORT_ONLY_ARCHS``); every
    config the port carries equal to ``repro``'s field by field (the
    registry's every arch; the port's own fields at their defaults);
    ``configs.get_config`` is the registry's;
  * ``repro_torch.ft``: ``HeartbeatMonitor``, ``StragglerPolicy`` and
    ``plan_elastic_restart`` make the same decisions on the same event
    sequences.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro import data as jdata  # noqa: E402
from repro import ft as jft  # noqa: E402
from repro import registry as jregistry  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import data as tdata  # noqa: E402
from repro_torch import ft as tft  # noqa: E402
from repro_torch import registry as tregistry  # noqa: E402
from repro_torch.config import PORT_ONLY_FIELDS, ModelConfig  # noqa: E402

DATASETS = ("top_tagging_dataset", "flavor_tagging_dataset",
            "quickdraw_dataset")
#: configs the port carries: every arch id of the registry (the last, the
#: port's own, which ``repro`` does not have)
PORTED = ("gemma-2b", "stablelm-3b", "deepseek-coder-33b", "nemotron-4-340b",
          "mamba2-780m", "qwen2-moe-a2.7b", "qwen3-moe-30b-a3b",
          "recurrentgemma-9b", "whisper-medium", "phi-3-vision-4.2b",
          "top-tagging-lstm", "top-tagging-gru",
          "flavor-tagging-lstm", "flavor-tagging-gru", "quickdraw-lstm",
          "quickdraw-gru", "granite-4.0-h-micro")


def _same_array(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("n,seed", [(1, 0), (37, 0), (64, 5), (200, 99)])
@pytest.mark.parametrize("name", DATASETS)
def test_datasets_byte_identical(name, n, seed):
    gx, gy = getattr(tdata, name)(n, seed=seed)
    wx, wy = getattr(jdata, name)(n, seed=seed)
    _same_array(gx, wx)
    _same_array(gy, wy)


@pytest.mark.parametrize("process_count", [1, 2])
@pytest.mark.parametrize("seed", [0, 3])
def test_lm_token_stream_byte_identical(seed, process_count):
    for proc in range(process_count):
        got = tdata.lm_token_stream(301, 8, 33, seed=seed,
                                    process_index=proc,
                                    process_count=process_count)
        want = jdata.lm_token_stream(301, 8, 33, seed=seed,
                                     process_index=proc,
                                     process_count=process_count)
        for _ in range(3):
            g, w = next(got), next(want)
            assert sorted(g) == sorted(w)
            for k in w:
                _same_array(g[k], w[k])


def test_registry_ids_equal_repro():
    own = set(tregistry.PORT_ONLY_ARCHS)
    assert {k: v for k, v in tregistry.ARCHS.items() if k not in own} \
        == jregistry.ARCHS
    assert not own & set(jregistry.ARCHS)
    assert [a for a in tregistry.list_archs() if a not in own] == \
        jregistry.list_archs()
    assert tregistry.ASSIGNED_ARCHS == jregistry.ASSIGNED_ARCHS
    assert set(PORTED) == set(tregistry.ARCHS)


@pytest.mark.parametrize("arch", sorted(jregistry.ARCHS))
def test_registry_config_equals_repro(arch):
    assert arch in PORTED
    got, want = tregistry.get_config(arch), jregistry.get_config(arch)
    assert isinstance(got, ModelConfig)
    for f in dataclasses.fields(ModelConfig):
        g = getattr(got, f.name)
        if f.name in PORT_ONLY_FIELDS:
            assert g == f.default, (arch, f.name, g)
            continue
        w = getattr(want, f.name)
        if dataclasses.is_dataclass(g):
            g, w = dataclasses.asdict(g), dataclasses.asdict(w)
        assert g == w, (arch, f.name, g, w)
    assert tconfigs.get_config(arch) == got


def test_one_lookup():
    assert tconfigs.get_config is tregistry.get_config
    with pytest.raises(KeyError, match="unknown arch"):
        tregistry.get_config("top-tagging-rnn")


def _events(seed, n_workers, n_events):
    """A seeded sequence of (worker, time) heartbeats and step times."""
    rng = np.random.RandomState(seed)
    now = 1000.0
    events = []
    for _ in range(n_events):
        now += float(rng.exponential(10.0))
        events.append((int(rng.randint(0, n_workers)), now,
                       float(rng.lognormal(0.0, 0.6))))
    return events


@pytest.mark.parametrize("seed", range(4))
def test_heartbeat_monitor_decisions_equal_repro(seed):
    n = 6
    got = tft.HeartbeatMonitor(n, timeout_s=30.0)
    want = jft.HeartbeatMonitor(n, timeout_s=30.0)
    for worker, now, _ in _events(seed, n, 60):
        got.beat(worker, now)
        want.beat(worker, now)
        for probe in (now, now + 15.0, now + 45.0):
            assert got.dead_workers(probe) == want.dead_workers(probe)
            assert got.healthy(probe) == want.healthy(probe)
    assert got.last_seen == want.last_seen


@pytest.mark.parametrize("seed", range(4))
def test_straggler_decisions_equal_repro(seed):
    got = tft.StragglerPolicy(threshold=1.5, patience=2)
    want = jft.StragglerPolicy(threshold=1.5, patience=2)
    assert got.evaluate() == want.evaluate() == {}
    for worker, _, dt in _events(seed, 5, 80):
        got.record_step(worker, dt)
        want.record_step(worker, dt)
        assert got.evaluate() == want.evaluate()
    assert got.strikes == want.strikes


def test_straggler_eviction_equal_repro():
    """One worker 3x slower for 4 steps: warn, then evict, in both."""
    got, want = tft.StragglerPolicy(), jft.StragglerPolicy()
    seen = []
    for step in range(6):
        for w in range(4):
            dt = 3.0 if (w == 3 and 1 <= step <= 4) else 1.0 + 0.01 * w
            got.record_step(w, dt)
            want.record_step(w, dt)
        g = got.evaluate()
        assert g == want.evaluate()
        seen.append(g[3])
    assert seen == ["ok", "warn", "warn", "evict", "evict", "ok"]


@pytest.mark.parametrize("original", [1, 8, 16, 64, 512])
def test_elastic_plans_equal_repro(original):
    for healthy in range(0, original + 2):
        got = tft.plan_elastic_restart(healthy, original)
        want = jft.plan_elastic_restart(healthy, original)
        if want is None:
            assert got is None
            continue
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
