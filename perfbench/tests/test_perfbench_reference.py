"""The plain reference against the port's CPU path, on the benchmark's
seeded weights and events, for each configuration the cells run."""

import json

import numpy as np
import pytest
import torch

from perfbench import spec
from perfbench.reference import make_weights, tagger
from perfbench.spec import HERE, load_benchmark, make_cell

#: every configuration file, with a traffic mix whose events it takes
CONFIGS = {"quickdraw-lstm": "strokes-2048",
           "flavor-tagging-gru": "tracks-8192",
           "quickdraw-lstm-nonstatic": "strokes-2048"}


def config(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def test_every_configuration_file_is_covered():
    assert {p.stem for p in (HERE / "configs").glob("*.json")} == \
        set(CONFIGS)
    assert {c["name"] for c in load_benchmark()["configs"]} <= set(CONFIGS)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_reference_equals_port_on_cpu(config):
    cell = make_cell(config, {}, HERE / "configs" / f"{config}.json",
                     CONFIGS[config])
    cfg = cell.cfg
    from repro_torch.kernels.schedule import KernelSchedule
    from repro_torch.registry import get_config
    from repro_torch.serving.engine import RNNServingEngine

    seed = 2**31 + 17
    weights = make_weights(cfg, seed, torch.device("cpu"))
    from perfbench.generators import GENERATORS
    x = GENERATORS[cell.traffic["generator"]](
        12, np.random.default_rng(seed))
    engine = RNNServingEngine(get_config(cfg["arch"]), weights,
                              schedule=KernelSchedule(**cfg["schedule"]),
                              device="cpu")
    got = engine.predict(x)
    ref = tagger(cfg, weights, torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (12, cfg["n_outputs"])
    # float32 on both sides, sums in other orders
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6)
    # and the port's own reference path (``impl="xla"``) of the same model
    plain = engine.model(torch.from_numpy(x), impl="xla").numpy()
    np.testing.assert_allclose(plain, ref, rtol=0, atol=2e-6)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_gate_order_matters(cell):
    """The comparison sees a swapped gate or the GRU's other reset
    variant: the reference with the LSTM's i and f blocks (GRU: z and r)
    swapped differs from the port by far more than the tolerance above."""
    cfg = config("quickdraw-lstm" if cell == "lstm" else "flavor-tagging-gru")
    w = make_weights(cfg, 5, torch.device("cpu"))
    H = cfg["hidden"]
    swapped = dict(w)
    for k in ("rnn/kernel", "rnn/recurrent"):
        a, b_, *rest = w[k].split(H, dim=1)
        swapped[k] = torch.cat([b_, a, *rest], 1)
    x = torch.randn(16, cfg["seq_len"], cfg["input_size"],
                    generator=torch.Generator().manual_seed(1))
    assert (tagger(cfg, swapped, x) - tagger(cfg, w, x)).abs().max() > 1e-3


def test_make_weights_layout_and_seed():
    cfg = config("flavor-tagging-gru")
    a = make_weights(cfg, 2**31 + 5, torch.device("cpu"))
    b = make_weights(cfg, 2**31 + 5, torch.device("cpu"))
    c = make_weights(cfg, 2**31 + 6, torch.device("cpu"))
    assert a["rnn/bias"].shape == (2, 360)
    assert a["rnn/recurrent"].shape == (120, 360)
    assert a["head/w"].shape == (10, 3)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["rnn/kernel"], c["rnn/kernel"])
    from repro_torch.models.rnn_tagger import param_specs
    from repro_torch.registry import get_config
    specs = param_specs(get_config(cfg["arch"]))
    assert {k: tuple(v.shape) for k, v in a.items()} == \
        {k: s.shape for k, s in specs.items()}


def test_check_sizes_refuses_another_config():
    cfg = dict(config("quickdraw-lstm"), hidden=64)
    for entry in ("predict", "predict_one"):
        with pytest.raises(ValueError):
            spec.entry(entry).check_config(cfg)
