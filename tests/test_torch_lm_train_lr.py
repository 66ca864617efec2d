"""stablelm-3b's rising loss at the trainer's lr 1e-3, classified on the CPU.

At published width the port's trainer took stablelm-3b's loss from 11.17
to 12.56 over 20 steps at lr 1e-3.  Here the port's ``launch.train.train``
and ``repro``'s run tiny stablelm-3b at that lr for 20 steps from the
same parameters (``repro``'s seed-0 draw, carried over) on the same
``lm_token_stream`` batches: the loss of every step (read from each
trainer's own step function, ``jax.debug.callback`` inside ``repro``'s
jitted step) agrees within the f32 tolerance.  So the trainer's loss
curve is ``repro``'s: the port keeps it equal.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro.launch import train as jlaunch  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.registry import get_config as jget_config  # noqa: E402
from repro.testing import CONFORMANCE_TOL, tiny_config  # noqa: E402

from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models.decode import lm_params_from_jax  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402


class _Carried(Model):
    """A model whose ``init`` returns given parameters."""

    def init(self, generator=None, device="cuda"):
        return {k: v.to(device) for k, v in self._params.items()}


def _recording(make, record, on_jax):
    def wrapped(*a, **kw):
        step = make(*a, **kw)

        def run(params, opt_state, batch):
            out = step(params, opt_state, batch)
            loss = out[2]["loss"]
            if on_jax:
                jax.debug.callback(lambda v: record.append(float(v)), loss)
            else:
                record.append(float(loss))
            return out
        return run
    return wrapped


def test_stablelm_loss_at_lr_1e3_equals_repro_every_step(monkeypatch):
    kw = dict(steps=20, batch=4, lr=1e-3, seq_len=32, tiny=True,
              log_every=5)
    jcfg = tiny_config(jget_config("stablelm-3b"))
    start = lm_params_from_jax(
        {k: np.asarray(v) for k, v in
         jbuild_model(jcfg).init(jax.random.PRNGKey(0)).items()}, "cpu")

    def build(cfg):
        m = _Carried(cfg)
        object.__setattr__(m, "_params", start)
        return m

    want, got = [], []
    monkeypatch.setattr(jlaunch, "make_train_step", _recording(
        jlaunch.make_train_step, want, on_jax=True))
    monkeypatch.setattr(tlaunch, "make_train_step", _recording(
        tlaunch.make_train_step, got, on_jax=False))
    monkeypatch.setattr(tlaunch, "build_model", build)
    jlaunch.train("stablelm-3b", **kw)
    tlaunch.train("stablelm-3b", device="cpu", **kw)
    assert len(want) == len(got) == 20
    tol = CONFORMANCE_TOL["float32"]
    for i, (g, w) in enumerate(zip(got, want)):
        assert abs(g - w) <= tol * max(1.0, abs(w)), (i, g, w)
