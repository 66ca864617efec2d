"""The stage pipeline on the CPU: 4 gloo ranks on localhost.

One subprocess group (``tests/torch_dist_worker.py pipeline``): 4 ranks
run ``core.rnn.pipeline.pipelined_rnn`` of the top-tagging LSTM and GRU
at published width, plain and hoisted, on the same numpy inputs as
``repro``'s ``ref.lstm_scan_ref`` / ``gru_scan_ref``: within 1e-5 of them
(``repro``'s ``test_pipelined_rnn_on_mesh`` bar), the same answer on every
rank.  Without a process group the pipeline refuses to run.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro.kernels import ref as jref  # noqa: E402
from repro.registry import get_config as jget_config  # noqa: E402

from repro_torch.config import RNNConfig  # noqa: E402
from repro_torch.core.rnn.pipeline import pipelined_rnn  # noqa: E402

from torch_dist_worker import run  # noqa: E402


def _pipeline_inputs():
    rng = np.random.RandomState(0)
    data, want = {}, {}
    for arch in ("top-tagging-lstm", "top-tagging-gru"):
        r = jget_config(arch).rnn
        g = 4 if r.cell == "lstm" else 3
        xs = rng.randn(6, r.seq_len, r.input_size).astype(np.float32)
        W = rng.randn(r.input_size, g * r.hidden).astype(np.float32) * .3
        U = rng.randn(r.hidden, g * r.hidden).astype(np.float32) * .3
        b = rng.randn(*((g * r.hidden,) if r.cell == "lstm"
                        else (2, g * r.hidden))).astype(np.float32) * .1
        for n, v in zip(("xs", "W", "U", "b"), (xs, W, U, b)):
            data[f"{arch}/{n}"] = v
        scan = jref.lstm_scan_ref if r.cell == "lstm" else jref.gru_scan_ref
        want[arch] = np.asarray(scan(*(jax.numpy.asarray(v)
                                       for v in (xs, W, U, b))))
    return data, want


@pytest.fixture(scope="module")
def pipeline(tmp_path_factory):
    out = tmp_path_factory.mktemp("pipeline")
    data, want = _pipeline_inputs()
    np.savez(out / "inputs.npz", **data)
    run("pipeline", out)
    got = [dict(np.load(out / f"rank{r}.npz")) for r in range(4)]
    return got, want


@pytest.mark.parametrize("arch", ["top-tagging-lstm", "top-tagging-gru"])
@pytest.mark.parametrize("mode", ["plain", "hoist"])
def test_pipelined_rnn_equals_static_scan(pipeline, arch, mode):
    got, want = pipeline
    for rank_out in got:
        o = rank_out[f"{arch}/{mode}"]
        assert o.shape == want[arch].shape
        err = float(np.abs(o - want[arch]).max())
        assert err < 1e-5, (arch, mode, err)
    assert all(np.array_equal(r[f"{arch}/{mode}"], got[0][f"{arch}/{mode}"])
               for r in got)


def test_pipeline_needs_a_process_group():
    x = torch.zeros(2, 4, 3)
    with pytest.raises((RuntimeError, ValueError)):
        pipelined_rnn(RNNConfig(hidden=4, seq_len=4, input_size=3), x,
                      torch.zeros(3, 16), torch.zeros(4, 16),
                      torch.zeros(16))
