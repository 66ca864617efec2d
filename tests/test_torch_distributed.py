"""The port's sharded training on the CPU: 8 gloo ranks on localhost.

One subprocess group (``tests/torch_dist_worker.py sharded``), spawned
once and read by every test here: 8 ranks on a (2, 4) ("data", "model")
mesh: tiny stablelm-3b's loss
    with DTensor parameters and batch equals the unsharded loss within
    2e-4 (``repro``'s ``test_sharded_train_equals_single_device`` bar),
    ``launch.train.train(mesh_shape=(2, 4))`` for 2 steps equals the
    unsharded trainer within 2e-4 and returns DTensors, and its checkpoint
    restores with ``restore(shardings=)`` as DTensors with the given
    placements, equal bit for bit to the trained parameters.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_dist_worker import run  # noqa: E402

@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharded")
    run("sharded", out)
    return [json.loads((out / f"rank{r}.json").read_text())
            for r in range(8)]


def test_sharded_loss_equals_single_device(sharded):
    for res in sharded:
        err = abs(res["loss_single"] - res["loss_sharded"])
        assert err < 2e-4, err
    # the placements follow the rules: vocab over 'model', FSDP over 'data'
    # (mesh dims data, model; vocab -> model, embed -> data, heads -> model)
    pl = sharded[0]["placements"]
    assert pl["embed/table"] == ["S(1)", "S(0)"]
    assert pl["decoder/attn/wq"] == ["S(1)", "S(2)"]
    assert pl["final_norm/scale"] == ["R", "R"]


def test_sharded_trainer_equals_unsharded(sharded):
    for res in sharded:
        assert np.isfinite(res["train_sharded"])
        assert abs(res["train_single"] - res["train_sharded"]) < 2e-4
        assert res["trained_dtensors"]


def test_restore_with_shardings_round_trip(sharded):
    for res in sharded:
        assert res["restored_step"] == 2
        assert res["restored_equal"] and res["restored_opt_sharded"]


