"""The port's checkpoint manager against ``repro``'s, on the CPU.

``repro_torch.checkpoint.CheckpointManager`` keeps ``repro``'s on-disk
format exactly: the same directory and file names, the same ``.npy`` bytes,
the same ``manifest.json`` (fields, crc32s, bfloat16 stored as uint16 bits
under the logical dtype ``"bfloat16"``).  A checkpoint written by either
package restores in the other, bit for bit, in float32 and bfloat16, and the
port restores bfloat16 without ``ml_dtypes``.  A training run saved at step
k, restored into a fresh state and continued equals the uninterrupted run
bit for bit (``repro``'s ``tests/test_system.py`` holds the same).
"""

import json
import os
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
jnp = jax.numpy

from repro.checkpoint import CheckpointManager as JCheckpointManager  # noqa: E402
from repro.training import OptState as JOptState  # noqa: E402

from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.config import OptimizerConfig, TrainConfig  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.registry import get_config  # noqa: E402
from repro_torch.training import (OptState, adamw_init,  # noqa: E402
                                  make_train_step)

DTYPES = ("float32", "bfloat16")


def _arrays(dtype, seed=0):
    """Parameters and optimizer moments as numpy float32 draws, and the
    same values as torch tensors and as jax arrays in ``dtype``."""
    rng = np.random.RandomState(seed)
    shapes = {"rnn/kernel": (6, 80), "rnn/bias": (2, 60), "head/b": (1,),
              "dense0/w": (20, 64)}
    raw = {tree: {k: rng.randn(*s).astype(np.float32)
                  for k, s in shapes.items()}
           for tree in ("params", "m", "v")}
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    t = {tree: {k: torch.from_numpy(v).to(tdt) for k, v in d.items()}
         for tree, d in raw.items()}
    j = {tree: {k: jnp.asarray(v, jdt) for k, v in d.items()}
         for tree, d in raw.items()}
    tstate = OptState(torch.tensor(7, dtype=torch.int32), t["m"], t["v"])
    jstate = JOptState(jnp.asarray(7, jnp.int32), j["m"], j["v"])
    return (t["params"], tstate), (j["params"], jstate)


def _bits(v):
    """Raw bits of a tensor or array (bfloat16 as uint16)."""
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.bfloat16:
            return v.view(torch.int16).numpy().view(np.uint16)
        return v.numpy()
    a = np.asarray(v)
    return a.view(np.uint16) if "bfloat16" in str(a.dtype) else a


def _assert_same_bits(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = _bits(got[k]), _bits(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert g.tobytes() == w.tobytes(), k


@pytest.mark.parametrize("dtype", DTYPES)
def test_files_equal_repro(tmp_path, dtype):
    (tp, ts), (jp, js) = _arrays(dtype)
    got = CheckpointManager(str(tmp_path / "port")).save(
        3, tp, ts, extra={"arch": "top-tagging-gru"})
    want = JCheckpointManager(str(tmp_path / "repro")).save(
        3, jp, js, extra={"arch": "top-tagging-gru"})
    assert os.path.basename(got) == os.path.basename(want) == \
        "step_000000003"
    assert sorted(os.listdir(got)) == sorted(os.listdir(want))
    for name in os.listdir(want):
        with open(os.path.join(got, name), "rb") as f, \
                open(os.path.join(want, name), "rb") as g:
            assert f.read() == g.read(), name
    with open(os.path.join(got, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["opt_step"] == 7
    logical = {info["dtype"] for info in manifest["arrays"].values()}
    assert logical == {dtype}


@pytest.mark.parametrize("dtype", DTYPES)
def test_port_checkpoint_restores_in_repro(tmp_path, dtype):
    (tp, ts), _ = _arrays(dtype, seed=1)
    CheckpointManager(str(tmp_path)).save(5, tp, ts)
    step, params, opt = JCheckpointManager(str(tmp_path)).restore()
    assert step == 5 and opt["step"] == 7
    _assert_same_bits(params, tp)
    _assert_same_bits(opt["m"], ts.m)
    _assert_same_bits(opt["v"], ts.v)


@pytest.mark.parametrize("dtype", DTYPES)
def test_repro_checkpoint_restores_in_port(tmp_path, dtype, monkeypatch):
    _, (jp, js) = _arrays(dtype, seed=2)
    JCheckpointManager(str(tmp_path)).save(5, jp, js)
    # the card's machine has no ml_dtypes: the port must not need it
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)
    step, params, opt = CheckpointManager(str(tmp_path)).restore(
        device="cpu")
    assert step == 5 and opt["step"] == 7
    assert all(isinstance(v, torch.Tensor) and v.dtype == getattr(torch, dtype)
               for v in params.values())
    _assert_same_bits(params, jp)
    _assert_same_bits(opt["m"], js.m)
    _assert_same_bits(opt["v"], js.v)


def test_manager_bookkeeping(tmp_path):
    (tp, ts), _ = _arrays("float32")
    mgr = CheckpointManager(str(tmp_path), keep=2)
    with pytest.raises(FileNotFoundError):
        mgr.restore(device="cpu")
    assert mgr.latest_step() is None
    for s in (1, 2, 3):
        mgr.save(s, tp, ts if s != 2 else None)
    os.makedirs(tmp_path / "step_000000009.tmp")     # an unpublished save
    assert mgr.latest_step() == 3
    assert sorted(os.listdir(tmp_path)) == [
        "step_000000002", "step_000000003", "step_000000009.tmp"]
    step, params, opt = mgr.restore(2, device="cpu")
    assert step == 2 and opt is None
    _assert_same_bits(params, tp)
    # a shardings map that names no key restores plain tensors
    step, params, _ = mgr.restore(2, shardings={}, device="cpu")
    _assert_same_bits(params, tp)
    # a flipped byte fails the crc check (np.save's header is 128 bytes)
    path = tmp_path / "step_000000003" / "params__rnn__kernel.npy"
    raw = bytearray(path.read_bytes())
    raw[200] ^= 1
    path.write_bytes(bytes(raw))
    with pytest.raises(IOError, match="checksum mismatch"):
        mgr.restore(device="cpu")
    mgr.restore(device="cpu", verify=False)


def _run(step_fn, params, state, x, y, steps):
    for i in steps:
        idx = np.random.RandomState(100 + i).randint(0, len(x), 32)
        params, state, _ = step_fn(params, state, {
            "x": torch.from_numpy(x[idx]), "y": torch.from_numpy(y[idx])})
    return params, state


@pytest.mark.parametrize("arch", ["top-tagging-gru", "flavor-tagging-lstm"])
def test_restart_resumes_bit_for_bit(tmp_path, arch):
    """Save at step 3, restore into a fresh state, continue: equal to the
    uninterrupted 6 steps bit for bit, parameters and moments."""
    cfg = get_config(arch)
    m = build_model(cfg)
    opt = OptimizerConfig(lr=1e-3, warmup_steps=0, total_steps=20,
                          weight_decay=0.0)
    step_fn = make_train_step(m, TrainConfig(optimizer=opt))
    rng = np.random.RandomState(0)
    x = rng.randn(256, 6, cfg.rnn.input_size).astype(np.float32)
    y = rng.randint(0, max(cfg.rnn.n_outputs, 2), 256).astype(np.int32)
    p0 = m.init(torch.Generator().manual_seed(0), device="cpu")
    pa, sa = _run(step_fn, p0, adamw_init(p0, opt), x, y, range(6))
    pb, sb = _run(step_fn, p0, adamw_init(p0, opt), x, y, range(3))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, pb, sb)
    _, pr, orst = mgr.restore(device="cpu")
    fresh = adamw_init(pr, opt)
    sr = fresh._replace(step=torch.tensor(orst["step"], dtype=torch.int32),
                        m=orst["m"], v=orst["v"])
    pc, sc = _run(step_fn, pr, sr, x, y, range(3, 6))
    _assert_same_bits(pc, pa)
    _assert_same_bits(sc.m, sa.m)
    _assert_same_bits(sc.v, sa.v)
    assert int(sc.step) == int(sa.step) == 6


def test_train_entry_point_saves_and_resumes(tmp_path):
    """``train(checkpoint_dir=...)`` saves its last step; ``resume``
    restores parameters and moments and, as ``repro``'s, starts the batch
    stream again at its first batch."""
    ckpt = str(tmp_path)
    tlaunch.train("flavor-tagging-gru", steps=2, batch=16, lr=5e-3,
                  checkpoint_dir=ckpt, log_every=1, device="cpu")
    assert CheckpointManager(ckpt).latest_step() == 2
    got, _ = tlaunch.train("flavor-tagging-gru", steps=3, batch=16, lr=5e-3,
                           checkpoint_dir=ckpt, resume=True, log_every=1,
                           device="cpu")
    assert CheckpointManager(ckpt).latest_step() == 3
    m = build_model(get_config("flavor-tagging-gru"))
    _, p, o = CheckpointManager(ckpt).restore(2, device="cpu")
    opt = OptimizerConfig(lr=5e-3, warmup_steps=1, total_steps=3,
                          weight_decay=0.01)
    st = adamw_init(p, opt)._replace(
        step=torch.tensor(o["step"], dtype=torch.int32), m=o["m"], v=o["v"])
    batch = next(tlaunch._rnn_batches(m.cfg, 16, device="cpu"))
    want, _, _ = make_train_step(m, TrainConfig(optimizer=opt))(p, st, batch)
    _assert_same_bits(got, want)
