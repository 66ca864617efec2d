"""The port's training path against ``repro``'s, on the CPU.

Same parameters (the port's seeded draw, carried over to ``repro`` through
numpy), same numpy batches, the port on CPU tensors:

  * ``kernels.ref.matmul`` is differentiable on the CPU (its gradients
    through the same k-ordered product), and its forward keeps the bits of
    an explicit k-ascending loop;
  * loss, accuracy and every gradient of the six taggers against
    ``jax.value_and_grad(m.loss)``, each gradient within
    ``1e-5 * max(1, max|g|)``;
  * ``lr_schedule`` and ``adamw_update`` fed the same gradients for 5 steps
    (warmup, cosine, clip active, no-decay keys) within 1e-6;
  * ``make_train_step`` for 3 steps, accum 1 and 2, against ``repro``'s
    jitted step.  Tolerance on the parameters: 1 % of the most AdamW can
    move an element in those steps (``lr`` a step).  Adam's normalisation
    ``m / (sqrt(v) + eps)`` turns a gradient element near zero (1e-10 to
    1e-8 in these taggers' recurrent kernels) into an update of order
    ``lr``: the two packages' gradients agree to ~3e-8 of their largest
    element, which is a relative difference of 1e-3 at such an element and
    so 1e-3 of its update (measured: up to 2.5e-5 at ``lr = 1e-2`` over 3
    steps).  Loss, accuracy, grad norm and lr are held within 1e-6;
  * int8 gradient compression bit for bit;
  * the trainer entry point (``launch.train``) on ``--device cpu``;
  * an LM's ``Model.loss`` and ``Model.forward`` (gemma-2b; every family
    and its gradients in ``tests/test_torch_lm_train.py``).
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
jnp = jax.numpy

from repro.config import OptimizerConfig as JOptimizerConfig  # noqa: E402
from repro.config import TrainConfig as JTrainConfig  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.testing import tiny_config as jtiny_config  # noqa: E402
from repro.registry import get_config as jget_config  # noqa: E402
from repro.training import adamw_init as jadamw_init  # noqa: E402
from repro.training import adamw_update as jadamw_update  # noqa: E402
from repro.training import lr_schedule as jlr_schedule  # noqa: E402
from repro.training import make_train_step as jmake_train_step  # noqa: E402
from repro.training import grad_compression as jgc  # noqa: E402

from repro_torch.config import OptimizerConfig, TrainConfig  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models.decode import lm_params_from_jax  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.registry import get_config  # noqa: E402
from repro_torch.testing import tiny_config  # noqa: E402
from repro_torch.training import (adamw_init, adamw_update,  # noqa: E402
                                  adamw_update_, lr_schedule,
                                  make_train_step)
from repro_torch.training import grad_compression as tgc  # noqa: E402
from repro_torch.training.optimizer import global_norm  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TAGGERS = ("top-tagging-lstm", "top-tagging-gru", "flavor-tagging-lstm",
           "flavor-tagging-gru", "quickdraw-lstm", "quickdraw-gru")
T_CUT = 8                 # timesteps of the CPU batches
B = 8


def _batch(cfg, seed, b=B, t=T_CUT):
    rnn = cfg.rnn
    rng = np.random.RandomState(seed)
    x = rng.randn(b, t, rnn.input_size).astype(np.float32)
    y = rng.randint(0, max(rnn.n_outputs, 2), b).astype(np.int32)
    return x, y


def _setup(arch):
    """Both packages' models on the same parameters: the port's seeded
    draw, carried over to ``repro`` through numpy."""
    tm = build_model(get_config(arch))
    tp = tm.init(torch.Generator().manual_seed(0), device="cpu")
    jp = {k: jnp.asarray(v.numpy()) for k, v in tp.items()}
    return jbuild_model(jget_config(arch)), jp, tm, tp


def _close(got, want, atol, rtol=0.0):
    got = {k: np.asarray(v, np.float32) for k, v in got.items()}
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        w = np.asarray(w, np.float32)
        assert got[k].shape == w.shape, k
        excess = np.abs(got[k] - w) - (atol + rtol * np.abs(w))
        assert not (excess > 0).any(), (k, float(np.abs(got[k] - w).max()))


# ---------------------------------------------------------------------------
# kernels.ref.matmul
# ---------------------------------------------------------------------------


def _k_loop(a, w):
    """An explicit k-ascending sum, one rounded product and one rounded
    add per term (the forward ``ref.matmul`` must keep)."""
    acc = torch.zeros(a.shape[0], w.shape[1], dtype=torch.float32)
    for k in range(a.shape[1]):
        acc = acc + a[:, k:k + 1].float() * w[k].float()
    return acc


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ref_matmul_forward_bits_and_gradients(dtype):
    dt = getattr(torch, dtype)
    rng = np.random.RandomState(3)
    a = torch.from_numpy(rng.randn(7, 13).astype(np.float32)).to(dt)
    w = torch.from_numpy(rng.randn(13, 5).astype(np.float32)).to(dt)
    want = _k_loop(a, w).to(dt)
    plain = ref.matmul(a, w)
    a_, w_ = a.clone().requires_grad_(), w.clone().requires_grad_()
    out = ref.matmul(a_, w_)
    for got in (plain, out.detach()):
        assert got.dtype == dt
        assert torch.equal(got.view(torch.int16 if dt == torch.bfloat16
                                    else torch.int32),
                           want.view(torch.int16 if dt == torch.bfloat16
                                     else torch.int32))
    g = torch.from_numpy(rng.randn(7, 5).astype(np.float32)).to(dt)
    ga, gw = torch.autograd.grad(out, (a_, w_), g)
    assert torch.equal(ga, _k_loop(g, w.t()).to(dt))
    assert torch.equal(gw, _k_loop(a.t(), g).to(dt))


def test_ref_matmul_gradcheck_and_lead_dims():
    rng = np.random.RandomState(4)
    a = torch.from_numpy(rng.randn(2, 3, 4)).requires_grad_()
    w = torch.from_numpy(rng.randn(4, 5)).requires_grad_()
    assert torch.autograd.gradcheck(ref.matmul, (a, w))
    assert torch.autograd.gradgradcheck(ref.matmul, (a, w))
    # a float32 operand against a float64 weight promotes, as jnp's @
    a32 = a.detach().float().requires_grad_()
    (ga,) = torch.autograd.grad(ref.matmul(a32, w).sum(), (a32,))
    assert ga.dtype == torch.float32 and ga.shape == a32.shape


# ---------------------------------------------------------------------------
# loss and gradients of the six taggers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", TAGGERS)
def test_loss_and_grads_match_repro(arch):
    jm, jp, tm, tp = _setup(arch)
    x, y = _batch(tm.cfg, seed=1)
    (jloss, jmetrics), jg = jax.jit(jax.value_and_grad(
        lambda p, x, y: jm.loss(p, {"x": x, "y": y}), has_aux=True))(
            jp, jnp.asarray(x), jnp.asarray(y))
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    loss, metrics = tm.loss(leaves, {"x": torch.from_numpy(x),
                                     "y": torch.from_numpy(y)})
    grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                 list(leaves.values()))))
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-6,
                                                 abs=1e-6)
    assert float(metrics["accuracy"]) == float(jmetrics["accuracy"])
    assert sorted(grads) == sorted(jg)
    for k, g in grads.items():
        want = np.asarray(jg[k])
        err = float(np.abs(g.numpy() - want).max())
        assert err <= 1e-5 * max(1.0, float(np.abs(want).max())), (k, err)


@pytest.mark.parametrize("arch", ["top-tagging-gru", "quickdraw-lstm"])
def test_model_forward_matches_repro(arch):
    jm, jp, tm, tp = _setup(arch)
    x, _ = _batch(tm.cfg, seed=2)
    want = np.asarray(jm.forward(jp, {"x": jnp.asarray(x)}))
    with torch.no_grad():
        got = tm.forward(tp, {"x": torch.from_numpy(x)}).numpy()
    assert np.abs(got - want).max() <= 3e-5


def test_lm_loss_and_forward_name_item_10():
    """Module item 10's sequence forward: ``Model.loss`` and
    ``Model.forward`` of an LM (gemma-2b at ``tiny_config``) run and equal
    ``repro``'s on the same parameters and tokens (every family and the
    gradients: ``tests/test_torch_lm_train.py``)."""
    jcfg = jtiny_config(jget_config("gemma-2b"))
    jm = jbuild_model(jcfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    tp = lm_params_from_jax({k: np.asarray(v) for k, v in jp.items()},
                            "cpu")
    tm = build_model(tiny_config(get_config("gemma-2b")))
    rng = np.random.RandomState(4)
    batch = {"tokens": rng.randint(0, 256, (2, 12)).astype(np.int32),
             "labels": rng.randint(-1, 256, (2, 12)).astype(np.int32)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        logits = tm.forward(tp, tb).numpy()
        loss, metrics = tm.loss(tp, tb)
    want = np.asarray(jax.jit(jm.forward)(jp, jb))
    assert np.abs(logits - want).max() <= 3e-5 * max(1.0,
                                                     np.abs(want).max())
    jloss, jmetrics = jax.jit(jm.loss)(jp, jb)
    assert float(loss) == pytest.approx(float(jloss), abs=3e-5)
    assert sorted(metrics) == sorted(jmetrics)
    for k in metrics:
        assert float(metrics[k]) == pytest.approx(float(jmetrics[k]),
                                                  abs=3e-5), k


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------


def test_lr_schedule_matches_repro():
    for opt in (OptimizerConfig(lr=5e-3, warmup_steps=10, total_steps=150),
                OptimizerConfig(lr=1.0, warmup_steps=0, total_steps=7),
                OptimizerConfig(lr=3e-4)):
        jopt = JOptimizerConfig(**dataclasses.asdict(opt))
        jsched = jax.jit(jlr_schedule, static_argnums=0)
        for s in (0, 1, 5, 9, 10, 11, 77, 149, 150, 2000):
            got = lr_schedule(opt, torch.tensor(s, dtype=torch.int32))
            want = jsched(jopt, jnp.asarray(s, jnp.int32))
            assert got.dtype == torch.float32
            assert float(got) == pytest.approx(float(want), rel=1e-6,
                                               abs=1e-12)


def test_configs_match_repro():
    assert dataclasses.asdict(OptimizerConfig()) == \
        dataclasses.asdict(JOptimizerConfig())
    assert dataclasses.asdict(TrainConfig()) == \
        dataclasses.asdict(JTrainConfig())


@pytest.mark.parametrize("grad_clip", [1.0, 0.0], ids=["clip", "noclip"])
def test_adamw_update_matches_repro(grad_clip):
    """5 steps on the same gradients: warmup then cosine, the clip active
    (the gradients' norm is ~30), decayed and no-decay keys."""
    opt = OptimizerConfig(lr=1e-2, warmup_steps=2, total_steps=5,
                          weight_decay=0.1, grad_clip=grad_clip)
    jopt = JOptimizerConfig(**dataclasses.asdict(opt))
    rng = np.random.RandomState(5)
    shapes = {"rnn/kernel": (6, 12), "rnn/bias": (12,), "dense0/b": (7,),
              "layer/norm1/scale": (4,), "head/w": (7, 1)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tst, jst = adamw_init(tp, opt), jadamw_init(jp, jopt)
    jupdate = jax.jit(jadamw_update, static_argnums=3)
    for step in range(5):
        grads = {k: (rng.randn(*s) * 10).astype(np.float32)
                 for k, s in shapes.items()}
        grads["head/w"][0, 0] = 1e-9          # a near-zero element
        tp, tst, tm = adamw_update(
            tp, {k: torch.from_numpy(v) for k, v in grads.items()}, tst, opt)
        jp, jst, jm = jupdate(
            jp, {k: jnp.asarray(v) for k, v in grads.items()}, jst, jopt)
        _close(tp, jp, 1e-6)
        _close(tst.m, jst.m, 1e-6)
        _close(tst.v, jst.v, 1e-6, rtol=1e-6)
        assert int(tst.step) == int(jst.step) == step + 1
        assert tst.step.dtype == torch.int32
        for k in ("grad_norm", "lr"):
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-6)
    assert float(tm["grad_norm"]) > 10 * max(grad_clip, 1.0)


def _same_bits(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k].view(torch.int16 if got[k].dtype ==
                                       torch.bfloat16 else torch.int32),
                           want[k].view(torch.int16 if want[k].dtype ==
                                        torch.bfloat16 else torch.int32)), k


@pytest.mark.parametrize("weight_decay", [0.1, 0.0], ids=["wd", "nowd"])
@pytest.mark.parametrize("grad_clip", [1.0, 0.0], ids=["clip", "noclip"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_in_place_equals_functional(dtype, grad_clip,
                                                 weight_decay):
    """``adamw_update_`` gives ``adamw_update``'s bits over 4 steps (params
    in f32 or bf16, the moments in the optimizer's state dtype) and
    returns the very tensors it was given, written in place."""
    opt = OptimizerConfig(lr=1e-2, warmup_steps=2, total_steps=4,
                          weight_decay=weight_decay, grad_clip=grad_clip)
    dt = getattr(torch, dtype)
    rng = np.random.RandomState(8)
    shapes = {"rnn/kernel": (6, 12), "rnn/bias": (12,), "dense0/b": (7,),
              "layer/norm1/scale": (4,), "head/w": (7, 1)}
    start = {k: torch.from_numpy(rng.randn(*s).astype(np.float32)).to(dt)
             for k, s in shapes.items()}
    fp, fst = dict(start), adamw_init(start, opt)
    ip = {k: v.clone() for k, v in start.items()}
    ist = adamw_init(ip, opt)
    ptrs = {k: (ip[k].data_ptr(), ist.m[k].data_ptr(), ist.v[k].data_ptr())
            for k in ip}
    for _ in range(4):
        grads = {k: torch.from_numpy((rng.randn(*s) * 10).astype(
            np.float32)).to(dt) for k, s in shapes.items()}
        fp, fst, fm = adamw_update(fp, grads, fst, opt)
        given_p, given_m, given_v = dict(ip), dict(ist.m), dict(ist.v)
        ip, ist, im = adamw_update_(ip, grads, ist, opt)
        _same_bits(ip, fp)
        _same_bits(ist.m, fst.m)
        _same_bits(ist.v, fst.v)
        assert int(ist.step) == int(fst.step)
        for k in ("grad_norm", "lr"):
            assert torch.equal(im[k], fm[k])
        for k in ip:
            assert ip[k] is given_p[k] and ist.m[k] is given_m[k] \
                and ist.v[k] is given_v[k]
            assert (ip[k].data_ptr(), ist.m[k].data_ptr(),
                    ist.v[k].data_ptr()) == ptrs[k]
    assert not any(torch.equal(ip[k], start[k]) for k in ip)


def test_adamw_update_in_place_refuses_shared_memory():
    """A tied weight (one tensor under two keys) cannot be updated in
    place as the functional update does it: refused, nothing written."""
    opt = OptimizerConfig(lr=1e-2, warmup_steps=0, total_steps=4)
    w = torch.ones(3, 4)
    params = {"embed": w, "unembed": w, "head/w": torch.ones(4)}
    st = adamw_init(params, opt)
    grads = {k: torch.ones_like(v) for k, v in params.items()}
    with pytest.raises(ValueError, match="shares memory"):
        adamw_update_(params, grads, st, opt)
    assert torch.equal(w, torch.ones(3, 4))


def test_no_decay_rule_matches_repro():
    """``_NO_DECAY`` matches substrings: ``dense0/b`` is decayed, paths
    with ``bias`` / ``norm`` / ``scale`` are not."""
    opt = OptimizerConfig(lr=0.1, warmup_steps=0, total_steps=10,
                          weight_decay=1.0, grad_clip=0)
    keys = ("dense0/b", "rnn/bias", "layer/norm1/scale", "head/w")
    tp = {k: torch.ones(4) for k in keys}
    new, _, _ = adamw_update(tp, {k: torch.zeros(4) for k in keys},
                             adamw_init(tp, opt), opt)
    jp = {k: jnp.ones(4) for k in keys}
    jopt = JOptimizerConfig(**dataclasses.asdict(opt))
    jnew, _, _ = jadamw_update(jp, {k: jnp.zeros(4) for k in keys},
                               jadamw_init(jp, jopt), jopt)
    _close(new, jnew, 0.0)
    assert float(new["dense0/b"][0]) < 1.0
    assert float(new["rnn/bias"][0]) == 1.0


def test_global_norm_matches_repro():
    from repro.training.optimizer import global_norm as jglobal_norm

    rng = np.random.RandomState(6)
    tree = {f"p{i}": rng.randn(5, 3).astype(np.float32) for i in range(4)}
    got = global_norm({k: torch.from_numpy(v) for k, v in tree.items()})
    want = jglobal_norm({k: jnp.asarray(v) for k, v in tree.items()})
    assert float(got) == pytest.approx(float(want), rel=1e-7)


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------

STEP_OPT = dict(lr=1e-2, warmup_steps=1, total_steps=5, weight_decay=0.01,
                grad_clip=1.0)
STEPS = 3


@pytest.mark.parametrize("arch,accum", [
    ("top-tagging-gru", 1), ("top-tagging-gru", 2),
    ("flavor-tagging-lstm", 1), ("quickdraw-gru", 2)])
def test_train_step_matches_repro(arch, accum):
    jm, jp, tm, tp = _setup(arch)
    jstep = jax.jit(jmake_train_step(
        jm, JTrainConfig(optimizer=JOptimizerConfig(**STEP_OPT)),
        grad_accum=accum))
    tstep = make_train_step(
        tm, TrainConfig(optimizer=OptimizerConfig(**STEP_OPT)),
        grad_accum=accum)
    jst = jadamw_init(jp, JOptimizerConfig(**STEP_OPT))
    tst = adamw_init(tp, OptimizerConfig(**STEP_OPT))
    for i in range(STEPS):
        x, y = _batch(tm.cfg, seed=10 + i)
        jp, jst, jmet = jstep(jp, jst, {"x": jnp.asarray(x),
                                        "y": jnp.asarray(y)})
        tp, tst, tmet = tstep(tp, tst, {"x": torch.from_numpy(x),
                                        "y": torch.from_numpy(y)})
        assert sorted(tmet) == sorted(jmet)
        for k in tmet:
            assert float(tmet[k]) == pytest.approx(float(jmet[k]), rel=1e-6,
                                                   abs=1e-6), k
    assert all(not v.requires_grad for v in tp.values())
    _close(tp, jp, 1e-2 * STEP_OPT["lr"] * STEPS)


@pytest.mark.parametrize("arch,accum", [
    ("top-tagging-gru", 1), ("flavor-tagging-lstm", 2), ("gemma-2b", 1)])
def test_donated_train_step_equals_functional(arch, accum):
    """``make_train_step(..., donate=True)`` (the trainer's step) equals
    the functional step bit for bit over 3 steps, updating the parameters
    and moments it is given in place (the functional run starts from
    clones of them)."""
    cfg = get_config(arch)
    if cfg.family != "rnn":
        cfg = tiny_config(cfg)
    m = build_model(cfg)
    opt = OptimizerConfig(**STEP_OPT)
    tc = TrainConfig(optimizer=opt)
    p = m.init(torch.Generator().manual_seed(0), device="cpu")
    fp = {k: v.clone() for k, v in p.items()}
    dp = {k: v.clone() for k, v in p.items()}
    fst, dst = adamw_init(fp, opt), adamw_init(dp, opt)
    given = [dp[k] for k in dp] + [dst.m[k] for k in dst.m]
    fstep = make_train_step(m, tc, grad_accum=accum)
    dstep = make_train_step(m, tc, grad_accum=accum, donate=True)
    rng = np.random.RandomState(3)
    for i in range(STEPS):
        if cfg.family == "rnn":
            x, y = _batch(cfg, seed=20 + i)
            batch = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
        else:
            toks = rng.randint(0, cfg.vocab_size, (4, 17))
            batch = {"tokens": torch.from_numpy(toks[:, :-1]),
                     "labels": torch.from_numpy(toks[:, 1:])}
        fp, fst, fmet = fstep(fp, fst, batch)
        dp, dst, dmet = dstep(dp, dst, batch)
        for k in fmet:
            assert torch.equal(dmet[k], fmet[k]), k
    _same_bits(dp, fp)
    _same_bits(dst.m, fst.m)
    _same_bits(dst.v, fst.v)
    kept = [dp[k] for k in dp] + [dst.m[k] for k in dst.m]
    assert len(kept) == len(given) and all(
        a is b for a, b in zip(kept, given))
    assert not any(torch.equal(dp[k], p[k]) for k in p)


def test_grad_accum_matches_full_batch():
    """accum=2 == one step on the full batch (rtol 1e-4, as ``repro``'s
    ``test_optimizer.py`` holds it)."""
    _, _, tm, tp = _setup("top-tagging-gru")
    tc = TrainConfig(optimizer=OptimizerConfig(
        lr=1e-2, warmup_steps=0, total_steps=10, grad_clip=0,
        weight_decay=0))
    x = torch.from_numpy(np.random.RandomState(0)
                         .randn(8, 20, 6).astype(np.float32))
    y = torch.from_numpy((np.arange(8) % 2).astype(np.int32))
    st = adamw_init(tp, tc.optimizer)
    p1, _, m1 = make_train_step(tm, tc, grad_accum=1)(tp, st, {"x": x,
                                                               "y": y})
    p2, _, m2 = make_train_step(tm, tc, grad_accum=2)(tp, st, {"x": x,
                                                               "y": y})
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-5)
    for k in p1:
        np.testing.assert_allclose(p1[k].numpy(), p2[k].numpy(), rtol=1e-4,
                                   atol=1e-5)


def test_train_step_rejects_what_is_not_ported():
    _, _, tm, _ = _setup("top-tagging-gru")
    tp = tm.init(torch.Generator().manual_seed(0), device="cpu")
    x, y = _batch(tm.cfg, seed=0)
    b = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
    # gradient shardings that name no DTensor leave plain tensors alone
    pinned = make_train_step(tm, TrainConfig(), grad_shardings={})(
        tp, adamw_init(tp, OptimizerConfig()), b)[0]
    plain = make_train_step(tm, TrainConfig())(
        tp, adamw_init(tp, OptimizerConfig()), b)[0]
    assert all(torch.equal(pinned[k], plain[k]) for k in plain)
    step = make_train_step(tm, TrainConfig(), grad_accum=3)
    with pytest.raises(ValueError, match="accum 3"):
        step(tp, adamw_init(tp, OptimizerConfig()),
             {"x": torch.from_numpy(x), "y": torch.from_numpy(y)})


def test_compressed_step_matches_repro():
    opt = dict(STEP_OPT)
    jm, jp, tm, tp = _setup("top-tagging-lstm")
    jstep = jax.jit(jmake_train_step(jm, JTrainConfig(
        optimizer=JOptimizerConfig(**opt), compress_grads=True)))
    tstep = make_train_step(tm, TrainConfig(
        optimizer=OptimizerConfig(**opt), compress_grads=True))
    x, y = _batch(tm.cfg, seed=7)
    jp, _, _ = jstep(jp, jadamw_init(jp, JOptimizerConfig(**opt)),
                     {"x": jnp.asarray(x), "y": jnp.asarray(y)})
    tp, _, _ = tstep(tp, adamw_init(tp, OptimizerConfig(**opt)),
                     {"x": torch.from_numpy(x), "y": torch.from_numpy(y)})
    _close(tp, jp, 1e-2 * opt["lr"])


# ---------------------------------------------------------------------------
# int8 gradient compression
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_int8_compression_bit_for_bit(seed):
    rng = np.random.RandomState(seed)
    g = (rng.randn(257) * 10.0 ** rng.uniform(-6, 2)).astype(np.float32)
    g[:3] = [0.5, -0.5, 1.5]                      # ties scale permitting
    q, s = tgc.quantize_int8(torch.from_numpy(g))
    jq, js = jgc.quantize_int8(jnp.asarray(g))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.numpy().tobytes() == np.asarray(js).tobytes()
    deq = tgc.dequantize_int8(q, s).numpy()
    np.testing.assert_array_equal(deq, np.asarray(jgc.dequantize_int8(jq,
                                                                      js)))
    grads = {"a": g, "b": g[:40] * 3}
    got = tgc.compress_decompress({k: torch.from_numpy(v)
                                   for k, v in grads.items()})
    want = jgc.compress_decompress({k: jnp.asarray(v)
                                    for k, v in grads.items()})
    for k in grads:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    err, jerr = None, None
    for _ in range(3):
        got, err = tgc.compress_with_error_feedback(
            {k: torch.from_numpy(v) for k, v in grads.items()}, err)
        want, jerr = jgc.compress_with_error_feedback(
            {k: jnp.asarray(v) for k, v in grads.items()}, jerr)
        for k in grads:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
            np.testing.assert_array_equal(err[k].numpy(), np.asarray(jerr[k]))


def test_round_half_to_even_on_exact_ties():
    """Scale 1 (max |g| = 127): the ties 0.5, 1.5, 2.5 round to even in
    both packages."""
    g = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5], np.float32)
    q, _ = tgc.quantize_int8(torch.from_numpy(g))
    jq, _ = jgc.quantize_int8(jnp.asarray(g))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(q.numpy()[1:], [0, 2, 2, 0, -2])


# ---------------------------------------------------------------------------
# trainer entry point
# ---------------------------------------------------------------------------


def test_rnn_batches_draw_repro_indices():
    from repro.launch import train as jlaunch

    cfg = get_config("flavor-tagging-gru")
    tb = tlaunch._rnn_batches(cfg, 16, device="cpu")
    jb = jlaunch._rnn_batches(jget_config("flavor-tagging-gru"), 16)
    for _ in range(3):
        t, j = next(tb), next(jb)
        for k in ("x", "y"):
            assert t[k].device.type == "cpu"
            np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]))


def test_train_entry_point_equals_its_steps():
    """``train(..., device="cpu")`` is ``make_train_step`` over
    ``_rnn_batches`` from ``Model.init`` on a CPU generator of seed 0."""
    params, loss = tlaunch.train("flavor-tagging-gru", steps=3, batch=16,
                                 lr=5e-3, log_every=1, device="cpu")
    assert np.isfinite(loss)
    assert all(not v.requires_grad and v.device.type == "cpu"
               for v in params.values())
    m = build_model(get_config("flavor-tagging-gru"))
    p = m.init(torch.Generator().manual_seed(0), device="cpu")
    opt = OptimizerConfig(lr=5e-3, warmup_steps=1, total_steps=3,
                          weight_decay=0.01)
    st = adamw_init(p, opt)
    step = make_train_step(m, TrainConfig(optimizer=opt))
    batches = tlaunch._rnn_batches(m.cfg, 16, device="cpu")
    for _ in range(3):
        p, st, _ = step(p, st, next(batches))
    for k in p:
        assert torch.equal(p[k], params[k]), k


def test_train_refuses_what_is_not_ported(monkeypatch):
    """An LM whose forward needs a frontend's embeddings (the token
    stream has none, as in ``repro``), a mesh of several ranks with no
    process group, and a CUDA device that is not there."""
    for arch, need in (("whisper-medium", "frame_embeds"),
                       ("phi-3-vision-4.2b", "img_embeds")):
        with pytest.raises(ValueError, match=need):
            tlaunch.train(arch, steps=1, tiny=True, device="cpu")
    with pytest.raises(RuntimeError, match="process group of 8 ranks"):
        tlaunch.train("top-tagging-gru", steps=1, mesh_shape=(2, 4),
                      device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlaunch.train("top-tagging-gru", steps=1)


def test_train_cli_runs_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "flavor-tagging-gru", "--steps", "2", "--batch", "16", "--device",
         "cpu"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "[train] step 2/2 loss=" in out.stdout
