"""The port's LM training path against ``repro``'s, on the CPU.

  * ``Model.loss`` of all ten LMs at ``repro.testing.tiny_config``: the
    loss, every metric (``nll``, ``z_loss``, ``accuracy``; the moe
    family's load balance and router z-loss) and the gradient of every
    parameter against ``jax.value_and_grad`` (MoE at a capacity that drops
    tokens); one bfloat16 case (the loss, and the backward through the
    stack), and the gradient's argmax term that ``repro``'s ``lm_loss``
    carries, against its closed form;
  * ``moe_block(train=True)`` under gradients, whole and in sequence
    chunks, with the drops shown;
  * ``remat`` "none", "full" and "dots" give the same loss and gradients
    bit for bit;
  * ``make_train_step`` on LM batches (``tokens``, ``labels`` and a
    frontend's embeddings, split into two microbatches) for 2 steps
    against ``repro``'s jitted step;
  * ``launch.train.train("gemma-2b", tiny=True, device="cpu")`` against
    ``repro``'s trainer from the same parameters, and the CLI.

Parameters are drawn with numpy over ``repro``'s parameter specs
(``test_torch_families.setup``) and carried over by ``lm_params_from_jax``;
batches are drawn with numpy from a seed; each JAX loss runs under one
``jax.jit`` per arch (a module-scoped fixture).  Tolerance:
``CONFORMANCE_TOL`` (3e-5 float32, 2e-2 bfloat16) times max(1, max
|reference|), a gradient per parameter.
"""

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
from repro.launch import train as jlaunch  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.registry import get_config as jget_config  # noqa: E402
from repro.testing import CONFORMANCE_TOL, tiny_config  # noqa: E402
from repro.training import adamw_init as jadamw_init  # noqa: E402
from repro.training import make_train_step as jmake_train_step  # noqa: E402

from repro_torch.config import OptimizerConfig, TrainConfig  # noqa: E402
from repro_torch.configs import LMS  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.decode import lm_params_from_jax  # noqa: E402
from repro_torch.models.model import Model, build_model  # noqa: E402
from repro_torch.training import adamw_init, make_train_step  # noqa: E402

from test_torch_families import setup as lm_setup  # noqa: E402
from test_torch_prefill import lm_batch  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
B, S = 2, 20     # moe: 40 tokens, capacity 12 an expert at train time
STEP_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=4, weight_decay=0.01)
STEPS = 2


def close(got, want, dtype="float32", what=""):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= CONFORMANCE_TOL[dtype] * scale, (what, err)


def _batches(jcfg, seed, b=B):
    batch = lm_batch(jcfg, seed, b=b, s=S)
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def port_loss_and_grads(tcfg, tp, tb):
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in tp.items()}
    loss, metrics = build_model(tcfg).loss(leaves, tb)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
        dict(zip(leaves, grads))


def check_loss(got, want, dtype="float32"):
    (loss, metrics, grads), ((jloss, jmetrics), jgrads) = got, want
    close(loss, jloss, dtype, "loss")
    assert sorted(metrics) == sorted(jmetrics)
    for k in metrics:
        close(metrics[k], jmetrics[k], dtype, k)
    assert sorted(grads) == sorted(jgrads)
    for k, g in grads.items():
        assert g.dtype == getattr(torch, str(jgrads[k].dtype)), k
        close(g.float(), np.asarray(jgrads[k], np.float32), dtype, k)


@pytest.fixture(scope="module", params=sorted(LMS))
def lm(request):
    jcfg, tcfg, jp, tp = lm_setup(request.param)
    jb, tb = _batches(jcfg, 21)
    want = jax.jit(jax.value_and_grad(jbuild_model(jcfg).loss,
                                      has_aux=True))(jp, jb)
    return dict(tcfg=tcfg, tp=tp, tb=tb, want=want)


def test_loss_metrics_and_gradients_equal_repro(lm):
    got = port_loss_and_grads(lm["tcfg"], lm["tp"], lm["tb"])
    check_loss(got, lm["want"])
    assert all(torch.isfinite(g).all() for g in got[2].values())


def test_bfloat16_loss_and_backward():
    """One bfloat16 case (gemma-2b, params and compute): the loss and its
    metrics, and the gradient of every parameter through the whole stack
    under a smooth objective of the hidden states, within the bfloat16
    tolerance.  The LM loss's own gradient carries ``repro``'s argmax term,
    a step in the logits: where the packages' bfloat16 logits order a
    near-tie differently the term lands on another row of the unembedding,
    so that gradient is compared in float32
    (``test_lm_loss_gradient_keeps_repros_argmax_term``)."""
    jcfg, tcfg, jp, tp = lm_setup("gemma-2b", "bfloat16")
    jb, tb = _batches(jcfg, 22)
    jl, jmet = jax.jit(jbuild_model(jcfg).loss)(jp, jb)
    with torch.no_grad():
        tl, tmet = build_model(tcfg).loss(tp, tb)
    close(tl, jl, "bfloat16", "loss")
    for k in jmet:
        close(tmet[k], jmet[k], "bfloat16", k)

    proj = np.random.RandomState(7).randn(B, S, jcfg.d_model).astype(
        np.float32)

    def jobj(p):
        h = jtf.forward(jcfg, p, jb["tokens"])[0]
        return jnp.sum(h.astype(jnp.float32) * proj)

    jg = jax.jit(jax.grad(jobj))(jp)
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in tp.items()}
    h = ttf.forward(tcfg, leaves, tb["tokens"])[0]
    assert h.dtype == torch.bfloat16
    grads = torch.autograd.grad((h.float() * torch.from_numpy(proj)).sum(),
                                list(leaves.values()))
    for k, g in zip(leaves, grads):
        assert g.dtype == torch.bfloat16, k
        close(g.float(), np.asarray(jg[k], np.float32), "bfloat16", k)


def test_lm_loss_gradient_keeps_repros_argmax_term():
    """``lm_loss`` subtracts a detached max inside the exponent and adds
    the max back undetached, so in both packages the gradient of the
    log-normaliser is softmax + onehot(argmax), not the softmax alone
    (``ROADMAP.md`` §3).  Checked against that closed form on the
    unembedding of stablelm-3b (untied, no soft cap), float32."""
    jcfg, tcfg, jp, tp = lm_setup("stablelm-3b")
    rng = np.random.RandomState(8)
    hid = rng.randn(1, 6, jcfg.d_model).astype(np.float32)
    lab = np.array([[3, -1, 7, 250, -1, 0]], np.int32)
    w = tp["unembed/w"].clone().requires_grad_(True)
    loss, _ = ttf.lm_loss(tcfg, {"unembed/w": w}, torch.from_numpy(hid),
                          torch.from_numpy(lab))
    got = torch.autograd.grad(loss, w)[0].numpy()
    jgot = jax.grad(lambda w_: jtf.lm_loss(
        jcfg, {"unembed/w": w_}, jnp.asarray(hid), jnp.asarray(lab))[0])(
            jp["unembed/w"])

    logits = hid[0] @ tp["unembed/w"].numpy()                # [6, V]
    e = np.exp(logits - logits.max(-1, keepdims=True))
    soft = e / e.sum(-1, keepdims=True)
    lse = np.log(e.sum(-1)) + logits.max(-1)
    eye = np.eye(logits.shape[-1], dtype=np.float32)
    mask = (lab[0] >= 0).astype(np.float32)[:, None]
    both_terms = soft + eye[logits.argmax(-1)]
    dlogits = mask / mask.sum() * (both_terms - eye[np.maximum(lab[0], 0)]
                                   + 1e-4 * 2 * lse[:, None] * both_terms)
    want = hid[0].T @ dlogits
    close(got, want, what="port")
    close(jgot, want, what="repro")
    softmax_only = want - hid[0].T @ (mask / mask.sum() * (
        1 + 1e-4 * 2 * lse[:, None]) * eye[logits.argmax(-1)])
    assert np.abs(got - softmax_only).max() > 1e-2


@pytest.mark.parametrize("chunk_tokens", [8192, 16], ids=["whole", "chunks"])
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "qwen3-moe-30b-a3b"])
def test_moe_block_train_gradients_equal_repro(arch, chunk_tokens,
                                               monkeypatch):
    """``moe_block(train=True)``: out, aux and the gradients of x and of
    every expert weight; 16 tokens a chunk splits the 40 into sequence
    chunks of 10 (each at its own capacity) in both packages."""
    monkeypatch.setattr(jmoe, "_CHUNK_TOKENS", chunk_tokens)
    monkeypatch.setattr(tmoe, "_CHUNK_TOKENS", chunk_tokens)
    jcfg, tcfg, jp, tp = lm_setup(arch)
    pre = "decoder/moe"
    jlayer = {k: v[0] for k, v in jp.items() if k.startswith(pre)}
    x = np.random.RandomState(5).randn(B, S, jcfg.d_model).astype(np.float32)

    def jfn(p, x_):
        out, aux = jmoe.moe_block(jcfg, x_, p, pre, train=True)
        return jnp.sum(out * out) + aux["moe_load_balance"] \
            + aux["moe_z_loss"], (out, aux)

    (_, (jout, jaux)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jfn, argnums=(0, 1), has_aux=True))(jlayer, jnp.asarray(x))
    leaves = {k: tp[k][0].clone().requires_grad_(True) for k in jlayer}
    xt = torch.from_numpy(x).requires_grad_(True)
    out, aux = tmoe.moe_block(tcfg, xt, leaves, pre, train=True)
    total = (out * out).sum() + aux["moe_load_balance"] + aux["moe_z_loss"]
    grads = torch.autograd.grad(total, [xt, *leaves.values()])
    close(out.detach(), jout)
    for k in aux:
        close(aux[k].detach(), jaux[k], what=k)
    close(grads[0], jgx, what="x")
    for (k, _), g in zip(leaves.items(), grads[1:]):
        close(g, jgp[k], what=k)
    if chunk_tokens > B * S:
        # the capacity drops tokens: an expert is routed more than it takes
        logits = torch.from_numpy(x).reshape(-1, jcfg.d_model) @ tp[
            f"{pre}/router"][0]
        _, top_i = tmoe.top_k(torch.softmax(logits, -1), jcfg.moe.top_k)
        cap = int(B * S * jcfg.moe.top_k * jcfg.moe.capacity_factor
                  / jcfg.moe.n_experts)
        assert int(torch.bincount(top_i.reshape(-1)).max()) > cap


@pytest.mark.parametrize("arch", ["gemma-2b", "qwen2-moe-a2.7b",
                                  "recurrentgemma-9b", "whisper-medium"])
def test_remat_modes_give_the_same_bits(arch):
    """``remat`` "full" and "dots" recompute the layers in the backward
    pass (whisper: the cross-attention reads the encoder through a
    closure; moe: the aux sums ride through; hybrid: the remainder
    layer): the loss and every gradient bit for bit "none"'s."""
    jcfg, tcfg, _, tp = lm_setup(arch)
    _, tb = _batches(jcfg, 23)
    ref = port_loss_and_grads(tcfg, tp, tb)
    for mode in ("full", "dots"):
        got = port_loss_and_grads(tcfg.replace(remat=mode), tp, tb)
        assert torch.equal(got[0], ref[0]), mode
        assert all(torch.equal(got[1][k], v) for k, v in ref[1].items())
        for k, g in ref[2].items():
            assert torch.equal(got[2][k], g), (mode, k)
    with pytest.raises(ValueError, match="remat"):
        port_loss_and_grads(tcfg.replace(remat="some"), tp, tb)


@pytest.mark.parametrize("arch", ["phi-3-vision-4.2b", "whisper-medium"])
def test_lm_train_step_equals_repro(arch):
    """Two AdamW steps over microbatches of 2 (the batch's tokens, labels
    and the frontend's embeddings split alike); metrics (loss, grad norm,
    lr, ...) within the f32 tolerance at every step.  Parameters: every
    element within the most AdamW can move it (2 lr a step), and all but
    a thousandth of each tensor's elements within 1 % of lr a step (the
    taggers' bar in ``test_torch_training.py``).  Adam divides by the
    gradient's own size, so an element whose gradient lies within the
    gradient tolerance of zero moves by up to lr in either sign."""
    jcfg, tcfg, jp, tp = lm_setup(arch)
    jstep = jax.jit(jmake_train_step(
        jbuild_model(jcfg),
        JTrainConfig(optimizer=JOptimizerConfig(**STEP_OPT)), grad_accum=2))
    tstep = make_train_step(build_model(tcfg),
                            TrainConfig(optimizer=OptimizerConfig(**STEP_OPT)),
                            grad_accum=2)
    jst = jadamw_init(jp, JOptimizerConfig(**STEP_OPT))
    tst = adamw_init(tp, OptimizerConfig(**STEP_OPT))
    for i in range(STEPS):
        jb, tb = _batches(jcfg, 30 + i, b=4)
        jp, jst, jmet = jstep(jp, jst, jb)
        tp, tst, tmet = tstep(tp, tst, tb)
        assert sorted(tmet) == sorted(jmet)
        for k in tmet:
            close(tmet[k], jmet[k], what=k)
    assert all(not v.requires_grad for v in tp.values())
    lr_steps = STEP_OPT["lr"] * STEPS
    for k, v in tp.items():
        err = np.abs(v.numpy() - np.asarray(jp[k]))
        assert float(err.max()) <= 2 * lr_steps, (k, float(err.max()))
        assert float((err > 1e-2 * lr_steps).mean()) <= 1e-3, k


class _Carried(Model):
    """A model whose ``init`` returns given parameters."""

    def init(self, generator=None, device="cuda"):
        return {k: v.to(device) for k, v in self._params.items()}


def test_train_entry_point_equals_repro(monkeypatch, capsys):
    """``train("gemma-2b", tiny=True, device="cpu")`` from ``repro``'s
    seed-0 parameters (the trainer's own draw, carried over) over the same
    ``lm_token_stream`` batches: the last logged loss within the f32
    tolerance of ``repro``'s trainer."""
    kw = dict(steps=3, batch=4, lr=1e-2, seq_len=24, tiny=True)
    jcfg = tiny_config(jget_config("gemma-2b"))
    start = lm_params_from_jax(
        {k: np.asarray(v) for k, v in
         jbuild_model(jcfg).init(jax.random.PRNGKey(0)).items()}, "cpu")

    def build(cfg):
        m = _Carried(cfg)
        object.__setattr__(m, "_params", start)
        return m

    monkeypatch.setattr(tlaunch, "build_model", build)
    _, want = jlaunch.train("gemma-2b", **kw)
    params, got = tlaunch.train("gemma-2b", device="cpu", **kw)
    assert np.isfinite(got) and got != 0.0
    assert abs(got - want) <= CONFORMANCE_TOL["float32"] * max(1.0, want)
    assert all(not v.requires_grad for v in params.values())
    out = capsys.readouterr().out
    assert out.count("[train] step 3/3 loss=") == 2


def test_train_cli_runs_an_lm_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "mamba2-780m", "--tiny", "--steps", "2", "--batch", "2",
         "--seq-len", "16", "--device", "cpu"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "[train] step 2/2 loss=" in out.stdout
