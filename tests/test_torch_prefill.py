"""The port's sequence forward (prefill) against ``repro``'s, on the CPU.

  * ``attention.blockwise_attention`` (causal or not, a window, GQA ratios,
    ragged q and kv that take the pads, ``q_offset``, chunk sizes, one
    bfloat16 case) and ``full_attention``;
  * ``ssm._ssd_chunked`` (a chunk that divides the sequence and one that
    pads it, with and without an initial state), and its one deliberate
    difference: the masked decay is ``exp(where(tril, seg, -inf))``, the
    same forward bits as ``repro``'s ``where(tril, exp(seg), 0)`` with a
    finite gradient where ``repro``'s is NaN;
  * ``rglru._scan_linear_recurrence`` (T within a chunk, T not a multiple
    of it, several chunks, an initial state) and ``rglru_mix`` with
    ``return_state``;
  * ``transformer.forward`` and ``Model.forward`` of all ten LMs at
    ``repro.testing.tiny_config``, over sequences longer than one
    attention and SSD chunk (whisper's encoder frames too), and the
    port's forward == its own teacher-forced decode chain within 5e-4,
    ``repro``'s bar in its ``tests/test_decode.py``.

Parameters are drawn with numpy over ``repro``'s parameter specs
(``test_torch_families.setup``) and carried over by ``lm_params_from_jax``;
inputs are drawn with numpy from a seed; each JAX model function runs
under one ``jax.jit`` per arch (a module-scoped fixture).  Tolerance:
``CONFORMANCE_TOL`` (3e-5 float32, 2e-2 bfloat16) times max(1, max
|reference|).
"""

import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
jnp = jax.numpy

from repro.models import attention as jattn  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.registry import get_config as jget_config  # noqa: E402
from repro.testing import CONFORMANCE_TOL, tiny_config  # noqa: E402

from repro_torch.configs import LMS  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import rglru as trglru  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models import decode as tdecode  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

from test_torch_families import setup as lm_setup  # noqa: E402
from test_torch_lm import port_config  # noqa: E402

B = 2
S = 40          # past one attention chunk (32) and five SSD chunks (8)
FRAMES = 44     # whisper's encoder: two chunks, the second padded


def close(got, want, dtype="float32"):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= CONFORMANCE_TOL[dtype] * scale, err


def both(a, dtype="float32"):
    """A numpy draw as a jnp array and a CPU tensor of ``dtype`` (bfloat16
    rounds through float32 on both sides)."""
    a = np.asarray(a, np.float32)
    return (jnp.asarray(a, getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

#: (causal, window, heads, kv heads, sq, sk, q_offset, chunk_q, chunk_kv)
ATTN_CASES = {
    "causal": (True, 0, 4, 4, 40, 40, 0, 16, 16),
    "causal-gqa-ragged": (True, 0, 4, 2, 37, 37, 0, 16, 8),
    "causal-mqa-chunks": (True, 0, 4, 1, 40, 40, 0, 8, 16),
    "window": (True, 8, 4, 2, 40, 40, 0, 16, 16),
    "window-wider-chunks": (True, 12, 4, 1, 33, 33, 0, 32, 8),
    "bidirectional-pad": (False, 0, 4, 4, 21, 30, 0, 16, 16),
    "bidirectional-gqa": (False, 0, 8, 2, 24, 17, 0, 8, 8),
    "q-offset": (True, 0, 4, 2, 9, 40, 31, 4, 16),
    "q-offset-window": (True, 6, 4, 4, 12, 40, 28, 8, 8),
    "one-chunk": (True, 0, 2, 2, 12, 12, 0, 1024, 2048),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_blockwise_attention_equals_repro(case):
    causal, window, h, hk, sq, sk, off, cq, ck = ATTN_CASES[case]
    rng = np.random.RandomState(len(case))
    jq, tq = both(rng.randn(B, sq, h, 16))
    jk, tk = both(rng.randn(B, sk, hk, 16))
    jv, tv = both(rng.randn(B, sk, hk, 16))
    kw = dict(causal=causal, window=window, q_offset=off)
    want = jax.jit(functools.partial(
        jattn.blockwise_attention, chunk_q=cq, chunk_kv=ck, **kw))(jq, jk, jv)
    got = tattn.blockwise_attention(tq, tk, tv, chunk_q=cq, chunk_kv=ck,
                                    **kw)
    assert got.dtype == torch.float32
    close(got, want)
    if not window:     # full_attention masks no window
        close(tattn.full_attention(tq, tk, tv, **kw),
              jax.jit(functools.partial(jattn.full_attention, **kw))(
                  jq, jk, jv))
        # and the two schedules agree on the port
        close(got, tattn.full_attention(tq, tk, tv, **kw))


def test_blockwise_attention_bfloat16():
    rng = np.random.RandomState(3)
    jq, tq = both(rng.randn(B, 37, 4, 16), "bfloat16")
    jk, tk = both(rng.randn(B, 37, 2, 16), "bfloat16")
    jv, tv = both(rng.randn(B, 37, 2, 16), "bfloat16")
    want = jax.jit(functools.partial(
        jattn.blockwise_attention, causal=True, chunk_q=16, chunk_kv=8))(
            jq, jk, jv)
    got = tattn.blockwise_attention(tq, tk, tv, causal=True, chunk_q=16,
                                    chunk_kv=8)
    assert got.dtype == torch.bfloat16
    close(got.float(), want, "bfloat16")


# ---------------------------------------------------------------------------
# SSD
# ---------------------------------------------------------------------------


def _ssd_inputs(s, seed, g=1, h=4, p=8, n=16, decay=1.0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, s, h, p), -decay * rng.rand(B, s, h),
            rng.randn(B, s, g, n), rng.randn(B, s, g, n),
            rng.randn(B, h, p, n))


@pytest.mark.parametrize("s,chunk,g,init", [
    (32, 8, 1, False), (29, 8, 1, False), (29, 8, 2, True),
    (16, 16, 1, True), (5, 8, 1, True)],
    ids=["divides", "pads", "groups-state", "one-chunk-state",
         "short-state"])
def test_ssd_chunked_equals_repro(s, chunk, g, init):
    xdt, la, Bm, Cm, h0 = _ssd_inputs(s, s + chunk, g=g)
    j = [jnp.asarray(a, jnp.float32) for a in (xdt, la, Bm, Cm, h0)]
    t = [torch.from_numpy(a.astype(np.float32)) for a in (xdt, la, Bm, Cm,
                                                          h0)]
    want_y, want_s = jax.jit(
        lambda x, la_, b, c, h: jssm._ssd_chunked(x, la_, b, c, chunk, h))(
            *j[:4], j[4] if init else None)
    got_y, got_s = tssm._ssd_chunked(*t[:4], chunk, t[4] if init else None)
    close(got_y, want_y)
    close(got_s, want_s)


def test_ssd_decay_mask_same_forward_finite_gradient():
    """The documented difference: with a steep decay (seg above the
    diagonal past exp's float32 range) ``repro``'s gradient of log_a is NaN
    and the port's is finite; the forward and the gradient of xdt are
    within tolerance of ``repro``'s, and the two masks give the same
    bits."""
    xdt, la, Bm, Cm, _ = _ssd_inputs(32, 1, decay=12.0)
    j = [jnp.asarray(a, jnp.float32) for a in (xdt, la, Bm, Cm)]
    t = [torch.from_numpy(a.astype(np.float32)) for a in (xdt, la, Bm, Cm)]

    def jloss(xdt_, la_):
        return jnp.sum(jssm._ssd_chunked(xdt_, la_, j[2], j[3], 16)[0])

    jy = jax.jit(lambda *a: jssm._ssd_chunked(*a, 16)[0])(*j)
    jg = jax.jit(jax.grad(jloss, argnums=(0, 1)))(j[0], j[1])
    assert not bool(jnp.isnan(jg[0]).any())
    assert bool(jnp.isnan(jg[1]).any())

    xt = t[0].clone().requires_grad_(True)
    lt = t[1].clone().requires_grad_(True)
    ty = tssm._ssd_chunked(xt, lt, t[2], t[3], 16)[0]
    close(ty.detach(), jy)
    ty.sum().backward()
    close(xt.grad, jg[0])
    assert torch.isfinite(lt.grad).all()

    cum = torch.cumsum(t[1].reshape(B, 2, 16, 1, 4)[:, 0], dim=1)
    seg = cum[:, :, None] - cum[:, None, :]
    tril = torch.ones(16, 16, dtype=torch.bool).tril()[None, :, :, None, None]
    assert torch.isinf(torch.exp(seg)).any()
    port = torch.exp(torch.where(tril, seg, torch.tensor(float("-inf"))))
    ref = torch.where(tril, torch.exp(seg), torch.zeros(()))
    assert torch.equal(port, ref)


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T,chunk,h0", [
    (7, 256, False), (16, 16, True), (37, 8, True), (32, 8, False),
    (64, 8, True)],
    ids=["within-chunk", "one-chunk-h0", "ragged-h0", "four-chunks",
         "eight-chunks-h0"])
def test_scan_linear_recurrence_equals_repro(T, chunk, h0):
    rng = np.random.RandomState(T)
    a = rng.uniform(0.5, 1.0, (B, T, 12)).astype(np.float32)
    b = rng.randn(B, T, 12).astype(np.float32)
    h = rng.randn(B, 12).astype(np.float32)
    want = jax.jit(functools.partial(jrglru._scan_linear_recurrence,
                                     chunk=chunk))(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(h) if h0 else None)
    got = trglru._scan_linear_recurrence(
        torch.from_numpy(a), torch.from_numpy(b),
        torch.from_numpy(h) if h0 else None, chunk=chunk)
    close(got, want)
    # the sequential recurrence
    hs, cur = [], (h if h0 else np.zeros((B, 12), np.float32))
    for t in range(T):
        cur = a[:, t] * cur + b[:, t]
        hs.append(cur)
    close(got, np.stack(hs, 1))


@pytest.mark.parametrize("with_state", [False, True],
                         ids=["fresh", "state-and-conv"])
def test_rglru_mix_equals_repro(with_state):
    jcfg, tcfg, jp, tp = lm_setup("recurrentgemma-9b")
    pre = "hybrem0/mix"
    rng = np.random.RandomState(4)
    x = rng.randn(B, S, jcfg.d_model).astype(np.float32)
    w = jcfg.rglru.lru_width
    st = rng.randn(B, w).astype(np.float32) if with_state else None
    cc = (rng.randn(B, jcfg.rglru.conv_width - 1, w).astype(np.float32)
          if with_state else None)
    jout, (jh, jc) = jax.jit(lambda p, *a: jrglru.rglru_mix(
        jcfg, *a[:1], p, pre, *a[1:], return_state=True))(
            jp, jnp.asarray(x), None if st is None else jnp.asarray(st),
            None if cc is None else jnp.asarray(cc))
    tout, (th, tc) = trglru.rglru_mix(
        tcfg, torch.from_numpy(x), tp, pre,
        None if st is None else torch.from_numpy(st),
        None if cc is None else torch.from_numpy(cc), return_state=True)
    close(tout, jout)
    close(th, jh)
    close(tc, jc)
    assert th.dtype == torch.float32
    plain = trglru.rglru_mix(tcfg, torch.from_numpy(x), tp, pre,
                             None if st is None else torch.from_numpy(st),
                             None if cc is None else torch.from_numpy(cc))
    assert torch.equal(plain, tout)


# ---------------------------------------------------------------------------
# The whole forward, every LM
# ---------------------------------------------------------------------------


def lm_batch(jcfg, seed, b=B, s=S):
    """tokens [b, s], labels [b, s (+ patches)] with -1 masks, and the
    frontend stubs' embeddings the family needs, as numpy arrays."""
    rng = np.random.RandomState(seed)
    n_img = jcfg.n_frontend_tokens if jcfg.frontend == "vision" else 0
    batch = {"tokens": rng.randint(0, jcfg.vocab_size, (b, s)).astype(
                 np.int32),
             "labels": rng.randint(-1, jcfg.vocab_size, (b, s + n_img)
                                   ).astype(np.int32)}
    if jcfg.enc_dec:
        batch["frame_embeds"] = rng.randn(b, FRAMES, jcfg.d_model).astype(
            np.float32)
    if n_img:
        batch["img_embeds"] = rng.randn(b, n_img, jcfg.d_model).astype(
            np.float32)
    return batch


@pytest.fixture(scope="module", params=sorted(LMS))
def lm(request):
    """One arch at ``tiny_config`` (attention and SSD over several chunks):
    both configs, both params, a batch, and ``repro``'s jitted forward
    and ``Model.forward``."""
    jcfg, tcfg, jp, tp = lm_setup(request.param)
    batch = lm_batch(jcfg, 11)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jm = jbuild_model(jcfg)
    hidden = jax.jit(lambda p, b: jtf.forward(
        jcfg, p, b["tokens"], train=False, img_embeds=b.get("img_embeds"),
        frame_embeds=b.get("frame_embeds")))(jp, jb)
    logits = jax.jit(jm.forward)(jp, jb)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    return dict(jcfg=jcfg, tcfg=tcfg, tp=tp, tb=tb, hidden=hidden[0],
                aux=hidden[1], logits=logits)


def test_transformer_forward_equals_repro(lm):
    tcfg, tb = lm["tcfg"], lm["tb"]
    with torch.no_grad():
        hidden, aux = ttf.forward(tcfg, lm["tp"], tb["tokens"], train=False,
                                  img_embeds=tb.get("img_embeds"),
                                  frame_embeds=tb.get("frame_embeds"))
    assert hidden.dtype == torch.float32
    close(hidden, lm["hidden"])
    assert sorted(aux) == sorted(lm["aux"])
    for k, v in aux.items():
        close(v, lm["aux"][k])


def test_model_forward_equals_repro(lm):
    with torch.no_grad():
        logits = build_model(lm["tcfg"]).forward(lm["tp"], lm["tb"])
    n_img = lm["jcfg"].n_frontend_tokens if lm["jcfg"].frontend == \
        "vision" else 0
    assert logits.shape == (B, S + n_img, ttf.padded_vocab(lm["tcfg"]))
    close(logits, lm["logits"])


def test_forward_refuses_missing_frontend_inputs():
    for arch, need in (("whisper-medium", "frame_embeds"),
                       ("phi-3-vision-4.2b", "img_embeds")):
        cfg = port_config(tiny_config(jget_config(arch)))
        assert ttf.required_inputs(cfg) == (need,)
        with pytest.raises(ValueError, match=need):
            ttf.forward(cfg, {}, torch.zeros(1, 4, dtype=torch.int64))
    assert ttf.required_inputs(
        port_config(tiny_config(jget_config("gemma-2b")))) == ()


def test_forward_equals_its_decode_chain(lm):
    """``repro``'s own bar (``tests/test_decode.py``) on the port: the
    forward's logits == a teacher-forced chain of ``decode_step`` calls at
    every position within 5e-4 (MoE at capacity 8.0, so that neither pass
    drops a token; whisper's encoder K / V precomputed into ``cache/xk`` /
    ``cache/xv``; phi-3-vision without patches, as decode takes text)."""
    tcfg, tp, tb = lm["tcfg"], lm["tp"], lm["tb"]
    if tcfg.moe is not None:
        tcfg = tcfg.replace(moe=dataclasses.replace(
            tcfg.moe, capacity_factor=8.0, eval_capacity_factor=8.0))
    toks = tb["tokens"][:, :12].long()
    batch = {"tokens": toks}
    if "frame_embeds" in tb:
        batch["frame_embeds"] = tb["frame_embeds"]
    if "img_embeds" in tb:
        batch["img_embeds"] = tb["img_embeds"][:, :0]
    with torch.no_grad():
        full = build_model(tcfg).forward(tp, batch)
        cache = tdecode.init_cache(tcfg, B, 16, "float32", "cpu")
        if tcfg.enc_dec:
            enc = ttf._encode(tcfg, tp, batch["frame_embeds"])
            st = ttf.slice_layer(tp, "xdecoder/")
            for n, w in (("cache/xk", "xdecoder/xattn/wk"),
                         ("cache/xv", "xdecoder/xattn/wv")):
                cache[n] = torch.stack([
                    torch.einsum("bsd,dhk->bshk", enc, st[w][l])
                    for l in range(tcfg.n_decoder_layers)])
        for t in range(toks.shape[1]):
            logits, cache = tdecode.decode_step(
                tcfg, tp, cache, toks[:, t:t + 1],
                torch.full((B,), t, dtype=torch.int64))
            err = float((logits[:, 0] - full[:, t]).abs().max())
            assert err < 5e-4, (t, err)
