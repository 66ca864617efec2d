"""Test support: reduced smoke-test configs + the golden-model conformance
harness for the kernel scheduling layer.

The port of ``repro.testing``.  Every (kernel x mode x reuse_factor x
dtype) cell must reproduce the reference scan (``kernels/ref.py``, the
port's ``backend="xla"``) within dtype tolerance; the native int8/int4
datapath must reproduce numpy integer golden models; an engine must
reproduce the tagger's reference forward.  The inputs are the same numpy
draws as ``repro``'s, as tensors on ``device=`` (the card unless the
caller asks for the CPU); a float64 draw becomes bfloat16 through the same
rounding as ``jnp.asarray`` (via float32, on the CPU).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.config import FixedPointConfig, ModelConfig
from repro_torch.kernels.schedule import KernelSchedule

Device = Union[str, torch.device]


def tiny_config(full: ModelConfig) -> ModelConfig:
    """Shrink an assigned arch to CPU-testable size, keeping its family,
    attention grouping structure, MLP type and block pattern (every LM
    family: a few experts, a narrow SSM, one hybrid super-block plus a
    remainder layer, two encoder and decoder layers; a hybrid with its own
    ``pattern``, one whole period).  Granite's scalars are kept.  The
    taggers are already tiny."""
    if full.rnn is not None:
        return full  # paper taggers are already tiny
    kw = dict(
        n_layers=min(full.n_layers, 2 if not full.rglru else 4),
        d_model=64,
        vocab_size=256,
        d_ff=128,
        param_dtype="float32",
        compute_dtype="float32",
        grad_accum=1,
        attn_chunk_q=32,
        attn_chunk_kv=32,
        remat="none",
    )
    if full.n_heads:
        ratio = max(full.n_heads // max(full.n_kv_heads, 1), 1)
        n_heads = 4
        kw.update(n_heads=n_heads,
                  n_kv_heads=max(n_heads // ratio, 1),
                  head_dim=16)
    if full.moe is not None:
        kw["moe"] = dataclasses.replace(
            full.moe, n_experts=8,
            top_k=min(full.moe.top_k, 2),
            n_shared_experts=min(full.moe.n_shared_experts, 1),
            d_ff_expert=32)
        kw["d_ff"] = 32
    if full.ssm is not None:
        kw["ssm"] = dataclasses.replace(full.ssm, d_state=16, head_dim=16,
                                        chunk_size=8)
    if full.rglru is not None:
        kw["rglru"] = dataclasses.replace(full.rglru, lru_width=64, window=16)
        kw["n_layers"] = 4  # one super-block + 1 remainder
    pattern = getattr(full, "pattern", ())  # repro's configs have none
    if pattern:
        kw["n_layers"] = len(pattern)       # one whole period
    if full.enc_dec:
        kw.update(n_encoder_layers=2, n_decoder_layers=2, n_layers=2,
                  max_encoder_len=32)
    if full.frontend == "vision":
        kw["n_frontend_tokens"] = 8
    return dataclasses.replace(full, **kw)


# ---------------------------------------------------------------------------
# Golden-model conformance harness for KernelSchedule
# ---------------------------------------------------------------------------

# default absolute/relative tolerance per dtype: fp32 accumulation error over
# a scan; bf16 inputs round at ~2^-8
CONFORMANCE_TOL: Dict[str, float] = {"float32": 3e-5, "bfloat16": 2e-2}


def _tensor(a: np.ndarray, dtype: torch.dtype, device: Device
            ) -> torch.Tensor:
    """A numpy draw as a ``dtype`` tensor on ``device``, rounded on the CPU
    as ``jnp.asarray(a, dtype)`` rounds it."""
    return torch.from_numpy(np.asarray(a)).to(dtype).to(device)


def _np(v) -> np.ndarray:
    """A tensor (any device) or array as a numpy array; bfloat16 widened
    to float32 (exact), which numpy has no type for."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        return (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    return np.asarray(v)


def _np32(v) -> np.ndarray:
    return _np(v).astype(np.float32, copy=False)


def make_kernel_inputs(kernel: str, *, B: int = 4, T: int = 12, F: int = 6,
                       H: int = 20, M: int = 32, K: int = 64, N: int = 48,
                       dtype: str = "float32", seed: int = 0,
                       device: Device = "cuda") -> Tuple:
    """Deterministic inputs for one scheduled kernel, on ``device``.

    lstm/gru use (B, T, F, H); rglru uses (B, T, H) with H as the width;
    reuse_matmul uses (M, K, N).
    """
    rng = np.random.RandomState(seed)
    dt = getattr(torch, dtype)
    t = lambda a: _tensor(a, dt, device)  # noqa: E731
    if kernel in ("lstm", "gru"):
        g = 4 if kernel == "lstm" else 3
        xs = t(rng.randn(B, T, F))
        W = t(rng.randn(F, g * H) * 0.3)
        U = t(rng.randn(H, g * H) * 0.3)
        bshape = (g * H,) if kernel == "lstm" else (2, g * H)
        b = t(rng.randn(*bshape) * 0.1)
        return xs, W, U, b
    if kernel == "rglru":
        a = t(np.exp(-np.abs(rng.randn(B, T, H))))
        bx = t(rng.randn(B, T, H))
        return a, bx
    if kernel == "reuse_matmul":
        x = t(rng.randn(M, K))
        w = t(rng.randn(K, N))
        return x, w
    raise KeyError(f"unknown kernel {kernel!r}")


def _max_err(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.max(np.abs(got - want))) if got.size else 0.0


def assert_schedule_conformance(kernel: str, schedule: KernelSchedule, *,
                                dtype: str = "float32",
                                tol: Optional[float] = None,
                                seed: int = 0, device: Device = "cuda",
                                **shape_kw) -> float:
    """Run one (kernel x schedule x dtype) cell on ``device`` against the
    reference.

    Returns the max abs error; raises AssertionError beyond tolerance.
    Shape kwargs (B, T, F, H, M, K, N) pass through to make_kernel_inputs —
    ragged batches and off-lane hidden sizes are legal, the scheduling layer
    owns the padding.
    """
    from repro_torch.kernels import ops

    scheduled, golden = ops.SCHEDULED_KERNELS[kernel]
    inputs = make_kernel_inputs(kernel, dtype=dtype, seed=seed,
                                device=device, **shape_kw)
    with torch.inference_mode():
        got = _np32(scheduled(*inputs, schedule=schedule))
        want = _np32(golden(*inputs))
    assert got.shape == want.shape, (kernel, schedule, got.shape, want.shape)
    err = _max_err(got, want)
    limit = CONFORMANCE_TOL[dtype] if tol is None else tol
    scale = max(1.0, float(np.max(np.abs(want)))) if want.size else 1.0
    assert err <= limit * scale, (
        f"{kernel} diverged from golden model under {schedule}: "
        f"max_err={err:.3e} > {limit * scale:.3e} (dtype={dtype}, "
        f"shapes={shape_kw}, device={device})")
    return err


# ---------------------------------------------------------------------------
# Quantized golden models (numpy integer references) + conformance harness
# ---------------------------------------------------------------------------
#
# The native int8/int4 datapath is verified against INDEPENDENT numpy
# references that re-implement each cell's hls4ml quantization points with
# integer matmuls (exact int accumulation, like the hardware) and f32
# activations.  Inputs come PTQ'd (weights on the fp grid), under which
# native == emulation is bit-exact; the only legal divergence from the
# numpy golden is an activation landing a half-ulp away from a rounding tie
# (numpy's exp vs torch's — one grid step), hence the default tolerance of
# 2 x fixed_point_error_bound = one grid step.

#: the configs the conformance suite pins for the native datapath:
#: ap_fixed<8,3> (int8 storage, scale 2^5) and ap_fixed<4,2> (nibble-packed)
def native_fp_configs():
    return {"int8": FixedPointConfig(8, 3), "int4": FixedPointConfig(4, 2)}


def _np_sigmoid(x):
    return (1.0 / (1.0 + np.exp(-x.astype(np.float32)))).astype(np.float32)


def _np_tanh(x):
    return np.tanh(x.astype(np.float32))


def _np_ints(x, fp):
    """On-grid f32 values -> integer grid indices (exact)."""
    return np.round(np.asarray(x, np.float64) * fp.scale).astype(np.int64)


def quantized_golden_lstm(xs, W, U, b, fp) -> np.ndarray:
    """Numpy integer reference of the quantized LSTM scan: int64 gate
    accumulators over PTQ'd weights, quantize_np at every datapath point of
    ``cells.lstm_cell_quantized``.  Returns the final hidden state."""
    from repro_torch.core.quant.fixed_point import quantize_np

    q = lambda v: quantize_np(v, fp)                       # noqa: E731
    xs = _np32(xs)
    Wq, Uq = _np_ints(q(_np(W)), fp), _np_ints(q(_np(U)), fp)
    bq = q(_np(b))
    B, T, _ = xs.shape
    H = Uq.shape[0]
    inv2 = np.float32(1.0 / (fp.scale * fp.scale))
    h = np.zeros((B, H), np.float32)
    c = np.zeros((B, H), np.float32)
    for t in range(T):
        xi = _np_ints(q(xs[:, t]), fp)
        hi = _np_ints(h, fp)
        z = q((xi @ Wq).astype(np.float32) * inv2
              + (hi @ Uq).astype(np.float32) * inv2 + bq)
        i, f, g, o = (z[:, :H], z[:, H:2 * H], z[:, 2 * H:3 * H], z[:, 3 * H:])
        i, f, o = q(_np_sigmoid(i)), q(_np_sigmoid(f)), q(_np_sigmoid(o))
        g = q(_np_tanh(g))
        c = q(q(f * c) + q(i * g))
        h = q(o * q(_np_tanh(c)))
    return h


def quantized_golden_gru(xs, W, U, b, fp) -> np.ndarray:
    """Numpy integer reference of the quantized GRU (reset_after) scan."""
    from repro_torch.core.quant.fixed_point import quantize_np

    q = lambda v: quantize_np(v, fp)                       # noqa: E731
    xs = _np32(xs)
    Wq, Uq = _np_ints(q(_np(W)), fp), _np_ints(q(_np(U)), fp)
    bq = q(_np(b))
    B, T, _ = xs.shape
    H = Uq.shape[0]
    inv2 = np.float32(1.0 / (fp.scale * fp.scale))
    h = np.zeros((B, H), np.float32)
    for t in range(T):
        xi = _np_ints(q(xs[:, t]), fp)
        hi = _np_ints(h, fp)
        zx = q((xi @ Wq).astype(np.float32) * inv2 + bq[0])
        zh = q((hi @ Uq).astype(np.float32) * inv2 + bq[1])
        zxz, zxr, zxh = np.split(zx, 3, axis=-1)
        zhz, zhr, zhh = np.split(zh, 3, axis=-1)
        z = q(_np_sigmoid(zxz + zhz))
        r = q(_np_sigmoid(zxr + zhr))
        hh = q(_np_tanh(q(zxh + q(r * zhh))))
        h = q(q(z * h) + q((1.0 - z) * hh))
    return h


def quantized_golden_rglru(a, bx, fp) -> np.ndarray:
    """Numpy integer reference of the quantized RG-LRU recurrence — ALL
    integer arithmetic (the native datapath is matmul-free), so it must
    match bit-for-bit."""
    from repro_torch.core.quant.fixed_point import quantize_np

    a, bx = _np32(a), _np32(bx)
    lo = int(round(fp.min_value * fp.scale))
    hi = int(round(fp.max_value * fp.scale))
    F = fp.fractional_bits
    ai = _np_ints(quantize_np(a, fp), fp)
    bi = _np_ints(quantize_np(bx, fp), fp)
    B, T, W = a.shape
    h = np.zeros((B, W), np.int64)
    hs = []
    for t in range(T):
        acc = ai[:, t] * h + (bi[:, t] << F)
        # round-half-even of acc / 2^F on the integer grid, then saturate
        h = np.clip(np.round(acc.astype(np.float64) / fp.scale), lo, hi
                    ).astype(np.int64)
        hs.append(h)
    return (np.stack(hs, axis=1) / fp.scale).astype(np.float32)


def quantized_golden_reuse_matmul(x, w, fp) -> np.ndarray:
    """Numpy integer reference of the quantized scheduled matmul
    z = q(q(x) @ q(w)) — exact int accumulation, must match bit-for-bit."""
    from repro_torch.core.quant.fixed_point import quantize_np

    xi = _np_ints(quantize_np(_np(x), fp), fp)
    wi = _np_ints(quantize_np(_np(w), fp), fp)
    acc = (xi @ wi).astype(np.float32) / np.float32(fp.scale * fp.scale)
    return quantize_np(acc, fp)


QUANTIZED_GOLDENS = {
    "lstm": quantized_golden_lstm,
    "gru": quantized_golden_gru,
    "rglru": quantized_golden_rglru,
    "reuse_matmul": quantized_golden_reuse_matmul,
}


def make_quantized_inputs(kernel: str, fp, *, dtype: str = "float32",
                          seed: int = 0, device: Device = "cuda",
                          **shape_kw) -> Tuple:
    """make_kernel_inputs with the WEIGHTS PTQ'd onto the fp grid (exact
    host-side quantize_np) — the regime where native == emulation bitwise;
    activations/inputs stay raw, the datapath quantizes them."""
    from repro_torch.core.quant.fixed_point import quantize_np

    inputs = make_kernel_inputs(kernel, dtype=dtype, seed=seed,
                                device=device, **shape_kw)
    if kernel in ("lstm", "gru"):
        xs, W, U, b = inputs
        return (xs,) + tuple(torch.from_numpy(quantize_np(_np(v), fp))
                             .to(device) for v in (W, U, b))
    return inputs


def assert_quantized_conformance(kernel: str, schedule: KernelSchedule,
                                 fp, *, tol: Optional[float] = None,
                                 seed: int = 0, device: Device = "cuda",
                                 **shape_kw) -> float:
    """Run one (kernel x schedule x fp) cell on ``device`` against its numpy
    integer golden model.  Default tolerance: ONE grid step
    (2 x fixed_point_error_bound) — the matmul/Hadamard datapath is exact,
    only an activation rounding tie may move a value one step.

    Returns the max abs error; raises AssertionError beyond tolerance.
    """
    from repro_torch.core.quant.fixed_point import fixed_point_error_bound
    from repro_torch.kernels import ops

    scheduled, _ = ops.SCHEDULED_KERNELS[kernel]
    inputs = make_quantized_inputs(kernel, fp, seed=seed, device=device,
                                   **shape_kw)
    with torch.inference_mode():
        got = _np32(scheduled(*inputs, schedule=schedule, fp=fp))
    want = QUANTIZED_GOLDENS[kernel](*inputs, fp)
    assert got.shape == want.shape, (kernel, schedule, got.shape, want.shape)
    err = _max_err(got, want)
    limit = 2.0 * fixed_point_error_bound(fp) if tol is None else tol
    assert err <= limit, (
        f"{kernel} diverged from quantized golden model under {schedule} "
        f"fp=ap_fixed<{fp.total_bits},{fp.integer_bits}>: max_err={err:.3e} "
        f"> {limit:.3e} (seed={seed}, shapes={shape_kw}, device={device})")
    return err


# ---------------------------------------------------------------------------
# End-to-end serving conformance (engine output vs the reference forward)
# ---------------------------------------------------------------------------


def serving_golden(cfg: ModelConfig, params, x, fp=None, mode=None,
                   lengths=None) -> np.ndarray:
    """Golden served output: the full tagger forward pass on the reference
    datapath (``impl="xla"``, kernels/ref.py semantics) on the parameters'
    device — what every engine (mode x impl x schedule x fp) cell must
    reproduce."""
    from repro_torch.models import rnn_tagger

    device = next(iter(params.values())).device
    with torch.inference_mode():
        out = rnn_tagger.forward(
            cfg, params,
            torch.as_tensor(np.asarray(x, np.float32), device=device),
            fp=fp, mode=mode, impl="xla",
            lengths=None if lengths is None
            else torch.as_tensor(np.asarray(lengths), device=device))
    return _np32(out)


def assert_serving_conformance(engine, x, *, schedule: Optional[KernelSchedule]
                               = None, fp=None, tol: Optional[float] = None,
                               dtype: str = "float32") -> float:
    """One engine.predict cell against the golden model, with the same
    tolerance discipline as :func:`assert_schedule_conformance`.

    Returns the max abs error; raises AssertionError beyond tolerance.
    """
    got = np.asarray(engine.predict(x, schedule=schedule, fp=fp), np.float32)
    sched, fpr = engine.resolve(schedule, fp)
    want = serving_golden(engine.cfg, engine.params, x, fp=fpr,
                          mode=sched.mode)
    assert got.shape == want.shape, (sched, got.shape, want.shape)
    err = _max_err(got, want)
    limit = CONFORMANCE_TOL[dtype] if tol is None else tol
    scale = max(1.0, float(np.max(np.abs(want)))) if want.size else 1.0
    assert err <= limit * scale, (
        f"engine diverged from golden model under {sched} fp={fpr}: "
        f"max_err={err:.3e} > {limit * scale:.3e}")
    return err
