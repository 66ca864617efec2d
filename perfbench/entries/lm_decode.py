"""An LM served token by token through ``repro_torch``'s
``LMServingEngine``, every slot kept full: the entry of an LM decode cell.

The configuration's file holds the model's published ``config.json`` keys
(a Granite 4.0-H dense hybrid: Mamba-2 and full-attention layers, the
layout ``reference_granite.py`` computes); the program's registry entry
for its ``arch`` must equal what those keys describe (``check_config``).
Set-up draws the weights on the card from the seed (``make_weights``), a
pool of ``pool_events`` requests from the seed (``make_pool``: uniform
token ids, lognormal prompt and output lengths), and the engine on those
weights with ``slots`` slots of ``max_seq`` positions; it fills every slot
from the pool and ticks ``warmup_calls`` times.

A call is one ``LMServingEngine.tick`` (every slot decodes one token, a
prompt's tokens teacher-forced through the same step) and the refills of
the slots it freed, from the pool in turn: ``events_per_call`` tokens.  A
pool item is not used by the call (the engine holds the traffic's state);
the call's answer keeps two of the tick's rows, drawn from the seed with
weights pos + 1 (a long context exercises the most resident state): each
a reference to the slot's token list, the position it decoded, its row
of the host logits the tick made, and a copy of its slot's SSM state in
the first Mamba layer as the tick left it (one device copy of heads x
head size x d_state floats a row).  The check holds each row's logits to
the plain float32 reference's full forward over the row's tokens up to
that position (prompt and generated tokens alike), and the state to the
reference's state of that layer after the same tokens.  A control
(``readings.py``) runs ``control_ticks`` ticks, about a run's window, and
samples ``check_calls`` of them, so that its rows sit at a window's
positions: a bfloat16 state drifts as the context grows.
"""

from __future__ import annotations

import gc
import itertools
import math
import random
import time
from typing import Callable, Dict, List, Mapping, Optional

import numpy as np

from perfbench import run, spec

#: the published layer kinds -> the port's hybrid pattern kinds
KINDS = {"mamba": "mamba", "attention": "attn"}


def model_config(cfg: Mapping):
    """The program's config for the published keys of ``cfg``, on the
    registry's entry for ``cfg["arch"]`` (an unknown arch raises
    ``KeyError`` at once).  Keys the port cannot express raise."""
    from repro_torch.registry import get_config

    base = get_config(cfg["arch"])
    from repro_torch.config import GraniteConfig, SSMConfig

    fixed = {"model_type": "granitemoehybrid", "num_local_experts": 0,
             "hidden_act": "silu", "normalization_function": "rmsnorm",
             "attention_bias": False, "mamba_proj_bias": False,
             "mamba_conv_bias": True, "tie_word_embeddings": True,
             "position_embedding_type": "nope"}
    odd = {k: cfg[k] for k, v in fixed.items() if cfg[k] != v}
    if odd or cfg["intermediate_size"] != cfg["shared_intermediate_size"]:
        raise ValueError(f"{cfg['arch']}: the port's hybrid has no {odd}")
    kinds = [KINDS[k] for k in cfg["layer_types"]]
    L = cfg["num_hidden_layers"]
    period = next(p for p in range(1, L + 1)
                  if L % p == 0 and kinds == kinds[:p] * (L // p))
    d, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    if cfg["mamba_n_heads"] * cfg["mamba_d_head"] != \
            cfg["mamba_expand"] * d:
        raise ValueError(f"{cfg['arch']}: mamba heads x head size is not "
                         f"expand x hidden size")
    return base.replace(
        n_layers=L, d_model=d, n_heads=heads,
        n_kv_heads=cfg["num_key_value_heads"], head_dim=d // heads,
        d_ff=cfg["shared_intermediate_size"], vocab_size=cfg["vocab_size"],
        norm_eps=cfg["rms_norm_eps"], pattern=tuple(kinds[:period]),
        ssm=SSMConfig(d_state=cfg["mamba_d_state"],
                      d_conv=cfg["mamba_d_conv"],
                      expand=cfg["mamba_expand"],
                      head_dim=cfg["mamba_d_head"],
                      n_groups=cfg["mamba_n_groups"],
                      chunk_size=cfg["mamba_chunk_size"]),
        granite=GraniteConfig(
            embedding_multiplier=float(cfg["embedding_multiplier"]),
            attention_multiplier=float(cfg["attention_multiplier"]),
            residual_multiplier=float(cfg["residual_multiplier"]),
            logits_scaling=float(cfg["logits_scaling"])),
        tie_embeddings=True, param_dtype=cfg["dtype"],
        compute_dtype=cfg["dtype"])


def check_config(cfg: Mapping, traffic: Optional[Mapping] = None) -> None:
    """The configuration's file against the program's registry (the same
    model, field by field) and, with ``traffic``, the requests against
    the slots' length."""
    from repro_torch.registry import get_config

    want = get_config(cfg["arch"])
    have = model_config(cfg)
    if have != want:
        raise ValueError(f"{cfg['arch']}: the configuration's file makes "
                         f"{have}, the program's registry has {want}")
    if cfg["ssm_state_dtype"] != "float32":
        raise ValueError("the port keeps its SSM state in float32")
    if traffic is not None:
        longest = traffic["prompt_tokens"]["max"] + \
            traffic["output_tokens"]["max"]
        if longest >= traffic["max_seq"]:
            raise ValueError(f"a request of {longest} tokens does not fit "
                             f"max_seq {traffic['max_seq']}")
        if traffic["events_per_call"] != traffic["slots"]:
            raise ValueError("a call answers one token a slot")


def make_weights(model_cfg, seed: int, device) -> Dict:
    """The program's parameters drawn from the seed on ``device``, in its
    layout (``transformer.param_specs``), in the configuration's dtype:
    matrices N(0, 1/fan_in), the embedding N(0, 0.02^2), RMSNorm scales
    N(0, 0.1^2) (the port's offset from one), the depthwise conv's weight
    and bias U(-1/2, 1/2) (PyTorch's default for a conv of width 4), and
    Mamba-2's own draws for A_log (log U[1, 16]), dt_bias (softplus^-1 of
    a log-uniform dt in [1e-3, 1e-1]) and D (ones)."""
    import torch

    from repro_torch.models.transformer import param_specs

    gen = torch.Generator(device=device).manual_seed(seed)
    dtype = getattr(torch, model_cfg.param_dtype)
    out = {}
    for name, s in sorted(param_specs(model_cfg).items()):
        shape = s.shape
        if name.endswith(("/scale", "/norm_scale")):
            w = 0.1 * torch.randn(shape, generator=gen, device=device)
        elif name.endswith(("/conv_w", "/conv_b")):
            w = torch.rand(shape, generator=gen, device=device) - 0.5
        elif name.endswith("/a_log"):
            w = torch.log(1 + 15 * torch.rand(shape, generator=gen,
                                              device=device))
        elif name.endswith("/dt_bias"):
            u = torch.rand(shape, generator=gen, device=device)
            dt = torch.exp(math.log(1e-3) + u * math.log(100.0))
            w = dt + torch.log(-torch.expm1(-dt))    # softplus(w) = dt
        elif name.endswith("/d_skip"):
            w = torch.ones(shape, device=device)
        elif name == "embed/table":
            w = 0.02 * torch.randn(shape, generator=gen, device=device)
        else:                   # [stack, fan_in..., out...] matrices
            fan_in = math.prod(shape[1:3]) if name.endswith("/wo") \
                else shape[1]
            w = torch.randn(shape, generator=gen, device=device) \
                / math.sqrt(fan_in)
        out[name] = w.to(dtype)
    return out


def reference_weights(model_cfg, params: Mapping) -> Dict:
    """The program's parameters as ``reference_granite.py`` takes them,
    from ``transformer.param_specs``' names: layer ``l`` is row ``l //
    period`` of the stacked ``hyb{l % period}/`` group; the attention's
    [d, heads, head_dim] projections flattened to [d, heads head_dim]
    (``wo`` the other way round); the RMSNorm scales as published, ``1 +
    scale`` in float32 (the program keeps the offset from one); the
    embedding's rows past the vocabulary (its padding) dropped.  Views of
    the program's tensors otherwise."""
    pattern = model_cfg.hybrid_pattern
    period = len(pattern)
    if model_cfg.n_layers % period:
        raise ValueError(f"{model_cfg.n_layers} layers is not whole "
                         f"periods of {period}")
    d = model_cfg.d_model

    def scale(t):
        return 1.0 + t.float()

    layers = []
    for l in range(model_cfg.n_layers):
        kind = pattern[l % period]

        def w(name, l=l):
            return params[f"hyb{l % period}/{name}"][l // period]

        layer = {"input_norm": scale(w("norm1/scale")),
                 "post_norm": scale(w("norm2/scale")),
                 "mlp_gate": w("mlp/w_gate"), "mlp_up": w("mlp/w_up"),
                 "mlp_down": w("mlp/w_down")}
        if kind == "mamba":
            layer.update(in_proj=w("ssm/w_in"), conv_w=w("ssm/conv_w"),
                         conv_b=w("ssm/conv_b"), dt_bias=w("ssm/dt_bias"),
                         A_log=w("ssm/a_log"), D=w("ssm/d_skip"),
                         gate_norm=scale(w("ssm/norm_scale")),
                         out_proj=w("ssm/w_out"))
        else:
            layer.update(q_proj=w("attn/wq").reshape(d, -1),
                         k_proj=w("attn/wk").reshape(d, -1),
                         v_proj=w("attn/wv").reshape(d, -1),
                         o_proj=w("attn/wo").reshape(-1, d))
        layers.append(layer)
    return {"embed": params["embed/table"][:model_cfg.vocab_size],
            "final_norm": scale(params["final_norm/scale"]),
            "layers": layers}


def first_mamba(cfg: Mapping) -> int:
    """The index of the first Mamba layer in ``layer_types``."""
    return cfg["layer_types"].index("mamba")


def make_pool(traffic: Mapping, vocab: int, seed: int) -> List:
    """``pool_events`` requests drawn from the seed: (prompt token ids,
    output tokens), lengths lognormal and clipped as the traffic says."""
    rng = np.random.default_rng(seed)
    n = traffic["pool_events"]

    def lengths(t):
        x = np.exp(rng.normal(math.log(t["median"]), t["sigma"], n))
        return np.clip(np.rint(x), t["min"], t["max"]).astype(np.int64)

    plen, olen = lengths(traffic["prompt_tokens"]), lengths(
        traffic["output_tokens"])
    ids = rng.integers(0, vocab, int(plen.sum()), dtype=np.int64)
    cuts = np.cumsum(plen)[:-1]
    return list(zip(np.split(ids, cuts), olen.tolist()))


def make_call(engine, pool: List, seed: int) -> Callable:
    """Fill every slot from the pool; the call: one tick, two rows drawn
    from the seed (each with a copy of its slot's state in the first
    Mamba layer), the freed slots refilled."""
    rng = random.Random(seed)
    slots = engine.slots
    turn = itertools.count()
    # that layer is row 0 of the stacked cache entry of its pattern index
    pattern = engine.cfg.hybrid_pattern
    state = f"cache/hyb{pattern.index('mamba')}_state"

    def refill() -> None:
        for s in slots:
            if not s.active:
                prompt, out = pool[next(turn) % len(pool)]
                engine.add_request(prompt.tolist(), max_new=out)

    refill()

    def call(_item):
        tokens = [s.tokens for s in slots]
        finished = engine.tick()
        last = engine.last_logits()
        picks = rng.choices(range(len(slots)),
                            weights=((last.pos + 1) * last.active).tolist(),
                            k=2)
        cache = engine.decode_cache()
        answer = tuple((tokens[i], int(last.pos[i]), last.rows[i],
                        cache[state][0, i].clone()) for i in picks)
        if finished:
            refill()
        return answer

    return call


def build(cell: spec.Cell, seed: int, device, stamps: Dict[str, float]
          ) -> run.Bench:
    """Weights, requests and the engine, every slot filled and warmed."""
    import torch

    from repro_torch.serving.lm_engine import LMServingEngine

    stamps["program"] = time.perf_counter() - run.T0
    cfg, traffic = cell.cfg, cell.traffic
    model_cfg = model_config(cfg)
    weights = make_weights(model_cfg, seed, device)
    stamps["weights"] = time.perf_counter() - run.T0
    pool = make_pool(traffic, cfg["vocab_size"], seed)
    stamps["events"] = time.perf_counter() - run.T0
    engine = LMServingEngine(
        model_cfg, weights, max_batch=traffic["slots"],
        max_seq=traffic["max_seq"], cache_dtype=cfg["cache_dtype"],
        device=device,
        cache_dir=str(run.CACHE_DIR) if device.type == "cuda" else None)
    call = make_call(engine, pool, seed)
    stamps["engine"] = time.perf_counter() - run.T0
    for i in range(traffic["warmup_calls"]):
        call(None)
        if not i:
            stamps["first_call"] = time.perf_counter() - run.T0
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    stamps["warm"] = time.perf_counter() - run.T0
    return run.Bench(cell, weights, pool, engine, call, stamps)


def well_formed(out, vocab: int, state_shape) -> bool:
    return isinstance(out, tuple) and len(out) == 2 and all(
        isinstance(r, tuple) and len(r) == 4 and len(r[0]) > r[1] >= 0
        and np.shape(r[2]) == (vocab,) and tuple(r[3].shape) == state_shape
        for r in out)


def longest_memory_head(p: Mapping) -> int:
    """A Mamba layer's head whose decay at its dt bias, exp(-softplus(
    dt_bias) exp(A_log)), is nearest one: the head that sums the most
    steps, and so the most of a narrower state's rounding."""
    import torch.nn.functional as F

    return int((F.softplus(p["dt_bias"].float())
                * p["A_log"].float().exp()).argmin())


def compare(bench: run.Bench, kept, answer: Optional[Callable] = None
            ) -> Dict:
    """Each sampled row against the reference over the same tokens up to
    the same position: ``{name: [value, limit]}``.  ``logit_gap_max``:
    the largest over the rows of |program - reference| over |reference|
    (L2 over the vocabulary, float32): random weights set the logits'
    scale, which the ratio takes out, and the whole row's error is
    steadier than its largest entry.  ``ssm_state_gap``: the largest over
    the rows of the same ratio for the slot's SSM state in the first
    Mamba layer, in its head of longest memory (L2 over head size x
    d_state): the layer's inputs come from the embedding alone, so the
    program's bfloat16 arithmetic costs it as little as anywhere, while a
    state held in a narrower dtype drifts there the most; bfloat16
    activations through 40 layers hide that drift in the logits.
    ``answer(tokens, pos)`` (a control) stands in for the program's
    (logits, state)."""
    import torch

    from perfbench import reference_granite as ref

    cfg = bench.cell.cfg
    model_cfg = model_config(cfg)
    vocab = cfg["vocab_size"]
    outs = [o for _, o in kept]
    padded = bench.weights["embed/table"].shape[0]
    first = first_mamba(cfg)
    shape = (cfg["mamba_n_heads"], cfg["mamba_d_head"],
             cfg["mamba_d_state"])
    bad = sum(not well_formed(o, padded, shape) for o in outs)
    if bad:
        return {"answers_missing": [bad, 0]}
    weights = reference_weights(model_cfg, bench.weights)
    head = longest_memory_head(weights["layers"][first])
    dev = bench.weights["embed/table"].device

    def gap(got, want):
        return float(torch.linalg.vector_norm(got - want)
                     / torch.linalg.vector_norm(want))

    gaps, state_gaps, nonfinite = [], [], 0
    for tokens, pos, row, state in (r for o in outs for r in o):
        t = torch.tensor(tokens[:pos + 1], dtype=torch.int64, device=dev)
        want = ref.forward(cfg, weights, t, [pos])[0]
        want_state = ref.mamba_state(cfg, weights, t, first)
        if answer is not None:
            row, state = answer(t, pos)
        got = torch.as_tensor(row).to(dev).float()[:vocab]
        state = state.to(dev).float()
        if not (bool(torch.isfinite(got).all())
                and bool(torch.isfinite(state).all())):
            nonfinite += 1
            gaps.append(math.inf)
            state_gaps.append(math.inf)
            continue
        gaps.append(gap(got, want))
        state_gaps.append(gap(state[head], want_state[head]))
    check = cfg["check"]
    return {"answers_missing": [0, 0],
            "nonfinite_rows": [nonfinite, 0],
            "logit_gap_max": [max(gaps), check["logit_gap_max"]],
            "ssm_state_gap": [max(state_gaps), check["ssm_state_gap"]]}


def fp8_rounded(weights: Dict) -> Dict:
    """Every tensor of the reference's weights through float8_e4m3fn at a
    per-tensor scale (its largest magnitude to 448, the format's
    largest), back in float32."""
    import torch

    def r(w):
        w = w.float()
        s = 448.0 / w.abs().max().clamp(min=1e-30)
        return (w * s).to(torch.float8_e4m3fn).float() / s

    return {"embed": r(weights["embed"]),
            "final_norm": r(weights["final_norm"]),
            "layers": [{k: r(v) for k, v in layer.items()}
                       for layer in weights["layers"]]}


def control(cell: spec.Cell, seed: int, device) -> Dict:
    """The controls' checks, each below the configuration's precision and
    put in the program's place on rows of the program's own run at a
    window's positions: ``fp8_weights.*``, the reference on the weights
    rounded through float8_e4m3fn (below bfloat16), and ``bf16_state.*``,
    the reference with its SSM state carried in bfloat16 between steps
    (below float32)."""
    import torch

    from perfbench import reference_granite as ref

    bench = build(cell, seed, device, {})
    sample = run.Sample(cell.traffic["check_calls"], seed)
    for i in range(cell.traffic["control_ticks"]):
        sample.offer((i, bench.call(None)))
    bench.engine = bench.call = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    cfg = cell.cfg
    weights = reference_weights(model_config(cfg), bench.weights)
    low = fp8_rounded(weights)
    first = first_mamba(cfg)

    def fp8_weights(t, pos):
        return (ref.forward(cfg, low, t, [pos])[0],
                ref.mamba_state(cfg, low, t, first))

    def bf16_state(t, pos):
        kw = {"state_dtype": torch.bfloat16}
        return (ref.forward(cfg, weights, t, [pos], **kw)[0],
                ref.mamba_state(cfg, weights, t, first, **kw))

    out = {}
    for name, fn in (("fp8_weights", fp8_weights),
                     ("bf16_state", bf16_state)):
        for k, v in compare(bench, sample.kept, answer=fn).items():
            out[f"{name}.{k}"] = v
    return out
