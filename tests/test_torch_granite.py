"""granite-4.0-h-micro on the port, held to its plain reference on the CPU.

``repro`` has no such model, so the port is held to the benchmark's
``perfbench/reference_granite.py`` (plain float32 ``torch``, the
published description: a quadratic SSD, causal NoPE GQA, Granite's four
scalars), on the parameters as ``perfbench/entries/lm_decode.py`` lays
them out for it, at ``repro_torch.testing.tiny_config`` of it: one whole period of
ten layers with attention at index 5, d 64, the published scalars, on
seeded weights with Mamba-2's own draws of A_log and dt_bias and random
norm scales (the port's init leaves them at constants).

Tolerances: 3e-5 times max(1, max |reference|) between the port in float32
and the reference, as ``CONFORMANCE_TOL["float32"]`` everywhere in the
port's tests: both sides are float32 and differ only in the order of
their sums (a chunked SSD against the quadratic form, blockwise attention
against a whole softmax, the decode chain against the sequence).  The
reference's two forms of the SSD (quadratic, and step by step with a
float32 state) agree within the same; carried in bfloat16, the state
breaks it.
"""

import json
import math
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.config import ModelConfig
from repro_torch.configs import get_config
from repro_torch.models import decode
from repro_torch.models.model import Model, build_model
from repro_torch.serving import LMServingEngine, SpecConfig
from repro_torch.testing import CONFORMANCE_TOL, tiny_config

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:               # the benchmark's package
    sys.path.append(str(ROOT))

from perfbench import reference_granite as ref  # noqa: E402
from perfbench.entries.lm_decode import (KINDS,  # noqa: E402
                                         reference_weights)

ARCH = "granite-4.0-h-micro"
TOL = CONFORMANCE_TOL["float32"]


def published(cfg: ModelConfig) -> dict:
    """The config under its published ``config.json`` keys (those the
    reference reads)."""
    g, s = cfg.granite, cfg.ssm
    kind = {v: k for k, v in KINDS.items()}
    return {"hidden_size": cfg.d_model, "num_attention_heads": cfg.n_heads,
            "num_key_value_heads": cfg.n_kv_heads,
            "layer_types": [kind[k] for k in cfg._pattern_for_layers()],
            "mamba_n_heads": s.expand * cfg.d_model // s.head_dim,
            "mamba_d_head": s.head_dim, "mamba_n_groups": s.n_groups,
            "mamba_d_state": s.d_state, "rms_norm_eps": cfg.norm_eps,
            "embedding_multiplier": g.embedding_multiplier,
            "attention_multiplier": g.attention_multiplier,
            "residual_multiplier": g.residual_multiplier,
            "logits_scaling": g.logits_scaling,
            "position_embedding_type": "nope",
            "vocab_size": cfg.vocab_size}


def draw(cfg: ModelConfig, seed: int = 0) -> dict:
    """Seeded float32 weights on the CPU: the port's init, then Mamba-2's
    draws of A_log (log U[1, 16]) and dt_bias (softplus^-1 of a
    log-uniform dt in [1e-3, 1e-1]), and N(0, 0.1^2) norm scales and conv
    biases, so that no parameter sits at a constant."""
    g = torch.Generator().manual_seed(seed)
    p = build_model(cfg).init(g, device="cpu")
    for k, v in p.items():
        if k.endswith("/a_log"):
            v.copy_(torch.log(torch.empty_like(v).uniform_(1, 16,
                                                           generator=g)))
        elif k.endswith("/dt_bias"):
            dt = torch.exp(torch.empty_like(v).uniform_(
                math.log(1e-3), math.log(1e-1), generator=g))
            v.copy_(dt + torch.log(-torch.expm1(-dt)))
        elif k.endswith(("scale", "conv_b")):
            v.copy_(0.1 * torch.randn(v.shape, generator=g))
    return p


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_config(get_config(ARCH))
    return cfg, draw(cfg)


def close(got, want, tol=TOL):
    got, want = got.float(), want.float()
    assert got.shape == want.shape
    err = float((got - want).abs().max())
    assert err <= tol * max(1.0, float(want.abs().max())), err
    return err


def reference(cfg, params, tokens, positions=None, **kw):
    return ref.forward(published(cfg), reference_weights(cfg, params),
                       tokens, positions, **kw)


def test_tiny_keeps_one_period_and_the_scalars(tiny):
    cfg, _ = tiny
    full = get_config(ARCH)
    assert cfg.n_layers == 10 and cfg.hybrid_pattern == full.pattern
    assert cfg.hybrid_pattern.index("attn") == 5
    assert cfg.granite == full.granite


def test_forward_matches_the_reference(tiny):
    cfg, p = tiny
    tokens = torch.randint(0, cfg.vocab_size, (2, 37),
                           generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = Model(cfg).forward(p, {"tokens": tokens})
    for b in range(2):
        close(got[b], reference(cfg, p, tokens[b]))


def test_the_reference_forms_agree_and_a_bf16_state_breaks_them(tiny):
    cfg, p = tiny
    tokens = torch.randint(0, cfg.vocab_size, (40,),
                           generator=torch.Generator().manual_seed(2))
    quad = reference(cfg, p, tokens)
    close(reference(cfg, p, tokens, state_dtype=torch.float32), quad)
    bf16 = reference(cfg, p, tokens, state_dtype=torch.bfloat16)
    with pytest.raises(AssertionError):
        close(bf16, quad)


def test_engine_decode_matches_the_reference_across_a_refill(tiny):
    """Teacher-forced prompts and greedy tokens through the engine's
    ticks: every row the engine's argmax read equals the reference's full
    forward over that row's tokens up to its position, for a request
    that takes over a slot another one freed too."""
    cfg, p = tiny
    eng = LMServingEngine(cfg, p, max_batch=2, max_seq=32, device="cpu")
    requests = [([3, 1, 4, 1, 5], 3), ([9, 2, 6], 9), ([5, 3, 5, 8], 4)]
    ids = [eng.add_request(pr, max_new=n) for pr, n in requests[:2]]
    assert eng.add_request(*requests[2]) is None    # both slots busy
    rows = []
    refilled = False
    for _ in range(20):
        tokens = [s.tokens for s in eng.slots]
        done = eng.tick()
        last = eng.last_logits()
        rows += [(tokens[i], int(last.pos[i]), last.rows[i])
                 for i in range(2) if last.active[i]]
        if ids[0] in done and not refilled:
            ids.append(eng.add_request(requests[2][0],
                                       max_new=requests[2][1]))
            refilled = True
        if not any(s.active for s in eng.slots):
            break
    assert refilled and len(eng.run_to_completion()) == 0
    # the refilled request's rows are among those checked, from position 0
    assert sum(1 for t, pos, _ in rows if t[:4] == [5, 3, 5, 8]) == 7
    for tokens, pos, got in rows:
        want = reference(cfg, p, torch.tensor(tokens[:pos + 1]), [pos])[0]
        close(torch.from_numpy(got), want)


def test_engine_state_matches_the_reference_state(tiny):
    """The first Mamba layer's SSM state in the engine's decode cache
    after 40 teacher-forced tokens equals the reference's state after the
    same tokens, in its closed form and step by step in float32; carried
    in bfloat16, the reference's state breaks it (the benchmark's
    ``ssm_state_gap`` and its bf16-state control)."""
    cfg, p = tiny
    eng = LMServingEngine(cfg, p, max_batch=1, max_seq=64, device="cpu")
    prompt = torch.randint(0, cfg.vocab_size, (40,),
                           generator=torch.Generator().manual_seed(3))
    eng.add_request(prompt.tolist(), max_new=4)
    for _ in range(40):
        eng.tick()
    assert int(eng.last_logits().pos[0]) == 39
    first = cfg.hybrid_pattern.index("mamba")
    got = eng.decode_cache()[f"cache/hyb{first}_state"][0, 0]
    assert got.dtype == torch.float32
    pub, w = published(cfg), reference_weights(cfg, p)
    want = ref.mamba_state(pub, w, prompt, first)
    close(got, want)
    close(ref.mamba_state(pub, w, prompt, first, state_dtype=torch.float32),
          want)
    with pytest.raises(AssertionError):
        close(ref.mamba_state(pub, w, prompt, first,
                              state_dtype=torch.bfloat16), want)


def test_a_freed_slot_starts_its_next_request_from_zero_state(tiny):
    cfg, p = tiny
    eng = LMServingEngine(cfg, p, max_batch=1, max_seq=32, device="cpu")
    eng.add_request([7, 7, 7], max_new=2)
    eng.run_to_completion()
    for _ in range(2):                  # idle ticks step nothing
        eng.tick()
    dec = eng._decoders["default"]
    assert all(bool(dec.cache[k].abs().sum()) for k in dec.recurrent)
    eng.add_request([1, 2], max_new=1)
    assert dec.recurrent and all(not bool(dec.cache[k].abs().sum())
                                 for k in dec.recurrent)


def test_speculation_is_refused(tiny):
    """A Mamba-2 state absorbs every token, so a rejected draft could not
    be rolled back: the hybrid refuses ``spec=`` as every recurrent
    family does."""
    cfg, p = tiny
    with pytest.raises(ValueError, match="cannot be rolled back"):
        LMServingEngine(cfg, p, max_batch=1, max_seq=8, device="cpu",
                        spec=SpecConfig(k=2))


def test_cache_holds_two_kinds_of_state(tiny):
    cfg, _ = tiny
    specs = decode.cache_specs(cfg, 3, 24, "bfloat16")
    s = cfg.ssm
    heads = s.expand * cfg.d_model // s.head_dim
    conv = s.expand * cfg.d_model + 2 * s.n_groups * s.d_state
    for j, kind in enumerate(cfg.hybrid_pattern):
        pre = f"cache/hyb{j}_"
        if kind == "mamba":
            assert set(k for k in specs if k.startswith(pre)) == \
                {pre + "state", pre + "conv"}
            st, cv = specs[pre + "state"], specs[pre + "conv"]
            assert st.shape == (1, 3, heads, s.head_dim, s.d_state)
            assert st.dtype == "float32"
            assert cv.shape == (1, 3, s.d_conv - 1, conv)
            assert cv.dtype == "bfloat16"
        else:
            assert set(k for k in specs if k.startswith(pre)) == \
                {pre + "k", pre + "v"}
            for n in "kv":
                kv = specs[pre + n]
                assert kv.shape == (1, 3, 24, cfg.n_kv_heads, cfg.head_dim)
                assert kv.dtype == "bfloat16"


def spec_bytes(specs) -> int:
    size = {"float32": 4, "bfloat16": 2, "int32": 4}
    return sum(math.prod(s.shape) * size[s.dtype] for s in specs.values())


def test_state_bytes_at_the_published_widths(tiny):
    """128 slots of 8192 positions at full width: 143 546 368 bytes a
    slot (36 float32 SSM states of 64 x 64 x 128, 36 bf16 conv tails of 3
    x 4352, 4 layers of bf16 K and V of 8192 x 8 x 64); and a CPU
    engine's ``state_bytes`` is its cache's."""
    full = get_config(ARCH)
    per_slot = (36 * (64 * 64 * 128 * 4 + 3 * 4352 * 2)
                + 4 * 2 * 8192 * 8 * 64 * 2)
    assert per_slot == 143_546_368
    assert spec_bytes(decode.cache_specs(full, 128, 8192, "bfloat16")) == \
        128 * per_slot
    cfg, p = tiny
    eng = LMServingEngine(cfg, p, max_batch=3, max_seq=24,
                          cache_dtype="bfloat16", device="cpu")
    dec = eng._decoders["default"]
    assert dec.state_bytes == spec_bytes(
        decode.cache_specs(cfg, 3, 24, "bfloat16")) == sum(
            t.nbytes for t in dec.cache.values())
    assert dec.kv_len == 24


def test_specs_sum_to_the_published_parameter_count():
    cfg = get_config(ARCH)
    specs = Model(cfg).abstract_params()
    assert all(t.device.type == "meta" for t in specs.values())
    assert sum(t.numel() for t in specs.values()) == cfg.param_count() \
        == 3_191_396_096
    tiny = tiny_config(cfg)
    assert sum(t.numel() for t in Model(tiny).abstract_params().values()) \
        == tiny.param_count()


def test_the_benchmark_holds_the_same_reference_and_config():
    """The benchmark's configuration file has the registry's numbers
    under the published keys (its reference is the one these tests
    hold the port to)."""
    cfg = json.loads((ROOT / "perfbench/configs/granite-4.0-h-micro.json")
                     .read_text())
    for k, v in published(get_config(ARCH)).items():
        assert cfg[k] == v, k
