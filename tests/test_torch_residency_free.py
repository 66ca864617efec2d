"""The residency cache holds its sources weakly, on the CPU.

A dropped model's source tensors must die at once (a ``weakref`` to each
goes dead with the cycle collector off) while ``ops.RESIDENT_WEIGHTS``
still holds other entries: whether its packs copied the sources
(``resident_fused``, bf16 -> f32 scan weights), handed back a view of one
(``resident_matrix``'s reshape, ``pack_decode_params``' norm slices) or a
source itself (the f32 scan weights' no-op pack).  The cache's bytes fall
by the dropped entries' bytes, and a pack that hands back its sources
still returns the same container while its caller keeps it.
"""

import gc
import weakref

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import decode_step as tds  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.schedule import KernelSchedule  # noqa: E402
from repro_torch.models.decode import pack_decode_params  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.registry import get_config  # noqa: E402
from repro_torch.testing import tiny_config  # noqa: E402


@pytest.fixture
def no_gc():
    gc.collect()
    gc.disable()
    try:
        yield
    finally:
        gc.enable()


def _model_packs(params, cfg, sched):
    """Every kind of pack over ``params``: views, copies, the LM layout,
    identity and cast scan weights."""
    w = params["decoder/attn/wq"]
    packs = [tds.resident_matrix(w, schedule=sched, tag="free"),
             tds.resident_matrix(params["decoder/mlp/w_up"][0],
                                 schedule=sched, tag="free0"),
             tds.resident_fused((params["decoder/mlp/w_gate"][0],
                                 params["decoder/mlp/w_up"][0]),
                                schedule=sched, tag="free"),
             pack_decode_params(cfg, params)]
    g = torch.Generator().manual_seed(1)
    W, U, b = (torch.randn(s, generator=g) for s in ((6, 32), (8, 32), (32,)))
    packs.append(ops._scan_weights_resident("lstm", W, U, b))
    packs.append(ops._scan_weights_resident(
        "gru", W.bfloat16(), U.bfloat16(), b))
    return packs, [W, U, b]


def test_dropped_sources_die_while_other_entries_stay(no_gc):
    cache = ops.RESIDENT_WEIGHTS
    sched = KernelSchedule(reuse_factor=2)
    keep = torch.randn(16, 8, generator=torch.Generator().manual_seed(2))
    kept = tds.resident_matrix(keep, schedule=sched, tag="keep")

    cfg = tiny_config(get_config("gemma-2b"))
    params = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    before = cache.bytes
    packs, scan_w = _model_packs(params, cfg, sched)
    assert cache.bytes > before
    n_model = len(cache)
    # a pack that hands back its sources returns the same container
    assert all(p is s for p, s in zip(packs[4], scan_w))
    assert ops._scan_weights_resident("lstm", *scan_w) is packs[4]
    # a view pack comes back as itself on a hit
    assert tds.resident_matrix(params["decoder/attn/wq"], schedule=sched,
                               tag="free") is packs[0]

    refs = [weakref.ref(t) for t in list(params.values()) + scan_w]
    del params, packs, scan_w
    dead = [r() is None for r in refs]
    assert all(dead), f"{dead.count(False)} of {len(refs)} sources alive"
    assert cache.bytes == before
    assert len(cache) < n_model
    # the other model's entry is still there, and still a hit
    hits = cache.hits
    assert tds.resident_matrix(keep, schedule=sched, tag="keep") is kept
    assert cache.hits == hits + 1


def test_a_view_pack_keeps_the_storage_not_the_source(no_gc):
    """The cached layout of a view pack reads the source's memory (an
    in-place update repacks, as before) without referencing the source
    object."""
    sched = KernelSchedule(reuse_factor=4)
    w = torch.arange(24, dtype=torch.float32).reshape(2, 3, 4)
    a = tds.resident_matrix(w, schedule=sched, tag="view")
    assert a._base is None
    assert a.untyped_storage().data_ptr() == w.untyped_storage().data_ptr()
    assert torch.equal(a, w.reshape(2, 12))
    r = weakref.ref(w)
    del w
    assert r() is None
    assert a.sum().item() == sum(range(24))
