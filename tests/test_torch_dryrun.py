"""The dry run on torch's ``"fake"`` process group, on the CPU.

One subprocess group (``tests/torch_dist_worker.py``: five processes
started together, four ``dryrun`` processes, one arch each, each standing
for the 8 ranks of a (2, 4) ("data", "model") mesh, and the CLI): the counterpart of ``repro``'s
``test_tiny_cells_compile_on_mesh``.  The train step (backward and AdamW
included) and ``decode_step`` of tiny stablelm-3b, mamba2-780m,
qwen3-moe-30b-a3b and recurrentgemma-9b run on meta DTensors with no
allocation and give finite counts: argument bytes equal to the local
shards' bytes of the parameters plus the rest, a peak estimate at least
the arguments, global FLOPs equal to the per-device figure times 8, and
collectives with positive wire bytes.  The same processes check the
placements of a dim split over two mesh axes (``("pod", "data")``), that
a mesh of the wrong size is refused, and that ``FlopCounterMode`` entered
by itself counts a sharded product globally.  The CLI
(``python -m repro_torch.launch.dryrun``) runs a cell at full width on
the 256-rank production mesh.
"""

import json
import math

import pytest

torch = pytest.importorskip("torch")

from torch_dist_worker import run_together  # noqa: E402

ARCHS = ("stablelm-3b", "mamba2-780m", "qwen3-moe-30b-a3b",
         "recurrentgemma-9b")
CLI = ("--arch", "gemma-2b", "--shape", "decode_32k", "--mesh",
       "single_pod")


@pytest.fixture(scope="module")
def dry(tmp_path_factory):
    outs = [tmp_path_factory.mktemp("dry") for _ in range(len(ARCHS) + 1)]
    run_together([("dryrun", o, a) for o, a in zip(outs, ARCHS)]
                 + [("dryrun_cli", outs[-1]) + CLI])
    res = [json.loads((o / "dryrun.json").read_text()) for o in outs[:-1]]
    cells = {}
    for r in res:
        cells.update(r["cells"])
    fallback = {a: r["fallback_ops"] for a, r in zip(ARCHS, res)}
    cli = (json.loads((outs[-1] / "cli.json").read_text()),
           (outs[-1] / "cli.txt").read_text())
    return res[0], cells, cli, fallback


@pytest.mark.parametrize("kind", ["train", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_tiny_cell_runs_on_the_fake_mesh(dry, arch, kind):
    rec = dry[1][f"{arch}/{kind}"]
    mem, cost, coll = rec["memory"], rec["cost"], rec["collectives"]
    assert rec["params_all_meta_dtensors"]
    assert mem["argument_bytes"] > rec["params_local_bytes"] > 0
    assert mem["peak_is"] == "peak estimate"
    assert math.isfinite(mem["peak_bytes"])
    assert mem["peak_bytes"] >= mem["argument_bytes"]
    assert cost["flops_counted"] == "global"
    assert 0 < cost["flops"] < float("inf")
    assert cost["flops_per_device"] * 8 == cost["flops"]
    assert cost["bytes_accessed"] > 0
    assert 0 < coll["wire_bytes_per_device"] < float("inf")
    assert sum(coll["op_counts"].values()) > 0
    if kind == "train":
        # the backward reduces gradients into the sharded layout
        assert coll["op_counts"].get("reduce-scatter", 0) > 0


def test_missing_strategy_gets_the_replicate_fallback(dry):
    """mamba2-780m's process ran on a DTensor without a ``flip``
    strategy: ``ensure_strategies`` gave it the replicate fallback and the
    train cell (cumsum's backward flips) ran."""
    assert "flip.default" in dry[3]["mamba2-780m"]
    assert dry[1]["mamba2-780m/train"]["cost"]["flops"] > 0
    assert all("flip.default" not in v for k, v in dry[3].items()
               if k != "mamba2-780m")


def test_placements_and_mesh_size(dry):
    res = dry[0]
    assert res["pod_placements_ok"], res["pod_placements"]
    assert res["wrong_size_refused"]


def test_flop_counter_counts_the_global_product(dry):
    assert dry[0]["product_flops"] == 2 * 64 * 128 * 256


def test_cli_runs_a_full_width_cell(dry):
    recs, stdout = dry[2]
    assert "1 ok, 0 skipped, 0 failed" in stdout
    rec = recs[0]
    assert rec["mesh"] == "single_pod" and rec["kind"] == "decode"
    # one rank's shard of gemma-2b's params plus its cache shard
    assert 0 < rec["memory"]["argument_bytes"] < 2 * 2 ** 30
    assert rec["cost"]["flops_per_device"] * 256 == rec["cost"]["flops"]
