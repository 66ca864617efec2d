"""Multi-rank scenarios of the port on the CPU (gloo), for the tests.

``python tests/torch_dist_worker.py SCENARIO OUT_DIR`` spawns the ranks of
one scenario on ``tcp://localhost`` and writes each rank's results under
OUT_DIR (``rank{r}.json`` / ``rank{r}.npz``):

  * ``sharded`` (8 ranks, a (2, 4) mesh): tiny stablelm-3b's loss with
    DTensor parameters and batch against the unsharded loss, the trainer
    with ``mesh_shape=(2, 4)`` against the unsharded trainer, and a
    ``restore(shardings=)`` round trip of its checkpoint;
  * ``pipeline`` (4 ranks): ``pipelined_rnn`` of the top-tagging LSTM and
    GRU, plain and hoisted, on OUT_DIR/inputs.npz;
  * ``dryrun ARCH...`` (one process standing for 8 ranks, the ``"fake"``
    backend): the dry run of each tiny arch's train and decode cells on a
    (2, 4) mesh (with mamba2-780m, on a DTensor stripped of its ``flip``
    strategy, as torch 2.11's), the placements of a (2, 2, 2) pod mesh,
    where the FLOP counter counts, into ``dryrun.json``;
  * ``dryrun_cli ARGS...``: ``python -m repro_torch.launch.dryrun ARGS``
    with ``--out OUT_DIR/cli.json``, its stdout in ``cli.txt``.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

WORLD = {"sharded": 8, "pipeline": 4}


def _sharded(rank: int, out: Path) -> None:
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import train
    from repro_torch.models.init import param_shardings
    from repro_torch.models.model import build_model
    from repro_torch.registry import get_config
    from repro_torch.sharding.api import NamedSharding, sharding_context
    from repro_torch.sharding.auto import auto_overrides
    from repro_torch.testing import tiny_config

    res = {}
    cfg = tiny_config(get_config("stablelm-3b"))
    m = build_model(cfg)
    params = m.init(torch.Generator().manual_seed(0), "cpu")
    batch = {"tokens": torch.from_numpy(np.random.RandomState(0)
                                        .randint(0, 200, (8, 32))),
             "labels": torch.from_numpy(np.random.RandomState(1)
                                        .randint(0, 200, (8, 32)))}
    l0, _ = m.loss(params, batch)

    mesh = make_mesh((2, 4), ("data", "model"), device_type="cpu")
    ov = auto_overrides(cfg, mesh)
    with sharding_context(mesh, cfg.family, "train", ov) as ctx:
        sh = param_shardings(m.param_specs(), ctx)
        dp = {k: sh[k].distribute(v) for k, v in params.items()}
        db = {k: NamedSharding.of(mesh, ctx.pspec(("batch", None)))
              .distribute(v) for k, v in batch.items()}
        with implicit_replication():
            l1, _ = m.loss(dp, db)
        res["placements"] = {k: [str(p) for p in v.placements]
                             for k, v in dp.items()}
    res["loss_single"] = float(l0)
    res["loss_sharded"] = float(l1.full_tensor())

    kw = dict(steps=2, batch=8, seq_len=32, tiny=True, device="cpu",
              log_every=1)
    _, want = train("stablelm-3b", **kw)
    ckpt_dir = str(out / "ckpt")
    tp, got = train("stablelm-3b", mesh_shape=(2, 4),
                    checkpoint_dir=ckpt_dir, **kw)
    res["train_single"], res["train_sharded"] = want, got
    res["trained_dtensors"] = all(isinstance(v, DTensor)
                                  for v in tp.values())
    dist.barrier()
    with sharding_context(mesh, cfg.family, "train", ov) as ctx:
        sh = param_shardings(m.param_specs(), ctx)
    step, rp, opt = CheckpointManager(ckpt_dir).restore(device="cpu",
                                                        shardings=sh)
    res["restored_step"] = step
    res["restored_equal"] = all(
        isinstance(rp[k], DTensor)
        and tuple(rp[k].placements) == sh[k].placements
        and torch.equal(rp[k].full_tensor(), tp[k].full_tensor())
        for k in tp)
    res["restored_opt_sharded"] = all(
        tuple(opt["m"][k].placements) == sh[k].placements for k in tp)
    (out / f"rank{rank}.json").write_text(json.dumps(res))


def _pipeline(rank: int, out: Path) -> None:
    from repro_torch.core.rnn.pipeline import pipelined_rnn
    from repro_torch.registry import get_config

    data = np.load(out / "inputs.npz")
    res = {}
    for arch in ("top-tagging-lstm", "top-tagging-gru"):
        r = get_config(arch).rnn
        xs, W, U, b = (torch.from_numpy(data[f"{arch}/{n}"])
                       for n in ("xs", "W", "U", "b"))
        for hoist in (False, True):
            o = pipelined_rnn(r, xs, W, U, b, hoist_input=hoist)
            res[f"{arch}/{'hoist' if hoist else 'plain'}"] = o.numpy()
    np.savez(out / f"rank{rank}.npz", **res)


def _dryrun(out: Path, archs) -> None:
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.config import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import build_model
    from repro_torch.registry import get_config
    from repro_torch.sharding.api import placements, sharding_context
    from repro_torch.testing import tiny_config

    from repro_torch.sharding.api import ensure_strategies

    res = {"cells": {}}
    if "mamba2-780m" in archs:
        # a torch whose DTensor has no strategy for flip (2.11), which
        # cumsum's backward in mamba2's train step calls
        prop = DTensor._op_dispatcher.sharding_propagator
        for table in (prop.op_strategy_funcs,
                      getattr(prop, "op_single_dim_strategy_funcs", {})):
            table.pop(torch.ops.aten.flip.default, None)
    mesh = dryrun.dryrun_mesh((2, 4), ("data", "model"))
    for arch in archs:
        cfg = tiny_config(get_config(arch))
        for shape in (ShapeConfig("t", 32, 8, "train"),
                      ShapeConfig("d", 32, 8, "decode")):
            rec = dryrun.cell_record(cfg, shape, mesh, "tiny")
            with sharding_context(mesh, cfg.family, shape.kind) as ctx:
                ap = build_model(cfg).abstract_params(ctx)
            rec["params_local_bytes"] = sum(
                v._local_tensor.numel() * v.element_size()
                for v in ap.values())
            rec["params_all_meta_dtensors"] = all(
                isinstance(v, DTensor) and v._local_tensor.device.type
                == "meta" for v in ap.values())
            res["cells"][f"{arch}/{shape.kind}"] = rec

    pod = make_mesh((2, 2, 2), ("pod", "data", "model"), device_type="cpu")
    res["fallback_ops"] = list(ensure_strategies())
    res["pod_placements"] = [str(p) for p in placements(
        pod, (("pod", "data"), None, "model"))]
    res["pod_placements_ok"] = placements(
        pod, (("pod", "data"), None, "model")) == (Shard(0), Shard(0),
                                                   Shard(2)) and \
        placements(pod, (None, "data")) == (Replicate(), Shard(1),
                                            Replicate())
    try:
        make_mesh((2, 2), ("data", "model"), device_type="cpu")
        res["wrong_size_refused"] = False
    except RuntimeError:
        res["wrong_size_refused"] = True

    # where FlopCounterMode counts: a product sharded over the 8 ranks
    a = DTensor.from_local(torch.empty(32, 128, device="meta"), mesh,
                           [Shard(0), Replicate()], run_check=False,
                           shape=(64, 128), stride=(128, 1))
    w = DTensor.from_local(torch.empty(128, 64, device="meta"), mesh,
                           [Replicate(), Shard(1)], run_check=False,
                           shape=(128, 256), stride=(256, 1))
    with FlopCounterMode(display=False) as fc:
        a @ w
    res["product_flops"] = fc.get_total_flops()
    (out / "dryrun.json").write_text(json.dumps(res, default=str))


def _rank(rank: int, scenario: str, port: int, out: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=WORLD[scenario], rank=rank)
    try:
        {"sharded": _sharded, "pipeline": _pipeline}[scenario](
            rank, Path(out))
    finally:
        dist.destroy_process_group()


def main(scenario: str, out: str, *rest) -> None:
    if scenario == "dryrun":
        _dryrun(Path(out), rest)
        return
    if scenario == "dryrun_cli":
        r = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", *rest,
             "--out", str(Path(out) / "cli.json")], cwd=ROOT,
            capture_output=True, text=True, timeout=200)
        (Path(out) / "cli.txt").write_text(r.stdout)
        sys.stderr.write(r.stderr[-3000:])
        sys.exit(r.returncode)
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    mp.spawn(_rank, args=(scenario, port, out), nprocs=WORLD[scenario])


def run(scenario: str, out, *args) -> None:
    """Run ``scenario`` in a subprocess (a process group is global to its
    process) writing under ``out``; fail with its stderr if it fails."""
    run_together([(scenario, out) + args])


def run_together(calls) -> None:
    """Start every (scenario, out, *args) of ``calls`` at once, each in a
    subprocess, and wait for all; fail with the first failure's stderr."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__] + [str(a) for a in call], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for call in calls]
    errs = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            p.kill()
            _, err = p.communicate()
        errs.append((p.returncode, err))
    for rc, err in errs:
        assert rc == 0, err[-4000:]


if __name__ == "__main__":
    main(*sys.argv[1:])
