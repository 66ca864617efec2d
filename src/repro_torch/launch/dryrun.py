"""Multi-pod dry run: run every (arch x shape) cell's real step on the
production mesh with no allocation, and record what it would hold,
compute and send per device.

The port of ``repro/launch/dryrun.py``.  One process stands for every rank:
torch's ``"fake"`` process-group backend (``FakeStore``, world size 256 or
512) carries a ``DeviceMesh`` of ``repro``'s production shape, the
parameters, optimizer state and inputs are DTensors on the ``meta`` device
(no storage; ``Model.abstract_params``, ``launch/inputs.py``), and the
cell's step runs as it would on the cards: the train step with its
backward and AdamW update, prefill (forward + last-position logits), or
``decode_step``.  Under ``implicit_replication`` a plain tensor the model
makes (positions, masks) counts as replicated.  Per cell it records:

  * ``memory``: the argument bytes per device (the local shards of the
    parameters, optimizer state and batch or caches; the first two also
    apart: ``params_bytes``, ``opt_state_bytes``) and a ``peak_bytes``
    "peak estimate": the most bytes of local tensors alive at once while
    the step ran (``LiveBytes``, a dispatch mode that tracks each output's
    storage until it dies; a new peak is read after dropping the dead);
  * ``cost.bytes_accessed``: the bytes every local op reads and writes,
    one rank's (unfused eager ops, ``LiveBytes`` again): the roofline's
    memory term;
  * ``cost``: the FLOPs of ``torch.utils.flop_counter.FlopCounterMode``.
    Which FLOPs it counts depends on where it sits among the dispatch
    modes: entered last (on top) it sees each DTensor op before DTensor
    splits it and counts the GLOBAL op; below a mode that defers DTensor
    ops it would see one rank's local ops instead (checked: a product
    sharded over 8 ranks counts its whole 2·m·n·k on top, one shard's
    below).  ``run_cell`` enters it last: ``flops`` is the global count
    and ``flops_per_device`` divides it by the mesh size explicitly;
  * ``collectives``: the collectives DTensor issued, by kind, with their
    per-device wire bytes (``comm_analysis``, ``CommDebugMode``'s trace).

Two deliberate differences from ``repro``: no probe extrapolation
(``repro``'s ``_extrapolate_cost`` / ``probe_layers`` exist because XLA's
cost analysis counts a ``while`` body once; here every layer runs in
Python, so the count is direct), and no halving of bytes for bf16 archs
(``roofline.py`` halves them only to undo XLA's CPU backend's f32
legalization; the port's meta tensors carry their real dtype).

Usage (no card needed):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b \\
      --shape train_4k --mesh single_pod [--out results/dryrun_torch.json]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.config import (SHAPES, ModelConfig, OptimizerConfig,
                                ShapeConfig, TrainConfig, cell_applicable)
from repro_torch.launch.comm_analysis import CollectiveRecorder, analyze_comm
from repro_torch.launch.inputs import batch_specs, decode_input_specs
from repro_torch.launch.mesh import make_mesh, production_shape
from repro_torch.models.decode import decode_step
from repro_torch.models.init import meta_tensor, param_shardings
from repro_torch.models.model import build_model
from repro_torch.models.transformer import forward as tf_forward, logits_fn
from repro_torch.registry import ASSIGNED_ARCHS, get_config
from repro_torch.sharding.api import sharding_context
from repro_torch.sharding.auto import auto_overrides, dp_size
from repro_torch.training.optimizer import OptState
from repro_torch.training.train_step import make_train_step


def fake_world(world_size: int) -> None:
    """Start (or keep) a one-process ``"fake"`` process group of
    ``world_size`` ranks: collectives return at once, nothing is sent.
    The group is global to the process."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def dryrun_mesh(shape, axes):
    """A ``DeviceMesh`` of ``shape`` on a fake group of its size."""
    fake_world(math.prod(shape))
    return make_mesh(shape, axes, device_type="cpu")


def _local(t: torch.Tensor) -> torch.Tensor:
    return getattr(t, "_local_tensor", t)


def _local_bytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        t = _local(tree)
        return t.numel() * t.element_size()
    if isinstance(tree, dict):
        return sum(_local_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_local_bytes(v) for v in tree)
    return 0


class LiveBytes(TorchDispatchMode):
    """Peak estimate: the most bytes of local tensors (one rank's shards)
    alive at once.  Every op's outputs are noted by storage; a storage
    leaves the count when it dies.  Ops on DTensors return
    ``NotImplemented`` first, so the mode sees the local ops DTensor runs
    (and its collectives' buffers)."""

    def __init__(self, args=()):
        super().__init__()
        from torch.multiprocessing.reductions import StorageWeakRef

        self._ref = StorageWeakRef
        self.paused = 0
        self.live: Dict[int, tuple] = {}
        self.bytes = 0
        self.accessed = 0
        self._add(args)
        self.start_bytes = self.bytes
        self.peak = self.bytes
        self._since = 0

    def _add(self, tree) -> None:
        if isinstance(tree, torch.Tensor):
            t = _local(tree)
            st = t.untyped_storage()
            key = st._cdata
            old = self.live.get(key)
            if old is not None and old[0].expired():   # an address reused
                self.bytes -= old[1]
                old = None
            if old is None:
                self.live[key] = (self._ref(st), st.nbytes())
                self.bytes += st.nbytes()
        elif isinstance(tree, dict):
            for v in tree.values():
                self._add(v)
        elif isinstance(tree, (list, tuple)):
            for v in tree:
                self._add(v)

    @contextlib.contextmanager
    def outside_propagation(self):
        """Leave out the ops DTensor's sharding propagation runs on its
        global-shape meta stand-ins (``_propagate_tensor_meta_non_cached``:
        no rank holds those tensors).  Where this torch has no such
        method, nothing is left out."""
        from torch.distributed.tensor import DTensor

        prop = DTensor._op_dispatcher.sharding_propagator
        name = "_propagate_tensor_meta_non_cached"
        orig = getattr(prop, name, None)
        if orig is None:
            yield
            return

        def paused(*a, **kw):
            self.paused += 1
            try:
                return orig(*a, **kw)
            finally:
                self.paused -= 1

        setattr(prop, name, paused)
        try:
            yield
        finally:
            delattr(prop, name)

    def _sweep(self) -> None:
        for key in [k for k, (r, _) in self.live.items() if r.expired()]:
            self.bytes -= self.live.pop(key)[1]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if self.paused:
            return out
        self.accessed += _local_bytes(args) + _local_bytes(out)
        self._since += 1
        if self._since >= max(16, len(self.live) // 8):
            self._since = 0
            self._sweep()
        self._add(out)
        if self.bytes > self.peak:
            self._sweep()      # a new peak counts live storages only
            self.peak = max(self.peak, self.bytes)
        return out


def _abstract_opt_state(aparams, state_dtype: str = "float32") -> OptState:
    dt = getattr(torch, state_dtype)
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device="meta"),
        m={k: torch.zeros_like(v, dtype=dt) for k, v in aparams.items()},
        v={k: torch.zeros_like(v, dtype=dt) for k, v in aparams.items()},
    )


def pick_accum(cfg: ModelConfig, shape: ShapeConfig, mesh) -> int:
    """Largest accum <= cfg.grad_accum dividing the per-replica batch."""
    per = max(shape.global_batch // max(dp_size(mesh), 1), 1)
    a = min(cfg.grad_accum, per)
    while per % a:
        a -= 1
    return max(a, 1)


def cell_step(cfg: ModelConfig, shape: ShapeConfig, mesh,
              grad_accum: Optional[int] = None):
    """(step thunk, its arguments) of one cell, under an active sharding
    context on ``mesh`` (the caller's); a train cell accumulates over
    ``grad_accum`` microbatches (default ``pick_accum``, as ``repro``'s
    dry run; the trainer's own step takes 1)."""
    from repro_torch.sharding.api import current_context

    ctx = current_context()
    model = build_model(cfg)
    aparams = model.abstract_params(ctx)
    kind = shape.kind
    if kind == "train":
        accum = grad_accum or pick_accum(cfg, shape, mesh)
        # >100B params: bf16 optimizer moments + bf16 grad accumulation, as
        # repro's dry run
        big = cfg.param_count() > 100e9
        tc = TrainConfig(optimizer=OptimizerConfig(
            state_dtype="bfloat16" if big else "float32"))
        # donate=True: the update in place, the port of repro's
        # donate_argnums=(0, 1) (the state is held once)
        step = make_train_step(
            model, tc, grad_accum=accum,
            accum_dtype="bfloat16" if big else "float32",
            grad_shardings=param_shardings(model.param_specs(), ctx),
            donate=True)
        aopt = _abstract_opt_state(aparams, tc.optimizer.state_dtype)
        batch = batch_specs(cfg, shape, ctx)
        return (lambda: step(aparams, aopt, batch)), (aparams, aopt, batch)
    if kind == "prefill":
        batch = batch_specs(cfg, shape, ctx)

        def prefill():
            hidden, _ = tf_forward(cfg, aparams, batch["tokens"], train=False,
                                   img_embeds=batch.get("img_embeds"),
                                   frame_embeds=batch.get("frame_embeds"))
            return logits_fn(cfg, aparams, hidden[:, -1:])

        return prefill, (aparams, batch)
    cache, tokens, pos = decode_input_specs(cfg, shape, ctx)
    return ((lambda: decode_step(cfg, aparams, cache, tokens, pos)),
            (aparams, cache, tokens, pos))


def run_cell(cfg: ModelConfig, shape: ShapeConfig, mesh,
             grad_accum: Optional[int] = None) -> Dict:
    """Run one cell's step on meta DTensors under the three counters."""
    from torch.distributed.tensor.experimental import implicit_replication
    from torch.utils.flop_counter import FlopCounterMode

    overrides = auto_overrides(cfg, mesh, shape)
    with sharding_context(mesh, cfg.family, shape.kind, overrides):
        fn, args = cell_step(cfg, shape, mesh, grad_accum)
        arg_bytes = _local_bytes(args)
        opt = args[1] if shape.kind == "train" else None
        flops = FlopCounterMode(display=False)
        comm = CollectiveRecorder()
        live = LiveBytes(args)
        # the FLOP counter is entered last, so it sees each DTensor op
        # before DTensor splits it (a global count); the two modes below
        # it see the local ops and collectives DTensor issues
        with implicit_replication(), live.outside_propagation(), comm, \
                live, flops:
            out = fn()
        live._sweep()
        del out
    return {"argument_bytes": arg_bytes, "params_bytes": _local_bytes(args[0]),
            "opt_state_bytes": _local_bytes(opt) if opt else 0,
            "peak_bytes": live.peak,
            "bytes_accessed": live.accessed,
            "flops": float(flops.get_total_flops()), "comm": analyze_comm(comm)}


def cell_record(cfg: ModelConfig, shape: ShapeConfig, mesh,
                mesh_name: str, grad_accum: Optional[int] = None) -> Dict:
    t0 = time.time()
    rec: Dict = {"arch": cfg.name, "shape": shape.name, "mesh": mesh_name,
                 "kind": shape.kind}
    r = run_cell(cfg, shape, mesh, grad_accum)
    rec["run_s"] = round(time.time() - t0, 1)
    n = math.prod(mesh.mesh.shape)
    rec["memory"] = {"argument_bytes": r["argument_bytes"],
                     "params_bytes": r["params_bytes"],
                     "opt_state_bytes": r["opt_state_bytes"],
                     "peak_bytes": r["peak_bytes"],
                     "peak_is": "peak estimate"}
    rec["cost"] = {"flops": r["flops"], "flops_counted": "global",
                   "flops_per_device": r["flops"] / n,
                   "bytes_accessed": r["bytes_accessed"]}
    ca = r["comm"]
    rec["collectives"] = {"wire_bytes_per_device": ca.total_wire_bytes,
                          "by_kind": ca.by_kind(),
                          "op_counts": ca.op_counts()}
    return rec


def run_cells(archs, shapes, meshes, out_path: Optional[str]):
    results = []
    if out_path and os.path.exists(out_path):
        with open(out_path) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"]) for r in results}

    for mesh_name in meshes:
        mesh = dryrun_mesh(*production_shape(mesh_name == "multi_pod"))
        for arch in archs:
            cfg = get_config(arch)
            for shape_name in shapes:
                shape = SHAPES[shape_name]
                key = (cfg.name, shape.name, mesh_name)
                if key in done:
                    continue
                ok, why = cell_applicable(cfg, shape)
                if not ok:
                    rec = {"arch": cfg.name, "shape": shape.name,
                           "mesh": mesh_name, "skipped": why}
                else:
                    print(f"[dryrun] {cfg.name} x {shape.name} x {mesh_name} "
                          f"...", flush=True)
                    try:
                        rec = cell_record(cfg, shape, mesh, mesh_name)
                        print(f"  ok in {rec['run_s']}s  peak estimate="
                              f"{rec['memory']['peak_bytes'] / 2 ** 30:.2f}"
                              f"GiB  wire="
                              f"{rec['collectives']['wire_bytes_per_device'] / 2 ** 20:.1f}"
                              f"MiB", flush=True)
                    except Exception as e:
                        rec = {"arch": cfg.name, "shape": shape.name,
                               "mesh": mesh_name,
                               "error": f"{type(e).__name__}: {e}",
                               "traceback": traceback.format_exc()[-2000:]}
                        print(f"  FAIL: {rec['error'][:200]}", flush=True)
                results.append(rec)
                if out_path:
                    os.makedirs(os.path.dirname(out_path) or ".",
                                exist_ok=True)
                    with open(out_path + ".tmp", "w") as f:
                        json.dump(results, f, indent=1)
                    os.replace(out_path + ".tmp", out_path)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["single_pod", "multi_pod", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    archs = ASSIGNED_ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = (["single_pod", "multi_pod"] if args.mesh == "both"
              else [args.mesh])
    results = run_cells(archs, shapes, meshes, args.out)
    n_ok = sum(1 for r in results if "memory" in r)
    n_skip = sum(1 for r in results if "skipped" in r)
    n_err = sum(1 for r in results if "error" in r)
    print(f"[dryrun] done: {n_ok} ok, {n_skip} skipped, {n_err} failed")
    if not args.out:
        print(json.dumps(results, indent=1)[:4000])
    return results


if __name__ == "__main__":
    main()
