"""Fault-tolerant checkpointing: atomic writes, manifest integrity, restore
onto another device.

The port of ``repro.checkpoint.manager``, in its on-disk format exactly, so
a checkpoint written by either package restores in the other:

  <dir>/step_000123/
    manifest.json            — step, array paths, shapes, dtypes, crc32s
    <tree>__<flatkey>.npy    — full arrays (tree: params | opt_m | opt_v)

bfloat16 is stored as its raw bits (uint16) under the logical dtype
``"bfloat16"`` and restored by viewing the bits as ``torch.bfloat16`` (no
``ml_dtypes``).  A save is published atomically (temp dir -> fsync ->
rename).  ``restore(device=...)`` places the arrays;
``restore(shardings=...)`` (path -> ``sharding.api.NamedSharding``, for
the params and both moments) returns DTensors with those placements, each
rank keeping its shard of the full, mesh-agnostic array, as ``repro``
``device_put``s onto the restore mesh.  A checkpoint of a sharded run
holds full arrays (the trainer gathers them before ``save``).
"""

from __future__ import annotations

import json
import os
import shutil
import zlib
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch


def _flat(k: str) -> str:
    return k.replace("/", "__")


def _to_numpy(v) -> Tuple[np.ndarray, str]:
    """A tensor or array as the numpy array to store, and its logical
    dtype."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        if v.dtype == torch.bfloat16:
            return v.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        v = v.numpy()
    arr = np.asarray(v)
    if arr.dtype.kind == "V" or "bfloat16" in str(arr.dtype):
        return arr.view(np.uint16), "bfloat16"
    return arr, str(arr.dtype)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    # -- paths ---------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:09d}")

    def latest_step(self) -> Optional[int]:
        steps = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                manifest = os.path.join(self.dir, name, "manifest.json")
                if os.path.exists(manifest):
                    steps.append(int(name[5:]))
        return max(steps) if steps else None

    # -- save ------------------------------------------------------------------
    def save(self, step: int, params: Dict, opt_state=None,
             extra: Optional[Dict] = None) -> str:
        final = self._step_dir(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)

        manifest = {"step": step, "arrays": {}, "extra": extra or {}}
        trees = {"params": params}
        if opt_state is not None:
            trees["opt_m"] = opt_state.m
            trees["opt_v"] = opt_state.v
            manifest["opt_step"] = int(opt_state.step)

        for tree_name, tree in trees.items():
            for k, v in tree.items():
                arr, logical_dtype = _to_numpy(v)
                key = f"{tree_name}__{_flat(k)}"
                np.save(os.path.join(tmp, key + ".npy"), arr)
                manifest["arrays"][key] = {
                    "tree": tree_name, "key": k,
                    "shape": list(arr.shape), "dtype": logical_dtype,
                    "crc": zlib.crc32(arr.tobytes()) & 0xFFFFFFFF,
                }

        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)          # atomic publish
        self._gc()
        return final

    def _gc(self):
        steps = sorted(
            int(n[5:]) for n in os.listdir(self.dir)
            if n.startswith("step_") and not n.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # -- restore ---------------------------------------------------------------
    def restore(self, step: Optional[int] = None,
                shardings: Optional[Dict] = None,
                verify: bool = True,
                device: Union[str, torch.device] = "cuda",
                ) -> Tuple[int, Dict, Optional[Dict]]:
        """Returns (step, params, opt dict or None), every array a tensor on
        ``device`` (the card unless the caller asks for the CPU); a key
        that ``shardings`` names is a DTensor with its placements."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)

        trees: Dict[str, Dict] = {"params": {}, "opt_m": {}, "opt_v": {}}
        for key, info in manifest["arrays"].items():
            arr = np.load(os.path.join(d, key + ".npy"))
            if verify:
                crc = zlib.crc32(arr.tobytes()) & 0xFFFFFFFF
                if crc != info["crc"]:
                    raise IOError(f"checksum mismatch for {key} "
                                  f"(corrupt checkpoint {d})")
            if info["dtype"] == "bfloat16" and arr.dtype == np.uint16:
                v = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                v = torch.from_numpy(arr)
            v = v.to(device)
            sh = (shardings or {}).get(info["key"])
            trees[info["tree"]][info["key"]] = (
                sh.distribute(v) if sh is not None else v)

        opt = None
        if trees["opt_m"]:
            opt = {"m": trees["opt_m"], "v": trees["opt_v"],
                   "step": manifest.get("opt_step", step)}
        return step, trees["params"], opt
