"""Persistent compile cache: zero-warmup serving for the port's engines.

The first request of a ``(schedule_key, batch shape)`` pair pays for
everything its path needs before a kernel can run: ``nvcc`` for each CUDA
library it launches (seconds, where the library is not built yet),
loading each library, and the card's residency queries that pick the
launch layout of each scan (``scan_layout.card_layout``).  The JAX package
closes the same cliff by serializing XLA executables; the port has no
executable to serialize (its executors are Python closures over kernels),
so an entry holds what a first request pays for and a later process can
reuse:

  * the CUDA libraries the path launches, by content hash (a copy of each
    ``lib<name>-<hash>.so`` is kept beside the entries, so a checkout
    whose ``build/kernels`` lacks it loads it without ``nvcc``), and the C
    entry points it calls;
  * the launch layouts its shapes resolve to (``card_layout``'s arguments
    and answer), which a warm hit seeds (``scan_layout.SEEDED``), so the
    card is asked nothing;
  * nothing that is a result.

:class:`CompileCache` keeps the entries in a directory, one JSON file per
content hash of ``{torch / CUDA / toolkit versions, platform, card, kernel
sources, cfg, schedule and fp axes, argument shapes}``; a change of any of
these misses.  :class:`CachedExecutor` wraps one executor and readies each
argument-shape signature once: warm from an entry (no ``nvcc``, no
residency query, no executor build counted) or cold (the executor's build
is counted once, the call runs inside ``cuda.recording`` and what it used
is stored).  :meth:`CachedExecutor.warm` readies a signature without
running a request: cold, it runs the executor once on zeros inside a dry
``cuda.recording`` (libraries built and loaded, layouts resolved, no
kernel launched).  A load failure (a corrupted or stale file) warns once,
quarantines the entry and costs one cold build of the same kernels: the
kernels still launch, and ``errors`` / ``quarantined`` count it.  Writes
are safe for N replicas sharing one directory: temp file, then
``os.replace``.

Per-key cold / warm counters feed the engines' ``serve_report`` (the
``compile`` column: hit rate and the first cold signature's seconds).
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import time
import uuid
import warnings
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.kernels import cuda
from repro_torch.kernels import scan_layout

#: bump to invalidate every existing cache entry (entry layout)
_FORMAT_VERSION = 1

#: file suffix of an entry (``serving.faults.corrupt_cache_entries``
#: matches it)
CACHE_SUFFIX = ".torchcache"

Device = Union[str, torch.device, None]


def _toolkit_version() -> str:
    """The CUDA toolkit's version from its ``version.json`` (read, so that
    no ``nvcc`` runs), or "none"."""
    home = Path(os.environ.get("CUDA_HOME") or "/usr/local/cuda")
    try:
        doc = json.loads((home / "version.json").read_text())
        return str(doc["cuda"]["version"])
    except (OSError, ValueError, KeyError, TypeError):
        return "none"


def _env_meta(device: Device = None) -> Dict[str, str]:
    """The toolchain axes that invalidate an entry: torch, its CUDA, the
    toolkit that builds the kernels, the platform, the card (name and
    compute capability) and the kernel sources; "cpu" where the engine
    serves on the CPU."""
    dev = torch.device(device) if device is not None else torch.device(
        "cuda" if torch.cuda.is_available() else "cpu")
    meta = {
        "format": str(_FORMAT_VERSION),
        "torch": torch.__version__,
        "torch_cuda": str(torch.version.cuda),
        "toolkit": _toolkit_version(),
        "platform": dev.type,
        "kernels": cuda.sources_digest(),
    }
    if dev.type == "cuda":
        idx = dev.index if dev.index is not None \
            else torch.cuda.current_device()
        meta.update(n_devices=str(torch.cuda.device_count()),
                    device_kind=torch.cuda.get_device_name(idx),
                    capability="%d.%d" % torch.cuda.get_device_capability(
                        idx))
    else:
        meta.update(n_devices="0", device_kind="cpu", capability="none")
    return meta


def fingerprint(meta: Dict[str, Any]) -> str:
    """Stable content hash of an entry's metadata (sorted-key JSON)."""
    blob = json.dumps(meta, sort_keys=True, default=repr)
    return hashlib.sha256(blob.encode()).hexdigest()[:24]


def _slug(name: str, limit: int = 48) -> str:
    safe = "".join(c if c.isalnum() or c in "-_." else "_" for c in name)
    return safe[:limit] or "entry"


@dataclass
class KeyCompileStats:
    """Per-logical-key (schedule key) compile accounting."""

    cold: int = 0                       # fresh build (one recorded run)
    warm: int = 0                       # served from a stored entry
    errors: int = 0                     # load/store failures (fell back)
    quarantined: int = 0                # known-corrupt entries skipped
    first_compile_s: Optional[float] = None

    def summary(self) -> Dict[str, float]:
        total = self.cold + self.warm
        return {
            "cold": float(self.cold),
            "warm": float(self.warm),
            "errors": float(self.errors),
            "quarantined": float(self.quarantined),
            "hit_rate": (self.warm / total) if total else 0.0,
            "first_compile_s": self.first_compile_s,
        }


class CompileCache:
    """Directory of entries shared by serving engines.

    ``cache_dir=None`` disables persistence but keeps the accounting: every
    signature then costs exactly one in-process cold build, and
    ``serve_report`` still shows honest cold counts.  ``device`` is the
    engine's (its platform and card go into every entry's identity).
    """

    def __init__(self, cache_dir: Optional[Union[os.PathLike, str]] = None,
                 device: Device = None):
        self.dir = Path(cache_dir) if cache_dir is not None else None
        self.enabled = self.dir is not None
        if self.enabled:
            self.dir.mkdir(parents=True, exist_ok=True)
        self._env = _env_meta(device)
        self._stats: Dict[str, KeyCompileStats] = {}
        # negative cache: entry paths that already failed to load.  The
        # first failure warns and quarantines; later lookups skip the file
        # silently until a successful store replaces it.
        self._quarantine: set = set()

    # -- accounting ----------------------------------------------------------

    def stats(self, key: str) -> KeyCompileStats:
        return self._stats.setdefault(key, KeyCompileStats())

    def report_row(self, key: str) -> Dict[str, float]:
        return self.stats(key).summary()

    def record_cold(self, key: str, compile_s: float) -> None:
        st = self.stats(key)
        st.cold += 1
        if st.first_compile_s is None:
            st.first_compile_s = compile_s

    def record_warm(self, key: str) -> None:
        self.stats(key).warm += 1

    @property
    def cold_compiles(self) -> int:
        return sum(s.cold for s in self._stats.values())

    @property
    def warm_hits(self) -> int:
        return sum(s.warm for s in self._stats.values())

    # -- entry identity ------------------------------------------------------

    def entry_meta(self, meta: Dict[str, Any]) -> Dict[str, Any]:
        return {**self._env, **meta}

    def entry_path(self, name_hint: str, meta: Dict[str, Any]) -> Path:
        assert self.dir is not None
        full = self.entry_meta(meta)
        return self.dir / f"{_slug(name_hint)}-{fingerprint(full)}{CACHE_SUFFIX}"

    def _library_copy(self, filename: str) -> Path:
        assert self.dir is not None
        return self.dir / "kernels" / filename

    # -- load / store --------------------------------------------------------

    def load(self, name_hint: str, meta: Dict[str, Any],
             key: str) -> Optional[Dict[str, Any]]:
        """Read and apply the entry for ``meta``: each library it names is
        loaded (copied into ``build/kernels`` from the cache first where
        the build lacks it; never built) and its launch layouts are
        seeded.  None on a miss OR any failure (unreadable file, metadata
        mismatch, a missing or foreign library): the caller builds cold."""
        if not self.enabled:
            return None
        path = self.entry_path(name_hint, meta)
        if str(path) in self._quarantine:
            # known corrupt: don't re-attempt (and re-warn) every request
            self.stats(key).quarantined += 1
            return None
        if not path.exists():
            return None
        try:
            doc = json.loads(path.read_text())
            if doc.get("meta") != json.loads(json.dumps(
                    self.entry_meta(meta), default=repr)):
                raise ValueError(
                    f"entry metadata mismatch (hash collision or stale "
                    f"format): {path.name}")
            for name, filename in doc["libraries"].items():
                want = cuda.library_path(name)
                if want.name != filename:
                    raise ValueError(f"library {filename} is not this "
                                     f"tree's {want.name}")
                if not want.exists():
                    src = self._library_copy(filename)
                    if not src.exists():
                        raise FileNotFoundError(f"library {filename} is "
                                                f"in neither build nor cache")
                    want.parent.mkdir(parents=True, exist_ok=True)
                    tmp = want.with_name(f"{filename}.{uuid.uuid4().hex}")
                    shutil.copyfile(src, tmp)
                    os.replace(tmp, want)
                cuda.library(name)
            for args, layout in doc["layouts"]:
                scan_layout.SEEDED[tuple(args)] = \
                    scan_layout.ScanLayout(*layout)
            return doc
        except Exception as e:  # corrupted/stale entry: warn ONCE, fall back
            self.stats(key).errors += 1
            self._quarantine.add(str(path))
            warnings.warn(
                f"compile cache entry {path.name} unusable "
                f"({type(e).__name__}: {e}); falling back to a cold build "
                f"(entry quarantined — not re-read until overwritten)",
                RuntimeWarning, stacklevel=2)
            return None

    def store(self, name_hint: str, meta: Dict[str, Any],
              rec: cuda.Recording, key: str) -> bool:
        """Write what ``rec`` recorded under its content hash, with a copy
        of each library it names.

        Write-temp-then-rename: safe under concurrent writers (N replicas
        sharing one directory race benignly — last complete write wins,
        readers never observe a partial file)."""
        if not self.enabled:
            return False
        path = self.entry_path(name_hint, meta)
        tmp = path.with_name(
            f"{path.name}.tmp.{os.getpid()}.{uuid.uuid4().hex[:8]}")
        try:
            libraries = {name: cuda.library_path(name).name
                         for name in sorted(rec.libraries)}
            for filename in libraries.values():
                dst = self._library_copy(filename)
                if not dst.exists():
                    dst.parent.mkdir(parents=True, exist_ok=True)
                    part = dst.with_name(f"{filename}.{uuid.uuid4().hex}")
                    shutil.copyfile(cuda.BUILD_DIR / filename, part)
                    os.replace(part, dst)
            doc = {"meta": self.entry_meta(meta), "libraries": libraries,
                   "entries": sorted(rec.entries),
                   "layouts": [[list(a), list(lay)]
                               for a, lay in rec.layouts.items()]}
            tmp.write_text(json.dumps(doc, sort_keys=True, default=repr))
            os.replace(tmp, path)
            # a fresh, complete entry now lives at this path: lift any
            # quarantine from a corrupt predecessor
            self._quarantine.discard(str(path))
            return True
        except Exception as e:  # unwritable directory, full disk, ...
            self.stats(key).errors += 1
            warnings.warn(
                f"compile cache store failed for {path.name} "
                f"({type(e).__name__}: {e}); serving uncached",
                RuntimeWarning, stacklevel=2)
            try:
                if tmp.exists():
                    tmp.unlink()
            except OSError:
                pass
            return False


class ArgSpec(NamedTuple):
    """An argument's shape and dtype without its values (the port's
    ``jax.ShapeDtypeStruct``): :meth:`CachedExecutor.warm` runs a cold
    signature on zeros of it."""

    shape: Tuple[int, ...]
    dtype: str = "float32"


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)) and not isinstance(tree, ArgSpec):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _leaf_signature(leaf) -> Tuple:
    if leaf is None:
        return ("none",)
    if isinstance(leaf, ArgSpec):
        return (tuple(leaf.shape), str(np.dtype(leaf.dtype)))
    if isinstance(leaf, torch.Tensor):
        return (tuple(leaf.shape), str(leaf.dtype).replace("torch.", ""))
    if isinstance(leaf, np.ndarray):
        return (tuple(leaf.shape), str(leaf.dtype))
    return ("value", repr(leaf))


def _arg_signature(args: Tuple[Any, ...]) -> Tuple:
    """Hashable (shape, dtype) signature over every tensor and array
    argument (dicts, lists and tuples flattened in order): the
    shape-bucket identity of one readied signature."""
    return tuple(_leaf_signature(leaf) for leaf in _leaves(args))


def _materialize(tree):
    """``tree`` with every :class:`ArgSpec` as numpy zeros."""
    if isinstance(tree, ArgSpec):
        return np.zeros(tree.shape, np.dtype(tree.dtype))
    if isinstance(tree, dict):
        return {k: _materialize(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_materialize(v) for v in tree)
    return tree


class CachedExecutor:
    """One executor, each argument-shape signature readied once, warm from
    a stored entry or cold.

    Call it exactly like the executor (positional args).  The first call
    with a new signature loads the entry (warm: no build counted) or runs
    cold: ``on_build`` fires the first time this executor builds (the
    engines' executor counts), the call runs inside ``cuda.recording`` and
    what it used is stored for the next process.  :meth:`warm` readies a
    signature without running a request (args may mix real values and
    :class:`ArgSpec`\\ s): the engines' pre-warm path.
    """

    def __init__(self, fn: Callable, cache: CompileCache, key: str,
                 meta: Dict[str, Any], name_hint: Optional[str] = None,
                 on_build: Optional[Callable[[], None]] = None):
        self._fn = fn
        self._cache = cache
        self.key = key
        self._meta = dict(meta)
        self._name = name_hint if name_hint is not None else key
        self._on_build = on_build
        self._built = False
        self._ready: set = set()

    def _entry_meta(self, sig: Tuple) -> Dict[str, Any]:
        return {**self._meta, "signature": repr(sig)}

    def _acquire(self, sig: Tuple, args: Tuple[Any, ...], run: bool):
        """Ready ``sig``: warm from the cache, else cold (``run``: the call
        itself, recorded; otherwise one dry run on zeros).  Returns the
        call's result where one ran, else None."""
        meta = self._entry_meta(sig)
        if self._cache.load(self._name, meta, self.key) is not None:
            self._cache.record_warm(self.key)
            self._ready.add(sig)
            return self._fn(*args) if run else None
        t0 = time.perf_counter()
        if not self._built:
            self._built = True
            if self._on_build is not None:
                self._on_build()
        with cuda.recording(dry=not run) as rec:
            out = self._fn(*(args if run else _materialize(args)))
        self._cache.record_cold(self.key, time.perf_counter() - t0)
        self._cache.store(self._name, meta, rec, self.key)
        self._ready.add(sig)
        return out if run else None

    def __call__(self, *args):
        sig = _arg_signature(args)
        if sig in self._ready:
            return self._fn(*args)
        return self._acquire(sig, args, run=True)

    def warm(self, *args) -> Dict[str, Any]:
        """Ready this signature WITHOUT running a request: ``{"status":
        "hot"|"warm"|"cold", "compile_s": float}``; no kernel launches
        either way."""
        sig = _arg_signature(args)
        if sig in self._ready:
            return {"status": "hot", "compile_s": 0.0}
        cold_before = self._cache.stats(self.key).cold
        t0 = time.perf_counter()
        self._acquire(sig, args, run=False)
        dt = time.perf_counter() - t0
        cold = self._cache.stats(self.key).cold > cold_before
        return {"status": "cold" if cold else "warm",
                "compile_s": dt if cold else 0.0}

    def compiled_signatures(self) -> int:
        return len(self._ready)
