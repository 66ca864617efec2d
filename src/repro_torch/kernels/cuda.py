"""Build, load and count the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``.  The
build happens at first use (or through :func:`build`) into ``build/kernels/``
at the root of the checkout; a library's file name carries a hash of its
source and flags, so an edited source rebuilds and an unchanged one is
reused.  Nothing is built or loaded at import time.

Every kernel wrapper adds one to its entry in :data:`LAUNCHES` where it
launches its kernel, and nowhere else, so a caller can show that a run went
through the kernels; :data:`ENTRIES` counts the same calls by C entry
point, which tells a kernel's routes apart (the hoisted and pipeline
scans on the cluster kernel or, past its H, ``*_block`` on the block
kernel); :func:`launch_total` sums :data:`LAUNCHES` for a reader that
wants the launches between two moments (``repro_torch.tracing``).  A
CUDA graph's replay adds the launches its capture made
(:func:`count_launches`; ``serving/graphs.py``), so the counts stay those
of the kernels that ran, and :data:`GRAPHS` counts its captures and
replays.  :data:`COUNTS` counts the ``nvcc`` runs and the card's
residency queries (``scan_layout.card_resident``): what a warm compile
cache entry spares a first request.

:func:`recording` notes, for the serving compile cache, which libraries
and C entry points a run launches and which launch layouts it resolves;
``recording(dry=True)`` builds and loads each library a launch needs but
launches nothing and counts nothing (the cache's cold warm-up).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Tuple

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_HOISTED = (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P])
#: xs, xs_bf16, W, U, b, out, B, T, in, H, R, then the cluster layout
#: (cluster, rows, k_split, threads, smem_bytes), stream
_CLUSTER_SCAN = (_I, [_P, _I, _P, _P, _P, _P] + [_I] * 10 + [_P])
#: zx, U, b, out, out_bf16, B, T, H, R, then the cluster layout, stream
_CLUSTER_HOISTED = (_I, [_P, _P, _P, _P] + [_I] * 10 + [_P])
#: C signature of every exported function, per library (``csrc/<name>.cu``);
#: each library exports ``kernel_error_string`` for its error codes
SIGNATURES = {
    "rnn_scan": {
        "lstm_scan": _CLUSTER_SCAN,
        "gru_scan": _CLUSTER_SCAN,
        "lstm_scan_hoisted": _CLUSTER_HOISTED,
        "lstm_scan_hoisted_block": _HOISTED,
        "gru_scan_hoisted": _CLUSTER_HOISTED,
        "gru_scan_hoisted_block": _HOISTED,
        "lstm_scan_pipeline": _CLUSTER_HOISTED,
        "lstm_scan_pipeline_block": _HOISTED,
        "gru_scan_pipeline": _CLUSTER_HOISTED,
        "gru_scan_pipeline_block": _HOISTED,
        "scan_rows_per_block": (_I, [_I]),
        "cluster_scan_resident": (_I, [_I] * 8),
        "cluster_zx_scan_resident": (_I, [_I] * 8),
        "kernel_error_string": (ctypes.c_char_p, [_I]),
    },
    "reuse_matmul": {
        "col_matmul": (_I, [_P, _I, _P, _P, _I, _I, _I, _I, _P]),
        "col_matmul_layout": (_I, [_I, _I, _I, _I, _P]),
        "reuse_matmul": (_I, [_P, _P, _I, _P, _I, _I, _I, _I, _P]),
        "reuse_matmul_layout": (_I, [_I, _I, _I, _I, _P]),
        "kernel_error_string": (ctypes.c_char_p, [_I]),
    },
    "quantized": {
        "quant_matmul": (_I, [_P, _P, _P, _I, _I, _I, _I, _P]),
        "quant_matmul_layout": (_I, [_I, _I, _I, _I, _P]),
        "fixed_point": (_I, [_P, _I, _P, ctypes.c_longlong, _F, _F, _F, _I,
                             _I, _F, _P]),
        "kernel_error_string": (ctypes.c_char_p, [_I]),
    },
    "decode_matmul": {
        #: x, w, bf16, out, ws, M, K, N, R, then the layout (vec, rows,
        #: chunk, chunks a split, column warps, K warps), stream
        "decode_matmul": (_I, [_P, _P, _I, _P, _P] + [_I] * 10 + [_P]),
        "kernel_error_string": (ctypes.c_char_p, [_I]),
    },
    "rglru_scan": {
        "rglru_scan": (_I, [_P, _I, _P, _I, _P, _I, _I, _I, _I, _I, _I,
                            _P]),
        #: a, a_bf16, bx, bx_bf16, out, B, W, SMs, long long[6] out
        "rglru_scan_layout": (_I, [_P, _I, _P, _I, _P, _I, _I, _I, _P]),
        "kernel_error_string": (ctypes.c_char_p, [_I]),
    },
    "hadamard": {
        "hadamard": (_I, [_P, _P, _I, _P, ctypes.c_longlong, _P]),
        "kernel_error_string": (ctypes.c_char_p, [_I]),
    },
}

#: kernel name -> launches since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {
    "lstm_scan": 0, "lstm_scan_hoisted": 0, "lstm_scan_pipeline": 0,
    "gru_scan": 0, "gru_scan_hoisted": 0, "gru_scan_pipeline": 0,
    "col_matmul": 0, "reuse_matmul": 0, "quant_matmul": 0, "fixed_point": 0,
    "decode_matmul": 0, "rglru_scan": 0, "hadamard": 0}

#: C entry point -> calls since the last :func:`reset_launches`
ENTRIES: Dict[str, int] = {}

#: ``nvcc`` runs and residency queries of the card, since import
COUNTS: Dict[str, int] = {"nvcc": 0, "residency": 0}

#: CUDA graphs captured and replayed by the serving executors, since import
GRAPHS: Dict[str, int] = {"captures": 0, "replays": 0}


class Recording:
    """What the runs inside one :func:`recording` used: libraries, C entry
    points and launch layouts (``scan_layout.launch_layout``'s arguments
    -> layout)."""

    def __init__(self, dry: bool):
        self.dry = dry
        self.libraries: set = set()
        self.entries: set = set()
        self.layouts: Dict[tuple, tuple] = {}


_RECORDINGS: List[Recording] = []


@contextlib.contextmanager
def recording(dry: bool = False) -> Iterator[Recording]:
    """Record the libraries, C entry points and launch layouts of every
    launch inside the block; ``dry``: build and load each library, resolve
    each layout, but launch nothing (and count nothing in
    :data:`LAUNCHES`)."""
    rec = Recording(dry)
    _RECORDINGS.append(rec)
    try:
        yield rec
    finally:
        _RECORDINGS.remove(rec)


def recording_mode() -> Optional[str]:
    """"dry" inside a dry :func:`recording`, "live" inside another, else
    None."""
    if not _RECORDINGS:
        return None
    return "dry" if any(rec.dry for rec in _RECORDINGS) else "live"


def record_layout(args: tuple, layout: tuple) -> None:
    """Note a launch layout resolved for ``args`` in every recording."""
    for rec in _RECORDINGS:
        rec.layouts[args] = tuple(layout)


def sources_digest() -> str:
    """Hash of every CUDA source and header, the flags, and the launch
    layout model (``kernels/scan_layout.py``): what a compile cache entry's
    libraries and layouts were made from."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")) + [Path(__file__).with_name(
            "scan_layout.py")]:
        h.update(f.name.encode() + f.read_bytes())
    return h.hexdigest()[:16]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: (library, function) -> the resolved ctypes function
_fns: Dict[Tuple[str, str], Callable] = {}


def launch_total() -> int:
    """Every kernel launch counted in :data:`LAUNCHES` since the last
    :func:`reset_launches`: the difference of two readings with no reset
    between them is the launches between them."""
    return sum(LAUNCHES.values())


def launches_since(before: Tuple[Dict[str, int], Dict[str, int]]
                   ) -> Tuple[Dict[str, int], Dict[str, int]]:
    """The launches counted in :data:`LAUNCHES` and :data:`ENTRIES` since
    ``before`` (``(dict(LAUNCHES), dict(ENTRIES))``), nonzero only."""
    return tuple({k: n - was.get(k, 0) for k, n in now.items()
                  if n != was.get(k, 0)}
                 for now, was in zip((LAUNCHES, ENTRIES), before))


def count_launches(launches: Dict[str, int], entries: Dict[str, int],
                   times: int = 1) -> None:
    """Add ``times`` x a :func:`launches_since` reading to the counts: a
    graph's replay adds what its capture launched, and the capture, which
    runs nothing, takes it back (``times=-1``)."""
    for name, n in launches.items():
        LAUNCHES[name] += times * n
    for name, n in entries.items():
        ENTRIES[name] = ENTRIES.get(name, 0) + times * n


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    ENTRIES.clear()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found on PATH, in $CUDA_HOME/bin or "
                       "/usr/local/cuda/bin: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives (its name
    hashes the source, the headers beside it and the flags)."""
    src = b"".join(f.read_bytes() for f in [CSRC / f"{name}.cu",
                                           *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names: Iterable[str] = tuple(SIGNATURES)) -> Dict[str, Path]:
    """Compile every library in ``names`` that is not built yet, one ``nvcc``
    per source, all started together.  Returns name -> library path; the
    compiler's output (``-Xptxas -v``: registers, shared memory, spills) is
    kept beside each library as ``.log``."""
    paths = {n: library_path(n) for n in names}
    todo = [n for n, path in paths.items() if not path.exists()]
    if not todo:
        return paths
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in todo:
        COUNTS["nvcc"] += 1
        tmp = paths[n].with_suffix(f".{os.getpid()}.tmp")
        log = open(paths[n].with_suffix(".log"), "w")
        procs[n] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
            stdout=log, stderr=subprocess.STDOUT), tmp, log)
    failed = []
    for n, (proc, tmp, log) in procs.items():
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, paths[n])
        else:
            failed.append(f"{n} (exit {rc}, see {paths[n].with_suffix('.log')})")
    if failed:
        raise RuntimeError("nvcc failed: " + "; ".join(failed))
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            for fn, (restype, argtypes) in SIGNATURES[name].items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            _libs[name] = lib
        return lib


def function(lib_name: str, name: str) -> Callable:
    """The C function ``name`` of library ``lib_name``, resolved once (the
    library's lock is taken only then)."""
    fn = _fns.get((lib_name, name))
    if fn is None:
        fn = _fns[(lib_name, name)] = getattr(library(lib_name), name)
    return fn


def stream_ptr(device: torch.device) -> int:
    """PyTorch's current stream on CUDA ``device`` as a raw pointer, without
    building a ``torch.cuda.Stream`` object as ``current_stream`` does."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def launch(lib_name: str, kernel: str, device: torch.device, *args,
           count_as: Optional[str] = None) -> None:
    """Call the C function ``kernel`` of library ``lib_name`` with ``args``
    on PyTorch's current stream of ``device``, raise if it returned a CUDA
    error (a refused launch never runs, and a later synchronise would not
    report it), and count the launch under ``count_as`` (default: the C
    function's name) and the C function in :data:`ENTRIES`.  Inside a
    :func:`recording` the library and entry point are noted; inside a dry
    one nothing is launched or counted."""
    fn = function(lib_name, kernel)
    if _RECORDINGS:
        for rec in _RECORDINGS:
            rec.libraries.add(lib_name)
            rec.entries.add(kernel)
        if any(rec.dry for rec in _RECORDINGS):
            return
    rc = fn(*args, stream_ptr(device))
    if rc != 0:
        msg = library(lib_name).kernel_error_string(rc).decode()
        raise RuntimeError(f"{kernel}: CUDA error {rc}: {msg}")
    LAUNCHES[count_as or kernel] += 1
    ENTRIES[kernel] = ENTRIES.get(kernel, 0) + 1


def require(kernel: str, io_dtype: torch.dtype, *,
            io: Tuple[str, ...] = ("xs",), **tensors: torch.Tensor
            ) -> torch.device:
    """Check the arguments of a launch: ``io_dtype`` (the activations'
    type) is float32 or bfloat16, the tensors named in ``io`` have it, every
    other tensor is float32, and all are contiguous on one CUDA device,
    which is returned."""
    if io_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{kernel}: activations must be float32 or "
                        f"bfloat16, not {io_dtype}")
    device = next(iter(tensors.values())).device
    for name, t in tensors.items():
        want = io_dtype if name in io else torch.float32
        if t.dtype != want:
            raise TypeError(f"{kernel}: {name} must be {want}, not "
                            f"{t.dtype}")
        if t.device != device:
            raise ValueError(f"{kernel}: {name} is on {t.device}, expected "
                             f"{device}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")
    return device


def require_int8(kernel: str, **tensors: torch.Tensor) -> torch.device:
    """Check the arguments of an integer launch: every tensor is int8 and
    contiguous, all on one CUDA device, which is returned."""
    device = next(iter(tensors.values())).device
    for name, t in tensors.items():
        if t.dtype != torch.int8:
            raise TypeError(f"{kernel}: {name} must be torch.int8, not "
                            f"{t.dtype}")
        if t.device != device:
            raise ValueError(f"{kernel}: {name} is on {t.device}, expected "
                             f"{device}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")
    return device


def rows_per_block(batch: int) -> int:
    """Batch rows each thread block of the hoisted and pipeline scan
    kernels carries (the in-loop scans take a cluster layout instead:
    ``kernels/scan_layout.py``)."""
    return library("rnn_scan").scan_rows_per_block(batch)
