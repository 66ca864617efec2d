"""Replay a warmed serving executor's call as one CUDA graph.

A warmed ``predict`` of the float datapath spends its host time on work
that does not change from call to call: the scan wrapper's residency,
padding and layout lookups, its launch, the launches of the head, the
synchronous copy back.  :class:`GraphReplay` wraps one executor of
:class:`~repro_torch.serving.engine.RNNServingEngine`.  For each input
shape (the executor's signature) it runs the first call eagerly and
captures the second on a side stream: one graph that holds the whole
forward on a static device input (the same launches, on the same layouts,
in the same order, so each answer keeps its bits) and the copy of the
answer into a pinned host buffer.  From then on a call of that shape
copies the caller's array into the static input, replays the graph on the
same stream, waits for it and copies the answer out: a new array that
nothing aliases.

The copy in is CUDA's asynchronous copy from the caller's pageable
array: it returns once CUDA has staged the array, and the graph's
kernels follow its DMA on the stream.  On the card's host that is faster
than staging the array through a pinned buffer of our own, whose host
copy then precedes a DMA that cannot start before it ends (``PERF.md``
§6: 281–310 us against 386–482 us to the copy's end, 1.90 against
2.03 ms a whole bulk call).  Registering the caller's memory is left out
on purpose: it would pay off only where callers reuse their buffers.

Which executors capture is decided from what they observe
(:func:`replays`): the engine's device is CUDA, the request's ``fp`` is
None (the float datapath, in every mode: static, non-static, pipeline,
hoisted or not) and its schedule runs the kernels.  Native-int and
ap_fixed ``fp`` stay eager: their residency packs are new tensors that
the residency cache's LRU eviction may free under a graph.  The
reference backend (``"xla"``) stays eager: it is the golden model the
kernels are held to.  Ragged calls (``lengths``) stay eager, and so do
calls inside a ``cuda.recording`` (a compile cache's cold build records
what a real run launches; a dry one launches nothing).  A CPU engine never
captures.

A graph bakes in the weights' addresses: beside each graph the executor
keeps the ``(data_ptr, _version)`` of every engine weight, and where one
changed (a weight replaced, or updated in place) it drops the graph and
captures again, counted as a capture.  The static buffers make an
executor non-reentrant, so one lock guards it.  ``cuda.LAUNCHES`` /
``ENTRIES`` keep counting the kernels that ran: a capture runs nothing
and takes back what it counted, a replay adds it; ``cuda.GRAPHS`` counts
captures and replays.  Inside a ``tracing.recording()`` a replayed call
records ``engine.h2d`` (the copy into the static input), ``engine.replay``
(the graph's launch) and ``engine.d2h`` (the wait and the copy out); a
capture records ``engine.capture`` around the captured forward's spans.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Mapping, Tuple

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.kernels import cuda


def replays(device: torch.device, fp, use_kernels: bool) -> bool:
    """Whether an executor on ``device`` with this ``fp`` captures graphs:
    CUDA, the float datapath, the kernels' schedule."""
    return device.type == "cuda" and fp is None and use_kernels


class CudaGraph:
    """One captured forward: ``run(device_in)``, its answer copied into
    ``host_out`` (pinned), on a side stream.  :meth:`replay` launches it
    on the current stream; :meth:`wait` blocks until it has ended."""

    def __init__(self, run: Callable[[torch.Tensor], torch.Tensor],
                 device_in: torch.Tensor, host_out: torch.Tensor):
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            out = run(device_in)
            if out.shape != host_out.shape or out.dtype != host_out.dtype:
                raise RuntimeError(
                    f"captured forward gave {tuple(out.shape)} {out.dtype}, "
                    f"its eager call {tuple(host_out.shape)} "
                    f"{host_out.dtype}")
            host_out.copy_(out, non_blocking=True)
        self.done = torch.cuda.Event()

    def replay(self) -> None:
        self.graph.replay()
        self.done.record()

    def wait(self) -> None:
        self.done.synchronize()


class _Graph:
    """A signature's graph, its static input, its pinned output (as a
    numpy view), the launches its capture counted and the weights it was
    captured on."""

    __slots__ = ("graph", "device_in", "host_out", "launches", "weights")


class GraphReplay:
    """One executor's calls, eager until a signature's second call, then
    replayed (module docstring).

    ``eager(x, lengths)`` is the executor's own call (host array in, host
    array out); ``run(device_in)`` its forward on a device tensor, which
    a capture records; ``weights`` the engine's weight mapping, whose
    tensors' ``(data_ptr, _version)`` a graph is keyed on.  A signature's
    graph is a :class:`CudaGraph` (the CPU tests put a stand-in in its
    place)."""

    def __init__(self, eager: Callable, run: Callable,
                 weights: Mapping[str, torch.Tensor], device: torch.device):
        self._eager = eager
        self._run = run
        self._weights = weights
        self._device = device
        self._lock = threading.Lock()
        #: input shape -> (shape, dtype) of its eager answer
        self._seen: Dict[Tuple[int, ...], Tuple] = {}
        self._graphs: Dict[Tuple[int, ...], _Graph] = {}

    def _weights_key(self) -> Tuple:
        return tuple((t.data_ptr(), t._version)
                     for t in self._weights.values())

    def __call__(self, x, lengths=None) -> np.ndarray:
        if lengths is not None or cuda.recording_mode() is not None:
            out = self._eager(x, lengths)
            if lengths is None and cuda.recording_mode() == "live":
                self._seen[np.shape(x)] = (out.shape, out.dtype)
            return out
        x = np.asarray(x)
        with self._lock:
            g = self._graphs.get(x.shape)
            if g is not None and g.weights != self._weights_key():
                del self._graphs[x.shape]      # its weights moved: again
                g = None
            if g is None:
                if x.shape not in self._seen:
                    out = self._eager(x, None)
                    self._seen[x.shape] = (out.shape, out.dtype)
                    return out
                g = self._capture_graph(x.shape)
            return self._replay(g, x)

    def _capture_graph(self, shape: Tuple[int, ...]) -> _Graph:
        rec = tracing.ACTIVE
        if rec is not None:
            span = rec.open("engine.capture")
        out_shape, out_dtype = self._seen[shape]
        # made outside inference mode: a replay writes device_in in place
        device_in = torch.empty(shape, dtype=torch.float32,
                                device=self._device)
        host_out = torch.from_numpy(np.empty(0, out_dtype)).new_empty(
            out_shape, pin_memory=self._device.type == "cuda")
        before = (dict(cuda.LAUNCHES), dict(cuda.ENTRIES))
        try:
            with torch.inference_mode():
                graph = CudaGraph(self._run, device_in, host_out)
        finally:
            launched = cuda.launches_since(before)
            cuda.count_launches(*launched, times=-1)
        g = _Graph()
        g.graph, g.launches = graph, launched
        g.device_in, g.host_out = device_in, host_out.numpy()
        g.weights = self._weights_key()
        self._graphs[shape] = g
        cuda.GRAPHS["captures"] += 1
        if rec is not None:
            rec.close(span)
        return g

    def _replay(self, g: _Graph, x: np.ndarray) -> np.ndarray:
        rec = tracing.ACTIVE
        if rec is not None:
            span = rec.open("engine.h2d")
        # returns once CUDA has staged x; the graph follows the DMA
        g.device_in.copy_(torch.from_numpy(x), non_blocking=True)
        if rec is not None:
            rec.close(span)
            span = rec.open("engine.replay")
        g.graph.replay()
        cuda.count_launches(*g.launches)
        cuda.GRAPHS["replays"] += 1
        if rec is not None:
            rec.close(span)
            span = rec.open("engine.d2h")
        g.graph.wait()
        out = g.host_out.copy()
        if rec is not None:
            rec.close(span)
        return out

    def graphs(self) -> int:
        """Signatures with a captured graph."""
        return len(self._graphs)

    def close(self) -> None:
        """Drop every graph, with its memory pool and static buffers."""
        with self._lock:
            self._graphs.clear()
            self._seen.clear()
