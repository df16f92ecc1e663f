"""Capture a training step as a CUDA graph and replay it.

The counterpart of ``jax.jit`` over the JAX package's chunk bodies (the
``lax.scan`` step of ``training/fit.py::_chunk_runner``, ``run_chunk`` of
``training/lbfgs.py``): the host issues a whole step as one graph launch
instead of its hundreds of kernel launches.  A step is a Python function
over static buffers (tensors that live as long as the step does and are
updated in place); :class:`StepGraph` runs it:

* on the CPU, eagerly, every time (the tier-1 tests run the same Python that
  is captured on the card);
* on a CUDA device, eagerly for its first :data:`WARMUP_RUNS` calls on a
  side stream (torch's capture warm-up: the optimizer's state, cuBLAS's
  workspace; these are real steps), then captured once with
  ``torch.cuda.graph`` and replayed for every later call.

A graph reads and writes fixed addresses, so it is keyed on the storage of
every tensor it touches (``keyed()``, read after the capture).
:meth:`StepGraph.check`, called where a caller may have replaced one of them
(a chunk boundary: checkpoint restores, ``load_state_dict``), drops the
graph when the key moved; the next calls warm up and capture again.  The
graph holds a reference to each keyed tensor, so none of them is freed
while it may still be replayed.

A capture that fails raises :class:`GraphCaptureError`; the step is never
run eagerly in its place.  Python's cyclic garbage collector is held off
during a capture: a dead graph freed inside a capture destroys its CUDA
graph there, which the runtime refuses and which invalidates the
capture.  The kernel wrappers count their launches in
Python, which runs once at capture and never at replay: the launches a
capture records are taken back out of the counters and added again at every
replay, so a counter reads the launches the device ran.

The serving engine runs each (kind, bucket) rung through a
:class:`StepGraph` too: :meth:`StepGraph.prime` warms a rung up and captures
it at its first query, which the replay then answers, and the rungs of one
engine share a :class:`SharedPool`.
"""

from __future__ import annotations

import contextlib
import gc
import inspect
import time
import weakref
from typing import Callable, Optional

import torch

from ..ops import cuda_taylor as ct

WARMUP_RUNS = 3

# every capture of this process: {"name", "seconds", "pool_bytes"}
captures: list = []


class GraphCaptureError(RuntimeError):
    """Capturing a step as a CUDA graph failed (an operation that
    synchronises with the host or allocates outside the graph's pool)."""


def storage_key(tensors) -> tuple:
    """The storage addresses a graph over ``tensors`` reads and writes."""
    return tuple(t.untyped_storage().data_ptr() for t in tensors)


def _weak(fn: Callable) -> Callable:
    """``fn``, holding a bound method's object weakly.  A step owns its
    :class:`StepGraph`; a strong reference back would make a cycle that
    only the cyclic collector frees, keeping the graph and its pool of
    device memory alive until it runs."""
    if not inspect.ismethod(fn):
        return fn
    ref = weakref.WeakMethod(fn)
    return lambda: ref()()


_side_streams: dict = {}


def side_stream(device: torch.device) -> torch.cuda.Stream:
    """The stream warm-ups and captures run on, one per device.  Each
    warm-up waits for the current stream first, so a block the caching
    allocator hands out on it is never one the current stream still
    reads."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    if index not in _side_streams:
        _side_streams[index] = torch.cuda.Stream(index)
    return _side_streams[index]


@contextlib.contextmanager
def _collector_off():
    """Python's cyclic collector held off (around a capture)."""
    collecting = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if collecting:
            gc.enable()


class CudaGraph:
    """``torch.cuda.CUDAGraph`` behind the two calls :class:`StepGraph`
    makes; captured on ``stream``, the stream of the warm-up.  The capture
    is ``torch.cuda.graph``'s without its synchronisation and cache release
    on entry: a capture runs nothing on the device, and emptying the cache
    costs a step's time or more each time.  ``pool`` (a
    :class:`SharedPool`'s ``id``) shares one memory pool between graphs
    that never run at the same time; ``None`` gives the graph a private
    one."""

    def __init__(self, stream: Optional[torch.cuda.Stream], pool=None):
        self.graph = torch.cuda.CUDAGraph()
        self.stream = stream
        self.pool = pool

    def capture(self, fn: Callable):
        with torch.cuda.stream(self.stream):
            self.graph.capture_begin(pool=self.pool,
                                     capture_error_mode="global")
            try:
                fn()
            finally:
                self.graph.capture_end()

    def replay(self):
        self.graph.replay()


class SharedPool:
    """One graph memory pool for graphs that never run at the same time
    (the rungs of a serving engine).  PyTorch frees a pool when the last
    graph captured into it is destroyed and then refuses a capture into
    it, so the pool holds a graph of its own (one fill of one element):
    the graphs that share it may be dropped and captured again in any
    order.  (A ``torch.cuda.MemPool`` would hold the pool too, but aborts
    the process if it is destroyed before the graphs captured into it.)"""

    def __init__(self, device: torch.device):
        self.id = torch.cuda.graph_pool_handle()
        self._holder = torch.cuda.CUDAGraph()
        stream = side_stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with _collector_off(), torch.cuda.stream(stream):
            self._holder.capture_begin(pool=self.id)
            try:
                torch.zeros(1, device=device)
            finally:
                self._holder.capture_end()


class StepGraph:
    """Run ``fn`` (a step over static buffers) eagerly, or warm it up,
    capture it and replay it (module docstring).

    ``keyed()`` lists every tensor ``fn`` reads or writes that outlives one
    call.  ``eager=True`` runs ``fn`` eagerly on every device: the referee
    the graph is held to on the card, nothing else.  ``make_graph(stream)``
    builds the graph object (default :class:`CudaGraph` on a CUDA device);
    with one given, the CPU captures and replays it too."""

    def __init__(self, fn: Callable, keyed: Callable, device: torch.device,
                 name: str, eager: bool = False,
                 make_graph: Optional[Callable] = None):
        self.fn, self.keyed, self.name = _weak(fn), _weak(keyed), name
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        if make_graph is None and self.cuda:
            make_graph = CudaGraph
        self.make_graph = None if eager else make_graph
        self.graph = None
        self.warm = 0
        self.key = None
        self.held = ()
        self.launches = ()  # (counter, launches per replay)
        self.captures = 0

    def check(self):
        """Drop the graph if a keyed tensor was replaced since the
        capture."""
        if self.graph is not None and storage_key(self.keyed()) != self.key:
            self.graph, self.held, self.warm = None, (), 0

    def prime(self):
        """Warm up and capture now, if a graph is due and missing: the
        first call of a step that must be served by a replay at once (a
        serving rung's first query).  The warm-ups are the usual eager runs
        on the side stream; their results are not the caller's."""
        if self.make_graph is None or self.graph is not None:
            return
        while self.warm < WARMUP_RUNS:
            self._warm_up()
        self._capture()

    def __call__(self):
        """One step."""
        if self.make_graph is None:
            self.fn()
            return
        if self.graph is None:
            if self.warm < WARMUP_RUNS:
                self._warm_up()
                return
            self._capture()
        self.graph.replay()
        for counter, n in self.launches:
            counter.launches += n

    def _warm_up(self):
        if self.cuda:
            stream = side_stream(self.device)
            current = torch.cuda.current_stream(self.device)
            stream.wait_stream(current)
            with torch.cuda.stream(stream):
                self.fn()
            current.wait_stream(stream)
        else:
            self.fn()
        self.warm += 1

    def _capture(self):
        before = [(c, c.launches) for c in ct.COUNTED]
        t0 = time.perf_counter()
        # a capture allocates from the graph's pool: what the allocator
        # reserves across it is what the pool grew by (all of a private one)
        reserved = torch.cuda.memory_reserved(self.device) if self.cuda else 0
        graph = self.make_graph(side_stream(self.device) if self.cuda
                                else None)
        try:
            with _collector_off():
                graph.capture(self.fn)
        except RuntimeError as e:
            raise GraphCaptureError(
                f"capturing the {self.name} as a CUDA graph failed; it is not "
                "run eagerly instead") from e
        finally:
            # capture launches nothing: take its counts back out
            recorded = [(c, c.launches - n) for c, n in before]
            for c, n in before:
                c.launches = n
        seconds = time.perf_counter() - t0
        self.launches = tuple((c, n) for c, n in recorded if n)
        self.held = tuple(self.keyed())
        self.key = storage_key(self.held)
        self.graph = graph
        self.captures += 1
        pool = (torch.cuda.memory_reserved(self.device) - reserved
                if self.cuda else 0)
        captures.append({"name": self.name, "seconds": seconds,
                         "pool_bytes": int(pool)})
