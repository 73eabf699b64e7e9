"""Capture once, launch many: the port's counterpart of "jit once, dispatch
many" (the JAX package's ``jax.jit`` around ``preprocess_and_track`` and
``track_fuse_scan``, with ``lax.while_loop`` inside).

A :class:`GraphProgram` is a list of segments.  A segment is a callable
without arguments that works in place on tensors that outlive it (it may
also leave new tensors where later segments find them: captured, their
memory belongs to the program and every launch rewrites it).  A *loop*
segment comes with a bool scalar tensor ``done`` that the callable writes;
it runs until ``done`` is true, at least once.

On a CUDA device (unless ``capture=False``) :meth:`GraphProgram.build`
runs every segment ``WARM_UP_PASSES`` times on a side stream (so that
libraries load, kernels get their attributes and constants are uploaded
outside any capture), captures each into a
``torch.cuda.CUDAGraph`` (one memory pool for all), and joins the graphs
into one executable graph through ``csrc/graph_loop.cu``: a loop segment
becomes a conditional WHILE node, so its exit test runs on the device and
:meth:`run` is one ``cudaGraphLaunch`` that waits for nothing.  A failed
capture raises; nothing falls back to eager execution.

Uncaptured (on the CPU, which the caller asked for, or on the card with
``capture=False``), :meth:`run` calls the same callables in order and reads
``done`` after every pass of a loop.

Where the span recorder (:mod:`.tracing`) is on when :meth:`build` runs,
the program times its segments: on the card a one-thread stamp kernel sits
before the first segment and after each one, reads ``%globaltimer`` and adds
the time since the last stamp to that segment's device counter (a loop's
counter takes all its passes); uncaptured, the host clock times each
segment.  :meth:`GraphProgram.segment_ns` reads the sums.  With the
recorder off the program has no stamps: one node a segment.
"""
from __future__ import annotations

import ctypes
import gc
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..device import resolve_device
from ..ops import _build
from . import tracing

# eager passes over the segments before the capture; they launch the
# segments' kernels like any eager call
WARM_UP_PASSES = 2

_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = _build.load("graph_loop")
        ptr = ctypes.POINTER(ctypes.c_void_p)
        lib.graph_program_build.argtypes = [ctypes.c_int, ptr, ptr, ptr, ctypes.c_void_p,
                                            ctypes.POINTER(ctypes.c_int), ptr]
        lib.graph_program_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.graph_program_destroy.argtypes = [ctypes.c_void_p]
        lib.globaltimer_steps.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        for fn in (lib.graph_program_build, lib.graph_program_launch,
                   lib.graph_program_destroy, lib.globaltimer_steps):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def globaltimer_steps(device, n: int = 4096) -> List[int]:
    """The ``n`` successive nonzero steps of the card's ``%globaltimer``
    that one thread sees when it reads the timer in a loop: their least is
    the resolution of :meth:`GraphProgram.segment_ns` on that card."""
    dev = resolve_device(device)
    out = torch.zeros(n, dtype=torch.int64, device=dev)
    lib = _load()
    with torch.cuda.device(dev):
        _build.check(lib.globaltimer_steps(out.data_ptr(), n,
                                           torch.cuda.current_stream(dev).cuda_stream),
                     "globaltimer_steps")
    return out.cpu().tolist()


class GraphProgram:
    """See the module's docstring.  Counters: ``n_replays`` (launches of the
    whole program), ``n_flag_reads`` (exit flags the host read: none when
    captured), ``capture_s`` (seconds :meth:`build` took, warm-up included),
    ``n_nodes`` (nodes of the executable graph's top level, when captured)
    and, where the recorder was on at :meth:`build`, :meth:`segment_ns`.
    ``capture``: capture on a CUDA device (a CPU program never is)."""

    def __init__(self, device, capture: bool = True):
        self.device = resolve_device(device)
        self.captured = capture and self.device.type == "cuda"
        self._segments: List[Tuple[Callable[[], None], Optional[torch.Tensor]]] = []
        self.names: List[str] = []
        self._exec: Optional[ctypes.c_void_p] = None
        self._graphs: list = []                   # own the segments' memory
        self._recorded: List[Dict[str, int]] = []  # kernel launches per segment
        self._runs: Optional[torch.Tensor] = None  # device count of loop passes
        self._counted: List[int] = []              # passes already in the launch counts
        self._replays_counted = 0
        self._stamps: Optional[torch.Tensor] = None  # last stamp, then ns a segment
        self._host_ns: Optional[List[int]] = None     # the same on the CPU
        self.n_replays = 0
        self.n_flag_reads = 0
        self.capture_s = 0.0
        self.n_nodes = 0

    def add(self, fn: Callable[[], None], done: Optional[torch.Tensor] = None,
            name: str = "") -> None:
        """Append a segment (a loop where ``done`` is given); ``name`` keys
        it in :meth:`segment_ns` (by default its position)."""
        if done is not None and (done.dtype != torch.bool or done.numel() != 1):
            raise ValueError("a loop's exit flag is one bool")
        name = name or str(len(self._segments))
        if name in self.names:
            raise ValueError(f"segment name {name!r} is taken")
        self._segments.append((fn, done))
        self.names.append(name)

    def build(self, keep: Sequence[torch.Tensor] = ()) -> None:
        """Capture the segments (where :attr:`captured`).  ``keep``: the
        tensors that the segments update in place; they hold the same values
        afterwards.  Everything runs on the program's card, whichever card is
        current."""
        if not self.captured:
            self._host_ns = [0] * len(self._segments) if tracing.ON else None
            return
        t0 = time.perf_counter()
        lib = _load()
        with torch.cuda.device(self.device):
            self._capture(lib, keep)
        _build.add_flusher(self._count_launches)
        self.capture_s = time.perf_counter() - t0

    def _capture(self, lib, keep: Sequence[torch.Tensor]) -> None:
        saved = [t.clone() for t in keep]
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            for _ in range(WARM_UP_PASSES):
                for fn, _done in self._segments:
                    fn()
        main.wait_stream(side)
        pool = torch.cuda.graph_pool_handle()
        # no cyclic garbage collection inside a capture: one there can free an
        # older program (its __del__ destroys its graph exec) or a graph, and
        # such a CUDA call invalidates the capture in progress
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            for fn, _done in self._segments:
                graph = torch.cuda.CUDAGraph(keep_graph=True)
                # a capture stream of the program's card: torch.cuda.graph's
                # default one is made once, on the card current at the first
                # capture of the process
                with _build.recording() as rec, torch.cuda.graph(
                        graph, pool=pool, stream=side, capture_error_mode="thread_local"):
                    fn()
                self._graphs.append(graph)
                self._recorded.append(rec)
        finally:
            if collecting:
                gc.enable()
        main.wait_stream(side)
        n = len(self._segments)
        self._runs = torch.zeros(n, dtype=torch.int64, device=self.device)
        self._counted = [0] * n
        array = ctypes.c_void_p * n
        raws = array(*[g.raw_cuda_graph() for g in self._graphs])
        done = array(*[None if d is None else d.data_ptr() for _, d in self._segments])
        runs = array(*[self._runs[k].data_ptr() for k in range(n)])
        if tracing.ON:
            self._stamps = torch.zeros(n + 1, dtype=torch.int64, device=self.device)
        out = ctypes.c_void_p()
        n_nodes = ctypes.c_int()
        _build.check(lib.graph_program_build(
            n, raws, done, runs, None if self._stamps is None else self._stamps.data_ptr(),
            ctypes.byref(n_nodes), ctypes.byref(out)), "graph_program_build")
        self._exec = out
        self.n_nodes = n_nodes.value
        for t, s in zip(keep, saved):
            t.copy_(s)
        torch.cuda.synchronize(self.device)

    def run(self) -> None:
        if self.captured:
            if self._exec is None:
                raise RuntimeError("GraphProgram.run before build")
            _build.check(_build.launch_on(self.device.index, _lib.graph_program_launch,
                                          self._exec), "graph_program_launch")
            self.n_replays += 1
            return
        for k, (fn, done) in enumerate(self._segments):
            t0 = time.perf_counter_ns()
            fn()
            while done is not None:
                self.n_flag_reads += 1
                if bool(done):
                    break
                fn()
            if self._host_ns is not None:
                self._host_ns[k] += time.perf_counter_ns() - t0

    def segment_ns(self) -> Dict[str, int]:
        """Nanoseconds each segment took over every launch since
        :meth:`build`, a loop's passes all counted, by name; empty unless
        the recorder was on at :meth:`build`.  On the card the stamps'
        sums: reading waits for the card."""
        if self._stamps is not None:
            ns = self._stamps[1:].cpu().tolist()
        elif self._host_ns is not None:
            ns = list(self._host_ns)
        else:
            return {}
        return dict(zip(self.names, ns))

    def loop_passes(self) -> List[int]:
        """Passes each segment's loop has made since :meth:`build` (0 for a
        plain segment).  Reads the device's counters: it waits for the card."""
        return [] if self._runs is None else self._runs.cpu().tolist()

    def _count_launches(self) -> None:
        """Add to the launch counts what the replays since the last call
        launched: a plain segment's kernels once a replay, a loop's once a
        pass (the device counts its passes)."""
        passes = self.loop_passes()
        replays = self.n_replays - self._replays_counted
        for k, (rec, (_, done)) in enumerate(zip(self._recorded, self._segments)):
            times = replays if done is None else passes[k] - self._counted[k]
            for name, per_pass in rec.items():
                if times:
                    _build.count_launch(name, per_pass * times)
        self._counted = passes
        self._replays_counted = self.n_replays

    def __del__(self):
        if self._exec is not None and _lib is not None:
            _lib.graph_program_destroy(self._exec)
            self._exec = None
