"""One decode tick as a CUDA graph: captured once, replayed once a tick.

The JAX package compiles its decode loop (``generate``'s ``lax.scan`` over
one tick, ``deepspeed_tpu/inference/engine.py:428``, and the batcher's
decode windows, ``serving.py:343-366`` and ``:520-549``). PyTorch runs
eagerly and enqueues every op of every layer from Python on every tick, so
the port captures one tick by hand with ``torch.cuda.CUDAGraph`` and
replays it: one host call a tick instead of hundreds. (``torch.compile``
would break its graph at every ctypes-bound kernel.)

A tick is a function of no arguments that reads and writes static device
buffers only: its token, positions, done flags, write heads or paged
lengths, page table, sampling state and output rows live at fixed
addresses, which the caller refreshes between windows and the tick
advances in place (``models/common.advance_heads``). Every kernel it
launches is recorded with those addresses, so a replay computes the next
tick.

:class:`DecodeGraph` runs ``n`` ticks. On the card, its first use runs the
first tick eagerly on its own capture stream (which loads the kernels'
libraries and makes the buffers that are made lazily, such as the GEMV's
column-tile counters, outside capture), captures the next one, and replays
it for the rest; later uses only replay. A failed capture raises: there is
no quiet fallback to the eager tick. Python's cyclic garbage collector is
paused while a tick is captured: a collection there can free an unrelated
object that holds a CUDA graph (a batcher dropped in a reference cycle),
and destroying a graph while another is being captured invalidates that
capture. On the CPU there is no graph and the
same tick function runs ``n`` times, so the CPU tests run the code the card
replays.

Launch counts: the capture's counts are taken back and added once per
replay (``ops/_build.recording_capture`` / ``count_replays``), so the
counters read what the eager ticks would.
"""
from __future__ import annotations

import contextlib
import gc
import time
from typing import Callable, Iterator, Optional

import torch

from ..ops import decode_layer
from ..ops._build import count_replays, recording_capture


@contextlib.contextmanager
def gc_paused() -> Iterator[None]:
    """No automatic garbage collection inside the block (the collector's
    earlier state is restored after it); the garbage waits for the next
    collection outside."""
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


class DecodeGraph:
    """``tick`` captured as a CUDA graph on ``device`` (or run as it is on
    the CPU). ``generator``: the ``torch.Generator`` the tick draws from,
    registered with the graph so that replays draw what eager ticks would;
    ``tickets``: the GEMV column-tile counters to reserve on the capture
    stream (``decode_layer.tickets_needed``).

    ``capture_s`` is the first use's warm-up tick plus capture, in host
    seconds; ``replays`` counts replays. With ``inspect_edges`` set (a
    diagnostic) the capture also records the graph's edges and how many are
    programmatic (``edges``)."""

    inspect_edges = False

    def __init__(self, tick: Callable[[], None], device: torch.device,
                 generator: Optional[torch.Generator] = None, tickets: int = 0):
        self.tick, self.device = tick, torch.device(device)
        self.generator, self.tickets = generator, int(tickets)
        self.graph = self.stream = self.launches = self.edges = None
        self.capture_s = 0.0
        self.replays = 0

    def run(self, n: int) -> None:
        """``n`` ticks, in order on the current stream."""
        if n <= 0:
            return
        if self.device.type != "cuda":
            for _ in range(n):
                self.tick()
            return
        if self.graph is None:
            self._capture()
            n -= 1
        for _ in range(n):
            self.graph.replay()
        count_replays(self.launches, n)
        self.replays += n

    def _capture(self) -> None:
        t0 = time.perf_counter()
        cur = torch.cuda.current_stream(self.device)
        s = torch.cuda.Stream(self.device)
        s.wait_stream(cur)
        keep = type(self).inspect_edges
        with torch.cuda.stream(s):
            decode_layer.gemv_tickets(self.device, s.cuda_stream, self.tickets)   # reserve
            self.tick()                          # the first tick, eager
            g = torch.cuda.CUDAGraph(keep_graph=keep)
            if self.generator is not None:
                g.register_generator_state(self.generator)
            with recording_capture() as launches, gc_paused():
                with torch.cuda.graph(g, stream=s):
                    self.tick()
            if keep:
                self.edges = decode_layer.graph_edges(g)
                g.instantiate()
        cur.wait_stream(s)
        self.graph, self.stream, self.launches = g, s, launches
        self.capture_s = time.perf_counter() - t0
