"""Does a garbage collection inside a CUDA-graph capture break the capture?

On the card, in one process per case:

    python3 scripts/graph_gc_probe.py tensors   # the collection frees tensors
    python3 scripts/graph_gc_probe.py graph     # ... frees another CUDAGraph
    python3 scripts/graph_gc_probe.py gen       # ... one with a registered generator
    python3 scripts/graph_gc_probe.py parity        # chip_smoke's serve_graph_parity,
    python3 scripts/graph_gc_probe.py parity --old  # a collection forced in every capture

The first three capture a graph whose body runs ``gc.collect()`` while a
dropped reference cycle holds the named object, and print whether the
capture survived. ``parity`` runs the smoke's ``serve_graph_parity`` phase
with a collection forced inside every decode-tick capture wherever the
collector is enabled (``DecodeGraph`` pauses it while capturing);
``--old`` removes that pause and makes each batcher's tick hold its
batcher again (a dropped batcher then waits in a cycle for the collector),
as the capture code stood before the pause. Exit code 1 where the capture
failed.
"""
import contextlib
import gc
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def capture_case(case: str) -> bool:
    dev = torch.device("cuda")
    x = torch.zeros(16, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def make(register):
        g = torch.cuda.CUDAGraph()
        s = torch.cuda.Stream()
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            x.add_(1)
            if register:
                g.register_generator_state(gen)
            with torch.cuda.graph(g, stream=s):
                x.add_(torch.rand(16, device=dev, generator=gen) if register else 1)
        torch.cuda.current_stream().wait_stream(s)
        return g

    class Holder:
        pass

    h = Holder()
    h.self = h                                   # a cycle: only the collector frees it
    if case == "tensors":
        h.t = torch.ones(1 << 20, device=dev)
    else:
        h.g = make(case == "gen")
        h.g.replay()
    torch.cuda.synchronize()
    del h
    g = torch.cuda.CUDAGraph()
    if case == "gen":
        g.register_generator_state(gen)
    try:
        with torch.cuda.graph(g):
            x.mul_(2)
            n = gc.collect()
            x.mul_(2)
        g.replay()
        torch.cuda.synchronize()
    except Exception as e:   # noqa: BLE001 - the probe reports what capture raised
        print(case, "capture FAILED:", type(e).__name__, str(e).splitlines()[0], flush=True)
        return False
    print(case, "capture ok, objects collected", n, flush=True)
    return True


def parity(old: bool) -> bool:
    sys.path.insert(0, ROOT)
    import chip_smoke
    from deepspeed_tpu_torch.inference import graphs, serving
    from deepspeed_tpu_torch.ops import _build

    if old:
        graphs.gc_paused = contextlib.nullcontext
        tick_of = serving.ContinuousBatcher._decode_tick

        def held_tick(self, greedy, cache):
            t = tick_of(self, greedy, cache)

            def tick():
                self.n_slots                     # the tick holds its batcher
                t()
            return tick

        serving.ContinuousBatcher._decode_tick = held_tick
    init = graphs.DecodeGraph.__init__
    collected = []

    def collecting_init(self, tick, *a, **k):
        def t():
            if torch.cuda.is_current_stream_capturing() and gc.isenabled():
                collected.append(gc.collect())
            tick()
        init(self, t, *a, **k)

    graphs.DecodeGraph.__init__ = collecting_init
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    try:
        ok = chip_smoke.run_serve_graph_parity(torch)
    except Exception as e:   # noqa: BLE001
        print("parity RAISED", type(e).__name__, str(e).splitlines()[0], flush=True)
        ok = False
    print("parity", "ok" if ok else "FAILED", "old" if old else "paused",
          "collections in captures:", len(collected), flush=True)
    return ok


def main() -> int:
    if not torch.cuda.is_available():
        print("graph_gc_probe: CUDA is not available", file=sys.stderr)
        return 2
    case = sys.argv[1]
    ok = parity("--old" in sys.argv) if case == "parity" else capture_case(case)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
