"""Profiling helpers (port of gscodec_studio_tpu/utils/profiling.py).

  * ``timeit`` context and ``timeit_decorator``, on when TIMEIT=1:
    accumulate wall seconds per label, the card synchronized at the end
    of each timed block; ``report`` prints them.
  * ``honest_timer``: seconds per iteration of ``body(carry, *args) ->
    carry``, from K iterations less one, so that the fixed cost of a
    measurement cancels; on the card on CUDA events with a device sync
    before and after the iterations, on the CPU on time.perf_counter.
  * ``trace``: a torch.profiler trace of the block, written into a
    directory as a Chrome trace (trace.json).
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from collections import defaultdict

import torch

from gscodec_studio_tpu_torch.device import DeviceLike, resolve_device

TIMINGS = defaultdict(float)
COUNTS = defaultdict(int)


def _enabled() -> bool:
    return os.environ.get("TIMEIT", "0") == "1"


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def timeit(name: str):
    if not _enabled():
        yield
        return
    t0 = time.perf_counter()
    yield
    _sync()  # what the block queued on the card counts
    TIMINGS[name] += time.perf_counter() - t0
    COUNTS[name] += 1


def timeit_decorator(name=None):
    def deco(fn):
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*a, **kw):
            with timeit(label):
                return fn(*a, **kw)

        return wrapper

    return deco


def report():
    for k in sorted(TIMINGS):
        print(f"{k:40s} {TIMINGS[k]:9.3f}s  x{COUNTS[k]}")


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler over the block (CPU, and the card where there is
    one); the trace goes to ``logdir``/trace.json. Yields the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        _sync()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def honest_timer(body, args=(), K: int = 8, repeats: int = 3,
                 device: DeviceLike = None) -> float:
    """Seconds per iteration of ``body(carry, *args) -> carry``: the best
    of ``repeats`` runs of K iterations less the best of ``repeats`` runs
    of one, over K - 1. The carry starts as a float32 1e-12 on ``device``
    (None means the CUDA card)."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"

    def run(k):
        x = torch.tensor(1e-12, dtype=torch.float32, device=dev)
        if cuda:
            torch.cuda.synchronize(dev)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(k):
                x = body(x, *args)
            e1.record()
            torch.cuda.synchronize(dev)
            return e0.elapsed_time(e1) / 1e3
        t0 = time.perf_counter()
        for _ in range(k):
            x = body(x, *args)
        return time.perf_counter() - t0

    def best(k):
        run(k)  # warm-up
        return min(run(k) for _ in range(repeats))

    t1, tk = best(1), best(K)
    return (tk - t1) / (K - 1)
