"""One ``torch.profiler`` window inside a traced run, and what it shows.

The window's profiler records the device's kernels, copies and sets and
the CUDA runtime calls of every thread (CUPTI), between ``start`` and
``stop``; the window's length is taken on the host around them, so idle
time at either end counts as idle. It records no ATen op of the threads
that send the requests: recording those means the profiler's callbacks
on every thread (``profile_all_threads``), and a stop while those
threads ran ops corrupted the heap (``free(): invalid pointer``) once in
22 traced runs on an H100 host. ATen ops a step are counted apart, on
one thread, once the window has closed (``ops_per_step``). The Chrome
trace goes to a temporary file under ``TMPDIR`` and is deleted once
read.

The reductions (``Summary``) are the ``trace_step`` arithmetic of
``chip_smoke.py``, copied: device busy time is the union of the device
events' intervals, and overlap is the time during which events on two or
more streams run at once. An idle gap is named by the CUDA runtime call
the host was in at its middle, or by none: then the host was in Python
or in ATen between calls.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import os
import tempfile
import threading
import time

__all__ = ["Summary", "Tracer", "summarize", "warm", "ops_per_step"]

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver")
#: a step of the served path ends in one ``aten::sigmoid`` of its padded
#: rows (``InferencePlan.predict``)
STEP_OP = "aten::sigmoid"


def _profile(torch):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def warm(torch) -> None:
    """Start and stop the profiler once, so that the traced window does not
    pay the tracing library's first start."""
    prof = _profile(torch)
    prof.start()
    torch.zeros(1).add_(1)
    prof.stop()


class Tracer:
    """Profiles ``[t0 + at, t0 + at + length]`` of a window from a thread
    of its own; ``on_open`` is the window's opening callback."""

    def __init__(self, torch, at: float, length: float):
        self.torch = torch
        self.at, self.length = at, length
        self.prof = None
        self.p0 = self.p1 = None        # profiling: after start, before stop
        self._thread = None

    def on_open(self, t0: float) -> None:
        self._thread = threading.Thread(target=self._run, args=(t0,),
                                        daemon=True, name="perfbench-tracer")
        self._thread.start()

    def _run(self, t0: float) -> None:
        wait = t0 + self.at - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        prof = _profile(self.torch)
        prof.start()
        self.p0 = time.perf_counter()
        time.sleep(self.length)
        self.p1 = time.perf_counter()
        prof.stop()
        self.prof = prof

    def join(self) -> None:
        if self._thread is not None:
            self._thread.join()

    def events(self) -> list:
        return _events(self.prof)


def _events(prof) -> list:
    """The Chrome trace's events of a stopped profiler."""
    fd, path = tempfile.mkstemp(prefix="perfbench-trace-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.unlink(path)


@dataclasses.dataclass
class Summary:
    window_s: float                    # host clock, start to stop
    busy_s: float                      # union of device intervals
    overlap_s: float                   # two or more streams at once
    device_s_by_name: dict             # device seconds by event name
    idle_gaps: list                    # [(host call at the gap, seconds)]


def _union(spans) -> tuple[float, list]:
    """(covered length, gaps between covered intervals) of sorted spans."""
    busy, gaps = 0.0, []
    cur = None
    for a, b in spans:
        if cur is None:
            cur = b
            busy += b - a
            continue
        if a > cur:
            gaps.append((cur, a))
        if b > cur:
            busy += b - max(a, cur)
            cur = b
    return busy, gaps


def _overlap(spans_with_stream) -> float:
    edges = sorted([(s, 1, st) for s, _, st in spans_with_stream]
                   + [(t, -1, st) for _, t, st in spans_with_stream],
                   key=lambda e: e[:2])             # ends before starts
    active: dict = {}
    overlap, last = 0.0, None
    for t, step, st in edges:
        if last is not None and sum(1 for v in active.values() if v > 0) >= 2:
            overlap += t - last
        last = t
        active[st] = active.get(st, 0) + step
    return overlap


NO_CALL = "no CUDA call (the host in Python or ATen)"


def _label_gaps(gaps, calls) -> list:
    """Each idle gap named by the shortest CUDA runtime call running on
    the host at its middle; the sums by name, longest first."""
    calls = sorted(calls, key=lambda e: e["ts"])
    starts = [e["ts"] for e in calls]
    longest = max((e["dur"] for e in calls), default=0.0)
    by: dict = {}
    for a, b in gaps:
        mid = 0.5 * (a + b)
        lo = bisect.bisect_left(starts, mid - longest)
        hi = bisect.bisect_right(starts, mid)
        best = None
        for e in calls[lo:hi]:
            if e["ts"] + e["dur"] >= mid and (best is None
                                               or e["dur"] < best["dur"]):
                best = e
        name = best["name"] if best is not None else NO_CALL
        by[name] = by.get(name, 0.0) + (b - a) * 1e-6
    return sorted(by.items(), key=lambda kv: -kv[1])


def summarize(events: list, window_s: float) -> Summary:
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in DEVICE_CATS]
    calls = [e for e in events if e.get("ph") == "X"
             and e.get("cat") in HOST_CATS]
    spans = sorted((e["ts"], e["ts"] + e["dur"],
                    e.get("args", {}).get("stream", -1)) for e in dev)
    busy, gaps = _union([(a, b) for a, b, _ in spans])
    edges = window_s - (spans[-1][1] - spans[0][0]) * 1e-6 if spans \
        else window_s
    by_name: dict = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] * 1e-6
    return Summary(window_s=window_s, busy_s=busy * 1e-6,
                   overlap_s=_overlap(spans) * 1e-6,
                   device_s_by_name=by_name,
                   idle_gaps=sorted(_label_gaps(gaps, calls) + [
                       ("window edges: before the first or after the last "
                        "device event", max(0.0, edges))],
                       key=lambda kv: -kv[1]))


def ops_per_step(torch, call) -> tuple[float | None, int]:
    """(ATen ops the host dispatches a step, steps) over ``call()`` run on
    this thread under the profiler: the ops that end between the first
    and the last step's end, over the steps between them."""
    prof = _profile(torch)
    with prof:
        call()
    ops = [e for e in _events(prof) if e.get("ph") == "X"
           and e.get("cat") == "cpu_op"]
    ends = sorted(e["ts"] + e["dur"] for e in ops if e["name"] == STEP_OP)
    if len(ends) < 2:
        return None, len(ends)
    inside = sum(1 for e in ops if ends[0] < e["ts"] + e["dur"] <= ends[-1])
    return inside / (len(ends) - 1), len(ends)
