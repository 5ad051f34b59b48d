"""The one traffic generator: it reads a traffic file and drives a window.

A traffic file (``traffic/<name>.json``) gives the loop (``closed`` or
``open``), its threads, the candidate rows of a request, the engine's
bucket ladder, the id law, the pool's height, for an open loop the offered
rate, and for the harness the seconds of warm traffic in set-up
(``warm_s``) and the requests the check samples (``check_requests``).
A request's rows follow one of two laws: ``log_uniform`` between ``low``
and ``high``, or ``packed_samples``: samples of ``low`` to ``high`` rows
each (a uniform law), packed whole into requests of at most ``max_rows``
rows, a request closing when its next sample would not fit.
The schedule is stratified: every seed gets the same multiset of request
sizes (and of gaps between arrivals), in an order of its own, so seeds
change which ids and which order, not how much work. A closed loop, which
sends as many requests as it has time for, takes its sizes in whole
strata, each the same multiset in another order: a stratum is
``stratum`` requests (``log_uniform``) or the requests that ``stratum``
samples pack into (``packed_samples``), and the schedule holds at least
``schedule_len`` requests.

A request's block is the next ``rows`` rows of the id pool, taken in turn.
Its latency runs from when it was due to when its scores are on the host.
In a closed loop a request is due when its client sends it; in an open
loop, at its arrival time, whether or not a worker is free.
"""

from __future__ import annotations

import dataclasses
import math
import queue
import threading
import time
from typing import Callable

import numpy as np

from perfbench import manifest
from perfbench.ids import sub_seed

__all__ = ["Schedule", "Request", "Window", "schedule", "stratum", "packed",
           "run_window", "closed_loop", "open_loop"]


@dataclasses.dataclass
class Schedule:
    rows: np.ndarray                 # candidate rows of each request
    starts: np.ndarray               # first pool row of each request
    due: np.ndarray | None = None    # open loop: seconds after the opening


@dataclasses.dataclass
class Request:
    index: int                       # into the schedule, counted on
    rows: int
    start_row: int
    due: float                       # host clock
    sent: float                      # handed to the engine
    done: float | None               # scores on the host; None: failed
    scores: np.ndarray | None
    error: str | None = None


@dataclasses.dataclass
class Window:
    t0: float                        # the window opened
    t1: float                        # nothing is sent or due after this
    t_end: float                     # the last answer came
    attempted: int
    requests: list[Request]          # every request that came back
    lateness_s: np.ndarray | None = None   # open loop: sent after due

    @property
    def answered(self) -> list[Request]:
        return [r for r in self.requests if r.done is not None]

    @property
    def failed(self) -> int:
        return self.attempted - len(self.answered)


def _log_uniform(law: dict, q: np.ndarray) -> np.ndarray:
    if law["law"] != "log_uniform":
        raise ValueError(f"rows law {law['law']!r}: the laws are "
                         f"log_uniform and, in a closed loop, packed_samples")
    lo, hi = int(law["low"]), int(law["high"])
    x = np.exp(np.log(lo) + q * (np.log(hi + 1) - np.log(lo)))
    return np.clip(np.floor(x), lo, hi).astype(np.int64)


def packed(samples: np.ndarray, max_rows: int) -> np.ndarray:
    """Samples packed whole, in order, into requests of at most
    ``max_rows`` rows: a request closes when its next sample would not
    fit."""
    sizes, cur = [], 0
    for s in samples.tolist():
        if cur + s > max_rows:
            sizes.append(cur)
            cur = 0
        cur += s
    sizes.append(cur)
    return np.asarray(sizes, dtype=np.int64)


def stratum(law: dict, m: int) -> np.ndarray:
    """One stratum's request sizes, the same for every seed."""
    q = (np.arange(m) + 0.5) / m
    if law["law"] == "packed_samples":
        lo, hi, cap = int(law["low"]), int(law["high"]), int(law["max_rows"])
        if hi > cap:
            raise ValueError(f"a sample of {hi} rows exceeds max_rows {cap}")
        samples = lo + np.floor(q * (hi - lo + 1)).astype(np.int64)
        # one fixed order of the samples, so the packing is the seed's too
        return packed(np.random.default_rng(0).permutation(samples), cap)
    return _log_uniform(law, q)


def schedule(traffic: dict, seed: int, seconds: float,
             pool_rows: int) -> Schedule:
    """The window's requests: sizes, blocks and (open loop) due times."""
    if traffic["loop"] not in LOOPS:
        return manifest.loop(traffic["loop"]).schedule(traffic, seed,
                                                       seconds, pool_rows)
    rng = np.random.default_rng(sub_seed(seed, "schedule"))
    if traffic["loop"] == "open":
        n = max(1, math.ceil(float(traffic["rate_per_s"]) * seconds))
        q = (np.arange(n) + 0.5) / n
        rows = rng.permutation(_log_uniform(traffic["rows"], q))
    else:
        # a closed loop uses as much of its schedule as it has time for:
        # every stratum of consecutive requests holds the same sizes
        block = stratum(traffic["rows"], int(traffic["stratum"]))
        rows = np.concatenate([
            rng.permutation(block)
            for _ in range(-(-int(traffic["schedule_len"]) // len(block)))])
        n = len(rows)
    if rows.max() > pool_rows:
        raise ValueError(f"a request of {rows.max()} rows exceeds the pool")
    starts = np.empty(n, dtype=np.int64)
    pos = 0
    for j, r in enumerate(rows):
        if pos + r > pool_rows:
            pos = 0
        starts[j] = pos
        pos += r
    due = None
    if traffic["loop"] == "open":
        if traffic.get("arrivals", "poisson") != "poisson":
            raise ValueError(f"unknown arrivals {traffic['arrivals']!r}")
        gaps = rng.permutation(-np.log1p(-q)) / float(traffic["rate_per_s"])
        due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    return Schedule(rows=rows, starts=starts, due=due)


def _call(predict, pool, sched: Schedule, j: int, due: float) -> Request:
    i = j % len(sched.rows)
    r, s = int(sched.rows[i]), int(sched.starts[i])
    sent = time.perf_counter()
    try:
        scores = predict(pool[s:s + r])
    except Exception as exc:                 # a failed request, counted
        return Request(j, r, s, due, sent, None, None, repr(exc))
    return Request(j, r, s, due, sent, time.perf_counter(), scores)


def closed_loop(predict: Callable, pool: np.ndarray, sched: Schedule,
                threads: int, seconds: float, *,
                on_open: Callable[[float], None] | None = None,
                grace_s: float = 60.0) -> Window:
    """``threads`` clients, each sending its next request when the last
    one's scores are back, until ``seconds`` have passed; the requests
    in flight then finish and count."""
    lock = threading.Lock()
    state = {"next": 0, "t1": math.inf}
    go = threading.Event()
    out: list[list[Request]] = [[] for _ in range(threads)]

    def client(mine: list) -> None:
        go.wait()
        while True:
            with lock:
                if time.perf_counter() >= state["t1"]:
                    return
                j = state["next"]
                state["next"] += 1
            req = _call(predict, pool, sched, j, 0.0)
            req.due = req.sent
            mine.append(req)

    workers = [threading.Thread(target=client, args=(out[c],), daemon=True,
                                name=f"perfbench-client-{c}")
               for c in range(threads)]
    for w in workers:
        w.start()
    t0 = time.perf_counter()
    state["t1"] = t0 + seconds
    if on_open is not None:
        on_open(t0)
    go.set()
    deadline = state["t1"] + grace_s
    for w in workers:
        w.join(max(0.0, deadline - time.perf_counter()))
    reqs = sorted((r for mine in out for r in mine), key=lambda r: r.index)
    ends = [r.done for r in reqs if r.done is not None]
    with lock:
        attempted = state["next"]
    return Window(t0=t0, t1=state["t1"], t_end=max(ends, default=t0),
                  attempted=attempted, requests=reqs)


def open_loop(predict: Callable, pool: np.ndarray, sched: Schedule,
              threads: int, seconds: float, *,
              on_open: Callable[[float], None] | None = None,
              grace_s: float = 60.0) -> Window:
    """Requests arrive at their due times, whether or not a worker is
    free, and wait in one queue for ``threads`` workers. This thread is
    the generator; how late it hands each request over is recorded."""
    work: queue.SimpleQueue = queue.SimpleQueue()
    out: list[list[Request]] = [[] for _ in range(threads)]

    def worker(mine: list) -> None:
        while True:
            item = work.get()
            if item is None:
                return
            mine.append(_call(predict, pool, sched, *item))

    workers = [threading.Thread(target=worker, args=(out[c],), daemon=True,
                                name=f"perfbench-worker-{c}")
               for c in range(threads)]
    for w in workers:
        w.start()
    due_s = sched.due[sched.due < seconds]
    t0 = time.perf_counter() + 0.01
    t1 = t0 + seconds
    if on_open is not None:
        on_open(t0)
    late = np.empty(len(due_s))
    for j, d in enumerate(due_s):
        due = t0 + float(d)
        wait = due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        late[j] = time.perf_counter() - due
        work.put((j, due))
    wait = t1 - time.perf_counter()
    if wait > 0:
        time.sleep(wait)
    for _ in workers:
        work.put(None)
    deadline = t1 + grace_s
    for w in workers:
        w.join(max(0.0, deadline - time.perf_counter()))
    reqs = sorted((r for mine in out for r in mine), key=lambda r: r.index)
    ends = [r.done for r in reqs if r.done is not None]
    return Window(t0=t0, t1=t1, t_end=max(ends + [t1]), attempted=len(due_s),
                  requests=reqs, lateness_s=late)


LOOPS = ("closed", "open")


def run_window(traffic: dict, engine, pool: np.ndarray, sched: Schedule,
               seconds: float, **kw) -> Window:
    """The window of the traffic's loop over ``engine``: the generator's
    own loops call ``engine.predict``; any other loop is
    ``loops/<name>.py``'s ``run``."""
    if traffic["loop"] not in LOOPS:
        return manifest.loop(traffic["loop"]).run(traffic, engine, pool,
                                                  sched, seconds, **kw)
    loop = closed_loop if traffic["loop"] == "closed" else open_loop
    return loop(engine.predict, pool, sched, int(traffic["threads"]),
                seconds, **kw)
