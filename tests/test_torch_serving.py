"""repro_torch's serving stack against the reference's: batching policies,
the engine, its worker, the DeviceScheduler pool and the ServingRuntime.

Mirrors ``tests/test_serving.py``, ``tests/test_serving_async.py`` and
``tests/test_scheduler.py``. The reference model and ``InferenceEngine``
are built with JAX; the port's model takes the same parameters through
``repro_torch.bridge.load_jax_params``; the same numpy rows go through
both engines at the same policy and store. Scores agree within
``rtol=1e-5, atol=1e-6`` (``tests/test_system.py:42``: two packages, two
BLAS orders), and every engine counter is equal: requests, batches,
batches per bucket, padded rows, plan-cache hits and misses, every
mirrored store counter, versions and deltas.

Within the port on the CPU, a score is bitwise the same row's score
through a plan of the same bucket (a dense engine, or another mode);
across buckets the tests use the tolerance above, because on a card
cuBLAS may pick another GEMM for another batch size. Every threaded wait
is bounded.
"""

import functools
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

import repro.serving as jserving  # noqa: E402
from repro.configs import ctr_spec as jax_ctr_spec  # noqa: E402
from repro.embedding import CachedStore as JaxCachedStore  # noqa: E402
from repro.embedding import HostBackedStore as JaxHostStore  # noqa: E402
from repro.models.ctr import CTR_MODELS as JAX_MODELS  # noqa: E402
import repro_torch.serving as serving  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.bridge import load_jax_params  # noqa: E402
from repro_torch.configs import ctr_spec  # noqa: E402
from repro_torch.data import CRITEO, zipf_ids  # noqa: E402
from repro_torch.embedding import CachedStore, HostBackedStore  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.models.ctr import CTR_MODELS  # noqa: E402
from repro_torch.serving import (BucketedBatch, DeviceScheduler,  # noqa: E402
                                 FixedBatch, InferenceEngine, QueueFullError,
                                 RequestFuture, ServingRuntime, TimeoutBatch)
from repro_torch.serving.batching import BatchDecision  # noqa: E402

SCHEMA = CRITEO.scaled(2_000)
SPEC_KW = dict(embed_dim=8, hidden=64, max_field=2_000)
TOL = dict(rtol=1e-5, atol=1e-6)
WAIT_S = 60.0

#: every EngineStats counter held equal to the reference's
COUNTERS = (
    "n_requests", "n_batches", "n_rejected", "queue_depth",
    "batches_per_bucket", "padded_rows_total", "cache_hits", "cache_misses",
    "emb_cache_hits", "emb_cache_misses", "emb_cache_refreshes",
    "emb_cached_traffic_fraction", "emb_staged_rows", "emb_prefetched_rows",
    "emb_h2d_bytes", "emb_staging_overflows", "emb_gather_bytes",
    "emb_quant_rows", "emb_quant_bytes_saved", "emb_version",
    "emb_delta_pushes", "emb_delta_rows", "rows_behind",
    "mlp_quant_matmuls", "mlp_quant_weight_bytes",
    "mlp_quant_weight_bytes_saved")


# ---------------------------------------------------------------------------
# harness
# ---------------------------------------------------------------------------

@functools.cache
def jax_params(name, seed=0):
    spec = jax_ctr_spec(name, "criteo", **SPEC_KW)
    return spec, JAX_MODELS[name](spec).init(jax.random.PRNGKey(seed))


def jax_model(name, seed=0):
    """A fresh reference model (an engine rebinds its store) + params."""
    spec, params = jax_params(name, seed)
    return JAX_MODELS[name](spec), params


def port_model(name, seed=0):
    """The port's model on the reference's parameters."""
    model = CTR_MODELS[name](ctr_spec(name, "criteo", **SPEC_KW),
                             device="cpu")
    return load_jax_params(model, jax_params(name, seed)[1])


def rows_of(n, seed=0):
    rng = np.random.default_rng(seed)
    return [np.array([rng.integers(0, s) for s in SCHEMA.field_sizes],
                     dtype=np.int32) for _ in range(n)]


def zipf_rows(n, seed=0, exponent=1.1):
    return list(zipf_ids(np.random.default_rng(seed), n,
                         SCHEMA.field_sizes, exponent=exponent))


def make_policy(pkg, spec):
    """``("fixed", n)``, ``("bucketed", ladder)`` or ``("timeout", inner,
    max_wait_ms)`` as either package's policy object."""
    kind, *args = spec
    if kind == "fixed":
        return pkg.FixedBatch(*args)
    if kind == "bucketed":
        return pkg.BucketedBatch(tuple(args[0]))
    inner, wait = args
    return pkg.TimeoutBatch(make_policy(pkg, inner), max_wait_ms=wait)


def sync_hints(store):
    """Make a host store's prefetch hint wait for its worker, so which
    rows were prefetched — and so every staging counter — is the same in
    both packages, not a race with the worker thread."""
    hint = store.prefetch_hint

    def hint_and_wait(ids, mask=None):
        hint(ids, mask)
        assert store.pipeline.wait_idle(WAIT_S)
    store.prefetch_hint = hint_and_wait
    return store


@pytest.fixture
def host_stores():
    """Host stores made by a test; their prefetch workers stop after."""
    made = []
    yield made
    for s in made:
        s.pipeline.stop()


def make_stores(kind, name, made, capacity=64, staging=16 * 39,
                row_dtype=None):
    """The reference's and the port's store of one kind (None, None for
    the dense default)."""
    if kind == "dense":
        return None, None
    jespec = jax_params(name)[0].embedding_spec()
    espec = ctr_spec(name, "criteo", **SPEC_KW).embedding_spec()
    if kind == "cached":
        return (JaxCachedStore(jespec, capacity=capacity,
                               row_dtype=row_dtype),
                CachedStore(espec, capacity, row_dtype, device="cpu"))
    pair = (sync_hints(JaxHostStore(jespec, capacity=capacity,
                                    staging_capacity=staging,
                                    row_dtype=row_dtype)),
            sync_hints(HostBackedStore(espec, capacity, staging,
                                       row_dtype=row_dtype, device="cpu")))
    made += pair
    return pair


def engine_pair(name="widedeep", policy=("bucketed", (8, 16)),
                store="dense", made=None, store_kw=None, seed=0, **kw):
    """(port engine, reference engine) on the same parameters, policy and
    kind of store."""
    jstore, pstore = make_stores(store, name, made, **(store_kw or {}))
    jm, jp = jax_model(name, seed)
    jeng = jserving.InferenceEngine(jm, jp,
                                    policy=make_policy(jserving, policy),
                                    store=jstore, **kw)
    eng = InferenceEngine(port_model(name, seed),
                          policy=make_policy(serving, policy), store=pstore,
                          device="cpu", **kw)
    return eng, jeng


def assert_same_counters(eng, jeng):
    for f in COUNTERS:
        assert getattr(eng.stats, f) == getattr(jeng.stats, f), f
    assert eng.stats.padding_waste == jeng.stats.padding_waste
    assert set(eng.stats.compile_ms_per_bucket) == \
        set(jeng.stats.compile_ms_per_bucket)
    assert [(k.batch_size, k.store, k.compute_dtype)
            for k in eng.cached_plans] == \
        [(k.batch_size, k.store, k.compute_dtype)
         for k in jeng.cached_plans]


def deltas(n_rows, seed, espec):
    rng = np.random.default_rng(seed)
    ids = rng.choice(espec.zero_row, size=n_rows, replace=False)
    rows = (rng.standard_normal((n_rows, espec.dim)) * 0.1).astype(
        np.float32)
    return ids, rows


def run_step(eng, jeng, op, *args):
    """Apply one step to both engines; returns (port, reference) scores
    where the step serves anything."""
    if op in ("submit", "submit_zipf"):
        rows = (rows_of if op == "submit" else zipf_rows)(*args)
        futs = eng.submit_many(rows)
        jeng.submit_many(rows)
        assert all(isinstance(f, RequestFuture) for f in futs)
        return None
    if op == "serve":
        return eng.serve_pending(*args), jeng.serve_pending(*args)
    if op == "flush":
        return eng.flush(), jeng.flush()
    if op == "predict":
        rows = np.stack(rows_of(*args))
        return eng.predict(rows), jeng.predict(rows)
    if op == "refresh":
        eng.refresh_cache()
        jeng.refresh_cache()
        return None
    if op == "push":
        d = deltas(*args, eng.store.spec)
        assert eng.push_update(*d) == jeng.push_update(*d)
        return None
    assert op == "warmup"
    eng.warmup()
    jeng.warmup()
    return None


# name -> (model, policy, store, store kwargs, engine kwargs, steps)
SCENARIOS = {
    # tests/test_serving.py
    "empty_queue": ("widedeep", ("bucketed", (8, 16)), "dense", {}, {},
                    [("serve",)]),
    "partial_pads_smallest_bucket": (
        "widedeep", ("bucketed", (8, 16)), "dense", {}, {},
        [("submit", 3), ("serve",)]),
    "allow_partial_false_keeps_queue": (
        "widedeep", ("bucketed", (8, 16)), "dense", {}, {},
        [("submit", 5), ("serve", False), ("serve",)]),
    "submit_order_across_buckets": (
        "widedeep", ("bucketed", (8, 16, 32)), "dense", {}, {},
        [("submit", 43), ("serve",)]),
    "plan_cache_hits_and_misses": (
        "widedeep", ("bucketed", (8, 16)), "dense", {}, {},
        [("submit", 43), ("serve",), ("submit", 43, 1), ("serve",)]),
    "mixed_stream_dcn": (
        "dcn", ("bucketed", (8, 16, 32)), "dense", {}, {},
        [("submit", 12, 12), ("serve",), ("submit", 3, 3), ("serve",),
         ("submit", 40, 40), ("serve",), ("submit", 7, 7), ("serve",)]),
    "timeout_holds_then_flushes": (
        "widedeep", ("timeout", ("fixed", 8), 60_000.0), "dense", {}, {},
        [("submit", 3), ("serve",), ("flush",)]),
    "one_shot_predict": ("widedeep", ("bucketed", (8, 16)), "dense", {}, {},
                         [("predict", 5), ("predict", 1)]),
    "one_shot_chunks_oversize": (
        "widedeep", ("bucketed", (8, 16)), "dense", {}, {},
        [("predict", 37)]),
    "fixed_batch_warmup": ("widedeep", ("fixed", 32), "dense", {}, {},
                           [("warmup",), ("submit", 50), ("serve",)]),
    "latency_window": ("widedeep", ("fixed", 8), "dense", {},
                       {"latency_window": 16},
                       [("submit", 8), ("serve",)] * 6),
    "cached_matches_dense": (
        "widedeep", ("bucketed", (8, 16)), "cached", {"capacity": 256}, {},
        [("submit", 21), ("serve",)]),
    "cached_refresh_keeps_plans": (
        "widedeep", ("fixed", 8), "cached", {}, {},
        [("predict", 16, 3), ("refresh",), ("predict", 16, 3)]),
    "cached_auto_refresh": ("widedeep", ("fixed", 8), "cached", {},
                            {"refresh_every": 2},
                            [("submit", 8), ("serve",)] * 4),
    "cached_predict_chunks": (
        "widedeep", ("bucketed", (8, 16)), "cached", {"capacity": 128}, {},
        [("predict", 37, 9)]),
    # tests/test_serving_async.py (sync surface, queue depth, zipf refresh)
    "serve_then_flush": ("widedeep", ("bucketed", (8, 16)), "dense", {}, {},
                         [("submit", 20), ("serve",), ("flush",)]),
    "queue_depth": ("widedeep", ("fixed", 8), "dense", {}, {},
                    [("submit", 5), ("flush",)]),
    "cached_refresh_zipf": (
        "widedeep", ("bucketed", (8, 16)), "cached", {"capacity": 128}, {},
        [("warmup",)] + [s for r in range(3) for s in (
            ("submit_zipf", 24, r), ("serve",), ("refresh",))]),
    # the other models and stores, pushes between batches, int8
    "dcnv2_cached_push": (
        "dcnv2", ("bucketed", (8, 16)), "cached", {}, {"refresh_every": 3},
        [("submit_zipf", 40, 1), ("serve",), ("push", 32, 0),
         ("submit_zipf", 24, 2), ("flush",), ("push", 16, 1),
         ("predict", 20, 5)]),
    "deepfm_cached_int8_rows": (
        "deepfm", ("bucketed", (8, 16)), "cached", {"row_dtype": "int8"},
        {"refresh_every": 2},
        [("submit_zipf", 40, 3), ("serve",), ("push", 24, 2), ("flush",)]),
    "dcnv2_int8_compute": (
        "dcnv2", ("fixed", 16), "dense", {}, {"compute_dtype": "int8"},
        [("submit", 40, 4), ("serve",), ("flush",)]),
    "host_staged_loop": (
        "dcnv2", ("bucketed", (8, 16)), "host", {}, {"refresh_every": 3},
        [("submit_zipf", 56, 5), ("serve",), ("push", 32, 3),
         ("submit_zipf", 30, 6), ("flush",), ("predict", 20, 7)]),
    "host_overflow_chunks": (
        "widedeep", ("fixed", 8), "host", {"staging": 39},
        {"refresh_every": 2},
        [("submit_zipf", 20, 8), ("serve",), ("flush",), ("push", 8, 4),
         ("predict", 12, 9)]),
    "host_int8_rows": (
        "widedeep", ("bucketed", (8, 16)), "host", {"row_dtype": "int8"},
        {"refresh_every": 2},
        [("submit_zipf", 33, 10), ("flush",), ("push", 16, 5),
         ("predict", 16, 11)]),
}


@pytest.mark.parametrize("case", list(SCENARIOS))
def test_engine_matches_reference(case, host_stores):
    """The same steps through both engines: scores within TOL and every
    counter equal after every step."""
    name, policy, store, store_kw, kw, steps = SCENARIOS[case]
    eng, jeng = engine_pair(name, policy, store, host_stores, store_kw, **kw)
    for step in steps:
        out = run_step(eng, jeng, *step)
        if out is not None:
            got, want = out
            assert got.shape == want.shape, step
            np.testing.assert_allclose(got, want, **TOL, err_msg=str(step))
        assert_same_counters(eng, jeng)
        assert eng.pending() == jeng.pending()
    st = eng.stats
    if case == "partial_pads_smallest_bucket":
        assert st.batches_per_bucket == {8: 1} and st.padded_rows_total == 5
    if case == "submit_order_across_buckets":
        assert st.batches_per_bucket == {32: 1, 8: 2}
    if case == "latency_window":
        assert st.n_requests == 48 and len(st.latency_ms) == 16
        assert st.p99_ms >= st.p50_ms >= 0.0
    if store != "dense":
        assert st.emb_cache_hits + st.emb_cache_misses > 0
    if store == "host" and "staging" in store_kw:
        assert st.emb_staging_overflows > 0
    if "push" in {s[0] for s in steps}:
        assert st.emb_version > 0 and st.emb_delta_rows > 0
    if "refresh_every" in kw or "refresh" in {s[0] for s in steps}:
        assert st.emb_cache_refreshes > 0


@pytest.mark.parametrize("store", ["cached", "host"])
def test_tiered_engine_is_bitwise_a_dense_engine_of_the_same_bucket(
        store, host_stores):
    """fp32 tiers change where a row is read from, never its value: the
    port's tiered engine through refreshes and pushes is bitwise its own
    dense engine on the same bucket, replaying the same deltas."""
    eng, _ = engine_pair("dcnv2", ("fixed", 8), store, host_stores,
                         {"capacity": 32, "staging": 39 * 4},
                         refresh_every=2)
    dense = InferenceEngine(port_model("dcnv2"), policy=FixedBatch(8),
                            device="cpu")
    table = dense.store.mega_table
    for r in range(3):
        rows = zipf_rows(24, seed=20 + r)
        eng.submit_many(rows)
        dense.submit_many(rows)
        np.testing.assert_array_equal(eng.serve_pending(),
                                      dense.serve_pending())
        ids, vals = deltas(16, r, eng.store.spec)
        eng.push_update(ids, vals)
        table[torch.from_numpy(ids)] = torch.from_numpy(vals)
    assert eng.stats.emb_cache_refreshes >= 2
    assert eng.stats.cache_misses == 1
    if store == "host":
        assert eng.stats.emb_staging_overflows > 0


# ---------------------------------------------------------------------------
# batching policies (pure)
# ---------------------------------------------------------------------------

POLICIES = {
    "fixed": ("fixed", 32),
    "bucketed": ("bucketed", (8, 16, 32)),
    "bucketed_unsorted": ("bucketed", (64, 8, 8, 32)),
    "timeout": ("timeout", ("fixed", 8), 10.0),
}


@pytest.mark.parametrize("case", list(POLICIES))
def test_policy_decisions_match_reference(case):
    p = make_policy(serving, POLICIES[case])
    jp = make_policy(jserving, POLICIES[case])
    assert p.buckets == jp.buckets
    assert p.partial_hold_ms == jp.partial_hold_ms
    for pending in (0, 1, 3, 7, 8, 9, 20, 33, 100):
        for wait in (0.0, 5.0, 11.0, float("inf")):
            for partial in (False, True):
                d = p.decide(pending, wait, allow_partial=partial)
                jd = jp.decide(pending, wait, allow_partial=partial)
                assert (d is None) == (jd is None), (pending, wait, partial)
                if d is not None:
                    assert (d.take, d.bucket) == (jd.take, jd.bucket)
    if case == "fixed":
        assert p.decide(40, 0.0, allow_partial=False) == BatchDecision(32, 32)
    if case == "bucketed_unsorted":
        assert p.ladder == (8, 32, 64)
        with pytest.raises(ValueError):
            BucketedBatch(())
    if case == "timeout":
        assert p.decide(3, 5.0, allow_partial=True) is None
        assert p.decide(3, 11.0, allow_partial=True) == BatchDecision(3, 8)
    with pytest.raises(ValueError):
        BatchDecision(0, 8)


# ---------------------------------------------------------------------------
# backpressure
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["rejects", "reopens", "unbounded"])
def test_backpressure_matches_reference(case):
    depth = {"rejects": 4, "reopens": 2, "unbounded": None}[case]
    eng, jeng = engine_pair(policy=("bucketed", (8,)),
                            max_queue_depth=depth)
    n = {"rejects": 7, "reopens": 3, "unbounded": 40}[case]
    rows = rows_of(n)
    futs = eng.submit_many(rows)
    jfuts = jeng.submit_many(rows)
    assert [f.done() for f in futs] == [f.done() for f in jfuts]
    rejected = [f for f in futs if f.done()]
    for f in rejected:
        with pytest.raises(QueueFullError):
            f.result(timeout=0.1)
    if case == "reopens":
        eng.flush()
        jeng.flush()
        futs = [eng.submit(rows[0])]
        jeng.submit(rows[0])
        assert not futs[0].done()
    got, want = eng.flush(), jeng.flush()
    np.testing.assert_allclose(got, want, **TOL)
    accepted = [f for f in futs if f not in rejected]
    np.testing.assert_array_equal([f.result(timeout=5.0) for f in accepted],
                                  got)
    assert_same_counters(eng, jeng)
    assert eng.stats.n_rejected == {"rejects": 3, "reopens": 1,
                                    "unbounded": 0}[case]


# ---------------------------------------------------------------------------
# futures
# ---------------------------------------------------------------------------

def test_submit_returns_future_resolved_by_sync_drain():
    eng, jeng = engine_pair(policy=("fixed", 8))
    rows = rows_of(8)
    futs = eng.submit_many(rows)
    jeng.submit_many(rows)
    assert not any(f.done() for f in futs)
    drained = eng.serve_pending()
    assert all(f.done() for f in futs)
    got = np.array([f.result() for f in futs])
    np.testing.assert_array_equal(got, drained)
    np.testing.assert_allclose(got, jeng.serve_pending(), **TOL)
    assert all(f.latency_ms is not None and f.latency_ms >= 0 for f in futs)


def test_future_result_times_out_when_unserved():
    eng = InferenceEngine(port_model("widedeep"), policy=FixedBatch(8),
                          device="cpu")
    fut = eng.submit(rows_of(1)[0])
    with pytest.raises(TimeoutError):
        fut.result(timeout=0.01)


def test_malformed_row_fails_batch_futures_instead_of_hanging():
    eng = InferenceEngine(port_model("widedeep"), policy=FixedBatch(4),
                          device="cpu")
    futs = eng.submit_many(rows_of(3))
    bad = eng.submit(np.zeros(SCHEMA.k + 1, dtype=np.int32))
    with pytest.raises(ValueError):
        eng.flush()
    for f in futs + [bad]:
        assert f.done()
        with pytest.raises(ValueError):
            f.result(timeout=0)


def test_raising_done_callback_does_not_strand_other_futures():
    eng = InferenceEngine(port_model("widedeep"), policy=FixedBatch(8),
                          device="cpu")
    futs = eng.submit_many(rows_of(8))
    futs[0].add_done_callback(lambda f: 1 / 0)
    seen = []
    futs[1].add_done_callback(lambda f: seen.append(f.result()))
    eng.serve_pending()
    assert all(f.done() for f in futs)
    assert seen == [futs[1].result()]
    late = []
    futs[2].add_done_callback(lambda f: late.append(f.result()))
    assert late == [futs[2].result()]              # already done: runs now


# ---------------------------------------------------------------------------
# the background worker
# ---------------------------------------------------------------------------

def test_worker_drains_like_the_reference_in_submit_order():
    """Requests queued before the worker starts drain as the reference's
    sync drain does (same batches and buckets), futures resolve FIFO,
    scores within TOL of the reference's."""
    eng, jeng = engine_pair(policy=("bucketed", (8, 16)))
    eng.warmup()
    jeng.warmup()
    rows = rows_of(43)
    futs = eng.submit_many(rows)
    jeng.submit_many(rows)
    resolved, lock = [], threading.Lock()
    for i, f in enumerate(futs):
        f.add_done_callback(lambda _f, _i=i: (lock.acquire(),
                                              resolved.append(_i),
                                              lock.release()))
    eng.start()
    try:
        got = np.array([f.result(timeout=WAIT_S) for f in futs])
    finally:
        eng.stop()
    assert resolved == list(range(43))
    np.testing.assert_allclose(got, jeng.flush(), **TOL)
    assert_same_counters(eng, jeng)
    assert eng.stats.batches_per_bucket == {16: 2, 8: 2}


def test_worker_fires_timeout_slo_without_polling():
    eng, jeng = engine_pair(policy=("timeout", ("fixed", 8), 25.0),
                            worker_tick_ms=1.0)
    eng.warmup()
    eng.start()
    try:
        rows = rows_of(3)
        futs = eng.submit_many(rows)
        got = np.array([f.result(timeout=WAIT_S) for f in futs])
    finally:
        eng.stop()
    st = eng.stats
    assert st.n_batches == 1 and st.batches_per_bucket == {8: 1}
    assert st.n_requests == 3 and eng.pending() == 0
    jeng.submit_many(rows)
    np.testing.assert_allclose(got, jeng.flush(), **TOL)
    assert st.p50_ms >= 25.0            # the latency covers the SLO wait


class _StalledRow:
    """A request row whose conversion to an array stalls the submitting
    thread, as a loaded host descheduling it between rows would."""

    def __init__(self, row, stall_s):
        self.row, self.stall_s = row, stall_s

    def __array__(self, dtype=None, copy=None):
        time.sleep(self.stall_s)
        return np.asarray(self.row, dtype=dtype)


def test_submit_many_rows_all_cover_the_slo_when_the_submitter_stalls():
    """One ``submit_many`` is one arrival: a 10 ms stall of the caller
    between its rows (the worker thread free to run meanwhile) leaves
    every row's ``t_submit`` the same, so every row's latency covers the
    25 ms SLO, not only the first's."""
    eng, jeng = engine_pair(policy=("timeout", ("fixed", 8), 25.0),
                            worker_tick_ms=1.0)
    eng.warmup()
    eng.start()
    rows = rows_of(3)
    try:
        futs = eng.submit_many([rows[0], _StalledRow(rows[1], 0.010),
                                _StalledRow(rows[2], 0.010)])
        got = np.array([f.result(timeout=WAIT_S) for f in futs])
    finally:
        eng.stop()
    assert len({f.t_submit for f in futs}) == 1
    assert all(f.latency_ms >= 25.0 for f in futs), \
        [f.latency_ms for f in futs]
    assert eng.stats.n_batches == 1 and eng.stats.n_requests == 3
    jeng.submit_many(rows)
    np.testing.assert_allclose(got, jeng.flush(), **TOL)


def test_submit_many_refuses_each_row_past_max_queue_depth():
    """The depth bound stays per row inside one ``submit_many``: rows
    past it fail alone, as the reference's row-by-row ``submit`` does."""
    eng, jeng = engine_pair(policy=("fixed", 8), max_queue_depth=2)
    rows = rows_of(4)
    futs = eng.submit_many(rows)
    jfuts = jeng.submit_many(rows)
    assert [f.done() for f in futs] == [False, False, True, True]
    with pytest.raises(QueueFullError):
        futs[3].result(timeout=0)
    assert eng.stats.n_rejected == jeng.stats.n_rejected == 2
    assert eng.pending() == jeng.pending() == 2
    np.testing.assert_allclose(eng.flush(), jeng.flush(), **TOL)
    assert_same_counters(eng, jeng)
    assert [f.done() for f in jfuts] == [f.done() for f in futs]


def test_worker_drains_full_buckets_immediately():
    eng = InferenceEngine(port_model("widedeep"),
                          policy=TimeoutBatch(FixedBatch(8),
                                              max_wait_ms=60_000.0),
                          device="cpu")
    eng.warmup()
    eng.start()
    try:
        for f in eng.submit_many(rows_of(16)):
            f.result(timeout=WAIT_S)
    finally:
        eng.stop(flush=False)
    assert eng.stats.n_batches == 2 and eng.stats.queue_depth == 0


def test_start_stop_lifecycle_idempotent_and_flushing():
    eng = InferenceEngine(port_model("widedeep"),
                          policy=TimeoutBatch(FixedBatch(8),
                                              max_wait_ms=60_000.0),
                          device="cpu")
    eng.start()
    eng.start()
    assert eng.running
    futs = eng.submit_many(rows_of(3))
    eng.stop()
    assert not eng.running
    assert all(f.done() for f in futs) and eng.pending() == 0
    eng.stop()


def test_concurrent_submitters_with_worker_lose_no_request():
    eng = InferenceEngine(port_model("widedeep"), policy=BucketedBatch((8, 16)),
                          worker_tick_ms=0.2, device="cpu")
    eng.warmup()
    eng.start()
    futs_per_thread = {}

    def submitter(tid):
        futs_per_thread[tid] = eng.submit_many(rows_of(24, seed=tid))

    threads = [threading.Thread(target=submitter, args=(t,))
               for t in range(4)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT_S)
            assert not t.is_alive()
        for fs in futs_per_thread.values():
            for f in fs:
                f.result(timeout=WAIT_S)
    finally:
        eng.stop()
    st = eng.stats
    assert st.n_requests == 96 and st.queue_depth == 0
    assert sum(st.batches_per_bucket.values()) == st.n_batches
    assert eng.worker_error is None
    jm, jp = jax_model("widedeep")
    ref = jserving.InferenceEngine(jm, jp, policy=jserving.FixedBatch(8))
    for tid, fs in futs_per_thread.items():
        np.testing.assert_allclose([f.result() for f in fs],
                                   ref.predict(np.stack(rows_of(24, tid))),
                                   **TOL)


def test_worker_error_counted_and_reraised_from_stop():
    eng = InferenceEngine(port_model("widedeep"),
                          policy=TimeoutBatch(FixedBatch(8), max_wait_ms=5.0),
                          worker_tick_ms=1.0, device="cpu")
    eng.warmup()
    eng.start()
    futs = eng.submit_many(rows_of(2))
    bad = eng.submit(np.zeros(SCHEMA.k + 1, dtype=np.int32))
    for f in futs + [bad]:
        with pytest.raises(ValueError):
            f.result(timeout=WAIT_S)
    assert eng.stats.n_worker_errors == 1
    with pytest.raises(ValueError):
        eng.stop()
    eng.stop()


# ---------------------------------------------------------------------------
# refresh without recompile
# ---------------------------------------------------------------------------

def test_plan_runtime_inputs_match_reference():
    eng, jeng = engine_pair(policy=("fixed", 8), store="cached")
    dense, jdense = engine_pair(policy=("fixed", 8))
    assert eng.plan_for(8).runtime_inputs == jeng.plan_for(8).runtime_inputs
    assert eng.plan_for(8).runtime_inputs == ("emb:backing", "emb:cache",
                                              "emb:slot_of_row")
    assert dense.plan_for(8).runtime_inputs == () \
        == jdense.plan_for(8).runtime_inputs


def test_refresh_under_running_worker_stays_exact():
    """Refreshes between the worker's batches: bitwise a dense engine on
    the same bucket, one compile."""
    rows = zipf_rows(64, seed=7)
    dense = InferenceEngine(port_model("widedeep"), policy=FixedBatch(8),
                            device="cpu")
    want = dense.predict(np.stack(rows))
    eng = InferenceEngine(port_model("widedeep"), policy=FixedBatch(8),
                          store=CachedStore(
                              ctr_spec("widedeep", "criteo", **SPEC_KW)
                              .embedding_spec(), 128, device="cpu"),
                          refresh_every=2, device="cpu")
    eng.warmup()
    eng.start()
    try:
        got = np.array([f.result(timeout=WAIT_S)
                        for f in eng.submit_many(rows)])
    finally:
        eng.stop()
    np.testing.assert_array_equal(got, want)
    assert eng.store.stats.refreshes >= 2
    assert eng.stats.cache_misses == 1


# ---------------------------------------------------------------------------
# the runtime
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scheduler", ["shared", "per-engine"])
def test_runtime_routes_two_models_async_like_the_reference(scheduler):
    """Requests queued before start: each model's batches, buckets and
    counters equal the reference runtime's sync drain, scores within TOL
    and bitwise the port's own sync engine (same buckets)."""
    names = ("widedeep", "dcn")
    rt = ServingRuntime(scheduler=scheduler, pool_size=2)
    jrt = jserving.ServingRuntime()
    pol = ("timeout", ("bucketed", (8, 16)), 5.0)
    for name in names:
        rt.add_model(name, port_model(name), policy=make_policy(serving, pol),
                     worker_tick_ms=1.0, device="cpu")
        jm, jp = jax_model(name)
        jrt.add_model(name, jm, jp, policy=make_policy(jserving, pol))
    assert rt.models == names
    rt.warmup()
    jrt.warmup()
    futs = {n: rt.submit_many(n, rows_of(21, seed=i))
            for i, n in enumerate(names)}
    for i, n in enumerate(names):
        jrt.submit_many(n, rows_of(21, seed=i))
    rt.start()
    try:
        got = {n: np.array([f.result(timeout=WAIT_S) for f in fs])
               for n, fs in futs.items()}
    finally:
        rt.stop()
    want = jrt.flush()
    for i, name in enumerate(names):
        np.testing.assert_allclose(got[name], want[name], **TOL)
        assert_same_counters(rt.engine(name), jrt.engine(name))
        sync = InferenceEngine(port_model(name),
                               policy=make_policy(serving, pol), device="cpu")
        sync.submit_many(rows_of(21, seed=i))
        np.testing.assert_array_equal(got[name], sync.flush())
    agg = rt.stats()
    jagg = jrt.stats()
    assert (agg.n_models, agg.n_requests, agg.n_batches, agg.queue_depth) \
        == (jagg.n_models, jagg.n_requests, jagg.n_batches, 0)
    snap = agg.per_model["widedeep"]
    live = rt.engine("widedeep").stats
    assert snap is not live and snap.n_requests == live.n_requests == 21
    rt.engine("widedeep").predict(rows_of(1)[0])
    assert snap.n_requests == 21
    if scheduler == "shared":
        assert abs(agg.device_time_share - 1.0) < 1e-9
        assert rt.scheduler.n_dispatches == agg.sched_dispatches \
            == agg.n_batches
    else:
        assert rt.scheduler is None and agg.device_time_share == 0.0


def test_runtime_rejects_unknown_and_duplicate_models():
    rt = ServingRuntime()
    model = port_model("widedeep")
    rt.add_model("widedeep", model, policy=FixedBatch(8), device="cpu")
    with pytest.raises(ValueError, match="already registered"):
        rt.add_engine("widedeep", InferenceEngine(model, policy=FixedBatch(8),
                                                  device="cpu"))
    with pytest.raises(KeyError, match="widedeep"):
        rt.submit("nope", rows_of(1)[0])
    with pytest.raises(ValueError, match="scheduler"):
        ServingRuntime(scheduler="round-robin")


def test_runtime_shared_admission_refreshes_all_stores():
    """refresh_every counts traffic across models and refreshes every
    store off the intake thread, with no plan lost; the hit counters
    match a reference runtime driven the same way."""
    rt = ServingRuntime(refresh_every=16)
    jrt = jserving.ServingRuntime(refresh_every=16)
    for name in ("widedeep", "dcn"):
        jstore, store = make_stores("cached", name, None)
        rt.add_model(name, port_model(name), policy=FixedBatch(8),
                     store=store, device="cpu")
        jm, jp = jax_model(name)
        jrt.add_model(name, jm, jp, policy=jserving.FixedBatch(8),
                      store=jstore)
    rt.warmup()
    jrt.warmup()
    plans = {n: set(rt.engine(n).cached_plans) for n in rt.models}
    for i in range(2):
        for r in (rt, jrt):
            for name in r.models:
                r.submit_many(name, rows_of(8, seed=i))
            # the crossing submit started the refresh thread: let it land
            # before the drain, so both packages observe the same order
            r._refresh_thread.join(timeout=WAIT_S)
            r.flush()
    for name in rt.models:
        assert rt.engine(name).store.stats.refreshes == 2
        assert set(rt.engine(name).cached_plans) == plans[name]
        assert_same_counters(rt.engine(name), jrt.engine(name))


def test_serving_surface_matches_reference():
    """The port exports the reference's serving names (its LM ``generate``
    included), and nothing the reference removed."""
    assert set(serving.__all__) == set(jserving.__all__)
    assert not hasattr(serving, "CTRServingEngine")
    assert not hasattr(serving, "ServeStats")
    assert serving.engine.AGGREGATED_COUNTERS == \
        jserving.engine.AGGREGATED_COUNTERS
    assert serving.engine._STORE_MIRROR == jserving.engine._STORE_MIRROR
    assert serving.engine._PLAN_MIRROR == jserving.engine._PLAN_MIRROR
    import dataclasses
    assert [f.name for f in dataclasses.fields(serving.EngineStats)] == \
        [f.name for f in dataclasses.fields(jserving.EngineStats)]
    assert [f.name for f in dataclasses.fields(serving.RuntimeStats)] == \
        [f.name for f in dataclasses.fields(jserving.RuntimeStats)]


def test_engine_runs_on_the_card_unless_told_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = port_model("widedeep")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceEngine(model)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingRuntime().add_model("m", model)


# ---------------------------------------------------------------------------
# the shared pool (tests/test_scheduler.py)
# ---------------------------------------------------------------------------

def build_runtime(n_models, scheduler, pool_size=2, max_wait_ms=3.0,
                  ladder=(8, 16)):
    rt = ServingRuntime(scheduler=scheduler, pool_size=pool_size)
    for i in range(n_models):
        rt.add_model(f"m{i}", port_model("widedeep", seed=i % 2),
                     policy=TimeoutBatch(BucketedBatch(ladder),
                                         max_wait_ms=max_wait_ms),
                     worker_tick_ms=1.0, device="cpu")
    rt.warmup()
    return rt


def drive(rt, rows):
    names = rt.models
    futs = [rt.submit(names[i % len(names)], row)
            for i, row in enumerate(rows)]
    return np.array([f.result(timeout=WAIT_S) for f in futs])


def test_eight_models_two_threads_match_per_engine_mode():
    """N=8 models on a pool of 2 start at most pool_size + 1 threads;
    scores within TOL of per-engine-worker mode (the bucket that serves a
    row depends on timing) and of the reference."""
    rows = rows_of(96)
    shared = build_runtime(8, "shared", pool_size=2)
    before = threading.active_count()
    shared.start()
    peak = threading.active_count()
    try:
        got = drive(shared, rows)
        peak = max(peak, threading.active_count())
    finally:
        shared.stop()
    assert peak - before <= 2 + 1, (peak, before)
    agg = shared.stats()
    assert agg.n_requests == 96 and agg.queue_depth == 0

    per_engine = build_runtime(8, "per-engine")
    before = threading.active_count()
    per_engine.start()
    try:
        want = drive(per_engine, rows)
        workers = threading.active_count() - before
    finally:
        per_engine.stop()
    assert workers >= 8
    np.testing.assert_allclose(got, want, **TOL)
    ref = {s: jserving.InferenceEngine(*jax_model("widedeep", s),
                                       policy=jserving.FixedBatch(16))
           for s in (0, 1)}
    for i, row in enumerate(rows[:16]):
        np.testing.assert_allclose(got[i], ref[(i % 8) % 2].predict(row),
                                   **TOL)


def test_device_time_share_and_dispatch_counters():
    rt = build_runtime(3, "shared", pool_size=2)
    rt.start()
    try:
        drive(rt, rows_of(48))
    finally:
        rt.stop()
    agg = rt.stats()
    assert agg.sched_dispatches >= 3
    assert abs(agg.device_time_share - 1.0) < 1e-9
    for name in rt.models:
        st = agg.per_model[name]
        assert st.sched_dispatches >= 1
        assert 0.0 < st.device_time_share < 1.0
        assert st.sched_preempted_slack_ms >= 0.0
    sched = rt.scheduler
    assert sched is not None and not sched.running
    assert sched.n_dispatches == agg.sched_dispatches
    assert abs(sum(sched.shares.values()) - 1.0) < 1e-9


def test_starved_model_meets_slo_behind_heavy_traffic():
    rt = ServingRuntime(pool_size=2)
    rt.add_model("heavy", port_model("widedeep"),
                 policy=TimeoutBatch(FixedBatch(16), max_wait_ms=50.0),
                 worker_tick_ms=1.0, device="cpu")
    rt.add_model("starved", port_model("widedeep", seed=1),
                 policy=TimeoutBatch(FixedBatch(16), max_wait_ms=10.0),
                 worker_tick_ms=1.0, device="cpu")
    rt.warmup()
    rt.start()
    stop_flag = threading.Event()

    def hammer():
        while not stop_flag.is_set():
            for f in [rt.submit("heavy", r) for r in rows_of(32)]:
                f.result(timeout=WAIT_S)

    t = threading.Thread(target=hammer)
    t.start()
    try:
        stop_flag.wait(0.05)                   # heavy stream in full swing
        futs = [rt.submit("starved", r) for r in rows_of(3, seed=9)]
        t0 = time.perf_counter()
        for f in futs:
            f.result(timeout=30.0)
        waited_ms = (time.perf_counter() - t0) * 1e3
    finally:
        stop_flag.set()
        t.join(timeout=WAIT_S)
        rt.stop()
    assert not t.is_alive()
    assert waited_ms < 5_000.0, waited_ms
    st = rt.stats().per_model["starved"]
    assert st.n_requests == 3 and st.sched_dispatches >= 1


def test_backpressure_stays_per_engine_under_shared_pool():
    rt = ServingRuntime(pool_size=2)
    rt.add_model("bounded", port_model("widedeep"),
                 policy=TimeoutBatch(FixedBatch(64), max_wait_ms=60_000.0),
                 max_queue_depth=4, device="cpu")
    rt.add_model("free", port_model("widedeep", seed=1),
                 policy=TimeoutBatch(FixedBatch(8), max_wait_ms=2.0),
                 worker_tick_ms=1.0, device="cpu")
    rt.warmup()
    rt.start()
    try:
        kept = [rt.submit("bounded", r) for r in rows_of(4)]
        rejected = rt.submit("bounded", rows_of(1, seed=5)[0])
        assert rejected.done()
        with pytest.raises(QueueFullError):
            rejected.result(timeout=0)
        for f in [rt.submit("free", r) for r in rows_of(6, seed=7)]:
            f.result(timeout=WAIT_S)
    finally:
        rt.stop()
    assert all(f.done() for f in kept)
    st = rt.stats()
    assert st.n_rejected == 1
    assert st.per_model["bounded"].n_rejected == 1
    assert st.per_model["free"].n_rejected == 0


@pytest.mark.parametrize("case", ["full_bucket", "timeout_slack",
                                  "default_grace"])
def test_next_ready_matches_reference(case):
    policy, tick, n = {
        "full_bucket": (("bucketed", (8, 16)), 0.5, 19),
        "timeout_slack": (("timeout", ("fixed", 8), 200.0), 0.5, 1),
        "default_grace": (("fixed", 8), 5.0, 3)}[case]
    eng, jeng = engine_pair(policy=policy, worker_tick_ms=tick)
    assert eng.next_ready() is None
    rows = rows_of(n)
    eng.submit_many(rows)
    jeng.submit_many(rows)
    for dt in (0.0, 1.0):
        now = time.perf_counter() + dt
        c, jc = eng.next_ready(now), jeng.next_ready(now)
        assert (c.take, c.bucket, c.partial) == (jc.take, jc.bucket,
                                                 jc.partial)
        assert abs(c.slack_ms - jc.slack_ms) < 50.0  # submit times differ
    c = eng.next_ready()
    if case == "full_bucket":
        assert (c.take, c.bucket, c.partial, c.slack_ms) == (16, 16, False,
                                                             0.0)
    elif case == "timeout_slack":
        assert c.partial and 0.0 < c.slack_ms <= 200.0
        assert eng.next_ready(time.perf_counter() + 1.0).slack_ms < 0.0
    else:
        assert c.partial and c.slack_ms <= 8 * 5.0
    eng.flush()
    assert eng.next_ready() is None


def test_scheduler_picks_least_slack_candidate():
    sched = DeviceScheduler(pool_size=1)
    a = InferenceEngine(port_model("widedeep"),
                        policy=TimeoutBatch(FixedBatch(8), max_wait_ms=5.0),
                        device="cpu")
    b = InferenceEngine(port_model("widedeep", seed=1),
                        policy=TimeoutBatch(FixedBatch(8),
                                            max_wait_ms=500.0),
                        device="cpu")
    sched.attach("a", a)
    sched.attach("b", b)
    b.submit(rows_of(1, seed=1)[0])
    a.submit(rows_of(1, seed=0)[0])
    name, cand, _ = sched._pick(time.perf_counter() + 0.05)
    assert name == "a" and cand.partial
    name, cand, wait = sched._pick(time.perf_counter() - 1.0)
    assert name is None and wait > 0.0          # nothing due yet
    a.flush()
    b.flush()


def test_attach_rejects_conflicts():
    sched = DeviceScheduler(pool_size=1)
    eng = InferenceEngine(port_model("widedeep"), policy=FixedBatch(8),
                          device="cpu")
    sched.attach("m", eng)
    sched.attach("m", eng)
    other = InferenceEngine(port_model("widedeep", seed=1),
                            policy=FixedBatch(8), device="cpu")
    with pytest.raises(ValueError, match="already attached"):
        sched.attach("m", other)
    with pytest.raises(ValueError, match="another scheduler"):
        DeviceScheduler(pool_size=1).attach("m", eng)
    with pytest.raises(ValueError, match="pool_size"):
        DeviceScheduler(pool_size=0)


def test_coalesces_requests_across_intake_streams():
    eng = InferenceEngine(port_model("widedeep"),
                          policy=TimeoutBatch(FixedBatch(8),
                                              max_wait_ms=60_000.0),
                          device="cpu")
    eng.warmup()
    sched = DeviceScheduler(pool_size=2)
    sched.attach("m", eng)
    sched.start()
    futs, lock = [], threading.Lock()

    def intake(seed):
        for f in eng.submit_many(rows_of(4, seed=seed)):
            with lock:
                futs.append(f)

    threads = [threading.Thread(target=intake, args=(s,)) for s in (1, 2)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT_S)
            assert not t.is_alive()
        for f in futs:
            f.result(timeout=WAIT_S)
    finally:
        sched.stop()
    assert eng.stats.n_batches == 1
    assert eng.stats.batches_per_bucket == {8: 1}
    assert eng.stats.sched_dispatches == 1


def test_worker_error_surfaced_through_shared_pool_and_runtime_stop():
    rt = ServingRuntime(pool_size=2)
    rt.add_model("m", port_model("widedeep"),
                 policy=TimeoutBatch(FixedBatch(8), max_wait_ms=5.0),
                 worker_tick_ms=1.0, device="cpu")
    rt.warmup()
    rt.start()
    futs = rt.submit_many("m", rows_of(2))
    bad = rt.submit("m", np.zeros(SCHEMA.k + 1, dtype=np.int32))
    for f in futs + [bad]:
        with pytest.raises(ValueError):
            f.result(timeout=WAIT_S)
    with pytest.raises(ValueError):
        rt.stop()
    assert rt.stats().n_worker_errors == 1
    rt.stop()


# ---------------------------------------------------------------------------
# launch counters under threads
# ---------------------------------------------------------------------------

def test_launch_counters_are_exact_under_threads():
    """8 threads × 10,000 increments through the wrappers' one locked
    helper, with the interpreter switching threads as often as it can:
    the count is exact (a lost update would show), and reset/read keep
    their meaning."""
    kernels.reset_launch_counts()
    assert set(kernels.launch_counts().values()) == {0}
    fns = list(kernels.KERNELS.values())
    start = threading.Barrier(8)

    def bump(i):
        fn = fns[i % 2]
        start.wait(timeout=WAIT_S)
        for _ in range(10_000):
            _build.count_launch(fn)

    threads = [threading.Thread(target=bump, args=(i,)) for i in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT_S)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    counts = kernels.launch_counts()
    names = list(kernels.KERNELS)
    assert counts[names[0]] == counts[names[1]] == 40_000
    assert sum(counts.values()) == 80_000
    kernels.reset_launch_counts()
    assert set(kernels.launch_counts().values()) == {0}
