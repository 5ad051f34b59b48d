"""repro_torch's online updates, zipf traffic and serving CLI against the
reference's.

Mirrors ``tests/test_serving_updates.py``: ``push_update`` /
``pull_updates`` through the engine's versioned publish with zero
recompiles, the empty push, fp32 pushes bitwise a cold engine on the
delta-applied table (same bucket) and int8 tiers re-quantized onto a cold
store's grid, two engines pinning their own versions of one shared
``CachedStore``, the version floor under a concurrent serve and push,
``DeltaBuffer``/``SyntheticTrainer`` (the same stream as the reference's
for a seed) and staleness gauges, the host tier's read-only mmap, and the
runtime's push routing and ``delta_every`` cadence. Each engine case runs
the reference engine beside the port's on the same parameters and
deltas: scores within ``rtol=1e-5, atol=1e-6`` (two packages), counters
equal. Also ``zipf_ids`` against the reference's law (the same uniforms
give the same ids) and ``python -m repro_torch.launch.serve`` against
``python -m repro.launch.serve``: the same counters for the same flags.
"""

import re
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.launch.serve as jax_cli  # noqa: E402
import repro.serving as jserving  # noqa: E402
from repro.configs import ctr_spec as jax_ctr_spec  # noqa: E402
from repro.data.synthetic import CRITEO as JAX_CRITEO  # noqa: E402
from repro.data.synthetic import zipf_ids as jax_zipf_ids  # noqa: E402
from repro.embedding import CachedStore as JaxCachedStore  # noqa: E402
from repro.embedding import HostBackedStore as JaxHostStore  # noqa: E402
from repro.embedding.store import validate_deltas as jax_validate  # noqa: E402
from repro.models.ctr import CTR_MODELS as JAX_MODELS  # noqa: E402
import repro_torch.launch.serve as cli  # noqa: E402
from repro_torch.bridge import load_jax_params  # noqa: E402
from repro_torch.configs import ctr_spec  # noqa: E402
from repro_torch.data import CRITEO, zipf_ids, zipf_ids_from_uniform  # noqa: E402
from repro_torch.embedding import (CachedStore, DenseStore,  # noqa: E402
                                   HostBackedStore)
from repro_torch.embedding.store import validate_deltas  # noqa: E402
from repro_torch.models.ctr import CTR_MODELS  # noqa: E402
from repro_torch.serving import (DeltaBuffer, FixedBatch,  # noqa: E402
                                 InferenceEngine, ServingRuntime,
                                 SyntheticTrainer)

SCHEMA = CRITEO.scaled(2_000)
SPEC_KW = dict(embed_dim=8, hidden=64, max_field=2_000)
JSPEC = jax_ctr_spec("widedeep", "criteo", **SPEC_KW)
SPEC = ctr_spec("widedeep", "criteo", **SPEC_KW)
ESPEC = SPEC.embedding_spec()
JESPEC = JSPEC.embedding_spec()
TOL = dict(rtol=1e-5, atol=1e-6)
WAIT_S = 60.0
PARAMS = JAX_MODELS["widedeep"](JSPEC).init(jax.random.PRNGKey(0))
STORES = {"cached": (JaxCachedStore, CachedStore),
          "host": (JaxHostStore, HostBackedStore)}
COUNTERS = ("n_requests", "n_batches", "batches_per_bucket",
            "padded_rows_total", "cache_hits", "cache_misses",
            "emb_cache_hits", "emb_cache_misses", "emb_cache_refreshes",
            "emb_gather_bytes", "emb_quant_rows", "emb_quant_bytes_saved",
            "emb_staging_overflows", "emb_version", "emb_delta_pushes",
            "emb_delta_rows", "rows_behind")


@pytest.fixture
def made():
    """Stores made by a test; host stores' prefetch workers stop after."""
    stores = []
    yield stores
    for s in stores:
        if hasattr(s, "pipeline"):
            s.pipeline.stop()


def port_model():
    return load_jax_params(CTR_MODELS["widedeep"](SPEC, device="cpu"),
                           PARAMS)


def store_pair(kind, made, row_dtype=None, capacity=64):
    jcls, cls = STORES[kind]
    pair = (jcls(JESPEC, capacity=capacity, row_dtype=row_dtype),
            cls(ESPEC, capacity, row_dtype=row_dtype, device="cpu"))
    made += pair
    return pair


def engine_pair(kind, made, row_dtype=None, batch=16):
    jstore, store = store_pair(kind, made, row_dtype)
    jeng = jserving.InferenceEngine(JAX_MODELS["widedeep"](JSPEC), PARAMS,
                                    policy=jserving.FixedBatch(batch),
                                    store=jstore)
    eng = InferenceEngine(port_model(), policy=FixedBatch(batch),
                          store=store, device="cpu")
    return eng, jeng


def assert_same_counters(eng, jeng):
    for f in COUNTERS:
        assert getattr(eng.stats, f) == getattr(jeng.stats, f), f


def traffic(n=64, seed=1):
    return zipf_ids(np.random.default_rng(seed), n, SCHEMA.field_sizes)


def deltas(n_rows=32, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.choice(ESPEC.zero_row, size=n_rows, replace=False)
    rows = (rng.standard_normal((n_rows, ESPEC.dim)) * 0.1).astype(
        np.float32)
    return ids, rows


# --- validate_deltas: the shared intake contract ------------------------------

@pytest.mark.parametrize("case", ["zero_row", "out_of_range", "duplicates",
                                  "shape", "empty"])
def test_validate_deltas_matches_reference(case):
    d = ESPEC.dim
    ids, rows, err = {
        "zero_row": (np.array([0, ESPEC.zero_row]),
                     np.zeros((2, d), np.float32), "zero row"),
        "out_of_range": (np.array([-1]), np.zeros((1, d), np.float32),
                         "out of range"),
        "duplicates": (np.array([5, 9, 5]),
                       np.stack([np.full(d, v, np.float32)
                                 for v in (1.0, 2.0, 3.0)]), None),
        "shape": (np.array([1, 2]), np.zeros((2, d + 1), np.float32),
                  "shape"),
        "empty": (np.array([], np.int64), np.zeros((0, d)), None)}[case]
    if err is not None:
        with pytest.raises(ValueError, match=err):
            validate_deltas(ESPEC, ids, rows)
        with pytest.raises(ValueError, match=err):
            jax_validate(JESPEC, ids, rows)
        return
    got, want = validate_deltas(ESPEC, ids, rows), jax_validate(JESPEC, ids,
                                                                rows)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    if case == "duplicates":
        assert dict(zip(got[0].tolist(), got[1][:, 0].tolist())) == \
            {5: 3.0, 9: 2.0}


# --- engine push path ---------------------------------------------------------

def test_dense_store_rejects_online_deltas():
    """The engine refuses before it touches the store, as the reference's
    does; the store itself refuses too."""
    eng = InferenceEngine(port_model(), policy=FixedBatch(16), device="cpu")
    jeng = jserving.InferenceEngine(JAX_MODELS["widedeep"](JSPEC), PARAMS,
                                    policy=jserving.FixedBatch(16))
    ids, rows = deltas(4)
    before = eng.store.mega_table.clone()
    for e in (eng, jeng):
        with pytest.raises(ValueError, match="refreshable"):
            e.push_update(ids, rows)
    assert torch.equal(eng.store.mega_table, before)
    assert eng.stats.emb_version == 0
    with pytest.raises(NotImplementedError, match="constants"):
        DenseStore(ESPEC, device="cpu").apply_deltas(ids, rows)


@pytest.mark.parametrize("kind", list(STORES))
def test_push_update_matches_reference_with_zero_recompiles(kind, made):
    eng, jeng = engine_pair(kind, made)
    ids = traffic(32)
    np.testing.assert_allclose(eng.predict(ids), jeng.predict(ids), **TOL)
    compiles, plans = eng.stats.cache_misses, set(eng.cached_plans)
    d_ids, d_rows = deltas(48, seed=3)
    assert eng.push_update(d_ids, d_rows) == jeng.push_update(d_ids, d_rows) \
        == 48
    np.testing.assert_allclose(eng.predict(ids), jeng.predict(ids), **TOL)
    assert eng.stats.cache_misses == compiles
    assert set(eng.cached_plans) == plans
    assert (eng.stats.emb_version, eng.stats.emb_delta_pushes,
            eng.stats.emb_delta_rows) == (1, 1, 48)
    assert_same_counters(eng, jeng)


def test_empty_push_applies_nothing_and_keeps_version(made):
    eng, _ = engine_pair("cached", made)
    assert eng.push_update(np.array([], np.int64),
                           np.zeros((0, ESPEC.dim), np.float32)) == 0
    assert eng.stats.emb_version == 0 and eng.stats.emb_delta_pushes == 0


@pytest.mark.parametrize("kind", list(STORES))
def test_pushed_scores_bitexact_with_rebuilt_dense_engine(kind, made):
    """fp32: serving after 3 pushes is bitwise a cold dense engine on the
    delta-applied table (same bucket), and within TOL of the reference's
    rebuilt engine."""
    eng, jeng = engine_pair(kind, made)
    ids = traffic(32)
    eng.predict(ids)
    table = np.array(PARAMS["emb"]["mega_table"])
    for seed in range(3):
        d_ids, d_rows = deltas(32, seed=seed)
        eng.push_update(d_ids, d_rows)
        table[d_ids] = d_rows
    cold = port_model()
    cold.embedding.store.mega_table.copy_(torch.from_numpy(table))
    ref = InferenceEngine(cold, policy=FixedBatch(16), device="cpu")
    got = eng.predict(ids)
    np.testing.assert_array_equal(got, ref.predict(ids))
    jparams = {**PARAMS, "emb": {**PARAMS["emb"],
                                 "mega_table": jnp.asarray(table)}}
    jref = jserving.InferenceEngine(JAX_MODELS["widedeep"](JSPEC), jparams,
                                    policy=jserving.FixedBatch(16))
    np.testing.assert_allclose(got, jref.predict(ids), **TOL)
    assert eng.stats.emb_version == 3


@pytest.mark.parametrize("kind", list(STORES))
def test_int8_requant_parity_with_cold_store(kind, made):
    """int8 tiers: fp32 delta rows land on the grid a cold int8 store
    gives the delta-applied table — bitwise in the port, within TOL of the
    reference's pushed engine."""
    eng, jeng = engine_pair(kind, made, row_dtype="int8")
    ids = traffic(32)
    eng.predict(ids)
    jeng.predict(ids)
    quant_before = eng.store.stats.quant_rows
    d_ids, d_rows = deltas(48, seed=7)
    eng.push_update(d_ids, d_rows)
    jeng.push_update(d_ids, d_rows)
    assert eng.store.stats.quant_rows == quant_before + 48
    table = np.array(PARAMS["emb"]["mega_table"])
    table[d_ids] = d_rows
    cold_model = port_model()
    cold_model.embedding.store.mega_table.copy_(torch.from_numpy(table))
    _, cold_store = store_pair(kind, made, row_dtype="int8")
    cold = InferenceEngine(cold_model, policy=FixedBatch(16),
                           store=cold_store, device="cpu")
    got = eng.predict(ids)
    np.testing.assert_array_equal(got, cold.predict(ids))
    np.testing.assert_allclose(got, jeng.predict(ids), **TOL)
    assert_same_counters(eng, jeng)


def test_shared_cached_store_pins_ab_versions_independently(made):
    """Two engines over ONE CachedStore: pushes through ``prod`` do not
    reach ``shadow`` — it keeps serving its own last publish — and
    replaying the same stream into ``shadow`` reconverges bitwise; the
    reference's pair does the same."""
    shared = CachedStore(ESPEC, 64, device="cpu")
    jshared = JaxCachedStore(JESPEC, capacity=64)
    prod = InferenceEngine(port_model(), policy=FixedBatch(16),
                           store=shared, device="cpu")
    shadow = InferenceEngine(port_model(), policy=FixedBatch(16),
                             store=shared, device="cpu")
    jprod, jshadow = (jserving.InferenceEngine(
        JAX_MODELS["widedeep"](JSPEC), PARAMS,
        policy=jserving.FixedBatch(16), store=jshared) for _ in range(2))
    ids = traffic(32)
    baseline = shadow.predict(ids)
    np.testing.assert_array_equal(prod.predict(ids), baseline)
    stream = SyntheticTrainer(ESPEC, rows_per_batch=32, n_batches=2, seed=5)
    jstream = jserving.SyntheticTrainer(JESPEC, rows_per_batch=32,
                                        n_batches=2, seed=5)
    for src, e in ((stream, prod), (jstream, jprod)):
        while (batch := src.next_batch()) is not None:
            e.push_update(*batch)
    assert prod.stats.emb_version == 2 and shadow.stats.emb_version == 0
    np.testing.assert_array_equal(shadow.predict(ids), baseline)
    np.testing.assert_allclose(shadow.predict(ids), jshadow.predict(ids),
                               **TOL)
    np.testing.assert_allclose(prod.predict(ids), jprod.predict(ids), **TOL)
    assert not np.array_equal(prod.predict(ids), baseline)
    for src, e in ((stream.replay(), shadow), (jstream.replay(), jshadow)):
        while (batch := src.next_batch()) is not None:
            e.push_update(*batch)
    np.testing.assert_array_equal(shadow.predict(ids), prod.predict(ids))
    for e, je in ((prod, jprod), (shadow, jshadow)):
        assert (e.stats.emb_version, e.stats.emb_delta_pushes,
                e.stats.emb_delta_rows) == (je.stats.emb_version,
                                            je.stats.emb_delta_pushes,
                                            je.stats.emb_delta_rows)
    assert shadow.stats.emb_version == 2


def test_version_monotonic_under_concurrent_serve_and_push(made):
    eng, _ = engine_pair("cached", made)
    ids = traffic(16)
    eng.predict(ids)
    errors = []
    stop = threading.Event()

    def serve():
        try:
            while not stop.is_set():
                eng.predict(ids)
        except BaseException as e:            # noqa: BLE001 — the assert IS the test
            errors.append(e)

    t = threading.Thread(target=serve)
    t.start()
    try:
        for seed in range(30):
            eng.push_update(*deltas(16, seed=seed))
    finally:
        stop.set()
        t.join(timeout=WAIT_S)
    assert not t.is_alive()
    assert not errors, errors
    assert eng.stats.emb_version == 30
    assert eng._version_floor <= 30
    # the floor is hard-asserted: a version that ran backwards raises
    with eng.stats.lock:
        eng._version_floor = 31
    with pytest.raises(AssertionError, match="ran backwards"):
        eng.predict(ids)


# --- delta sources and staleness ----------------------------------------------

def test_delta_buffer_matches_reference():
    bufs = (DeltaBuffer(), jserving.DeltaBuffer())
    for buf in bufs:
        with pytest.raises(ValueError, match="row ids"):
            buf.feed([1, 2], np.zeros((3, ESPEC.dim), np.float32))
        assert buf.feed([1], np.full(ESPEC.dim, 1.0, np.float32)) == 1
        assert buf.feed([2, 3], np.full((2, ESPEC.dim), 2.0,
                                        np.float32)) == 3
    for buf in bufs:
        first = buf.next_batch()
        assert first[0].tolist() == [1] and float(first[1][0, 0]) == 1.0
        assert buf.next_batch()[0].tolist() == [2, 3]
        assert buf.next_batch() is None and buf.pending_rows() == 0


def test_staleness_gauges_match_reference(made):
    now = [100.0]
    eng, jeng = engine_pair("cached", made)
    bufs = (DeltaBuffer(clock=lambda: now[0]),
            jserving.DeltaBuffer(clock=lambda: now[0]))
    for e, buf in zip((eng, jeng), bufs):
        e.attach_delta_source(buf)
        assert e.stats.rows_behind == 0 and e.stats.seconds_behind == 0.0
        buf.feed(*deltas(8, seed=2))
    now[0] += 4.0
    for e in (eng, jeng):
        e.poll_staleness()
        assert e.stats.rows_behind == 8
        assert e.stats.seconds_behind == pytest.approx(4.0)
        assert e.pull_updates() == 8
        assert e.stats.rows_behind == 0 and e.stats.seconds_behind == 0.0
    assert_same_counters(eng, jeng)


def test_synthetic_trainer_is_the_reference_stream():
    """Seeded, finite, replayable — and the reference's deltas for the
    same seed, bitwise."""
    tr = SyntheticTrainer(ESPEC, rows_per_batch=8, n_batches=3, seed=11)
    jtr = jserving.SyntheticTrainer(JESPEC, rows_per_batch=8, n_batches=3,
                                    seed=11)
    assert tr.pending_rows() == jtr.pending_rows() == 24
    batches = []
    while (b := tr.next_batch()) is not None:
        jb = jtr.next_batch()
        for got, want in zip(b, jb):
            np.testing.assert_array_equal(got, want)
        batches.append(b)
    assert jtr.next_batch() is None
    assert len(batches) == 3 and tr.pending_rows() == 0
    again = tr.replay()
    for ids, rows in batches:
        r_ids, r_rows = again.next_batch()
        np.testing.assert_array_equal(ids, r_ids)
        np.testing.assert_array_equal(rows, r_rows)
    assert all(ids.max() < ESPEC.zero_row for ids, _ in batches)
    with pytest.raises(ValueError, match="updatable"):
        SyntheticTrainer(type("S", (), {"zero_row": 0})(), 1, 1)


# --- host backing persistence -------------------------------------------------

def test_host_engine_readonly_mmap_refuses_deltas_rplus_persists(tmp_path,
                                                                 made):
    """An engine over ``HostBackedStore.open(mode="r")`` refuses a push
    before publishing anything; over ``mode="r+"`` the push lands in the
    file."""
    path = tmp_path / "backing.bin"
    seeded = HostBackedStore(ESPEC, 64, backing_path=path, device="cpu")
    made.append(seeded)
    seeded.adopt({"mega_table": np.asarray(PARAMS["emb"]["mega_table"])})
    d_ids, d_rows = deltas(8, seed=4)
    for mode in ("r", "r+"):
        store = HostBackedStore.open(ESPEC, 64, path, mode=mode,
                                     device="cpu")
        made.append(store)
        model = CTR_MODELS["widedeep"](SPEC, store)
        model.load_state_dict(port_model().state_dict(), strict=False)
        eng = InferenceEngine(model, policy=FixedBatch(16), device="cpu")
        if mode == "r":
            with pytest.raises(ValueError, match="mode='r\\+'"):
                eng.push_update(d_ids, d_rows)
            assert eng.stats.emb_version == 0
        else:
            assert eng.push_update(d_ids, d_rows) == 8
    check = HostBackedStore.open(ESPEC, 64, path, device="cpu")
    made.append(check)
    np.testing.assert_array_equal(check.host_view()[d_ids], d_rows)


# --- runtime surface ----------------------------------------------------------

def test_runtime_routes_pushes_and_aggregates_versions_like_reference(made):
    rt, jrt = ServingRuntime(), jserving.ServingRuntime()
    for name in ("a", "b"):
        jstore, store = store_pair("cached", made)
        rt.add_model(name, port_model(), policy=FixedBatch(16), store=store,
                     device="cpu")
        jrt.add_model(name, JAX_MODELS["widedeep"](JSPEC), PARAMS,
                      policy=jserving.FixedBatch(16), store=jstore)
    for r in (rt, jrt):
        r.warmup()
        for seed in range(3):
            r.push_update("a", *deltas(16, seed=seed))
        r.push_update("b", *deltas(16, seed=9))
    st, jst = rt.stats(), jrt.stats()
    assert rt.engine("a").stats.emb_version == 3
    assert rt.engine("b").stats.emb_version == 1
    assert (st.emb_version, st.emb_delta_pushes, st.emb_delta_rows) == \
        (jst.emb_version, jst.emb_delta_pushes, jst.emb_delta_rows) == \
        (3, 4, 64)
    ids = traffic(16)
    np.testing.assert_allclose(rt.predict("a", ids), jrt.predict("a", ids),
                               **TOL)


@pytest.mark.parametrize("scheduler", ["shared", "per-engine"])
def test_runtime_delta_every_drains_stream_under_live_traffic(scheduler,
                                                              made):
    """Background pulls ride the admission count under a running
    drain; by the end the stream is applied, versions accounted, no
    recompile — the reference's totals."""
    rt = ServingRuntime(delta_every=8, scheduler=scheduler)
    jrt = jserving.ServingRuntime(delta_every=8)
    jstore, store = store_pair("cached", made)
    rt.add_model("m", port_model(), policy=FixedBatch(1), store=store,
                 worker_tick_ms=1.0, device="cpu")
    jrt.add_model("m", JAX_MODELS["widedeep"](JSPEC), PARAMS,
                  policy=jserving.FixedBatch(1), store=jstore)
    for r, cls in ((rt, SyntheticTrainer), (jrt, jserving.SyntheticTrainer)):
        r.attach_delta_stream("m", cls(r.engine("m").store.spec,
                                       rows_per_batch=16, n_batches=2,
                                       seed=0))
        r.warmup()
    compiles = rt.engine("m").stats.cache_misses
    rt.start()
    try:
        futs = [rt.submit("m", row) for row in traffic(32)]
        got = np.array([f.result(timeout=WAIT_S) for f in futs])
    finally:
        rt.stop()
    rt.pull_updates()
    jrt.submit_many("m", list(traffic(32)))
    jrt.flush()
    jrt.stop()
    jrt.pull_updates()
    st, jst = rt.stats(), jrt.stats()
    for f in ("emb_version", "emb_delta_pushes", "emb_delta_rows",
              "rows_behind", "n_requests", "n_batches"):
        assert getattr(st, f) == getattr(jst, f), f
    assert (st.emb_version, st.rows_behind, st.seconds_behind) == (2, 0, 0.0)
    assert rt.engine("m").stats.cache_misses == compiles
    assert np.all((got > 0) & (got < 1))


# --- zipf traffic -------------------------------------------------------------

@pytest.mark.parametrize("exponent", [0.0, 1.0, 1.1, 1.5, 2.0])
def test_zipf_ids_follow_the_reference_law(exponent):
    """The reference's own uniforms, mapped by the port: the same ids,
    bitwise; the port's sampler stays in range with the same head."""
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jax_zipf_ids(key, 2048, JAX_CRITEO.field_sizes,
                                       exponent=exponent))
        u = np.asarray(jax.random.uniform(key, (2048, CRITEO.k)))
        got = zipf_ids_from_uniform(u, CRITEO.field_sizes, exponent)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    ids = zipf_ids(np.random.default_rng(0), 4096, CRITEO.field_sizes,
                   exponent)
    assert ids.shape == (4096, CRITEO.k)
    assert (ids >= 0).all() and (ids < np.array(CRITEO.field_sizes)).all()
    np.testing.assert_array_equal(ids, zipf_ids(0, 4096, CRITEO.field_sizes,
                                                exponent))
    big = int(np.argmax(CRITEO.field_sizes))
    head = float(np.mean(ids[:, big] < 100))
    jhead = float(np.mean(want[:, big] < 100))
    assert abs(head - jhead) < 0.05, (head, jhead)


# --- the serving CLI ----------------------------------------------------------

def _counter_lines(text: str) -> list[str]:
    """The CLI's lines without its timings and mean score (the two
    packages draw their weights differently)."""
    out = []
    for line in text.splitlines():
        if not line.startswith("[serve"):
            continue
        line = re.sub(r"p(50|99)=[\d.]+ms", "", line)
        line = re.sub(r"mean_score=[\d.]+", "", line)
        line = re.sub(r"/[\d.]+ms", "", line)
        line = re.sub(r"preempted_slack=[\d.]+ms", "", line)
        out.append(line)
    return out


@pytest.mark.parametrize("flags", [
    "--requests 64",
    "--requests 64 --store cached --delta-every 16",
    "--models deepfm,widedeep --store cached --emb-dtype int8 "
    "--mlp-dtype int8 --refresh-every 2 --requests 40 --policy fixed "
    "--batch 16",
])
def test_cli_prints_the_reference_counters(flags, capsys, monkeypatch):
    cli.main(["--device", "cpu", *flags.split()])
    got = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["serve", *flags.split()])
    jax_cli.main()
    want = capsys.readouterr().out
    assert _counter_lines(got) == _counter_lines(want)
    assert len(_counter_lines(got)) >= 1
    if "delta" in flags:
        assert "[serve:delta] pushes=4 rows=1024 version=v4" in got


def test_cli_refuses_what_is_not_ported(monkeypatch):
    with pytest.raises(SystemExit, match="item 6"):
        cli.main(["--mode", "lm", "--device", "cpu"])
    with pytest.raises(SystemExit, match="DenseStore"):
        cli.main(["--device", "cpu", "--delta-every", "4",
                  "--requests", "8"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--requests", "8"])
    # --mesh is ported: on CUDA it needs a card a position, and says so
    with pytest.raises(SystemExit, match="needs 2 devices, found 0"):
        cli.main(["--mesh", "data=2"])
