"""repro_torch K2–K6 and the int8 row format against the reference.

The plain versions of K2 ``mtl_gather_multihot``, K3 ``mtl_gather_two_level``,
K4 ``mtl_gather_two_level_q8``, K5 ``mtl_gather_three_level`` and K6
``mtl_gather_three_level_q8`` (what the wrappers run on CPU tensors) are
held bitwise against the reference's Pallas kernels in interpret mode, on
tiers cut by the reference's own ``_split_cache``/``_q8_split_cache``
recipes (K2–K4) and on cache + staging tiers that cover every row, leave
some rows in neither tier (the zero guard) or hold a row in both (K5/K6). The port's ``"torch"`` oracle strategies are held against the
reference's ``"jnp"`` ones: bitwise for one-hot gathers, at the reference's
``TOL`` (``rtol=atol=1e-5``) where they pool. ``repro_torch.quant`` is held
bitwise against ``repro.quant``. The CUDA kernels themselves are held
against these plain versions in ``tests/test_torch_cuda.py``, on a card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro import quant as jquant  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch import quant  # noqa: E402
from repro_torch.kernels import (KERNELS, launch_counts, ops,  # noqa: E402
                                 reset_launch_counts)
from repro_torch.kernels.multi_table_lookup import (  # noqa: E402
    mtl_gather_multihot, mtl_gather_multihot_plain, mtl_gather_plain,
    mtl_gather_three_level, mtl_gather_three_level_plain,
    mtl_gather_three_level_q8, mtl_gather_three_level_q8_plain,
    mtl_gather_two_level, mtl_gather_two_level_plain,
    mtl_gather_two_level_q8, mtl_gather_two_level_q8_plain)
from test_kernels import _q8_split_cache, _split_cache  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
SIZES, D = [13, 29, 6], 16
# K3–K6 on the card load a piece of 4 elements a lane where d % 4 == 0
# and single elements at an odd d: their plain versions are held at a
# width of each kind


def with_widths(name, values, widths=(3, 32)):
    """``name`` x ``d`` parameters: the values at ``D`` keep their own ids,
    the other widths add ``-d<width>``."""
    return pytest.mark.parametrize(f"{name},d", [
        pytest.param(v, D, id=str(v)) for v in values] + [
        pytest.param(v, d, id=f"{v}-d{d}") for d in widths for v in values])


def t(x):
    """A reference array as a CPU tensor (copied, so it is writable)."""
    return torch.from_numpy(np.array(x))


def make_mega(rng, zero_row=True, d=D):
    """The mega-table of ``SIZES`` (with the trailing zero row the pooled
    lookups mask into) at width ``d``, its offsets, as jnp arrays."""
    mega = rng.normal(size=(sum(SIZES), d)).astype(np.float32)
    if zero_row:
        mega = np.concatenate([mega, np.zeros((1, d), np.float32)])
    offsets = np.concatenate([[0], np.cumsum(SIZES)[:-1]]).astype(np.int32)
    return jnp.asarray(mega), jnp.asarray(offsets)


def make_slots(rng, b, h):
    ids = np.stack([rng.integers(0, n, size=(b, h)) for n in SIZES],
                   axis=1).astype(np.int32)
    mask = rng.integers(0, 2, size=ids.shape).astype(np.float32)
    return jnp.asarray(ids), jnp.asarray(mask)


def make_onehot(rng, b):
    return jnp.asarray(np.stack([rng.integers(0, n, size=b) for n in SIZES],
                                axis=1).astype(np.int32))


# ---------------------------------------------------------------------------
# plain versions == the reference's Pallas kernels (interpret mode), bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("h", [1, 3, 5])
def test_multihot_plain_bitwise_vs_pallas(h):
    rng = np.random.default_rng(h)
    mega, offsets = make_mega(rng)
    ids, mask = make_slots(rng, 12, h)
    want = jops.multi_table_lookup_multihot(ids, mask, mega, offsets,
                                            strategy="pallas", interpret=True)
    got = mtl_gather_multihot(t(ids), t(mask), t(offsets), t(mega))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@with_widths("capacity", [1, 16, 48])
def test_two_level_plain_bitwise_vs_pallas_and_k1(capacity, d):
    rng = np.random.default_rng(capacity)
    mega, offsets = make_mega(rng, zero_row=False, d=d)
    cache, slot_of_row = _split_cache(rng, mega, capacity)
    ids = make_onehot(rng, 24)
    want = jops.multi_table_lookup_cached(ids, cache, mega, slot_of_row,
                                          offsets, strategy="pallas",
                                          interpret=True)
    got = mtl_gather_two_level(t(ids), t(offsets), t(slot_of_row), t(cache),
                               t(mega))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # K3 at h = 1 is K1 on the same table
    assert torch.equal(got, mtl_gather_plain(t(ids), t(offsets), t(mega)))


@with_widths("h", [1, 3, 5])
def test_two_level_pooled_plain_bitwise_vs_pallas_and_k2(h, d):
    rng = np.random.default_rng(10 + h)
    mega, offsets = make_mega(rng, d=d)
    cache, slot_of_row = _split_cache(rng, mega, 16)
    ids, mask = make_slots(rng, 12, h)
    want = jops.multi_table_lookup_cached_multihot(
        ids, mask, cache, mega, slot_of_row, offsets, strategy="pallas",
        interpret=True)
    got = mtl_gather_two_level(t(ids), t(offsets), t(slot_of_row), t(cache),
                               t(mega), mask=t(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(got, mtl_gather_multihot_plain(t(ids), t(mask),
                                                      t(offsets), t(mega)))


@with_widths("capacity", [1, 16, 48])
def test_two_level_q8_plain_bitwise_vs_pallas(capacity, d):
    rng = np.random.default_rng(capacity)
    mega, offsets = make_mega(rng, zero_row=False, d=d)
    q, scale, cache, cscale, slot_of_row = _q8_split_cache(rng, mega,
                                                           capacity)
    ids = make_onehot(rng, 24)
    want = jops.multi_table_lookup_cached_q8(
        ids, cache, cscale, q, scale, slot_of_row, offsets,
        strategy="pallas", interpret=True)
    got = mtl_gather_two_level_q8(t(ids), t(offsets), t(slot_of_row),
                                  t(cache), t(cscale), t(q), t(scale))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@with_widths("h", [1, 3, 5])
def test_two_level_q8_pooled_plain_bitwise_vs_pallas(h, d):
    rng = np.random.default_rng(20 + h)
    mega, offsets = make_mega(rng, d=d)
    q, scale, cache, cscale, slot_of_row = _q8_split_cache(rng, mega, 16)
    ids, mask = make_slots(rng, 12, h)
    want = jops.multi_table_lookup_cached_q8_multihot(
        ids, mask, cache, cscale, q, scale, slot_of_row, offsets,
        strategy="pallas", interpret=True)
    got = mtl_gather_two_level_q8(t(ids), t(offsets), t(slot_of_row),
                                  t(cache), t(cscale), t(q), t(scale),
                                  mask=t(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the "torch" oracle strategies == the reference's "jnp" ones
# ---------------------------------------------------------------------------

def _oracle_case(name, rng):
    """(port call, reference call) on the same inputs for one lookup."""
    h = 3
    mega, offsets = make_mega(rng)
    cache, slot_of_row = _split_cache(rng, mega, 16)
    q, scale, qcache, qscale, qslots = _q8_split_cache(rng, mega, 16)
    ids, mask = make_slots(rng, 12, h)
    one = make_onehot(rng, 12)
    cases = {
        "multihot": (ops.multi_table_lookup_multihot,
                     jops.multi_table_lookup_multihot,
                     (ids, mask, mega, offsets)),
        "cached": (ops.multi_table_lookup_cached,
                   jops.multi_table_lookup_cached,
                   (one, cache, mega, slot_of_row, offsets)),
        "cached_multihot": (ops.multi_table_lookup_cached_multihot,
                            jops.multi_table_lookup_cached_multihot,
                            (ids, mask, cache, mega, slot_of_row, offsets)),
        "cached_q8": (ops.multi_table_lookup_cached_q8,
                      jops.multi_table_lookup_cached_q8,
                      (one, qcache, qscale, q, scale, qslots, offsets)),
        "cached_q8_multihot": (ops.multi_table_lookup_cached_q8_multihot,
                               jops.multi_table_lookup_cached_q8_multihot,
                               (ids, mask, qcache, qscale, q, scale, qslots,
                                offsets)),
    }
    return cases[name]


@pytest.mark.parametrize("name", ["multihot", "cached", "cached_multihot",
                                  "cached_q8", "cached_q8_multihot"])
def test_torch_strategy_matches_reference_jnp(name):
    port, jax_fn, args = _oracle_case(name, np.random.default_rng(7))
    want = np.asarray(jax_fn(*args, strategy="jnp"))
    got = port(*[t(a) for a in args], strategy="torch").numpy()
    if "multihot" in name:
        np.testing.assert_allclose(got, want, **TOL)
    else:
        np.testing.assert_array_equal(got, want)
    # the kernel strategy (its plain version on the CPU) pools in slot
    # order, the oracle with a sum: equal within the reference's TOL
    np.testing.assert_allclose(
        port(*[t(a) for a in args], strategy="kernel").numpy(), want, **TOL)
    with pytest.raises(ValueError, match="unknown strategy"):
        port(*[t(a) for a in args], strategy="pallas")


# ---------------------------------------------------------------------------
# out-of-range input: clamped rows, out-of-range slots are misses
# ---------------------------------------------------------------------------

BAD_IDS = [-7, 2**31 - 1, 10**8]


def test_plain_versions_clamp_out_of_range_ids():
    rng = np.random.default_rng(3)
    mega, offsets = (np.asarray(a) for a in make_mega(rng))
    n = mega.shape[0]
    ids = np.stack([rng.integers(0, s, size=(4, 2)) for s in SIZES],
                   axis=1).astype(np.int32)
    ids[0, :, 0] = BAD_IDS
    mask = np.ones(ids.shape, np.float32)
    rows = np.clip(ids.astype(np.int64) + offsets[None, :, None], 0, n - 1)
    want = mega[rows].sum(axis=2).reshape(4, -1)
    got = mtl_gather_multihot_plain(t(ids), t(mask), t(offsets), t(mega))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    slot_of_row = np.full(n, -1, np.int32)
    slot_of_row[rows[0, 1, 0]] = 0
    cache = mega[rows[0, 1, 0]][None, :].copy()
    got3 = mtl_gather_two_level_plain(t(ids), t(offsets), t(slot_of_row),
                                      t(cache), t(mega), mask=t(mask))
    assert torch.equal(got3, got)
    q, scale = quant.quantize_rows(t(mega))
    got4 = mtl_gather_two_level_q8_plain(
        t(ids), t(offsets), t(slot_of_row), q[rows[0, 1, 0]][None, :],
        scale[rows[0, 1, 0]][None, :], q, scale, mask=t(mask))
    deq = quant.dequantize_rows(q, scale).numpy()
    np.testing.assert_allclose(got4.numpy(), deq[rows].sum(axis=2).reshape(
        4, -1), rtol=1e-6, atol=1e-6)


def test_slot_outside_the_cache_reads_the_backing():
    rng = np.random.default_rng(4)
    mega, offsets = (np.asarray(a) for a in make_mega(rng, zero_row=False))
    ids = np.asarray(make_onehot(rng, 8))
    cache = np.full((2, D), 99.0, np.float32)
    slot_of_row = np.full(mega.shape[0], 5, np.int32)        # all >= C
    slot_of_row[:3] = -9
    got = mtl_gather_two_level(t(ids), t(offsets), t(slot_of_row), t(cache),
                               t(mega))
    assert torch.equal(got, mtl_gather_plain(t(ids), t(offsets), t(mega)))


def test_masked_slots_read_the_zero_row():
    rng = np.random.default_rng(5)
    mega, offsets = (np.asarray(a) for a in make_mega(rng))
    ids, _ = make_slots(rng, 6, 4)
    ids = np.asarray(ids)
    none = np.zeros(ids.shape, np.float32)
    got = mtl_gather_multihot(t(ids), t(none), t(offsets), t(mega))
    assert torch.all(got == 0.0)
    first = none.copy()
    first[..., 0] = 1.0
    got = mtl_gather_multihot(t(ids), t(first), t(offsets), t(mega))
    assert torch.equal(got, mtl_gather_plain(t(ids[..., 0]), t(offsets),
                                             t(mega)))


# ---------------------------------------------------------------------------
# wrapper input checks, registry, launch counts
# ---------------------------------------------------------------------------

def _good_args(rng):
    mega, offsets = (np.asarray(a) for a in make_mega(rng))
    q, scale = jquant.quantize_rows(mega)
    q, scale = np.asarray(q), np.asarray(scale)
    ids = np.asarray(make_slots(rng, 4, 2)[0])
    slot_of_row = np.full(mega.shape[0], -1, np.int32)
    slot_of_row[:2] = [0, 1]
    return dict(ids=ids, mask=np.ones(ids.shape, np.float32),
                offsets=offsets, mega=mega, cache=mega[:2].copy(), q=q,
                scale=scale, qcache=q[:2].copy(), qscale=scale[:2].copy(),
                slot_of_row=slot_of_row)


def _call(kernel, a):
    a = {k: t(v) for k, v in a.items()}
    if kernel == "multihot":
        return mtl_gather_multihot(a["ids"], a["mask"], a["offsets"],
                                   a["mega"])
    if kernel == "two_level":
        return mtl_gather_two_level(a["ids"], a["offsets"], a["slot_of_row"],
                                    a["cache"], a["mega"], mask=a["mask"])
    return mtl_gather_two_level_q8(a["ids"], a["offsets"], a["slot_of_row"],
                                   a["qcache"], a["qscale"], a["q"],
                                   a["scale"], mask=a["mask"])


BAD_INPUTS = [(kernel, bad) for kernel in ("multihot", "two_level", "q8")
              for bad in ("ids_dtype", "mask_shape", "mask_dtype",
                          "offsets_len", "map_len", "table_dtype",
                          "noncontiguous")
              if (kernel, bad) != ("multihot", "map_len")]   # K2 has no map


@pytest.mark.parametrize("kernel,bad", BAD_INPUTS)
def test_wrappers_reject_what_the_kernels_do_not_take(kernel, bad):
    a = _good_args(np.random.default_rng(6))
    _call(kernel, a)                                   # the good call runs
    if bad == "ids_dtype":
        a["ids"] = a["ids"].astype(np.int64)
    elif bad == "mask_shape":
        a["mask"] = a["mask"][:, :, :1]
    elif bad == "mask_dtype":
        a["mask"] = a["mask"].astype(np.float64)
    elif bad == "offsets_len":
        a["offsets"] = a["offsets"][:2]
    elif bad == "map_len":
        a["slot_of_row"] = a["slot_of_row"][:-1]
    elif bad == "table_dtype":
        a["mega"], a["q"] = a["q"], a["mega"]
        a["cache"], a["qcache"] = a["qcache"], a["cache"]
    elif bad == "noncontiguous":
        a["ids"] = np.asfortranarray(a["ids"])
    with pytest.raises((TypeError, ValueError)):
        _call(kernel, a)


def test_registry_lists_the_tiered_kernels_and_cpu_counts_nothing():
    assert {"mtl_gather_multihot", "mtl_gather_two_level",
            "mtl_gather_two_level_q8"} <= set(KERNELS)
    reset_launch_counts()
    a = _good_args(np.random.default_rng(8))
    for kernel in ("multihot", "two_level", "q8"):
        _call(kernel, a)
    assert all(n == 0 for n in launch_counts().values())


# ---------------------------------------------------------------------------
# repro_torch.quant == repro.quant, bitwise
# ---------------------------------------------------------------------------

def _quant_table(rng):
    x = rng.normal(size=(32, 12)).astype(np.float32) * 0.05
    x[3] = 0.0                                          # all-zero row
    x[5, :5] = [127.0, 0.5, 1.5, 2.5, -2.5]             # scale 1: half-steps
    x[5, 5:] = -0.5
    x[7, :4] = [254.0, 1.0, 3.0, -5.0]                  # scale 2: half-steps
    x[7, 4:] = 0.0
    return x


def test_quantize_rows_bitwise_vs_reference():
    x = _quant_table(np.random.default_rng(0))
    jq, js = (np.asarray(a) for a in jquant.quantize_rows(jnp.asarray(x)))
    q, s = quant.quantize_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(q.numpy(), jq)
    np.testing.assert_array_equal(s.numpy(), js)
    assert q.dtype == torch.int8 and s.shape == (32, 1)
    np.testing.assert_array_equal(q[5, :5].numpy(), [127, 0, 2, 2, -2])
    assert torch.all(q[3] == 0) and s[3].item() == np.float32(quant.SCALE_EPS)
    assert int(q.min()) >= -127
    np.testing.assert_array_equal(
        quant.dequantize_rows(q, s).numpy(),
        np.asarray(jquant.dequantize_rows(jnp.asarray(jq), jnp.asarray(js))))
    assert torch.all(quant.dequantize_rows(q, s)[3] == 0.0)


# ---------------------------------------------------------------------------
# K5/K6: the host tier's three-level gathers (cache / staging / zero)
# ---------------------------------------------------------------------------

TIER_CASES = ("full", "partial", "both")
STALE = 7.0         # what a staged copy of a cached row holds in "both"


def make_tiers(rng, mega, case):
    """Cache and staging tiers over ``mega`` (numpy), fp32 and int8, and
    both maps. "full": every row in one tier; "partial": 8 cached and 8
    staged rows, the rest in neither (the zero guard); "both": as "full",
    and four cached rows also staged, with another value (the cache must
    win)."""
    n, d = mega.shape
    capacity, staged = (8, 8) if case == "partial" else (16, n - 16)
    pick = rng.choice(n, size=capacity + staged, replace=False)
    hot, warm = np.sort(pick[:capacity]), np.sort(pick[capacity:])
    extra = hot[:4] if case == "both" else hot[:0]
    slot_of_row = np.full(n, -1, np.int32)
    slot_of_row[hot] = np.arange(capacity, dtype=np.int32)
    smap = np.full(n, -1, np.int32)
    smap[warm] = np.arange(staged, dtype=np.int32)
    smap[extra] = staged + np.arange(extra.size, dtype=np.int32)
    q, scale = (np.asarray(a) for a in jquant.quantize_rows(mega))
    return dict(
        slot_of_row=slot_of_row, smap=smap, cache=mega[hot],
        staging=np.concatenate([mega[warm],
                                np.full((extra.size, d), STALE, np.float32)]),
        qcache=q[hot], qscale=scale[hot],
        qstaging=np.concatenate([q[warm], np.full((extra.size, d), 5,
                                                  np.int8)]),
        qsscale=np.concatenate([scale[warm],
                                np.ones((extra.size, 1), np.float32)]))


def _host_args(h, case, seed, d=D):
    rng = np.random.default_rng(seed)
    mega, offsets = (np.asarray(a) for a in make_mega(rng, d=d))
    tiers = make_tiers(rng, mega, case)
    ids, mask = (np.asarray(a) for a in make_slots(rng, 12, h))
    if h == 1:
        ids = ids[..., 0].copy()
    return mega, offsets, tiers, ids, mask


@pytest.mark.parametrize("case", TIER_CASES)
@with_widths("h", [1, 3])
def test_three_level_plain_bitwise_vs_pallas(h, d, case):
    mega, offsets, tr, ids, mask = _host_args(h, case, 30 + h, d)
    args = (tr["cache"], tr["staging"], tr["slot_of_row"], tr["smap"],
            offsets)
    if h == 1:
        want = jops.multi_table_lookup_host(ids, *args, strategy="pallas",
                                            interpret=True)
        m = None
    else:
        want = jops.multi_table_lookup_host_multihot(
            ids, mask, *args, strategy="pallas", interpret=True)
        m = t(mask)
    got = mtl_gather_three_level(t(ids), t(offsets), t(tr["slot_of_row"]),
                                 t(tr["smap"]), t(tr["cache"]),
                                 t(tr["staging"]), mask=m)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if case == "partial":
        return
    # every row resolves: K5 is K1 (h = 1) and K2 (pooled) on the table
    if h == 1:
        assert torch.equal(got, mtl_gather_plain(t(ids), t(offsets), t(mega)))
    else:
        assert torch.equal(got, mtl_gather_multihot_plain(
            t(ids), t(mask), t(offsets), t(mega)))


@pytest.mark.parametrize("case", TIER_CASES)
@with_widths("h", [1, 3])
def test_three_level_q8_plain_bitwise_vs_pallas(h, d, case):
    _, offsets, tr, ids, mask = _host_args(h, case, 40 + h, d)
    args = (tr["qcache"], tr["qscale"], tr["qstaging"], tr["qsscale"],
            tr["slot_of_row"], tr["smap"], offsets)
    if h == 1:
        want = jops.multi_table_lookup_host_q8(ids, *args, strategy="pallas",
                                               interpret=True)
        m = None
    else:
        want = jops.multi_table_lookup_host_q8_multihot(
            ids, mask, *args, strategy="pallas", interpret=True)
        m = t(mask)
    got = mtl_gather_three_level_q8(
        t(ids), t(offsets), t(tr["slot_of_row"]), t(tr["smap"]),
        t(tr["qcache"]), t(tr["qscale"]), t(tr["qstaging"]),
        t(tr["qsscale"]), mask=m)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_three_level_zero_guard_and_cache_priority():
    """Rows in neither tier read exactly 0.0 (K5 and K6); a row in both
    reads the cache's copy."""
    mega, offsets, tr, ids, _ = _host_args(1, "partial", 50)
    rows = ids.astype(np.int64) + offsets[None, :]
    neither = (tr["slot_of_row"][rows] < 0) & (tr["smap"][rows] < 0)
    assert neither.any() and not neither.all()
    b, k = ids.shape
    for got in (mtl_gather_three_level(
                    t(ids), t(offsets), t(tr["slot_of_row"]), t(tr["smap"]),
                    t(tr["cache"]), t(tr["staging"])),
                mtl_gather_three_level_q8(
                    t(ids), t(offsets), t(tr["slot_of_row"]), t(tr["smap"]),
                    t(tr["qcache"]), t(tr["qscale"]), t(tr["qstaging"]),
                    t(tr["qsscale"]))):
        got = got.numpy().reshape(b, k, -1)
        assert np.all(got[neither] == 0.0)
        assert not np.any(np.signbit(got[neither]))
        assert np.all(np.abs(got[~neither]).sum(axis=-1) > 0)
    mega, offsets, tr, ids, _ = _host_args(1, "both", 51)
    both = np.flatnonzero((tr["slot_of_row"] >= 0) & (tr["smap"] >= 0))
    assert both.size == 4
    ids = np.zeros((4, len(SIZES)), np.int32)
    field = np.searchsorted(offsets, both, side="right") - 1
    ids[np.arange(4), field] = both - offsets[field]
    got = mtl_gather_three_level(t(ids), t(offsets), t(tr["slot_of_row"]),
                                 t(tr["smap"]), t(tr["cache"]),
                                 t(tr["staging"]))
    assert not torch.any(got == STALE)
    assert torch.equal(got, mtl_gather_plain(t(ids), t(offsets), t(mega)))


def test_three_level_plain_versions_clamp_and_bound_slots():
    """Ids -7, 2**31-1 and 10**8 read clamped rows; a cache slot >= C or a
    staging slot >= S counts as absent (the next tier, or zero)."""
    rng = np.random.default_rng(52)
    mega, offsets = (np.asarray(a) for a in make_mega(rng))
    n = mega.shape[0]
    tr = make_tiers(rng, mega, "full")
    ids = np.array(make_onehot(rng, 6))
    ids[0, :3] = BAD_IDS
    rows = np.clip(ids.astype(np.int64) + offsets[None, :], 0, n - 1)
    args = (t(ids), t(offsets), t(tr["slot_of_row"]), t(tr["smap"]),
            t(tr["cache"]), t(tr["staging"]))
    got = mtl_gather_three_level(*args)
    np.testing.assert_array_equal(got.numpy(),
                                  mega[rows].reshape(6, -1))
    som, smap = tr["slot_of_row"].copy(), tr["smap"].copy()
    r_cached = int(np.flatnonzero(som >= 0)[0])
    r_staged = int(np.flatnonzero((smap >= 0) & (som < 0))[0])
    som[r_cached] = tr["cache"].shape[0] + 3        # past the cache
    smap[r_cached] = -1
    smap[r_staged] = tr["staging"].shape[0] + 3     # past the staging area
    out = mtl_gather_three_level_plain(
        t(np.array([[r_cached], [r_staged]], np.int32)),
        t(np.zeros(1, np.int32)), t(som), t(smap), t(tr["cache"]),
        t(tr["staging"]))
    assert torch.all(out == 0.0)
    outq = mtl_gather_three_level_q8_plain(
        t(np.array([[r_cached], [r_staged]], np.int32)),
        t(np.zeros(1, np.int32)), t(som), t(smap), t(tr["qcache"]),
        t(tr["qscale"]), t(tr["qstaging"]), t(tr["qsscale"]))
    assert torch.all(outq == 0.0)


def _host_oracle_case(name, rng):
    """(port call, reference call) on the same inputs for one host-tier
    lookup."""
    mega, offsets = (np.asarray(a) for a in make_mega(rng))
    tr = make_tiers(rng, mega, "full")
    ids, mask = (np.asarray(a) for a in make_slots(rng, 12, 3))
    one = np.asarray(make_onehot(rng, 12))
    f32 = (tr["cache"], tr["staging"], tr["slot_of_row"], tr["smap"],
           offsets)
    q8 = (tr["qcache"], tr["qscale"], tr["qstaging"], tr["qsscale"],
          tr["slot_of_row"], tr["smap"], offsets)
    cases = {
        "host": (ops.multi_table_lookup_host, jops.multi_table_lookup_host,
                 (one, *f32)),
        "host_multihot": (ops.multi_table_lookup_host_multihot,
                          jops.multi_table_lookup_host_multihot,
                          (ids, mask, *f32)),
        "host_q8": (ops.multi_table_lookup_host_q8,
                    jops.multi_table_lookup_host_q8, (one, *q8)),
        "host_q8_multihot": (ops.multi_table_lookup_host_q8_multihot,
                             jops.multi_table_lookup_host_q8_multihot,
                             (ids, mask, *q8)),
    }
    return cases[name]


@pytest.mark.parametrize("name", ["host", "host_multihot", "host_q8",
                                  "host_q8_multihot"])
def test_host_ops_match_reference(name):
    """"torch" == the reference's "jnp" (bitwise one-hot, ``TOL`` pooled);
    "kernel"/"auto" (the plain version on the CPU) == the reference's
    "pallas" in interpret mode, bitwise."""
    port, jax_fn, args = _host_oracle_case(name, np.random.default_rng(9))
    jargs = [jnp.asarray(a) for a in args]
    want = np.asarray(jax_fn(*jargs, strategy="jnp"))
    want_pl = np.asarray(jax_fn(*jargs, strategy="pallas", interpret=True))
    got = port(*[t(a) for a in args], strategy="torch").numpy()
    if "multihot" in name:
        np.testing.assert_allclose(got, want, **TOL)
    else:
        np.testing.assert_array_equal(got, want)
    for strategy in ("kernel", "auto"):
        np.testing.assert_array_equal(
            port(*[t(a) for a in args], strategy=strategy).numpy(), want_pl)
    with pytest.raises(ValueError, match="unknown strategy"):
        port(*[t(a) for a in args], strategy="serial")


def _host_call(kernel, a):
    a = {k: t(v) for k, v in a.items()}
    if kernel == "three_level":
        return mtl_gather_three_level(a["ids"], a["offsets"],
                                      a["slot_of_row"], a["smap"],
                                      a["cache"], a["staging"],
                                      mask=a["mask"])
    return mtl_gather_three_level_q8(a["ids"], a["offsets"], a["slot_of_row"],
                                     a["smap"], a["qcache"], a["qscale"],
                                     a["qstaging"], a["qsscale"],
                                     mask=a["mask"])


HOST_BAD_INPUTS = [(kernel, bad) for kernel in ("three_level", "q8")
                   for bad in ("ids_dtype", "mask_shape", "offsets_len",
                               "map_len", "staging_map_len", "map_dtype",
                               "staging_width", "table_dtype",
                               "noncontiguous")]


@pytest.mark.parametrize("kernel,bad", HOST_BAD_INPUTS)
def test_host_wrappers_reject_what_the_kernels_do_not_take(kernel, bad):
    rng = np.random.default_rng(10)
    mega, offsets = (np.asarray(a) for a in make_mega(rng))
    a = {k: v for k, v in make_tiers(rng, mega, "partial").items()}
    a["ids"] = np.asarray(make_slots(rng, 4, 2)[0])
    a["mask"] = np.ones(a["ids"].shape, np.float32)
    a["offsets"] = offsets
    _host_call(kernel, a)                               # the good call runs
    if bad == "ids_dtype":
        a["ids"] = a["ids"].astype(np.int64)
    elif bad == "mask_shape":
        a["mask"] = a["mask"][:, :, :1]
    elif bad == "offsets_len":
        a["offsets"] = a["offsets"][:2]
    elif bad == "map_len":
        a["slot_of_row"] = a["slot_of_row"][:-1]
    elif bad == "staging_map_len":
        a["smap"] = a["smap"][:-1]
    elif bad == "map_dtype":
        a["smap"] = a["smap"].astype(np.int64)
    elif bad == "staging_width":
        a["staging"] = a["staging"][:, :-1].copy()
        a["qstaging"] = a["qstaging"][:, :-1].copy()
    elif bad == "table_dtype":
        a["cache"], a["qcache"] = a["qcache"], a["cache"]
        a["staging"], a["qstaging"] = a["qstaging"], a["staging"]
    elif bad == "noncontiguous":
        a["ids"] = np.asfortranarray(a["ids"])
    with pytest.raises((TypeError, ValueError)):
        _host_call(kernel, a)


def test_registry_lists_the_host_kernels_and_cpu_counts_nothing():
    assert {"mtl_gather_three_level", "mtl_gather_three_level_q8"} \
        <= set(KERNELS)
    rng = np.random.default_rng(11)
    mega, offsets = (np.asarray(a) for a in make_mega(rng))
    a = dict(make_tiers(rng, mega, "full"), offsets=offsets)
    a["ids"] = np.asarray(make_slots(rng, 4, 2)[0])
    a["mask"] = np.ones(a["ids"].shape, np.float32)
    reset_launch_counts()
    for kernel in ("three_level", "q8"):
        _host_call(kernel, a)
    assert all(n == 0 for n in launch_counts().values())
