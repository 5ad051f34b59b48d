"""The traffic: a pure function of the seed, the same work for every seed."""

import collections

import numpy as np
import pytest
import torch

from perfbench import ids, loadgen, manifest


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


SIZES = (5_000_000, 4166, 2, 13, 300_000)


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, -3, 2**70])
def test_pool_is_a_pure_function_of_the_seed(seed):
    a = ids.zipf_pool(SIZES, 5000, 1.1, seed, "cpu", chunk=1024)
    b = ids.zipf_pool(SIZES, 5000, 1.1, seed, "cpu", chunk=1024)
    assert a.dtype == np.int32 and a.shape == (5000, len(SIZES))
    assert np.array_equal(a, b)
    assert (a >= 0).all() and (a < np.asarray(SIZES)[None]).all()
    other = ids.zipf_pool(SIZES, 5000, 1.1, seed + 1, "cpu", chunk=1024)
    assert not np.array_equal(a, other)


def test_pool_follows_the_zipf_law():
    a = ids.zipf_pool((1000,), 200_000, 1.1, 1, "cpu")[:, 0]
    counts = np.bincount(a, minlength=1000)
    assert counts[0] > counts[1] > counts[3] > counts[10] > counts[100]
    # P(0) / P(1) ~ 2^1.1 under the continuous law's inverse CDF
    assert 1.6 < counts[0] / counts[1] < 2.6


def test_sub_seeds_differ_by_use():
    assert ids.sub_seed(5, "ids") != ids.sub_seed(5, "weights")
    assert ids.sub_seed(5, "ids") != ids.sub_seed(6, "ids")
    assert 0 <= ids.sub_seed(-(2**80), "ids") < 2**63


#: an open mix of the generator's other loop, which no cell uses yet
OPEN = {"loop": "open", "threads": 4, "rate_per_s": 100,
        "rows": {"law": "log_uniform", "low": 1024, "high": 8192},
        "ladder": [1024, 2048, 4096, 8192], "pool_rows": 2_097_152}


def _traffic(name):
    return dict(OPEN) if name == "open" else manifest.traffic(name)


@pytest.mark.parametrize("name", ["offline-packed", "open"])
def test_every_seed_gets_the_same_work(name):
    tr = _traffic(name)
    a = loadgen.schedule(tr, 1, 10.0, tr["pool_rows"])
    b = loadgen.schedule(tr, 2, 10.0, tr["pool_rows"])
    assert collections.Counter(a.rows.tolist()) \
        == collections.Counter(b.rows.tolist())
    assert not np.array_equal(a.rows, b.rows)
    assert a.rows.min() >= tr["rows"]["low"]
    assert a.rows.max() <= tr["rows"].get("max_rows", tr["rows"]["high"])
    assert ((a.starts >= 0) & (a.starts + a.rows <= tr["pool_rows"])).all()
    again = loadgen.schedule(tr, 1, 10.0, tr["pool_rows"])
    assert np.array_equal(a.rows, again.rows)
    if tr["loop"] == "open":
        q = [0.1, 0.5, 0.9]
        assert np.quantile(np.diff(a.due), q) \
            == pytest.approx(np.quantile(np.diff(b.due), q), rel=0.02)
        assert np.all(np.diff(a.due) > 0) and a.due[0] == 0
        assert len(a.rows) == round(tr["rate_per_s"] * 10)
        assert a.due[-1] < 10.0


def test_a_closed_loop_takes_the_same_sizes_in_every_stratum():
    tr = manifest.traffic("offline-packed")
    m = len(loadgen.stratum(tr["rows"], tr["stratum"]))
    a = loadgen.schedule(tr, 1, 10.0, tr["pool_rows"])
    b = loadgen.schedule(tr, 2, 10.0, tr["pool_rows"])
    assert len(a.rows) >= tr["schedule_len"] and len(a.rows) % m == 0
    for lo in range(0, len(a.rows), m):
        assert sorted(a.rows[lo:lo + m]) == sorted(b.rows[:m])


def test_packed_samples_are_whole_samples():
    assert loadgen.packed(np.array([5, 4, 3, 6, 2]), 9).tolist() == [9, 9, 2]
    law = manifest.traffic("offline-packed")["rows"]
    sizes = loadgen.stratum(law, 601)
    # every sample size from 100 to 700 rows once
    assert sizes.sum() == sum(range(100, 701)) == 240_400
    assert sizes.max() <= law["max_rows"] == 8192
    # a request closed because its next sample would not fit; the last
    # holds what is left
    assert (sizes[:-1] > law["max_rows"] - law["high"]).all()
    assert sizes[-1] >= law["low"]


def test_log_uniform_sizes_have_the_stated_mean():
    tr = _traffic("open")
    s = loadgen.schedule(tr, 3, 200.0, tr["pool_rows"])
    lo, hi = tr["rows"]["low"], tr["rows"]["high"]
    assert s.rows.mean() == pytest.approx((hi - lo) / np.log(hi / lo),
                                          rel=0.01)
