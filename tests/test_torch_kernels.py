"""repro_torch kernels: plain versions against the reference's Pallas
kernels (interpret mode), wrapper input checks and the build's compiler
lookup. The CUDA kernels themselves are held against their plain versions
in ``tests/test_torch_cuda.py``, on a card.

Tolerances follow ``tests/test_kernels.py``: gathers are bitwise, the
fused tails and the FM reduction are held at ``rtol=atol=1e-5``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.fused_cross import (  # noqa: E402
    fused_cross_v1 as pallas_cross_v1, fused_cross_v2 as pallas_cross_v2)
from repro.kernels.fused_fm import (  # noqa: E402
    fused_fm_second_order as pallas_fm)
from repro.kernels.multi_table_lookup import (  # noqa: E402
    mtl_gather as pallas_gather)
from repro_torch.kernels import (_build, launch_counts, ops,  # noqa: E402
                                 ref, reset_launch_counts)
from repro_torch.kernels.fused_cross import (  # noqa: E402
    fused_cross_v1, fused_cross_v1_plain, fused_cross_v2, fused_cross_v2_plain)
from repro_torch.kernels.fused_fm import (  # noqa: E402
    fused_fm_second_order, fused_fm_second_order_plain)
from repro_torch.kernels.multi_table_lookup import (  # noqa: E402
    mtl_gather, mtl_gather_plain)

TOL = dict(rtol=1e-5, atol=1e-5)


def make_tables(rng, sizes, d):
    mega = rng.normal(size=(int(sum(sizes)) + 1, d)).astype(np.float32)
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int32)
    return mega, offsets


def make_ids(rng, sizes, b):
    return np.stack([rng.integers(0, n, size=b) for n in sizes],
                    axis=1).astype(np.int32)


# ---------------------------------------------------------------------------
# K1 mtl_gather
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [1, 8, 32])
@pytest.mark.parametrize("b,k", [(4, 2), (16, 5)])
def test_mtl_gather_bitwise_vs_pallas(b, k, d):
    rng = np.random.default_rng(b * k * d)
    sizes = list(rng.integers(2, 50, size=k))
    mega, offsets = make_tables(rng, sizes, d)
    ids = make_ids(rng, sizes, b)
    rows = (ids + offsets[None, :]).reshape(-1)
    want = np.asarray(pallas_gather(jnp.asarray(rows), jnp.asarray(mega),
                                    interpret=True)).reshape(b, k * d)
    got = mtl_gather(torch.from_numpy(ids), torch.from_numpy(offsets),
                     torch.from_numpy(mega))
    np.testing.assert_array_equal(got.numpy(), want)


def test_mtl_gather_clamps_out_of_range_rows():
    rng = np.random.default_rng(1)
    sizes = [5, 7, 3]
    mega, offsets = make_tables(rng, sizes, 4)
    ids = np.array([[-9, 0, 0], [0, 2**31 - 1, 2], [4, 6, -1]], np.int32)
    got = mtl_gather_plain(torch.from_numpy(ids), torch.from_numpy(offsets),
                           torch.from_numpy(mega)).numpy()
    rows = np.clip(ids.astype(np.int64) + offsets[None, :], 0,
                   mega.shape[0] - 1)
    np.testing.assert_array_equal(got, mega[rows.reshape(-1)].reshape(3, -1))


def test_alg1_literal_matches_every_strategy():
    rng = np.random.default_rng(0)
    sizes, d, b = [3, 17, 5], 4, 6
    mega, offsets = make_tables(rng, sizes, d)
    tables = [mega[o:o + n] for o, n in zip(offsets, sizes)]
    ids = make_ids(rng, sizes, b)
    lit = ref.multi_table_lookup_alg1(ids, tables)
    np.testing.assert_array_equal(
        lit, jref.multi_table_lookup_alg1(ids, tables))
    ids_t, mega_t, off_t = map(torch.from_numpy, (ids, mega, offsets))
    for strategy in ops.STRATEGIES:
        got = ops.multi_table_lookup(ids_t, mega_t, off_t, strategy=strategy)
        np.testing.assert_array_equal(got.numpy(), lit, err_msg=strategy)
    serial = ref.ref_serial_lookup(ids_t, [torch.from_numpy(t)
                                           for t in tables])
    np.testing.assert_array_equal(serial.numpy(), lit)
    with pytest.raises(ValueError):
        ops.multi_table_lookup(ids_t, mega_t, off_t, strategy="onehot")


# ---------------------------------------------------------------------------
# K9 / K10 / K11
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,D", [(4, 16), (32, 80), (7, 200)])
def test_fused_cross_v2_vs_pallas(b, D):
    rng = np.random.default_rng(b * D)
    x0, xw, x = (rng.normal(size=(b, D)).astype(np.float32)
                 for _ in range(3))
    want = pallas_cross_v2(*map(jnp.asarray, (x0, xw, x)), interpret=True)
    got = fused_cross_v2(*map(torch.from_numpy, (x0, xw, x)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("b,D", [(4, 16), (32, 80)])
def test_fused_cross_v1_vs_pallas(b, D):
    rng = np.random.default_rng(b + D)
    x0 = rng.normal(size=(b, D)).astype(np.float32)
    x = rng.normal(size=(b, D)).astype(np.float32)
    bias = rng.normal(size=(D,)).astype(np.float32)
    xlw = rng.normal(size=(b, 1)).astype(np.float32)
    want = pallas_cross_v1(*map(jnp.asarray, (x0, xlw, bias, x)),
                           interpret=True)
    got = fused_cross_v1(*map(torch.from_numpy, (x0, xlw, bias, x)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("b,k,d", [(4, 3, 8), (32, 13, 16), (16, 39, 32),
                                   (8, 39, 1)])
def test_fused_fm_vs_pallas(b, k, d):
    rng = np.random.default_rng(b * k)
    v = rng.normal(size=(b, k, d)).astype(np.float32)
    want = np.asarray(pallas_fm(jnp.asarray(v), interpret=True))
    got = fused_fm_second_order(torch.from_numpy(v))
    assert got.shape == (b, 1)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_plain_versions_match_reference_oracles():
    rng = np.random.default_rng(5)
    x0, xw, x = (rng.normal(size=(6, 10)).astype(np.float32)
                 for _ in range(3))
    xlw = rng.normal(size=(6, 1)).astype(np.float32)
    bias = rng.normal(size=(10,)).astype(np.float32)
    v = rng.normal(size=(6, 4, 3)).astype(np.float32)
    t = torch.from_numpy
    np.testing.assert_allclose(
        fused_cross_v2_plain(t(x0), t(xw), t(x)).numpy(),
        np.asarray(jref.ref_cross_v2_elementwise(x0, xw, x)), **TOL)
    np.testing.assert_allclose(
        fused_cross_v1_plain(t(x0), t(xlw), t(bias), t(x)).numpy(),
        np.asarray(jref.ref_cross_v1_elementwise(x0, xlw, bias, x)), **TOL)
    np.testing.assert_allclose(
        fused_fm_second_order_plain(t(v)).numpy()[:, 0],
        np.asarray(jref.ref_fm_second_order(jnp.asarray(v))), **TOL)


# ---------------------------------------------------------------------------
# wrapper contract
# ---------------------------------------------------------------------------

def test_wrappers_reject_what_the_kernels_do_not_take():
    ids = torch.zeros((4, 3), dtype=torch.int32)
    offs = torch.zeros(3, dtype=torch.int32)
    table = torch.zeros((10, 8))
    with pytest.raises(TypeError):
        mtl_gather(ids.long(), offs, table)
    with pytest.raises(ValueError):
        mtl_gather(ids, offs[:2], table)
    with pytest.raises(ValueError):
        mtl_gather(ids.t(), offs, table)                  # not contiguous
    with pytest.raises(ValueError):
        mtl_gather(ids, offs, table.to("meta"))           # mixed devices
    x = torch.zeros((4, 6))
    with pytest.raises(ValueError):
        fused_cross_v2(x, x, torch.zeros((4, 5)))
    with pytest.raises(TypeError):
        fused_cross_v2(x, x.double(), x)
    with pytest.raises(ValueError):
        fused_cross_v1(x, torch.zeros((4, 2)), torch.zeros(6), x)
    with pytest.raises(ValueError):
        fused_fm_second_order(torch.zeros((4, 6)))


def test_cpu_tensors_launch_nothing():
    reset_launch_counts()
    rng = np.random.default_rng(2)
    mega, offsets = make_tables(rng, [4, 4], 2)
    mtl_gather(torch.zeros((3, 2), dtype=torch.int32),
               torch.from_numpy(offsets), torch.from_numpy(mega))
    fused_fm_second_order(torch.zeros((3, 2, 2)))
    assert launch_counts() == dict.fromkeys(launch_counts(), 0)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(FileNotFoundError):
        _build.find_nvcc()
    monkeypatch.delenv("CUDA_HOME")
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(FileNotFoundError):
        _build.find_nvcc()


def test_build_dir_tracks_sources():
    d = _build.build_dir()
    assert d.parent == _build.BUILD_ROOT and d == _build.build_dir()
    assert {p.stem for p in _build.CSRC.glob("*.cu")} == {
        "mtl_gather", "fused_cross", "fused_fm"}
