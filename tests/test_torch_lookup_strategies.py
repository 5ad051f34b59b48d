"""repro_torch's input-first (K8) and one-hot (K7) lookups against the
reference.

The plain version of K8 (what ``mtl_input_first`` runs on CPU tensors) and
``multi_table_lookup(strategy="input_first")`` are held bitwise against the
reference's ``input_first`` strategy (its Pallas kernel in interpret mode
and its transpose) and against K1's plain version: the strawman lays the
work out by input, but every output float is a copy of a table float.
The tiered stores reject the strategy, as the reference's do. The plain
version of K7 is held bitwise against the reference's ``mtl_onehot`` in
interpret mode over its own sweep (``tests/test_kernels.py:102-115``): a
one-hot row has one nonzero term and an fp32 accumulator, so the product
is exact, and an id outside ``[0, n_pad)`` gives a zero row in both. The
CUDA kernels are held against these plain versions in
``tests/test_torch_cuda.py``, on a card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.embedding import CachedStore as JaxCachedStore  # noqa: E402
from repro.embedding import FusedEmbeddingCollection as JaxColl  # noqa: E402
from repro.embedding import FusedEmbeddingSpec as JaxSpec  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.multi_table_lookup import mtl_onehot as jax_onehot  # noqa: E402
from repro_torch.embedding import (CachedStore, FusedEmbeddingCollection,  # noqa: E402
                                   FusedEmbeddingSpec, HostBackedStore)
from repro_torch.kernels import KERNELS, ops  # noqa: E402
from repro_torch.kernels.multi_table_lookup import (  # noqa: E402
    mtl_gather_plain, mtl_input_first, mtl_input_first_plain, mtl_onehot,
    mtl_onehot_plain)


def t(x):
    """A reference array as a CPU tensor (copied, so it is writable)."""
    return torch.from_numpy(np.array(x))


def make_lookup(rng, sizes, d, b):
    mega = rng.normal(size=(sum(sizes), d)).astype(np.float32)
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int32)
    ids = np.stack([rng.integers(0, n, size=b) for n in sizes],
                   axis=1).astype(np.int32)
    return ids, mega, offsets


# ---------------------------------------------------------------------------
# K8: input-first
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sizes,d,b", [
    ([13, 29, 6], 16, 12), ([7, 1, 40, 3, 9], 8, 33), ([100], 32, 5),
    ([5, 5], 1, 64),
])
def test_input_first_bitwise_vs_reference_and_k1(sizes, d, b):
    rng = np.random.default_rng(len(sizes) * 100 + d)
    ids, mega, offsets = make_lookup(rng, sizes, d, b)
    want = np.asarray(jops.multi_table_lookup(
        jnp.asarray(ids), jnp.asarray(mega), jnp.asarray(offsets),
        strategy="input_first", interpret=True))
    args = tuple(map(torch.from_numpy, (ids, offsets, mega)))
    got = ops.multi_table_lookup(args[0], args[2], args[1],
                                 strategy="input_first")
    assert tuple(got.shape) == (b, len(sizes) * d)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(mtl_input_first_plain(*args).numpy(), want)
    np.testing.assert_array_equal(mtl_input_first(*args).numpy(), want)
    np.testing.assert_array_equal(mtl_gather_plain(*args).numpy(), want)
    fmajor = mtl_input_first(*args, field_major=True)
    assert tuple(fmajor.shape) == (len(sizes), b, d)
    np.testing.assert_array_equal(
        fmajor.numpy(), want.reshape(b, len(sizes), d).transpose(1, 0, 2))


def test_input_first_clamps_like_k1():
    rng = np.random.default_rng(9)
    ids, mega, offsets = make_lookup(rng, [13, 29, 6], 4, 8)
    ids[0, :3] = [-7, 2**31 - 1, 10**6]
    args = tuple(map(torch.from_numpy, (ids, offsets, mega)))
    assert torch.equal(mtl_input_first(*args), mtl_gather_plain(*args))


def test_input_first_through_the_dense_store():
    spec = FusedEmbeddingSpec(field_sizes=(60, 7, 350, 90), dim=8)
    coll = FusedEmbeddingCollection(spec, device="cpu")
    coll.store.reset_parameters(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    ids = torch.from_numpy(np.stack(
        [rng.integers(0, n, size=24) for n in spec.field_sizes],
        axis=1).astype(np.int32))
    assert torch.equal(coll(ids, strategy="input_first"), coll(ids))
    assert "input_first" in ops.STRATEGIES and "mtl_input_first" in KERNELS


@pytest.mark.parametrize("kind,row_dtype", [
    ("cached", None), ("cached", "int8"), ("host", None), ("host", "int8"),
])
def test_tiered_stores_reject_input_first(kind, row_dtype):
    """As the reference's cached and host lookups do: the strawman is a
    dense-table strategy."""
    fields = (60, 7, 350, 90)
    spec = FusedEmbeddingSpec(field_sizes=fields, dim=8)
    store = CachedStore(spec, 32, row_dtype, device="cpu") \
        if kind == "cached" else \
        HostBackedStore(spec, 32, 256, row_dtype=row_dtype, device="cpu")
    coll = FusedEmbeddingCollection(spec, store=store)
    ids = torch.zeros((4, len(fields)), dtype=torch.int32)
    with pytest.raises(ValueError, match="strategy"):
        coll(ids, strategy="input_first")
    if kind == "host":
        store.pipeline.stop()
    jspec = JaxSpec(field_sizes=fields, dim=8)
    jstore = JaxCachedStore(jspec, capacity=32, row_dtype=row_dtype)
    jcoll = JaxColl(jspec, store=jstore)
    params = jcoll.init(jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="strategy"):
        jcoll.apply(params, jnp.zeros((4, len(fields)), jnp.int32),
                    strategy="input_first")


# ---------------------------------------------------------------------------
# K7: one-hot over small padded tables
# ---------------------------------------------------------------------------

def as_f32(x):
    return np.array(x, dtype=np.float32)


@pytest.mark.parametrize("d", [1, 3, 8, 32])
@pytest.mark.parametrize("n_pad", [16, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_onehot_plain_bitwise_vs_pallas(d, n_pad, dtype):
    rng = np.random.default_rng(d + n_pad)
    k, b = 4, 20
    stacked = jnp.asarray(rng.normal(size=(k, n_pad, d)),
                          dtype=getattr(jnp, dtype))
    ids = jnp.asarray(rng.integers(0, n_pad, size=(b, k)), dtype=jnp.int32)
    want = jax_onehot(ids, stacked, interpret=True)
    tables = torch.from_numpy(as_f32(stacked)).to(getattr(torch, dtype))
    got = ops.multi_table_lookup_onehot(t(ids), tables)
    assert got.dtype == tables.dtype and tuple(got.shape) == (b, k, d)
    np.testing.assert_array_equal(as_f32(got.float()), as_f32(want))
    assert torch.equal(mtl_onehot_plain(t(ids), tables), got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_onehot_out_of_range_ids_give_zero_rows(dtype):
    """ids 8, -1 and 100 on an 8-row table match no one-hot column."""
    rng = np.random.default_rng(5)
    k, n_pad, d, b = 3, 8, 16, 6
    stacked = jnp.asarray(rng.normal(size=(k, n_pad, d)),
                          dtype=getattr(jnp, dtype))
    ids = rng.integers(0, n_pad, size=(b, k)).astype(np.int32)
    ids[0] = [8, -1, 100]
    ids[3, 1] = n_pad
    want = as_f32(jax_onehot(jnp.asarray(ids), stacked, interpret=True))
    tables = torch.from_numpy(as_f32(stacked)).to(getattr(torch, dtype))
    got = as_f32(mtl_onehot(torch.from_numpy(ids), tables).float())
    np.testing.assert_array_equal(got, want)
    assert not got[0].any() and not got[3, 1].any()
    assert np.all(np.abs(got[1:3]).sum(axis=-1) > 0)


def test_onehot_is_a_gather_of_the_same_rows():
    """In fp32, K7 over stacked tables equals K1 over the same tables
    concatenated (in-range ids)."""
    rng = np.random.default_rng(6)
    sizes, n_pad, d, b = [2, 106, 31, 128], 128, 32, 40
    stacked = np.zeros((len(sizes), n_pad, d), np.float32)
    for f, n in enumerate(sizes):
        stacked[f, :n] = rng.normal(size=(n, d))
    ids = np.stack([rng.integers(0, n, size=b) for n in sizes],
                   axis=1).astype(np.int32)
    mega = np.concatenate([stacked[f, :n] for f, n in enumerate(sizes)])
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int32)
    got = mtl_onehot(torch.from_numpy(ids), torch.from_numpy(stacked))
    want = mtl_gather_plain(*map(torch.from_numpy, (ids, offsets, mega)))
    assert torch.equal(got.reshape(b, -1), want)


def test_onehot_checks_its_inputs_and_is_not_a_strategy():
    ids = torch.zeros((4, 3), dtype=torch.int32)
    with pytest.raises(TypeError):
        mtl_onehot(ids, torch.zeros((3, 8, 4), dtype=torch.float16))
    with pytest.raises(ValueError):
        mtl_onehot(ids, torch.zeros((2, 8, 4)))
    with pytest.raises(TypeError):
        mtl_onehot(ids.long(), torch.zeros((3, 8, 4)))
    assert "mtl_onehot" in KERNELS
    # as in the reference, "onehot" is no branch of multi_table_lookup
    mega, offsets = torch.zeros((24, 4)), torch.tensor([0, 8, 16],
                                                        dtype=torch.int32)
    with pytest.raises(ValueError, match="strategy"):
        ops.multi_table_lookup(ids, mega, offsets, strategy="onehot")
    with pytest.raises(ValueError, match="strategy"):
        jops.multi_table_lookup(jnp.zeros((4, 3), jnp.int32),
                                jnp.zeros((24, 4)), jnp.asarray([0, 8, 16]),
                                strategy="onehot")
