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
from repro.models.ctr import common as jcommon, dcn as jdcn  # noqa: E402
from repro_torch.kernels.fused_cross import (  # noqa: E402
    CROSS_THREADS, CROSS_WORDS, cross_launch, fused_cross_v1,
    fused_cross_v1_plain, fused_cross_v2, fused_cross_v2_plain, launch_args)
from repro_torch.models.ctr import common as tcommon, dcn as tdcn  # noqa: E402
from repro_torch.kernels.fused_fm import (  # noqa: E402
    FM_THREADS, fm_launch, fused_fm_second_order, fused_fm_second_order_plain)
from repro_torch.kernels.multi_table_lookup import (  # noqa: E402
    ONEHOT_THREADS, TIERED_THREADS, Launch, _onehot_args, _tiered_args,
    gather_launch, input_first_launch, mtl_gather, mtl_gather_plain,
    onehot_launch, onehot_word, tier_word, tiered_launch, vector_words)

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


def test_vector_words_needs_d_a_multiple_of_4_and_aligned_bases():
    n, d = 10, 32
    table = torch.empty(n * d)
    view = torch.empty(n * d + 1)[1:].view(n, d)  # 4 bytes into its storage
    assert table.data_ptr() % 16 == 0 and view.data_ptr() % 16 == 4
    assert vector_words(32, table.data_ptr(), 256)
    assert vector_words(60, 0, 16)
    assert not vector_words(32, view.data_ptr(), 256)
    assert not vector_words(32, 256, 8)                  # the output too
    assert not vector_words(1, 0, 0) and not vector_words(3, 0, 0)
    assert not vector_words(30, 0, 0)


@pytest.mark.parametrize("b,k,d,vec,want", [
    # the main path: Criteo k = 39, d = 32 rows as 8 float4 words, 8 lanes
    (1024, 39, 32, True, Launch(True, 8, 1, 128, 2496)),
    (256, 39, 32, True, Launch(True, 8, 1, 128, 624)),
    # the wide/FM tables: one lane a row
    (1024, 39, 1, False, Launch(False, 1, 1, 128, 312)),
    (256, 39, 1, False, Launch(False, 1, 1, 128, 78)),
    # a misaligned d = 32 view: 4-byte words, a warp a row, two rows a lane
    (1024, 39, 32, False, Launch(False, 32, 2, 128, 4992)),
    (7, 39, 60, False, Launch(False, 32, 2, 128, 35)),
    # Fig. 11: d = 60 is 15 words on 16 lanes; the largest batch
    (2048, 39, 60, True, Launch(True, 16, 1, 128, 9984)),
    (65_536, 39, 32, True, Launch(True, 8, 1, 128, 159_744)),
    (1, 1, 3, False, Launch(False, 4, 1, 128, 1)),
])
def test_gather_launch(b, k, d, vec, want):
    got = gather_launch(b, k, d, vec)
    assert got == want
    words = d // 4 if vec else d
    assert got.lanes & (got.lanes - 1) == 0 and got.lanes <= 32
    assert got.lanes >= min(words, 32) > got.lanes // 2
    # a group of lanes for every `rows` rows, and no block without one
    groups = -(-b * k // got.rows)
    assert got.blocks * got.threads >= groups * got.lanes \
        > (got.blocks - 1) * got.threads


@pytest.mark.parametrize("b,k,want", [
    # Criteo b = 256: 9,984 threads in 156 blocks, a block or two on each
    # of an H100's 132 SMs (39 blocks of 256 threads before)
    (256, 39, Launch(True, 1, 1, 64, 156)),
    (1024, 39, Launch(True, 1, 1, 64, 624)),
    (2048, 39, Launch(True, 1, 1, 64, 1248)),
    (65_536, 39, Launch(True, 1, 1, 64, 39_936)),
])
def test_input_first_launch(b, k, want):
    got = input_first_launch(b, k, True)
    assert got == want
    assert got.blocks * got.threads >= b * k > (got.blocks - 1) * got.threads
    assert got.blocks >= 132


# ---------------------------------------------------------------------------
# K7 launch shapes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("itemsize,d,offset,want", [
    # fp32: 16-byte words where a row is a multiple of 16 bytes and both
    # bases are aligned to them; else the element's 4 bytes
    (4, 1, 0, 4), (4, 3, 0, 4), (4, 4, 0, 16), (4, 8, 0, 16),
    (4, 32, 0, 16),
    (4, 1, 4, 4), (4, 3, 4, 4), (4, 4, 4, 4), (4, 8, 4, 4), (4, 32, 4, 4),
    # bf16: 16 bytes from d = 8, 4 bytes for an even d (or a view 4 bytes
    # in), else the element's 2 bytes
    (2, 1, 0, 2), (2, 3, 0, 2), (2, 4, 0, 4), (2, 8, 0, 16), (2, 32, 0, 16),
    (2, 1, 4, 2), (2, 3, 4, 2), (2, 4, 4, 4), (2, 8, 4, 4), (2, 32, 4, 4),
    (2, 1, 2, 2), (2, 3, 2, 2), (2, 4, 2, 2), (2, 8, 2, 2), (2, 32, 2, 2),
])
def test_onehot_word(itemsize, d, offset, want):
    """K7's word: the largest of 16, 4 and the element's bytes that divides
    a row's bytes and both base addresses -- the tables ``offset`` bytes
    past a 16-byte boundary, or the output there."""
    assert onehot_word(d, itemsize, 4096 + offset, 8192) == want
    assert onehot_word(d, itemsize, 4096, 8192 + offset) == want
    assert onehot_word(d, itemsize, 4096, 8192) == \
        onehot_word(d, itemsize, 0, 0)


@pytest.mark.parametrize("dtype,offset,want", [
    (torch.float32, 0, 16), (torch.float32, 4, 4),
    (torch.bfloat16, 0, 16), (torch.bfloat16, 4, 4), (torch.bfloat16, 2, 2),
])
def test_onehot_word_on_table_views(dtype, offset, want):
    """A contiguous (k, n_pad, 32) view ``offset`` bytes into its storage
    passes the wrapper's checks but takes the narrower word."""
    el = torch.tensor([], dtype=dtype).element_size()
    k, n_pad, d = 3, 8, 32
    buf = torch.empty(k * n_pad * d + 16 // el, dtype=dtype)
    start = ((-buf.data_ptr()) % 16 + offset) // el
    view = buf[start:start + k * n_pad * d].view(k, n_pad, d)
    out = torch.empty((5, k, d), dtype=dtype)
    assert view.is_contiguous() and view.data_ptr() % 16 == offset
    assert onehot_word(d, el, view.data_ptr(), out.data_ptr()) == want


@pytest.mark.parametrize("b", [1, 256, 1024])
@pytest.mark.parametrize("d,itemsize,word,lanes,rows", [
    # Criteo's small fields at d = 32: 8 words of fp32 or 4 of bf16 a row
    (32, 4, 16, 8, 1), (32, 2, 16, 4, 1),
    # a view 4 bytes in: 32 fp32 words (a warp a row) or 16 bf16 word
    # pairs; 2 bytes in: 32 bf16 elements
    (32, 4, 4, 32, 1), (32, 2, 4, 16, 1), (32, 2, 2, 32, 1),
    # the element a word: d = 1 and d = 3
    (1, 4, 4, 1, 1), (1, 2, 2, 1, 1), (3, 4, 4, 4, 1), (3, 2, 2, 4, 1),
    # d = 60: 15 words on 16 lanes
    (60, 4, 16, 16, 1),
])
def test_onehot_launch(b, d, itemsize, word, lanes, rows):
    """K7's launch: the power of two up to 32 lanes that covers a row's
    words, one row a thread, ``ONEHOT_THREADS`` a block, and a grid with a
    group of lanes for every row."""
    k = 18
    got = onehot_launch(b, k, d, word, itemsize)
    groups = -(-b * k // rows)
    assert got == Launch(word == 16, lanes, rows, ONEHOT_THREADS,
                         -(-groups * lanes // ONEHOT_THREADS), word)
    words = d * itemsize // word
    assert got.lanes & (got.lanes - 1) == 0 and got.lanes <= 32
    assert got.lanes >= min(words, 32) > got.lanes // 2
    assert got.blocks * got.threads >= groups * got.lanes \
        > (got.blocks - 1) * got.threads


@pytest.mark.parametrize("b,k,d,itemsize,word,want", [
    # the kernel table's shapes: b = 1024 and 256 over 18 fields
    (1024, 18, 32, 4, 16, Launch(True, 8, 1, 256, 576, 16)),
    (256, 18, 32, 4, 16, Launch(True, 8, 1, 256, 144, 16)),
    (1024, 18, 32, 2, 16, Launch(True, 4, 1, 256, 288, 16)),
    (256, 18, 32, 2, 16, Launch(True, 4, 1, 256, 72, 16)),
    (1024, 18, 32, 4, 4, Launch(False, 32, 1, 256, 2304, 4)),
    # b = 1: one block
    (1, 18, 32, 4, 16, Launch(True, 8, 1, 256, 1, 16)),
    (1, 18, 32, 2, 16, Launch(True, 4, 1, 256, 1, 16)),
    (1, 18, 3, 4, 4, Launch(False, 4, 1, 256, 1, 4)),
    # past 2^20 blocks the kernel strides over the rows
    (1 << 22, 18, 32, 4, 16, Launch(True, 8, 1, 256, 1 << 20, 16)),
])
def test_onehot_launch_grid(b, k, d, itemsize, word, want):
    got = onehot_launch(b, k, d, word, itemsize)
    assert got == want
    assert _onehot_args(got) == (want.word, want.lanes, want.rows,
                                 want.threads, want.blocks)


# ---------------------------------------------------------------------------
# K3–K6 launch shapes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b", [1, 256, 1024])
@pytest.mark.parametrize("d,word,lanes", [
    # Criteo d = 32: 8 lanes of 4 floats, one 16-byte load each or, from a
    # tier 4 bytes into its storage, four 4-byte loads
    (32, 16, 8), (32, 4, 8),
    (16, 16, 4), (16, 4, 4),
    # d = 60: 15 pieces on 16 lanes
    (60, 16, 16), (60, 4, 16),
    # past 128 floats (32 for d % 4 != 0) a lane takes several pieces
    (136, 16, 32), (136, 4, 32), (35, 4, 32),
    # d % 4 != 0: a float a lane
    (3, 4, 4), (1, 4, 1),
])
def test_tiered_launch(d, word, lanes, b):
    """K3's and K5's launch: a piece of 4 floats a lane where d % 4 == 0
    (``vec``), else one; the power of two up to 32 lanes that covers a
    row's pieces; one row a thread; a group of lanes for every row; one
    launch rule for one-hot and pooled rows, and for K4 and K6."""
    k = 39
    got = tiered_launch(b, k, 1, d, word)
    vec = d % 4 == 0
    pieces = d // 4 if vec else d
    assert got == Launch(vec, lanes, 1, TIERED_THREADS,
                         -(-b * k * lanes // TIERED_THREADS), word)
    assert got.lanes >= min(pieces, 32) > got.lanes // 2
    assert got.blocks * got.threads >= b * k * got.lanes \
        > (got.blocks - 1) * got.threads
    for h in (5, 17):
        assert tiered_launch(b, k, h, d, word) == got
    assert tiered_launch(b, k, 5, d, word // 4) == got._replace(
        word=word // 4)                         # K4/K6: the same shape


def test_tier_word_takes_4_byte_loads_for_a_misaligned_fp32_tier():
    """The K3 and K5 wrappers give ``tiered_launch`` :func:`tier_word` over
    both tiers, K2's over its one table: one tier 4 bytes into its storage,
    or an odd width, takes the 4-byte path."""
    n, d = 10, 32
    cache, backing = (torch.empty(n * d).view(n, d) for _ in range(2))
    view = torch.empty(n * d + 1)[1:].view(n, d)
    assert cache.data_ptr() % 16 == 0 and view.data_ptr() % 16 == 4
    assert tier_word(d, 4, cache.data_ptr(), backing.data_ptr()) == 16
    assert tier_word(d, 4, view.data_ptr(), backing.data_ptr()) == 4
    assert tier_word(d, 4, backing.data_ptr(), view.data_ptr()) == 4
    assert tier_word(d, 4, backing.data_ptr()) == 16          # K2's table
    assert tier_word(d, 4, view.data_ptr()) == 4
    assert tier_word(d, 4, 0, 8) == 4                  # 8 bytes in
    assert tier_word(60, 4, 0, 16) == 16
    assert tier_word(35, 4, 0, 0) == 4 and tier_word(1, 4, 0, 0) == 4


def test_tiered_args_follow_the_c_entries():
    """The launch's arguments in K2–K6's C entries' order: ``vec, word,
    lane_bits, threads, blocks`` (K2's entry takes them too since it runs
    on the tiered kernel)."""
    assert _tiered_args(tiered_launch(1024, 39, 1, 32, 16)) == \
        (1, 16, 3, 128, 2496)
    assert _tiered_args(tiered_launch(1024, 39, 1, 32, 4)) == \
        (1, 4, 3, 128, 2496)
    assert _tiered_args(tiered_launch(1024, 39, 5, 3, 1)) == \
        (0, 1, 2, 128, 1248)


def test_q8_word_needs_d_and_every_tier_aligned_to_the_word():
    n, d = 10, 32
    codes = torch.empty(n * d, dtype=torch.int8)
    view = torch.empty(n * d + 1, dtype=torch.int8)[1:].view(n, d)
    assert codes.data_ptr() % 16 == 0 and view.data_ptr() % 16 == 1
    assert tier_word(32, 1, codes.data_ptr(), 256) == 4
    assert tier_word(16, 1, 0, 0) == 4
    assert tier_word(32, 1, view.data_ptr(), 256) == 1      # 1 byte in
    assert tier_word(32, 1, 4, 256) == 4                    # 4 bytes in
    assert tier_word(32, 1, 0, 2) == 1                      # 2 bytes in
    assert tier_word(60, 1, 0, 0) == 4
    assert tier_word(3, 1, 0, 0) == 1 and tier_word(1, 1, 0, 0) == 1


@pytest.mark.parametrize("d,word,h,want", [
    # Criteo d = 32: 8 lanes a row of 4 codes each, one-hot or pooled
    (32, 4, 1, Launch(True, 8, 1, 128, 2496, 4)),
    (32, 4, 5, Launch(True, 8, 1, 128, 2496, 4)),
    # a tier 1 byte into its storage: the same lanes, codes byte by byte
    (32, 1, 1, Launch(True, 8, 1, 128, 2496, 1)),
    (32, 1, 5, Launch(True, 8, 1, 128, 2496, 1)),
    (16, 4, 1, Launch(True, 4, 1, 128, 1248, 4)),
    (16, 4, 5, Launch(True, 4, 1, 128, 1248, 4)),
    (16, 1, 1, Launch(True, 4, 1, 128, 1248, 1)),
    (16, 1, 5, Launch(True, 4, 1, 128, 1248, 1)),
    # d = 60: 15 pieces on 16 lanes
    (60, 4, 1, Launch(True, 16, 1, 128, 4992, 4)),
    (60, 4, 5, Launch(True, 16, 1, 128, 4992, 4)),
    (60, 1, 1, Launch(True, 16, 1, 128, 4992, 1)),
    (60, 1, 5, Launch(True, 16, 1, 128, 4992, 1)),
    # d % 4 != 0: a code a lane
    (3, 1, 1, Launch(False, 4, 1, 128, 1248, 1)),
    (3, 1, 5, Launch(False, 4, 1, 128, 1248, 1)),
    (1, 1, 1, Launch(False, 1, 1, 128, 312, 1)),
    (1, 1, 5, Launch(False, 1, 1, 128, 312, 1)),
    # past 128 codes (32 for d % 4 != 0) a lane takes several pieces
    (136, 4, 1, Launch(True, 32, 1, 128, 9984, 4)),
    (35, 1, 5, Launch(False, 32, 1, 128, 9984, 1)),
])
def test_tiered_q8_launch(d, word, h, want):
    got = tiered_launch(1024, 39, h, d, word)
    assert got == want
    assert got.vec == (d % 4 == 0) and got.word == word
    pieces = d // 4 if got.vec else d
    assert got.lanes & (got.lanes - 1) == 0 and got.lanes <= 32
    assert got.lanes >= min(pieces, 32) > got.lanes // 2


@pytest.mark.parametrize("b,h", [
    # one launch rule for one-hot and pooled rows at every batch
    (256, 5), (1024, 5), (840, 5), (841, 5), (1024, 2), (65_536, 1),
])
def test_tiered_q8_launch_is_the_same_for_pooled_rows(b, h):
    got = tiered_launch(b, 39, h, 32, 4)
    assert got == tiered_launch(b, 39, 1, 32, 4)
    assert (got.vec, got.word, got.lanes, got.rows) == (True, 4, 8, 1)
    assert tiered_launch(b, 39, h, 32, 1).word == 1


@pytest.mark.parametrize("b,k,blocks", [
    # 8 lanes a row, 16 rows a 128-thread block: one block on each of an
    # H100's 132 SMs, and one row more takes a 133rd
    (2112, 1, 132), (2113, 1, 133), (1, 1, 1), (256, 39, 624),
    (10**6, 39, 1 << 20),                  # capped; the kernel strides on
])
def test_tiered_q8_launch_grid(b, k, blocks):
    got = tiered_launch(b, k, 1, 32, 4)
    assert got.blocks == blocks
    groups = -(-b * k // got.rows)
    if blocks < 1 << 20:
        assert got.blocks * got.threads >= groups * got.lanes \
            > (got.blocks - 1) * got.threads


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

# D = 117 (39 fields of 3): a float a piece on the card; b = 1: one row
@pytest.mark.parametrize("b,D", [(4, 16), (32, 80), (7, 200), (1, 117),
                                 (33, 117), (1, 1248)])
def test_fused_cross_v2_vs_pallas(b, D):
    rng = np.random.default_rng(b * D)
    x0, xw, x = (rng.normal(size=(b, D)).astype(np.float32)
                 for _ in range(3))
    want = pallas_cross_v2(*map(jnp.asarray, (x0, xw, x)), interpret=True)
    got = fused_cross_v2(*map(torch.from_numpy, (x0, xw, x)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("b,D", [(4, 16), (32, 80), (1, 117), (33, 117),
                                 (1, 1248)])
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


@pytest.mark.parametrize("b,D", [(1, 117), (33, 80), (7, 1248)])
@pytest.mark.parametrize("kind", ["v2", "v1"])
def test_layer0_cross_tail_vs_reference(kind, b, D):
    """Layer 0 passes ``x0`` as ``x`` too (the kernels then skip ``x``'s
    loads): the port's tail closures, which hand the wrapper the same
    tensor twice, against the reference's closures and its Pallas kernel
    given the same array twice."""
    rng = np.random.default_rng(100 * b + D)
    x0, xw = (rng.normal(size=(b, D)).astype(np.float32) for _ in range(2))
    xlw = rng.normal(size=(b, 1)).astype(np.float32)
    bias = rng.normal(size=(D,)).astype(np.float32)
    j, t = jnp.asarray, torch.from_numpy
    if kind == "v2":
        got = tcommon._cross_v2_tail(t(x0), t(xw))
        want = jcommon._cross_v2_tail(j(x0), j(xw))
        pallas = pallas_cross_v2(j(x0), j(xw), j(x0), interpret=True)
    else:
        got = tdcn._make_v1_kernel(t(bias))(t(x0), t(xlw))
        want = jdcn._make_v1_kernel(j(bias), first=True)(j(x0), j(xlw))
        pallas = pallas_cross_v1(j(x0), j(xlw), j(bias), j(x0),
                                 interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)


@pytest.mark.parametrize("b,D,aligned,want", [
    # the main path, D = 1248 = 312 pieces of 4 floats, 2 a thread: 16-byte
    # words where every operand is aligned, else four 4-byte words a piece
    (256, 1248, True, Launch(True, 1, 2, CROSS_THREADS, 312, 16)),
    (256, 1248, False, Launch(True, 1, 2, CROSS_THREADS, 312, 4)),
    (1024, 1248, True, Launch(True, 1, 2, CROSS_THREADS, 1248, 16)),
    (1024, 1248, False, Launch(True, 1, 2, CROSS_THREADS, 1248, 4)),
    # D % 4 != 0: a float a piece, 4-byte words whatever the alignment
    (256, 117, True, Launch(False, 1, 2, CROSS_THREADS, 117, 4)),
    (1024, 117, False, Launch(False, 1, 2, CROSS_THREADS, 468, 4)),
    # a ragged last block; one row; no rows
    (7, 1248, True, Launch(True, 1, 2, CROSS_THREADS, 9, 16)),
    (1, 1248, False, Launch(True, 1, 2, CROSS_THREADS, 2, 4)),
    (1, 4, True, Launch(True, 1, 2, CROSS_THREADS, 1, 16)),
    (0, 1248, True, Launch(True, 1, 2, CROSS_THREADS, 1, 16)),
])
def test_cross_launch(b, D, aligned, want):
    """K9's and K10's launch: pieces of 4 floats where D % 4 == 0, 16-byte
    words where the operands are also aligned; ``CROSS_WORDS`` pieces a
    thread; a grid that covers the pieces once, in one wave of the H100
    (132 SMs of 2048 threads) and on every SM at the main path's b."""
    got = cross_launch(b, D, aligned)
    assert got == want and got.rows == CROSS_WORDS
    pieces = b * D // (4 if got.vec else 1)
    per_block = got.threads * got.rows
    assert got.blocks * per_block >= pieces
    assert pieces == 0 or pieces > (got.blocks - 1) * per_block
    if D == 1248 and b >= 256:
        assert 132 <= got.blocks and got.blocks * got.threads <= 132 * 2048
    assert launch_args(got) == (int(got.vec), got.word, got.rows,
                                got.threads, got.blocks)


@pytest.mark.parametrize("b,k,d", [(4, 3, 8), (32, 13, 16), (16, 39, 32),
                                   (8, 39, 1), (8, 39, 3), (4, 13, 60),
                                   (1, 39, 32)])
def test_fused_fm_vs_pallas(b, k, d):
    rng = np.random.default_rng(b * k)
    v = rng.normal(size=(b, k, d)).astype(np.float32)
    want = np.asarray(pallas_fm(jnp.asarray(v), interpret=True))
    got = fused_fm_second_order(torch.from_numpy(v))
    assert got.shape == (b, 1)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_fused_fm_keeps_nan_as_the_reference_does():
    """A NaN, an inf or a -inf in a row gives NaN in that row, in the plain
    version as in the Pallas kernel; the other rows stay finite and
    agree."""
    rng = np.random.default_rng(19)
    v = (rng.normal(size=(6, 39, 32)) * 0.05).astype(np.float32)
    v[1, 5, 7], v[3, 0, 31], v[4, 38, 0] = np.nan, np.inf, -np.inf
    want = np.asarray(pallas_fm(jnp.asarray(v), interpret=True))
    got = fused_fm_second_order(torch.from_numpy(v)).numpy()
    bad = np.isin(np.arange(6), [1, 3, 4])
    assert np.isnan(want[bad]).all() and np.isnan(got[bad]).all()
    assert np.isfinite(got[~bad]).all()
    np.testing.assert_allclose(got[~bad], want[~bad], **TOL)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("b,k,d,lanes", [
    # one field of one float: a lane a field, 32 fields a warp
    (1, 1, 1, 1), (3, 39, 1, 1),
    # a partial last group: 3 pieces on 4 lanes, 15 words on 16
    (256, 39, 3, 4), (64, 13, 60, 16),
    # the main path: 8 float4 words a field, 4 fields a warp
    (256, 39, 32, 8), (1024, 39, 32, 8),
    # past 128 floats a lane takes several pieces
    (16, 7, 136, 32),
])
def test_fm_launch(b, k, d, lanes, aligned):
    """K11's launch: 4 floats a lane (``vec``) where d % 4 == 0 and ``v``
    is 16-byte aligned, else one; the power of two up to 32 lanes that
    covers a field's pieces (32 // lanes fields a warp at a time); a warp
    a row, ``FM_THREADS`` a block, a grid with a warp for every row."""
    got = fm_launch(b, d, aligned)
    vec = aligned and d % 4 == 0
    pieces = d // 4 if vec else d
    want_lanes = lanes if vec or d % 4 else min(32, lanes * 4)
    assert got == Launch(vec, want_lanes, 1, FM_THREADS,
                         -(-b * 32 // FM_THREADS))
    assert got.lanes & (got.lanes - 1) == 0 and got.lanes <= 32
    assert got.lanes >= min(pieces, 32) > got.lanes // 2
    assert got.blocks * got.threads >= 32 * b \
        > (got.blocks - 1) * got.threads
    if (b, k, d) == (256, 39, 32):          # 10 loads a lane cover a row
        assert -(-k // (32 // got.lanes)) == (10 if aligned else 39)
        assert got.blocks >= 132            # no SM of an H100 left idle


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
        "mtl_gather", "mtl_gather_tiered", "fused_cross", "fused_fm",
        "mtl_onehot", "mtl_input_first", "dense_matmul_q8",
        "quantize_rows_q8"}
