"""repro_torch on a card: each CUDA kernel against its plain version, the
kernels' stream discipline, and every model's four levels on CUDA against
the CPU path on the same weights.

Every test here needs an NVIDIA card and skips without one; this file
imports no JAX, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py -q

K1–K10, K12 and the activation quantizer are bitwise (copies, pools
summed in slot order, arithmetic rounded in the plain order without FMA,
K12's exact int32 sum with the plain version's fma epilogue, and the
quantizer's codes rounded half to even from the true quotient); K11 sums
in another order than ``torch.sum`` (``rtol=atol=1e-5``). Whole models
cross devices at ``rtol=1e-4, atol=1e-5``: cuBLAS and the CPU BLAS sum
the GEMMs in different orders.
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ctr_spec  # noqa: E402
from repro_torch.core import LEVELS, compile_plan  # noqa: E402
from repro_torch.data import CRITEO, sample_ids  # noqa: E402
from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402
from repro_torch.kernels.dense_matmul import (  # noqa: E402
    dmm_q8, dmm_q8_plain, pack_weight, pad_k)
from repro_torch.kernels.fused_cross import (  # noqa: E402
    cross_launch, fused_cross_v1, fused_cross_v1_plain, fused_cross_v2,
    fused_cross_v2_plain, launch_args)
from repro_torch.kernels.fused_fm import (  # noqa: E402
    fm_launch, fused_fm_second_order, fused_fm_second_order_plain)
from repro_torch.kernels.multi_table_lookup import (  # noqa: E402
    mtl_gather, mtl_gather_multihot, mtl_gather_multihot_plain,
    mtl_gather_plain, mtl_gather_three_level, mtl_gather_three_level_plain,
    mtl_gather_three_level_q8, mtl_gather_three_level_q8_plain,
    mtl_gather_two_level, mtl_gather_two_level_plain,
    mtl_gather_two_level_q8, mtl_gather_two_level_q8_plain, mtl_input_first,
    mtl_input_first_plain, mtl_onehot, mtl_onehot_plain, onehot_launch,
    onehot_word, tier_word, tiered_launch, vector_words)
from repro_torch.kernels.quantize import (  # noqa: E402
    quantize_rows_q8, quantize_rows_q8_plain)
from repro_torch.embedding import CachedStore, HostBackedStore  # noqa: E402
from repro_torch.models.ctr import CTR_MODELS  # noqa: E402
from repro_torch.serving import (BucketedBatch, FixedBatch,  # noqa: E402
                                 InferenceEngine, ServingRuntime,
                                 SyntheticTrainer)
from repro_torch.quant import (absmax_scale, quantize,  # noqa: E402
                               quantize_channels, quantize_rows)

pytestmark = pytest.mark.gpu

TOL = dict(rtol=1e-5, atol=1e-5)
SPEC_KW = dict(embed_dim=8, hidden=64, max_field=2_000)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _lookup_inputs(rng, b, k, d, device, misaligned=False):
    """(ids, offsets, table) on ``device``: k fields of random heights, the
    first three ids out of range (clamped), and the table 16-byte aligned
    or a view 4 bytes into its storage."""
    sizes = rng.integers(2, 5000, size=k)
    n = int(sizes.sum()) + 1
    mega = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    table = mega.to(device)
    if misaligned:
        table = torch.empty(n * d + 1, device=device)[1:].view(n, d)
        table.copy_(mega)
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int32)
    ids = np.stack([rng.integers(0, s, size=b) for s in sizes],
                   axis=1).astype(np.int32)
    bad = [-5, 2**31 - 1, 10**6][:ids.size]
    ids.reshape(-1)[:len(bad)] = bad                     # clamped rows
    return (torch.from_numpy(ids).to(device),
            torch.from_numpy(offsets).to(device), table)


LOOKUP_SHAPES = [(d, b, k) for d in (1, 3, 32, 60) for b in (1, 7, 256, 1024)
                 for k in (1, 39)]


@pytest.mark.parametrize("d,b,k", LOOKUP_SHAPES)
def test_mtl_gather_bitwise(cuda, d, b, k):
    args = _lookup_inputs(np.random.default_rng(d * 1000 + b + k), b, k, d,
                          cuda)
    before = mtl_gather.launches
    got = mtl_gather(*args)
    torch.cuda.synchronize()
    assert mtl_gather.launches == before + 1
    assert torch.equal(got, mtl_gather_plain(*args))


@pytest.mark.parametrize("d", [32, 60])
def test_lookups_take_a_misaligned_view(cuda, d):
    """A table 4 bytes into its storage goes through K1's and K8's 4-byte
    path, bitwise the plain version and the aligned table's result."""
    rng = np.random.default_rng(d)
    args = _lookup_inputs(rng, 1024, 39, d, cuda, misaligned=True)
    table = args[2]
    assert table.data_ptr() % 16 == 4
    assert not vector_words(d, table.data_ptr())
    before = (mtl_gather.launches, mtl_input_first.launches)
    k1 = mtl_gather(*args)
    k8 = mtl_input_first(*args)
    fmajor = mtl_input_first(*args, field_major=True)
    torch.cuda.synchronize()
    assert (mtl_gather.launches, mtl_input_first.launches) == \
        (before[0] + 1, before[1] + 2)
    want = mtl_gather_plain(*args)
    assert torch.equal(k1, want) and torch.equal(k8, want)
    assert torch.equal(fmajor, mtl_input_first_plain(*args,
                                                     field_major=True))
    aligned = table.clone()
    assert aligned.data_ptr() % 16 == 0
    assert torch.equal(mtl_gather(args[0], args[1], aligned), want)


@pytest.mark.parametrize("kernel", ["mtl_gather", "mtl_input_first"])
@pytest.mark.parametrize("d", [1, 32])
def test_lookups_launch_on_the_current_stream(cuda, kernel, d):
    """Launched on a side stream behind a sleep and a copy into the table,
    K1 and K8 must read the copied rows once that stream has synced."""
    ids, offsets, src = _lookup_inputs(np.random.default_rng(d), 256, 39, d,
                                       cuda)
    table = torch.zeros_like(src)
    want = mtl_gather_plain(ids, offsets, src)
    fn = mtl_gather if kernel == "mtl_gather" else mtl_input_first
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        torch.cuda._sleep(50_000_000)
        table.copy_(src)
        out = fn(ids, offsets, table)
    side.synchronize()
    assert torch.equal(out, want)


def _tiered_inputs(rng, h, device, b=256, d=32, capacity=4096):
    """Ids with out-of-range entries, a random mask, and a table split
    into a random hot set (fp32 and int8), on ``device``."""
    sizes = rng.integers(2, 5000, size=39)
    n = int(sizes.sum()) + 1
    mega = rng.normal(size=(n, d)).astype(np.float32)
    mega[-1] = 0.0
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int32)
    ids = np.stack([rng.integers(0, s, size=(b, h)) for s in sizes],
                   axis=1).astype(np.int32)
    ids[0, :3, 0] = [-7, 2**31 - 1, 10**8]               # clamped rows
    mask = rng.integers(0, 2, size=ids.shape).astype(np.float32)
    hot = np.sort(rng.choice(n, size=capacity, replace=False))
    slot_of_row = np.full(n, -1, np.int32)
    slot_of_row[hot] = np.arange(capacity, dtype=np.int32)
    slot_of_row[hot[0]] = capacity + 5                  # a slot past the cache
    t = {k: torch.from_numpy(v).to(device) for k, v in dict(
        ids=ids, mask=mask, offsets=offsets, mega=mega,
        slot_of_row=slot_of_row, hot=hot).items()}
    t["cache"] = t["mega"].index_select(0, t["hot"])
    t["q"], t["scale"] = quantize_rows(t["mega"])
    t["qcache"] = t["q"].index_select(0, t["hot"])
    t["qscale"] = t["scale"].index_select(0, t["hot"])
    return t


@pytest.mark.parametrize("h", [1, 5])
def test_tiered_gathers_bitwise(cuda, h):
    t = _tiered_inputs(np.random.default_rng(h), h, cuda)
    before = {f: f.launches for f in (mtl_gather_multihot,
                                      mtl_gather_two_level,
                                      mtl_gather_two_level_q8)}
    k2 = mtl_gather_multihot(t["ids"], t["mask"], t["offsets"], t["mega"])
    k3 = mtl_gather_two_level(t["ids"], t["offsets"], t["slot_of_row"],
                              t["cache"], t["mega"], mask=t["mask"])
    k4 = mtl_gather_two_level_q8(t["ids"], t["offsets"], t["slot_of_row"],
                                 t["qcache"], t["qscale"], t["q"],
                                 t["scale"], mask=t["mask"])
    torch.cuda.synchronize()
    assert all(f.launches == n + 1 for f, n in before.items())
    assert torch.equal(k2, mtl_gather_multihot_plain(
        t["ids"], t["mask"], t["offsets"], t["mega"]))
    assert torch.equal(k3, mtl_gather_two_level_plain(
        t["ids"], t["offsets"], t["slot_of_row"], t["cache"], t["mega"],
        mask=t["mask"]))
    assert torch.equal(k3, k2)
    assert torch.equal(k4, mtl_gather_two_level_q8_plain(
        t["ids"], t["offsets"], t["slot_of_row"], t["qcache"], t["qscale"],
        t["q"], t["scale"], mask=t["mask"]))
    if h == 1:                                          # K3 one-hot == K1
        ids = t["ids"][..., 0].contiguous()
        assert torch.equal(
            mtl_gather_two_level(ids, t["offsets"], t["slot_of_row"],
                                 t["cache"], t["mega"]),
            mtl_gather(ids, t["offsets"], t["mega"]))


@pytest.mark.parametrize("kernel", ["multihot", "two_level", "q8",
                                    "three_level", "three_level_q8"])
def test_tiered_gathers_launch_on_the_current_stream(cuda, kernel):
    """A write queued on a side stream behind a sleep must be what the
    kernel launched on that stream reads."""
    n, d = 4096, 32
    ids = torch.randint(0, n - 1, (64, 3), dtype=torch.int32, device=cuda)
    offsets = torch.zeros(3, dtype=torch.int32, device=cuda)
    slot_of_row = torch.full((n,), -1, dtype=torch.int32, device=cuda)
    table = torch.zeros((n, d), device=cuda)
    q = torch.zeros((n, d), dtype=torch.int8, device=cuda)
    scale = torch.ones((n, 1), device=cuda)
    staged_map = torch.arange(n, dtype=torch.int32, device=cuda)
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        torch.cuda._sleep(50_000_000)
        table.fill_(2.0)
        q.fill_(3)
        if kernel == "multihot":
            out = mtl_gather_multihot(ids, None, offsets, table)
        elif kernel == "two_level":
            out = mtl_gather_two_level(ids, offsets, slot_of_row,
                                       table[:8].clone(), table)
        elif kernel == "q8":
            out = mtl_gather_two_level_q8(ids, offsets, slot_of_row, q[:8],
                                          scale[:8], q, scale)
        elif kernel == "three_level":          # every row staged in place
            out = mtl_gather_three_level(ids, offsets, slot_of_row,
                                         staged_map, table[:8], table)
        else:
            out = mtl_gather_three_level_q8(ids, offsets, slot_of_row,
                                            staged_map, q[:8], scale[:8], q,
                                            scale)
    side.synchronize()
    assert torch.all(out == (3.0 if "q8" in kernel else 2.0))


def _host_inputs(rng, h, device, b=256, d=32, capacity=4096):
    """Ids with out-of-range entries and a random mask over a table split
    into a cache, a staging area (a slot past each tier included) and rows
    in neither tier, fp32 and int8; and the same staged fully."""
    t = _tiered_inputs(rng, h, device, b, d, capacity)
    n = t["mega"].shape[0]
    som = t["slot_of_row"].cpu().numpy()
    uncached = np.flatnonzero(som < 0)
    warm = np.sort(rng.choice(uncached, size=uncached.size // 2,
                              replace=False))
    smap = np.full(n, -1, np.int32)
    smap[warm] = np.arange(warm.size, dtype=np.int32)
    smap[warm[0]] = warm.size + 9                      # a slot past staging
    full = np.full(n, -1, np.int32)                    # every row resolves
    full[uncached] = np.arange(uncached.size, dtype=np.int32)
    hot0 = int(t["hot"][0])                     # its cache slot is past C:
    full[hot0] = uncached.size                  # stage it too
    t["smap"] = torch.from_numpy(smap).to(device)
    t["full_map"] = torch.from_numpy(full).to(device)
    rows = torch.from_numpy(np.concatenate([warm, [0]])).to(device)
    t["staging"] = t["mega"].index_select(0, rows)
    t["qstaging"] = t["q"].index_select(0, rows)
    t["qsscale"] = t["scale"].index_select(0, rows)
    frows = torch.from_numpy(np.concatenate([uncached, [hot0]])).to(device)
    t["full_staging"] = t["mega"].index_select(0, frows)
    return t


@pytest.mark.parametrize("h", [1, 5])
def test_three_level_gathers_bitwise(cuda, h):
    t = _host_inputs(np.random.default_rng(10 + h), h, cuda)
    before = {f: f.launches for f in (mtl_gather_three_level,
                                      mtl_gather_three_level_q8)}
    k5 = mtl_gather_three_level(t["ids"], t["offsets"], t["slot_of_row"],
                                t["smap"], t["cache"], t["staging"],
                                mask=t["mask"])
    k6 = mtl_gather_three_level_q8(t["ids"], t["offsets"], t["slot_of_row"],
                                   t["smap"], t["qcache"], t["qscale"],
                                   t["qstaging"], t["qsscale"],
                                   mask=t["mask"])
    torch.cuda.synchronize()
    assert all(f.launches == n + 1 for f, n in before.items())
    assert torch.equal(k5, mtl_gather_three_level_plain(
        t["ids"], t["offsets"], t["slot_of_row"], t["smap"], t["cache"],
        t["staging"], mask=t["mask"]))
    assert torch.equal(k6, mtl_gather_three_level_q8_plain(
        t["ids"], t["offsets"], t["slot_of_row"], t["smap"], t["qcache"],
        t["qscale"], t["qstaging"], t["qsscale"], mask=t["mask"]))
    assert (k5 == 0).any() and (k6 == 0).any()         # the zero guard
    # fully staged: K5 is K2 on the table (and K1 at h = 1)
    full = mtl_gather_three_level(t["ids"], t["offsets"], t["slot_of_row"],
                                  t["full_map"], t["cache"],
                                  t["full_staging"], mask=t["mask"])
    assert torch.equal(full, mtl_gather_multihot(t["ids"], t["mask"],
                                                 t["offsets"], t["mega"]))
    if h == 1:
        ids = t["ids"][..., 0].contiguous()
        assert torch.equal(
            mtl_gather_three_level(ids, t["offsets"], t["slot_of_row"],
                                   t["full_map"], t["cache"],
                                   t["full_staging"]),
            mtl_gather(ids, t["offsets"], t["mega"]))


def _byte_offset(t, offset):
    """``t`` (int8 or fp32) copied into a view ``offset`` bytes past a
    16-byte boundary of its storage."""
    el = t.element_size()
    assert offset % el == 0, (t.dtype, offset)
    buf = torch.empty(t.numel() + 32 // el, dtype=t.dtype, device=t.device)
    start = ((-buf.data_ptr()) % 16 + offset) // el
    view = buf[start:start + t.numel()].view(t.shape)
    view.copy_(t)
    assert view.data_ptr() % 16 == offset
    return view


def _same_bits(a, b):
    """Bitwise equal, NaN for NaN (+0.0 and -0.0 differ)."""
    nan = a.isnan()
    return torch.equal(nan, b.isnan()) and torch.equal(
        a.masked_fill(nan, 0).view(torch.int32),
        b.masked_fill(nan, 0).view(torch.int32))


def _q8_tier_inputs(rng, b, h, d, offset, device, k=7, capacity=512):
    """int8 cache, backing and staging tiers over a random table: ids with
    out-of-range entries, a random mask, a cache slot past C, a staging
    slot past S, a cached row also staged, half the uncached rows in
    neither tier, a NaN and an inf scale on rows the ids read, and every
    int8 tier a view ``offset`` bytes into its storage."""
    sizes = rng.integers(2, 3000, size=k)
    n = int(sizes.sum()) + 1
    mega = rng.normal(size=(n, d)).astype(np.float32)
    mega[-1] = 0.0
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int32)
    ids = np.stack([rng.integers(0, s, size=(b, h)) for s in sizes],
                   axis=1).astype(np.int32)
    ids.reshape(-1)[:3] = [-7, 2**31 - 1, 10**8][:ids.size]
    mask = rng.integers(0, 2, size=ids.shape).astype(np.float32)
    mask[-1, -1, 0] = mask[-1, 0, 0] = 1.0
    hot = np.sort(rng.choice(n, size=capacity, replace=False))
    som = np.full(n, -1, np.int32)
    som[hot] = np.arange(capacity, dtype=np.int32)
    som[hot[0]] = capacity + 5                          # past the cache
    uncached = np.flatnonzero(som < 0)
    warm = np.sort(rng.choice(uncached, size=uncached.size // 2,
                              replace=False))
    smap = np.full(n, -1, np.int32)
    smap[warm] = np.arange(warm.size, dtype=np.int32)
    smap[warm[0]] = warm.size + 9                       # past staging
    smap[hot[1]] = 0                                    # the cache wins
    q, scale = quantize_rows(torch.from_numpy(mega))
    for f, value in ((-1, float("nan")), (0, float("inf"))):
        scale[min(max(int(ids[-1, f, 0]) + int(offsets[f]), 0), n - 1)] = \
            value
    t = {name: torch.from_numpy(v).to(device) for name, v in dict(
        ids=ids, mask=mask, offsets=offsets, slot_of_row=som,
        smap=smap).items()}
    hot_t, warm_t = torch.from_numpy(hot), torch.from_numpy(warm)
    for name, codes in (("q", q), ("qcache", q[hot_t]),
                        ("qstaging", q[warm_t])):
        t[name] = _byte_offset(codes.to(device), offset)
    t["scale"] = scale.to(device)
    t["qscale"] = scale[hot_t].to(device)
    t["qsscale"] = scale[warm_t].to(device)
    return t


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("b", [1, 37, 256])
@pytest.mark.parametrize("h", [1, 5, 17])
@pytest.mark.parametrize("d", [1, 3, 16, 32, 35, 60, 136])
def test_int8_tiered_gathers_bitwise(cuda, d, h, b, offset):
    """K4 and K6 on every path they launch -- 4 codes a lane as one 4-byte
    word or, from tiers 1 byte into their storage, byte by byte; a code a
    lane for d % 4 != 0; several pieces a lane past 128 codes (32 for
    d % 4 != 0); a second chunk of slots (h = 17) -- are bitwise their
    plain versions, one launch a call; K6 gives +0.0 for a row in neither
    tier."""
    t = _q8_tier_inputs(np.random.default_rng(d * 100 + h * 10 + b), b, h,
                        d, offset, cuda)
    word = tier_word(d, 1, t["q"].data_ptr(), t["qcache"].data_ptr(),
                     t["qstaging"].data_ptr())
    assert word == (1 if offset or d % 4 else 4)
    launch = tiered_launch(b, 7, h, d, word)
    assert launch.vec == (d % 4 == 0)
    pieces = d // 4 if launch.vec else d
    assert (launch.lanes < pieces) == (d in (35, 136))
    k4_args = (t["offsets"], t["slot_of_row"], t["qcache"], t["qscale"],
               t["q"], t["scale"])
    k6_args = (t["offsets"], t["slot_of_row"], t["smap"], t["qcache"],
               t["qscale"], t["qstaging"], t["qsscale"])
    for ids, mask in ((t["ids"], t["mask"]),
                      (t["ids"][..., 0].contiguous(), None)):
        before = (mtl_gather_two_level_q8.launches,
                  mtl_gather_three_level_q8.launches)
        k4 = mtl_gather_two_level_q8(ids, *k4_args, mask=mask)
        k6 = mtl_gather_three_level_q8(ids, *k6_args, mask=mask)
        torch.cuda.synchronize()
        assert (mtl_gather_two_level_q8.launches,
                mtl_gather_three_level_q8.launches) == \
            (before[0] + 1, before[1] + 1)
        assert _same_bits(k4, mtl_gather_two_level_q8_plain(
            ids, *k4_args, mask=mask))
        assert _same_bits(k6, mtl_gather_three_level_q8_plain(
            ids, *k6_args, mask=mask))
    # h slots of the last call: one; rows in neither tier read +0.0
    rows = (ids.long() + t["offsets"].long()[None, :]).clamp(
        0, t["slot_of_row"].numel() - 1).reshape(-1)
    c, s = t["slot_of_row"][rows], t["smap"][rows]
    neither = ~((c >= 0) & (c < t["qcache"].shape[0])) \
        & ~((s >= 0) & (s < t["qstaging"].shape[0]))
    zero = k6.view(-1, d)[neither]
    assert torch.all(zero == 0) and not torch.signbit(zero).any()
    if b > 1:
        assert neither.any() and k4.isnan().any()


def test_int8_tiered_entries_refuse_bad_launches(cuda):
    """The C entries check the word, alignment and shape they are given
    and return a CUDA error code before launching."""
    from repro_torch.kernels import multi_table_lookup as mtl
    from repro_torch.kernels import _build
    t = _q8_tier_inputs(np.random.default_rng(0), 4, 1, 32, 1, cuda)
    out = torch.empty((4, 7 * 32), device=cuda)
    good = tiered_launch(4, 7, 1, 32, 1)
    fn = mtl._tiered("mtl_gather_two_level_q8", 9, 13)
    n_rows = t["slot_of_row"].numel()

    def call(vec, word, lane_bits, threads, d=32, dst=out, shard=(0, 0)):
        return fn(t["ids"].data_ptr(), None, t["offsets"].data_ptr(),
                  t["slot_of_row"].data_ptr(), t["qcache"].data_ptr(),
                  t["qscale"].data_ptr(), t["q"].data_ptr(),
                  t["scale"].data_ptr(), dst.data_ptr(), 4, 7, 1, d,
                  t["qcache"].shape[0], n_rows, shard[0],
                  n_rows - shard[1], vec, word, lane_bits, threads,
                  good.blocks, _build.current_stream(cuda))
    assert call(1, 1, 3, 128) == 0
    assert call(1, 4, 3, 128) == 716       # cudaErrorMisalignedAddress
    assert call(1, 1, 3, 128, dst=out.view(-1)[1:]) == 716
    assert call(1, 2, 3, 128) == 9         # cudaErrorInvalidConfiguration
    assert call(0, 4, 5, 128) == 9         # a 4-byte word needs vec
    assert call(1, 1, 3, 128, d=30) == 9   # vec needs d % 4 == 0
    assert call(1, 1, 6, 128) == 9
    assert call(1, 1, 3, 96 + 1) == 9
    assert call(1, 1, 3, 128, shard=(1, 0)) == 9   # a shard past the table
    assert call(1, 1, 3, 128, shard=(0, n_rows)) == 9   # an empty shard
    torch.cuda.synchronize()


def _f32_tier_inputs(rng, b, h, d, offset, device, k=7, capacity=512):
    """fp32 cache, backing and staging tiers over a random table (-0.0 in
    a third of its rows): ids with out-of-range entries, a random mask, a
    cache slot past C, a staging slot past S, a cached row also staged,
    half the uncached rows in neither tier; the cache and staging rows
    differ from their backing rows (a wrong tier shows), and the cache,
    the staging area and a copy of the table (``table``, K2's) are views
    ``offset`` bytes into their storage."""
    sizes = rng.integers(2, 3000, size=k)
    n = int(sizes.sum()) + 1
    mega = rng.normal(size=(n, d)).astype(np.float32)
    mega[::3, 0] = -0.0
    mega[-1] = 0.0
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int32)
    ids = np.stack([rng.integers(0, s, size=(b, h)) for s in sizes],
                   axis=1).astype(np.int32)
    ids.reshape(-1)[:3] = [-7, 2**31 - 1, 10**8][:ids.size]
    mask = rng.integers(0, 2, size=ids.shape).astype(np.float32)
    hot = np.sort(rng.choice(n - 1, size=capacity, replace=False))
    som = np.full(n, -1, np.int32)
    som[hot] = np.arange(capacity, dtype=np.int32)
    som[hot[0]] = capacity + 5                          # past the cache
    uncached = np.flatnonzero(som < 0)
    warm = np.sort(rng.choice(uncached, size=uncached.size // 2,
                              replace=False))
    smap = np.full(n, -1, np.int32)
    smap[warm] = np.arange(warm.size, dtype=np.int32)
    smap[warm[0]] = warm.size + 9                       # past staging
    smap[hot[1]] = 0                                    # the cache wins
    f = int(np.searchsorted(offsets, hot[1], side="right")) - 1
    ids[-1, f, 0], mask[-1, f, 0] = hot[1] - offsets[f], 1.0  # read it
    t = {name: torch.from_numpy(v).to(device) for name, v in dict(
        ids=ids, mask=mask, offsets=offsets, slot_of_row=som, smap=smap,
        mega=mega).items()}
    t["cache"] = _byte_offset(t["mega"][torch.from_numpy(hot).to(device)]
                               * 2.0, offset)
    t["staging"] = _byte_offset(
        t["mega"][torch.from_numpy(warm).to(device)] * 3.0, offset)
    t["table"] = _byte_offset(t["mega"], offset)
    return t


@pytest.mark.parametrize("offset", [0, 4])
@pytest.mark.parametrize("b", [1, 256])
@pytest.mark.parametrize("h", [1, 5, 17])
@pytest.mark.parametrize("d", [3, 32, 35, 136])
def test_fp32_tiered_gathers_bitwise(cuda, d, h, b, offset, monkeypatch):
    """K2, K3 and K5 on every path they launch -- 4 floats a lane as one
    16-byte load or, from a table or tier 4 bytes into its storage, four
    4-byte loads; a float a lane at d % 4 != 0; several pieces a lane past
    128 floats (32 for d % 4 != 0); a second chunk of slots (h = 17) --
    are bitwise their plain versions, one launch a call, with the launch
    ``tiered_launch`` gives for ``tier_word`` over the table or the tiers.
    K2 with one slot is bitwise K1. K5 gives +0.0 for a row in neither
    tier and reads the cache's copy of a row in both."""
    from repro_torch.kernels import multi_table_lookup as mtl
    t = _f32_tier_inputs(np.random.default_rng(d * 100 + h * 10 + b + offset),
                         b, h, d, offset, cuda)
    picked = []

    def spy(*args):
        picked.append(tiered_launch(*args))
        return picked[-1]
    monkeypatch.setattr(mtl, "tiered_launch", spy)
    k3_args = (t["offsets"], t["slot_of_row"], t["cache"], t["mega"])
    k5_args = (t["offsets"], t["slot_of_row"], t["smap"], t["cache"],
               t["staging"])
    word = 16 if d % 4 == 0 and offset == 0 else 4
    for ids, mask in ((t["ids"], t["mask"]),
                      (t["ids"][..., 0].contiguous(), None)):
        before = (mtl_gather_multihot.launches, mtl_gather_two_level.launches,
                  mtl_gather_three_level.launches)
        k2 = mtl_gather_multihot(ids, mask, t["offsets"], t["table"])
        k3 = mtl_gather_two_level(ids, *k3_args, mask=mask)
        k5 = mtl_gather_three_level(ids, *k5_args, mask=mask)
        torch.cuda.synchronize()
        assert (mtl_gather_multihot.launches, mtl_gather_two_level.launches,
                mtl_gather_three_level.launches) == \
            (before[0] + 1, before[1] + 1, before[2] + 1)
        slots = ids.shape[2] if ids.dim() == 3 else 1
        assert picked[-3:] == [tiered_launch(b, 7, slots, d, word)] * 3
        assert _same_bits(k2, mtl_gather_multihot_plain(
            ids, mask, t["offsets"], t["table"]))
        assert _same_bits(k3, mtl_gather_two_level_plain(
            ids, *k3_args, mask=mask))
        assert _same_bits(k5, mtl_gather_three_level_plain(
            ids, *k5_args, mask=mask))
    assert _same_bits(k2, mtl_gather(ids, t["offsets"], t["mega"]))
    # h slots of the last call: one; rows in neither tier read +0.0 and a
    # row in both tiers the cache's copy
    rows = (ids.long() + t["offsets"].long()[None, :]).clamp(
        0, t["slot_of_row"].numel() - 1).reshape(-1)
    c, s = t["slot_of_row"][rows], t["smap"][rows]
    cached = (c >= 0) & (c < t["cache"].shape[0])
    staged = (s >= 0) & (s < t["staging"].shape[0])
    neither = ~cached & ~staged
    zero = k5.view(-1, d)[neither]
    assert torch.all(zero == 0) and not torch.signbit(zero).any()
    assert _same_bits(k5.view(-1, d)[cached], t["cache"][c[cached].long()])
    assert (cached & staged).any()
    if b > 1:
        assert neither.any()


@pytest.mark.parametrize("kernel", ["multihot", "two_level",
                                    "three_level"])
def test_fp32_tiered_entries_refuse_bad_launches(cuda, kernel):
    """K2's, K3's and K5's C entries check the launch, width and alignment
    they are given and return a CUDA error code before launching."""
    from repro_torch.kernels import multi_table_lookup as mtl
    from repro_torch.kernels import _build
    t = _f32_tier_inputs(np.random.default_rng(1), 4, 1, 32, 0, cuda)
    odd = {name: _byte_offset(t[name], 4)
           for name in ("table", "cache", "staging")}
    out = torch.empty((4, 7 * 32 + 4), device=cuda)
    good = tiered_launch(4, 7, 1, 32, 16)
    fn = mtl._tiered(f"mtl_gather_{kernel}",
                     *{"multihot": (5, 12), "two_level": (7, 13),
                       "three_level": (8, 12)}[kernel])

    def call(vec, word, lane_bits, threads, blocks=good.blocks, d=32,
             dst=out, tiers=t):
        if kernel == "multihot":
            ptrs = (tiers["table"],)
            sizes = (t["slot_of_row"].numel(), 0, t["slot_of_row"].numel())
        elif kernel == "two_level":
            ptrs = (t["slot_of_row"], tiers["cache"], t["mega"])
            sizes = (tiers["cache"].shape[0], t["slot_of_row"].numel(), 0,
                     t["slot_of_row"].numel())
        else:
            ptrs = (t["slot_of_row"], t["smap"], tiers["cache"],
                    tiers["staging"])
            sizes = (tiers["cache"].shape[0], tiers["staging"].shape[0],
                     t["slot_of_row"].numel())
        return fn(t["ids"].data_ptr(), None, t["offsets"].data_ptr(),
                  *(p.data_ptr() for p in ptrs), dst.data_ptr(), 4, 7, 1, d,
                  *sizes, vec, word, lane_bits, threads, blocks,
                  _build.current_stream(cuda))
    assert call(1, 16, 3, 128) == 0
    assert call(1, 4, 3, 128) == 0 and call(0, 4, 5, 128) == 0
    assert call(1, 4, 3, 128, tiers=odd) == 0  # the 4-byte path takes it
    assert call(1, 16, 3, 128, tiers=odd) == 716  # cudaErrorMisalignedAddress
    assert call(1, 4, 3, 128, dst=out.view(-1)[1:]) == 716
    if kernel == "three_level":                # the staging area alone
        assert call(1, 16, 3, 128,
                    tiers=dict(t, staging=odd["staging"])) == 716
    assert call(2, 16, 3, 128) == 9       # cudaErrorInvalidConfiguration
    assert call(0, 16, 5, 128) == 9       # a 16-byte word needs vec
    assert call(1, 8, 3, 128) == 9 and call(1, 1, 3, 128) == 9
    assert call(1, 16, 3, 128, d=30) == 9      # vec needs d % 4 == 0
    assert call(1, 16, 6, 128) == 9 and call(1, 16, -1, 128) == 9
    assert call(1, 16, 3, 96 + 1) == 9 and call(1, 16, 3, 512) == 9
    assert call(1, 16, 3, 16) == 9 and call(1, 16, 3, 128, blocks=0) == 9
    torch.cuda.synchronize()


def _host_model(cuda, row_dtype, staging_capacity):
    spec = ctr_spec("dcnv2", "criteo", **SPEC_KW)
    dense = CTR_MODELS["dcnv2"](spec, device=cuda).init(
        torch.Generator(device=cuda).manual_seed(0))
    model = CTR_MODELS["dcnv2"](spec, device=cuda)
    model.load_state_dict(dense.state_dict())
    store = HostBackedStore(spec.embedding_spec(), 256, staging_capacity,
                            row_dtype=row_dtype, device=cuda)
    model.use_store(store)
    return dense, model, store


@pytest.mark.parametrize("row_dtype", [None, "int8"])
def test_host_store_dual_plan_matches_dense(cuda, row_dtype):
    """Hint, stage, predict, observe, refresh and deltas through one
    "dual" plan over a host store: fp32 bitwise the dense plan, int8
    within the reference's 1e-2 gate; K5/K6 once per step."""
    dense, model, store = _host_model(cuda, row_dtype, 64 * 39)
    plan = compile_plan(model, "dual", 64, device=cuda,
                        runtime_provider=model.store_runtime_env)
    dplan = compile_plan(dense, "dual", 64, device=cuda)
    schema = CRITEO.scaled(2_000)
    reqs = [sample_ids(schema, 64, step=r) for r in range(6)]
    kernel = "mtl_gather_three_level_q8" if row_dtype else \
        "mtl_gather_three_level"
    try:
        reset_launch_counts()
        for r, ids in enumerate(reqs):
            if r + 1 < len(reqs):
                store.prefetch_hint(reqs[r + 1])
            store.stage(ids)
            got = plan.predict(ids)
            model.embedding.observe(ids)
            want = dplan.predict(ids)
            if row_dtype is None:
                np.testing.assert_array_equal(got, want)
            else:
                assert np.abs(got - want).max() < 1e-2
            if r == 2:
                store.refresh()
                rows = np.arange(1, 3_000, 5)
                vals = np.full((rows.size, store.spec.dim), 0.01,
                               np.float32)
                store.apply_deltas(rows, vals)
                dense.embedding.store.mega_table[
                    torch.from_numpy(rows).to(cuda)] = \
                    torch.from_numpy(vals).to(cuda)
        counts = launch_counts()
        assert counts[kernel] == len(reqs), counts
        assert counts["mtl_gather"] == len(reqs), counts   # the dense plan
        # the uploads move what changed: less than a whole-area snapshot
        # per request even at this width, where most of the area changes
        snapshot = store.staging.numel() * 4 \
            + store.staging_slot_of_row.numel() * 4
        assert store.upload_bytes < len(reqs) * snapshot
    finally:
        store.pipeline.stop()


def test_staging_upload_waits_for_a_step_queued_on_another_stream(cuda):
    """A "dual" step queued on a side stream behind a sleep reads the
    staging area; a batch staged meanwhile from the default stream evicts
    the step's rows. The upload must wait for the step: its scores stay
    the dense ones."""
    dense, model, store = _host_model(cuda, None, 39 * 32)
    plan = compile_plan(model, "dual", 32, device=cuda,
                        runtime_provider=model.store_runtime_env)
    schema = CRITEO.scaled(2_000)
    ids, other = (sample_ids(schema, 32, step=s, skew="uniform")
                  for s in (5, 6))
    try:
        want = compile_plan(dense, "dual", 32, device=cuda).predict(ids)
        store.stage(ids)
        ids_dev = torch.from_numpy(ids).to(cuda)
        torch.cuda.synchronize()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            torch.cuda._sleep(200_000_000)
            out = plan(ids_dev)
            done = side.record_event()
        assert not done.query()                  # the step is still queued
        step_rows = store.miss_rows(ids)
        store.stage(other)                       # evicts the step's rows
        assert (store.pipeline.snapshot()[2][step_rows] < 0).any()
        side.synchronize()
        got = torch.sigmoid(out.reshape(-1)).cpu().numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(plan.predict(other),
                                      compile_plan(dense, "dual", 32,
                                                   device=cuda).predict(other))
    finally:
        store.pipeline.stop()


@pytest.mark.parametrize("row_dtype", [None, "int8"])
def test_store_swap_during_a_dual_step_frees_nothing_still_read(cuda,
                                                                row_dtype):
    """A dual step queued on a side stream (held behind a sleep) reads the
    store's tensors; deltas published meanwhile from the default stream
    must not let the allocator hand those tensors' memory to new writes
    before the step has read them."""
    spec = ctr_spec("dcnv2", "criteo", **SPEC_KW)
    model = CTR_MODELS["dcnv2"](spec, device=cuda).init(
        torch.Generator(device=cuda).manual_seed(0))
    store = CachedStore(spec.embedding_spec(), 256, row_dtype, device=cuda)
    model.use_store(store)
    plan = compile_plan(model, "dual", 64, device=cuda,
                        runtime_provider=model.store_runtime_env)
    ids = torch.from_numpy(sample_ids(CRITEO.scaled(2_000), 64, seed=4)
                           ).to(cuda)
    want = plan(ids).clone()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        torch.cuda._sleep(200_000_000)
        out = plan(ids)
        done = side.record_event()
    assert not done.query()                      # the step is still queued
    rows = np.arange(0, 2_000, 7)
    store.apply_deltas(rows, np.full((rows.size, spec.embed_dim), 9.0,
                                     np.float32))
    store.refresh()
    junk = [torch.full_like(t, float("nan") if t.is_floating_point()
                            else -1) for t in store.runtime_tensors().values()
            for _ in range(4)]
    side.synchronize()
    assert torch.equal(out, want)
    assert not torch.equal(plan(ids), want)      # the plan sees the deltas
    del junk


def test_quantize_rows_on_the_card_is_bitwise_the_cpu(cuda):
    """Codes and scales made on the card equal those made on the CPU (and
    so the reference's): the scale is a true division, not a multiply by
    a rounded reciprocal."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn((65_536, 32), generator=g) * 0.05
    x[7] = 0.0
    q, s = quantize_rows(x)
    qc, sc = quantize_rows(x.to(cuda))
    assert torch.equal(sc.cpu(), s) and torch.equal(qc.cpu(), q)


def test_fused_tails_and_fm(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    b, dim = 256, 1248
    x0, xw, x = (torch.randn((b, dim), device=cuda, generator=g)
                 for _ in range(3))
    xlw = torch.randn((b, 1), device=cuda, generator=g)
    bias = torch.randn((dim,), device=cuda, generator=g)
    assert torch.equal(fused_cross_v2(x0, xw, x),
                       fused_cross_v2_plain(x0, xw, x))
    assert torch.equal(fused_cross_v1(x0, xlw, bias, x),
                       fused_cross_v1_plain(x0, xlw, bias, x))
    v = torch.randn((b, 39, 32), device=cuda, generator=g) * 0.05
    torch.testing.assert_close(fused_fm_second_order(v),
                               fused_fm_second_order_plain(v), **TOL)


CROSS_SHAPES = [(b, D) for b in (1, 7, 256, 1024) for D in (4, 117, 1248)]


def _cross_inputs(rng, b, D, offset, same, device):
    """K9's ``(x0, xw_plus, x)`` and K10's ``(x0, xlw, bias, x)`` on
    ``device``: the (b, D) operands and the bias ``offset`` bytes into
    their storage, ``x`` is ``x0`` where ``same`` (layer 0)."""
    def make(shape, off=offset):
        t = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
        return _byte_offset(t.to(device), off)
    x0, xw, x = make((b, D)), make((b, D)), make((b, D))
    if same:
        x = x0
    return (x0, xw, x), (x0, make((b, 1), 0), make((D,)), x)


def _cross_call(monkeypatch, kind, args):
    """Call K9 or K10's wrapper on ``args``; return its output, the launch
    count it added and the C entry's ``same`` and launch arguments."""
    from repro_torch.kernels import fused_cross as fc
    wrapper = fused_cross_v2 if kind == "v2" else fused_cross_v1
    entry = fc._v2_kernel() if kind == "v2" else fc._v1_kernel()
    seen = []

    def spy(*a):
        seen.append(a[-7:-1])
        return entry(*a)
    monkeypatch.setattr(fc, f"_{kind}_kernel", lambda: spy)
    before = wrapper.launches
    out = wrapper(*args)
    torch.cuda.synchronize()
    return out, wrapper.launches - before, seen


def _cross_plain(kind, args):
    return (fused_cross_v2_plain if kind == "v2" else fused_cross_v1_plain)(
        *args)


@pytest.mark.parametrize("same", [False, True])
@pytest.mark.parametrize("offset", [0, 4])
@pytest.mark.parametrize("b,D", CROSS_SHAPES)
@pytest.mark.parametrize("kind", ["v2", "v1"])
def test_fused_cross_bitwise(cuda, kind, b, D, offset, same, monkeypatch):
    """K9 and K10 on every path they launch -- pieces of 4 floats as one
    16-byte word (D % 4 == 0, every operand aligned), as four 4-byte words
    (operands 4 bytes into their storage), a float a piece (D = 117); x
    read, or skipped where it is x0 (layer 0) -- bitwise their plain
    versions, one launch a call, with the launch ``cross_launch`` gives."""
    rng = np.random.default_rng(b * 10_000 + D * 10 + offset + same)
    v2_args, v1_args = _cross_inputs(rng, b, D, offset, same, cuda)
    args = v2_args if kind == "v2" else v1_args
    out, launches, seen = _cross_call(monkeypatch, kind, args)
    launch = cross_launch(b, D, offset == 0)
    assert launches == 1
    assert seen == [(int(same), *launch_args(launch))]
    assert launch.word == (16 if D % 4 == 0 and offset == 0 else 4)
    assert _same_bits(out, _cross_plain(kind, args))


@pytest.mark.parametrize("same", [False, True])
@pytest.mark.parametrize("offset", [0, 4])
@pytest.mark.parametrize("kind", ["v2", "v1"])
def test_fused_cross_keeps_nan_and_inf(cuda, kind, offset, same):
    """NaN, inf and -inf entries in every operand give the plain version's
    bits (NaN where it has NaN) and touch no other element."""
    rng = np.random.default_rng(29 + offset + same)
    v2_args, v1_args = _cross_inputs(rng, 256, 1248, offset, same, cuda)
    args = v2_args if kind == "v2" else v1_args
    clean = [t.clone() for t in args]
    if same:
        clean[-1] = clean[0]
    x0 = args[0]
    x0[0, 0], x0[5, 7], x0[9, 1247] = (float("nan"), float("inf"),
                                       float("-inf"))
    args[1][17, -1] = float("inf")           # xw_plus, or xlw's whole row
    if kind == "v2":
        args[1][-1] = float("nan")           # a row of xw_plus
    else:
        args[2][-1] = float("nan")           # a bias column
    if not same:
        args[-1][100, 100] = float("-inf")
    wrapper = fused_cross_v2 if kind == "v2" else fused_cross_v1
    got = wrapper(*args)
    want = _cross_plain(kind, args)
    torch.cuda.synchronize()
    assert got.isnan().any() and got.isinf().any()
    assert _same_bits(got, want)
    touched = ~(_cross_plain(kind, clean) == want)
    assert _same_bits(got[~touched], wrapper(*clean)[~touched])


@pytest.mark.parametrize("threads", [32, 64, 128, 256])
@pytest.mark.parametrize("words", [1, 2, 4])
@pytest.mark.parametrize("kind", ["v2", "v1"])
def test_fused_cross_entries_take_any_covering_launch(cuda, kind, words,
                                                      threads):
    """The C entries give the same bits at every pieces-a-thread and
    block-size setting of ``chip_smoke.py``'s sweep, on each path."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import fused_cross as fc
    for b, D, offset in ((256, 1248, 0), (7, 1248, 4), (33, 117, 0)):
        rng = np.random.default_rng(words * 1000 + threads + b)
        v2_args, v1_args = _cross_inputs(rng, b, D, offset, False, cuda)
        args = v2_args if kind == "v2" else v1_args
        launch = cross_launch(b, D, offset == 0)
        pieces = b * D // (4 if launch.vec else 1)
        launch = launch._replace(rows=words, threads=threads,
                                 blocks=-(-pieces // (words * threads)))
        out = torch.empty((b, D), device=cuda)
        entry = fc._v2_kernel() if kind == "v2" else fc._v1_kernel()
        code = entry(*(t.data_ptr() for t in args), out.data_ptr(), b, D, 0,
                     *launch_args(launch), _build.current_stream(cuda))
        assert code == 0, (b, D, offset)
        assert _same_bits(out, _cross_plain(kind, args)), (b, D, offset)


@pytest.mark.parametrize("kind", ["v2", "v1"])
def test_fused_cross_entries_refuse_bad_launches(cuda, kind):
    """K9's and K10's C entries check the launch, the alignment and the
    ``same`` flag they are given and return a CUDA error code before
    launching."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import fused_cross as fc
    rng = np.random.default_rng(11)
    b, D = 8, 16
    (x0, xw, x), v1_args = _cross_inputs(rng, b, D, 0, False, cuda)
    odd = _byte_offset(x0, 4)
    out = torch.empty((b, D), device=cuda)
    entry = fc._v2_kernel() if kind == "v2" else fc._v1_kernel()

    def call(same=0, vec=1, word=16, words=1, threads=32, blocks=1, a=x0,
             r=None, y=out, dim=D, rows=b):
        r = x if r is None else r
        ins = (a, xw, r) if kind == "v2" else (a, v1_args[1], v1_args[2], r)
        return entry(*(t.data_ptr() for t in ins), y.data_ptr(), rows, dim,
                     same, vec, word, words, threads, blocks,
                     _build.current_stream(cuda))
    assert call() == 0                                # 32 pieces, 32 threads
    assert call(a=odd) == 716               # cudaErrorMisalignedAddress
    assert call(a=odd, r=odd, word=4) == 0
    assert call(y=_byte_offset(out, 4), word=4) == 716  # a float4 store
    assert call(y=_byte_offset(out, 4), word=4, vec=0, blocks=4) == 0
    assert call(same=1) == 1                # cudaErrorInvalidValue: x != x0
    assert call(same=1, r=x0) == 0 and call(same=2) == 1
    assert call(vec=0) == 9                 # cudaErrorInvalidConfiguration
    assert call(word=8) == 9 and call(dim=14, rows=8) == 9
    assert call(words=0) == 9 and call(words=3) == 9
    assert call(words=8) == 9
    assert call(threads=16) == 9 and call(threads=48) == 9
    assert call(threads=512) == 9 and call(blocks=0) == 9
    assert call(rows=9) == 9                # 36 pieces, 32 covered
    assert call(rows=-1) == 9 and call(rows=0) == 0
    torch.cuda.synchronize()


FM_SHAPES = [(1, 1, 1), (3, 39, 1), (256, 39, 3), (256, 39, 32),
             (1024, 39, 32), (64, 13, 60), (16, 7, 136)]


def _fm_input(rng, shape, offset, device):
    """Embedding-scale ``v`` on ``device``, a view ``offset`` bytes into
    its storage."""
    v = torch.from_numpy(rng.normal(size=shape).astype(np.float32) * 0.05)
    return _byte_offset(v.to(device), offset)


@pytest.mark.parametrize("offset", [0, 4])
@pytest.mark.parametrize("b,k,d", FM_SHAPES)
def test_fused_fm_within_tol(cuda, b, k, d, offset, monkeypatch):
    """K11 on every path it launches -- 4 floats a lane as one 16-byte
    load (d % 4 == 0 and ``v`` aligned), a float a lane (d % 4 != 0, or
    ``v`` 4 bytes into its storage), a partial last group (d = 3, 60),
    groups past the last field (k = 1), several pieces a lane past 128
    floats (d = 136) -- within ``rtol=atol=1e-5`` of the plain version,
    one launch a call, with the launch ``fm_launch`` gives."""
    from repro_torch.kernels import fused_fm as fm
    v = _fm_input(np.random.default_rng(b * 1000 + k * 10 + d + offset),
                  (b, k, d), offset, cuda)
    picked = []

    def spy(*args):
        picked.append(fm_launch(*args))
        return picked[-1]
    monkeypatch.setattr(fm, "fm_launch", spy)
    before = fused_fm_second_order.launches
    got = fused_fm_second_order(v)
    torch.cuda.synchronize()
    assert fused_fm_second_order.launches == before + 1
    assert picked == [fm_launch(b, d, offset == 0)]
    assert picked[0].vec == (d % 4 == 0 and offset == 0)
    torch.testing.assert_close(got, fused_fm_second_order_plain(v), **TOL)


@pytest.mark.parametrize("offset", [0, 4])
def test_fused_fm_keeps_nan_and_inf_to_their_rows(cuda, offset):
    """A NaN, an inf or a -inf in a row gives NaN in that row, as in the
    plain version; every other row is bitwise what it is without them."""
    clean = _fm_input(np.random.default_rng(7 + offset), (64, 39, 32),
                      offset, cuda)
    v = _byte_offset(clean, offset)
    bad = (3, 10, 11)
    v[3, 5, 7], v[10, 0, 31], v[11, 38, 0] = (float("nan"), float("inf"),
                                              float("-inf"))
    got = fused_fm_second_order(v)
    want = fused_fm_second_order_plain(v)
    torch.cuda.synchronize()
    rows = torch.zeros(64, dtype=torch.bool, device=cuda)
    rows[list(bad)] = True
    assert got[rows].isnan().all() and want[rows].isnan().all()
    assert not got[~rows].isnan().any()
    assert _same_bits(got[~rows], fused_fm_second_order(clean)[~rows])
    torch.testing.assert_close(got[~rows], want[~rows], **TOL)


def test_fused_fm_entry_refuses_bad_launches(cuda):
    """K11's C entry checks the launch and alignment it is given and
    returns a CUDA error code before launching; any lane count it takes
    gives the row's sum."""
    from repro_torch.kernels import fused_fm as fm
    from repro_torch.kernels import _build
    v = _fm_input(np.random.default_rng(3), (4, 39, 32), 0, cuda)
    odd = _byte_offset(v, 4)
    out = torch.empty((5, 1), device=cuda)
    good = fm_launch(4, 32, True)

    def call(vec, lane_bits, threads, blocks=good.blocks, d=32, src=v):
        return fm._kernel()(src.data_ptr(), out.data_ptr(), 4, 39, d, vec,
                            lane_bits, threads, blocks,
                            _build.current_stream(cuda))
    want = fused_fm_second_order_plain(v)
    for vec, lane_bits, src in ((1, 3, v), (1, 0, v), (1, 5, v), (0, 3, odd),
                                (0, 5, odd), (0, 0, v)):
        assert call(vec, lane_bits, 64, src=src) == 0
        torch.testing.assert_close(out[:4], want, **TOL)
    assert call(1, 3, 64, src=odd) == 716   # cudaErrorMisalignedAddress
    assert call(2, 3, 64) == 9              # cudaErrorInvalidConfiguration
    assert call(1, 3, 64, d=30) == 9        # vec needs d % 4 == 0
    assert call(1, 6, 64) == 9 and call(1, -1, 64) == 9
    assert call(1, 3, 16) == 9 and call(1, 3, 96 + 1) == 9
    assert call(1, 3, 512) == 9 and call(1, 3, 64, blocks=0) == 9
    torch.cuda.synchronize()


def test_kernels_launch_on_the_current_stream(cuda):
    """On a side stream held up by a sleep, the kernel must read what that
    stream wrote after the sleep; launched on another stream it would race
    ahead and read zeros."""
    x = torch.zeros((64, 1024), device=cuda)
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        torch.cuda._sleep(50_000_000)
        x.fill_(2.0)
        out = fused_cross_v2(x, x, x)
    side.synchronize()
    assert torch.all(out == 6.0)


@pytest.mark.parametrize("model_name", list(CTR_MODELS))
def test_every_level_on_cuda_matches_the_cpu_path(cuda, model_name):
    spec = ctr_spec(model_name, "criteo", **SPEC_KW)
    cpu_model = CTR_MODELS[model_name](spec, device="cpu").init(
        torch.Generator().manual_seed(0))
    model = CTR_MODELS[model_name](spec, device=cuda)
    model.load_state_dict(cpu_model.state_dict())
    ids = sample_ids(CRITEO.scaled(2_000), 64, seed=4)
    want = compile_plan(cpu_model, "dual", 64, device="cpu")(
        torch.from_numpy(ids))
    outs = {}
    for level in LEVELS:
        plan = compile_plan(model, level, 64, device=cuda)
        reset_launch_counts()
        outs[level] = plan(torch.from_numpy(ids).to(cuda))
        counts = launch_counts()
        torch.testing.assert_close(outs[level].cpu(), want, rtol=1e-4,
                                   atol=1e-5, msg=lambda m: f"{level}: {m}")
        fused = level in ("fused_all", "dual")
        assert (counts["fused_cross_v2"] > 0) == (
            fused and model_name == "dcnv2"), counts
        assert (counts["fused_cross_v1"] > 0) == (
            fused and model_name == "dcn"), counts
        assert (counts["fused_fm_second_order"] > 0) == (
            fused and model_name == "deepfm"), counts
    for level, out in outs.items():
        torch.testing.assert_close(out, outs["naive"], rtol=1e-5, atol=1e-6,
                                   msg=lambda m: f"{level}: {m}")


# ---------------------------------------------------------------------------
# K12 dmm_q8, K8 mtl_input_first, K7 mtl_onehot
# ---------------------------------------------------------------------------

def _q8_args(rng, b, fan_in, fan_out, device, saturate=False):
    """Quantized layer inputs as the int8 plan makes them: per-row codes
    of ``h``, per-channel codes of ``w`` in the kernel's layout."""
    h = rng.normal(size=(b, fan_in)).astype(np.float32)
    w = (rng.normal(size=(fan_in, fan_out)) * 0.03).astype(np.float32)
    if saturate:                      # every code ±127, |acc| up to 127²·K
        h = np.sign(h) + (h == 0)
        w = np.sign(w) * 0.03 + (w == 0) * 0.03
        w[:, 0] = 0.03 * h[0]
    hc, wc = torch.from_numpy(h), torch.from_numpy(w)
    hs = absmax_scale(hc)
    wq, ws = quantize_channels(wc)
    bias = torch.from_numpy(rng.normal(size=(1, fan_out)).astype(np.float32))
    return [x.to(device) for x in (quantize(hc, hs), hs, pack_weight(wq), ws,
                                   bias)]


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("b,fan_in,fan_out,saturate", [
    (256, 1248, 1024, False), (1024, 1024, 1024, False),
    (1, 1, 1, False), (33, 7, 5, False), (64, 1248, 96, True),
    # M not a multiple of the 64-row tile, N not a multiple of any N-tile
    (200, 1248, 1024, False), (256, 1024, 96, False),
    (1024, 1248, 1000, False), (200, 1152, 1000, True),
])
def test_dmm_q8_bitwise(cuda, relu, b, fan_in, fan_out, saturate):
    rng = np.random.default_rng(b + fan_in)
    args = _q8_args(rng, b, fan_in, fan_out, cuda, saturate)
    before = dmm_q8.launches
    got = dmm_q8(*args, relu=relu)
    torch.cuda.synchronize()
    assert dmm_q8.launches == before + 1
    assert torch.equal(got, dmm_q8_plain(*args, relu=relu))
    cpu = dmm_q8_plain(*[a.cpu() for a in args], relu=relu)
    assert torch.equal(got.cpu(), cpu)
    if saturate:
        acc = args[0][0].cpu().long() @ args[2][0].cpu().long()
        assert int(acc) == 127 * 127 * fan_in > 2**24


def test_dmm_q8_launches_on_the_current_stream(cuda):
    rng = np.random.default_rng(0)
    hq, hs, wq_t, ws, bias = _q8_args(rng, 64, 256, 128, cuda)
    want = dmm_q8_plain(hq, hs, wq_t, ws, bias)
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    src = hq.clone()
    hq.zero_()
    torch.cuda.synchronize()
    with torch.cuda.stream(side):
        torch.cuda._sleep(50_000_000)
        hq.copy_(src)
        out = dmm_q8(hq, hs, wq_t, ws, bias)
    side.synchronize()
    assert torch.equal(out, want)


@pytest.mark.parametrize("offset", [1, 3, 16])
def test_dmm_q8_takes_an_offset_view(cuda, offset):
    """An ``hq`` that starts ``offset`` bytes into its storage (16-byte
    misaligned for 1 and 3) goes through the kernel all the same, padded
    into an aligned copy first."""
    rng = np.random.default_rng(offset)
    hq, hs, wq_t, ws, bias = _q8_args(rng, 200, 1248, 96, cuda)
    buf = torch.zeros(offset + hq.numel(), dtype=torch.int8, device=cuda)
    view = buf[offset:].view(hq.shape)
    view.copy_(hq)
    assert (view.data_ptr() % 16 == 0) == (offset % 16 == 0)
    before = dmm_q8.launches
    got = dmm_q8(view, hs, wq_t, ws, bias)
    torch.cuda.synchronize()
    assert dmm_q8.launches == before + 1
    assert torch.equal(got, dmm_q8_plain(hq, hs, wq_t, ws, bias))
    assert pad_k(view, 1248).data_ptr() % 16 == 0
    assert (pad_k(view, 1248) is view) == (offset % 16 == 0)


def _activation_rows(rng, b, fan_in):
    """Activations as the MLP feeds the quantizer, rows of very different
    scales, plus (where there are rows for them) an all-zero row and a
    row whose every ``x / scale`` lands on ``k + 0.5``."""
    h = (rng.normal(size=(b, fan_in))
         * rng.uniform(1e-3, 10.0, size=(b, 1))).astype(np.float32)
    if b > 1:
        h[1] = 0.0
    if b > 2:
        h[2] = _half_way_row(fan_in)
    return h


def _half_way_row(fan_in):
    """A row with max|x| = 127 s for s = 2**-4, so its scale is exactly s,
    and every other value (k + 0.5) s: round half to even decides each
    code."""
    s = np.float32(2.0**-4)
    k = (np.arange(fan_in) % 254) - 127 + 0.5            # -126.5 .. 126.5
    row = (k * s).astype(np.float32)
    row[0] = 127 * s
    return row


@pytest.mark.parametrize("b", [1, 33, 256, 1024])
@pytest.mark.parametrize("fan_in", [1248, 1024, 7, 1])
def test_quantize_rows_q8_bitwise(cuda, b, fan_in):
    rng = np.random.default_rng(b * 7 + fan_in)
    h = torch.from_numpy(_activation_rows(rng, b, fan_in))
    hc = h.to(cuda)
    before = quantize_rows_q8.launches
    hq, hs = quantize_rows_q8(hc)
    torch.cuda.synchronize()
    assert quantize_rows_q8.launches == before + 1
    assert hq.dtype == torch.int8 and tuple(hq.shape) == (b, fan_in)
    assert hs.dtype == torch.float32 and tuple(hs.shape) == (b, 1)
    want_q, want_s = quantize_rows_q8_plain(hc)
    assert torch.equal(hq, want_q) and torch.equal(hs, want_s)
    cpu_q, cpu_s = quantize_rows_q8_plain(h)
    assert torch.equal(hq.cpu(), cpu_q) and torch.equal(hs.cpu(), cpu_s)
    if b > 1:                                  # the all-zero row
        assert hs[1, 0].item() == np.float32(1e-12) and not hq[1].any()


@pytest.mark.parametrize("fan_in", [1248, 7])
def test_quantize_rows_q8_rounds_half_to_even(cuda, fan_in):
    row = _half_way_row(fan_in)
    hq, hs = quantize_rows_q8(torch.from_numpy(row[None]).to(cuda))
    assert hs.item() == 2.0**-4
    want = np.rint(row / np.float32(2.0**-4)).astype(np.int8)   # half-even
    np.testing.assert_array_equal(hq[0].cpu().numpy(), want)
    assert hq[0, 1].item() == -126          # -125.5 goes to the even code


@pytest.mark.parametrize("fan_in", [1248, 1024, 7])
def test_quantize_rows_q8_propagates_nan(cuda, fan_in):
    """A row holding a NaN gets a NaN scale, as the plain version's amax
    and clamp_min give it, and codes of 0, as on the CPU; inf rows get an
    inf scale. K12 then gives those rows NaN outputs, through its ReLU too.
    Every other scale, code and output is bitwise the plain version's."""
    rng = np.random.default_rng(fan_in)
    h = _activation_rows(rng, 256, fan_in)
    h[3, min(5, fan_in - 1)] = np.nan
    h[4, 0] = np.inf
    h[5, fan_in // 2] = -np.inf
    hq, hs = quantize_rows_q8(torch.from_numpy(h).to(cuda))
    want_q, want_s = quantize_rows_q8_plain(torch.from_numpy(h).to(cuda))
    cpu_q, cpu_s = quantize_rows_q8_plain(torch.from_numpy(h))
    torch.cuda.synchronize()
    nan = torch.isnan(hs)
    assert nan[:, 0].nonzero().flatten().tolist() == [3]
    assert torch.equal(nan, torch.isnan(want_s))
    assert torch.equal(hs[~nan].view(torch.int32),
                       want_s[~nan].view(torch.int32))
    assert torch.equal(hs.cpu()[~nan.cpu()].view(torch.int32),
                       cpu_s[~nan.cpu()].view(torch.int32))
    assert torch.isinf(hs[4:6]).all()
    assert torch.equal(hq.cpu(), cpu_q) and not hq[3:6].any()
    w = torch.from_numpy(rng.normal(size=(fan_in, 96)).astype(np.float32))
    wq, ws = quantize_channels(w)
    bias = torch.from_numpy(rng.normal(size=(1, 96)).astype(np.float32))
    wq_t, ws, bias = pack_weight(wq).to(cuda), ws.to(cuda), bias.to(cuda)
    for relu in (True, False):
        out = dmm_q8(hq, hs, wq_t, ws, bias, relu=relu)
        want = dmm_q8_plain(hq, hs, wq_t, ws, bias, relu=relu)
        torch.cuda.synchronize()
        rows = torch.isnan(out).all(dim=1)
        assert rows.nonzero().flatten().tolist() == [3, 4, 5], relu
        assert not torch.isnan(out[~rows]).any()
        assert torch.equal(out[~rows], want[~rows])
        assert torch.isnan(want[rows]).all()


def test_quantize_rows_q8_launches_on_the_current_stream(cuda):
    rng = np.random.default_rng(1)
    h = torch.from_numpy(_activation_rows(rng, 256, 1248)).to(cuda)
    want = quantize_rows_q8_plain(h)
    side = torch.cuda.Stream()
    src = h.clone()
    h.zero_()
    torch.cuda.synchronize()
    with torch.cuda.stream(side):
        torch.cuda._sleep(50_000_000)
        h.copy_(src)
        hq, hs = quantize_rows_q8(h)
    side.synchronize()
    assert torch.equal(hq, want[0]) and torch.equal(hs, want[1])


@pytest.mark.parametrize("d,b,k", LOOKUP_SHAPES)
def test_mtl_input_first_bitwise(cuda, d, b, k):
    args = _lookup_inputs(np.random.default_rng(d * 1000 + b + k + 7), b, k,
                          d, cuda)
    before = mtl_input_first.launches
    got = mtl_input_first(*args)
    fmajor = mtl_input_first(*args, field_major=True)
    torch.cuda.synchronize()
    assert mtl_input_first.launches == before + 2
    assert torch.equal(got, mtl_input_first_plain(*args))
    assert torch.equal(got, mtl_gather(*args))
    assert torch.equal(fmajor, mtl_input_first_plain(*args,
                                                     field_major=True))


ONEHOT_BAD_IDS = [-1, 128, 10**6, -2**31, 2**31 - 1]    # n_pad = 128


@pytest.mark.parametrize("b", [1, 256, 1024])
@pytest.mark.parametrize("d", [1, 3, 32])
@pytest.mark.parametrize("dtype,offset", [
    (torch.float32, 0), (torch.float32, 4),
    (torch.bfloat16, 0), (torch.bfloat16, 4), (torch.bfloat16, 2)])
def test_mtl_onehot_bitwise(cuda, dtype, offset, d, b):
    """K7 bitwise its plain version over Criteo's 18 small fields, on
    tables aligned or ``offset`` bytes into their storage (the narrower
    word), out-of-range ids giving +0.0 rows, one launch a call; fp32
    equal to K1 on the concatenated tables."""
    rng = np.random.default_rng(d * 10_000 + b + offset)
    sizes = rng.integers(2, 107, size=18)
    k, n_pad = len(sizes), 128
    stacked = np.zeros((k, n_pad, d), np.float32)
    for f, n in enumerate(sizes):
        stacked[f, :n] = rng.normal(size=(n, d))
    stacked[0, 0, 0] = -0.0
    ids = np.stack([rng.integers(0, n, size=b) for n in sizes],
                   axis=1).astype(np.int32)
    ids[0, 0] = 0                                         # the -0.0 row
    ids[0, 1:1 + len(ONEHOT_BAD_IDS)] = ONEHOT_BAD_IDS    # zero rows
    tables = torch.from_numpy(stacked).to(cuda, dtype)
    if offset:
        tables = _byte_offset(tables, offset)
    ids_c = torch.from_numpy(ids).to(cuda)
    before = mtl_onehot.launches
    got = mtl_onehot(ids_c, tables)
    torch.cuda.synchronize()
    assert mtl_onehot.launches == before + 1
    assert got.dtype == dtype and tuple(got.shape) == (b, k, d)
    el = tables.element_size()
    word = onehot_word(d, el, tables.data_ptr(), got.data_ptr())
    assert word == (16 if offset == 0 and d == 32 else
                    4 if (d * el) % 4 == 0 and offset != 2 else el)
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    want = mtl_onehot_plain(ids_c, tables)
    assert torch.equal(got.view(bits), want.view(bits))
    assert torch.equal(got.cpu().view(bits), mtl_onehot_plain(
        torch.from_numpy(ids), tables.cpu()).view(bits))
    zero = got[0, 1:1 + len(ONEHOT_BAD_IDS)]
    assert not zero.view(bits).any(), "zero rows are +0.0 bits"
    assert got[0, 0, 0].view(bits).item() == \
        torch.tensor(-0.0, dtype=dtype).view(bits).item()
    if dtype == torch.float32:
        mega = torch.cat([tables[f, :n] for f, n in enumerate(sizes)])
        offsets = torch.from_numpy(np.concatenate(
            [[0], np.cumsum(sizes)[:-1]]).astype(np.int32)).to(cuda)
        ok = ids_c.clone()
        ok[0, 1:1 + len(ONEHOT_BAD_IDS)] = 0
        assert torch.equal(mtl_onehot(ok, tables).reshape(b, -1),
                           mtl_gather(ok, offsets, mega))


def test_mtl_onehot_entry_refuses_bad_launches(cuda):
    """K7's C entry checks the launch it is given -- lanes a power of two
    up to 32, rows 1 or 2, a word of 16, 4 or the element's bytes that
    divides the row and both addresses, n_pad in [1, 2^31) -- and
    returns cudaErrorInvalidValue (1) before launching."""
    from repro_torch.kernels import multi_table_lookup as mtl
    from repro_torch.kernels import _build
    b, k, n_pad, d = 4, 3, 8, 32
    ids = torch.zeros((b, k), dtype=torch.int32, device=cuda)
    tables = torch.randn((k, n_pad, d), device=cuda)
    view = _byte_offset(tables, 4)
    out = torch.empty((b, k, d), device=cuda)
    good = onehot_launch(b, k, d, 16, 4)

    def call(word=16, lanes=good.lanes, rows=1, threads=128, t=tables,
             dst=out, itemsize=4, d=d, n=n_pad):
        return mtl._onehot_kernel()(
            ids.data_ptr(), t.data_ptr(), dst.data_ptr(), b, k, n, d,
            itemsize, word, lanes, rows, threads, good.blocks,
            _build.current_stream(cuda))
    assert call() == 0
    assert call(lanes=3) == 1
    assert call(lanes=64) == 1
    assert call(t=view) == 1                 # a 16-byte word 4 bytes in
    assert call(t=view, word=4, lanes=32) == 0
    assert call(dst=out.view(-1)[1:]) == 1
    assert call(word=8) == 1
    assert call(word=16, d=3, lanes=1) == 1  # 12-byte rows
    assert call(word=2, lanes=32) == 1       # 2 bytes is not fp32's element
    assert call(rows=3) == 1
    assert call(threads=96 + 1) == 1
    assert call(itemsize=8) == 1
    assert call(n=0) == 1 and call(n=2**31) == 1
    torch.cuda.synchronize()


def test_full_width_int8_dcnv2_matches_the_cpu_path(cuda):
    """The configuration of record at full width (uncapped Criteo, d = 32,
    MLP 1248 -> 1024 x 3) through compute_dtype="int8": three quantizer
    and three K12 launches a step, and the card's logits those of the CPU
    int8 path."""
    spec = ctr_spec("dcnv2", "criteo", embed_dim=32, hidden=1024)
    model = CTR_MODELS["dcnv2"](spec, device=cuda).init(
        torch.Generator(device=cuda).manual_seed(0))
    cpu_model = CTR_MODELS["dcnv2"](spec, device="cpu")
    cpu_model.load_state_dict(model.state_dict())
    ids = sample_ids(CRITEO, 256, seed=5)
    plan = compile_plan(model, "dual", 256, device=cuda, compute_dtype="int8")
    assert plan.stats.mlp_quant_weight_bytes == 3_387_392
    reset_launch_counts()
    got = plan(torch.from_numpy(ids).to(cuda))
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["dmm_q8"] == counts["quantize_rows_q8"] == 3, counts
    want = compile_plan(cpu_model, "dual", 16, device="cpu",
                        compute_dtype="int8")(torch.from_numpy(ids[:16]))
    torch.testing.assert_close(got[:16].cpu(), want, rtol=1e-4, atol=1e-5)
    fp32 = compile_plan(model, "dual", 256, device=cuda)(
        torch.from_numpy(ids).to(cuda))
    assert (torch.sigmoid(got) - torch.sigmoid(fp32)).abs().max() < 1e-2


# ---------------------------------------------------------------------------
# the serving stack on the card
# ---------------------------------------------------------------------------

SCHEMA = CRITEO.scaled(2_000)
#: per "dual" step of each served model: (kernel, launches)
STEP_LAUNCHES = {"dcnv2": {"fused_cross_v2": 3},
                 "deepfm": {"fused_fm_second_order": 1},
                 "dcn": {"fused_cross_v1": 3}, "widedeep": {}}
GATHERS = {"dense": "mtl_gather", "cached": "mtl_gather_two_level",
           "host": "mtl_gather_three_level"}


def _serving_models(name, device, store=None, **store_kw):
    """A model on ``device`` (weights from seed 0, drawn on the CPU) and
    its CPU twin, with stores of one kind."""
    spec = ctr_spec(name, "criteo", **SPEC_KW)
    cpu = CTR_MODELS[name](spec, device="cpu").init(
        torch.Generator().manual_seed(0))
    model = CTR_MODELS[name](spec, device=device)
    model.load_state_dict(cpu.state_dict())

    def make(dev):
        if store == "cached":
            return CachedStore(spec.embedding_spec(), 64, device=dev)
        if store == "host":
            return HostBackedStore(spec.embedding_spec(), 64,
                                   store_kw.get("staging", 16 * 39),
                                   device=dev)
        return None
    return model, cpu, make(device), make("cpu")


def _step_launches(name, store):
    want = dict(STEP_LAUNCHES[name])
    gather = GATHERS[store]
    want[gather] = want.get(gather, 0) + 1
    if name in ("deepfm", "widedeep"):         # the d = 1 table: dense K1
        want["mtl_gather"] = want.get("mtl_gather", 0) + 1
    return want


def _stop_host(*stores):
    for s in stores:
        if isinstance(s, HostBackedStore):
            s.pipeline.stop()


@pytest.mark.parametrize("name,store", [("dcnv2", "dense"),
                                        ("deepfm", "dense"),
                                        ("dcnv2", "cached"),
                                        ("dcnv2", "host")])
def test_engine_on_cuda_matches_the_cpu_engine(cuda, name, store):
    """Same weights, same rows, same buckets: the card's engine serves the
    CPU engine's batches with its counters, scores within the models'
    cross-device tolerance, and launches each kernel of the step once per
    plan step (three K9 / one K11; a host store's overflowing batch is a
    step per chunk)."""
    model, cpu, store_d, store_c = _serving_models(name, cuda, store)
    try:
        engs = [InferenceEngine(m, policy=BucketedBatch((8, 16, 32)),
                                store=s, refresh_every=2, device=d)
                for m, s, d in ((model, store_d, cuda),
                                (cpu, store_c, "cpu"))]
        outs, counts = [], None
        for e in engs:
            e.warmup()
            reset_launch_counts()
            got = []
            for n, seed in ((43, 1), (7, 2), (20, 3)):
                e.submit_many(list(sample_ids(SCHEMA, n, seed=seed,
                                              skew="zipf")))
                got.append(e.serve_pending())
            outs.append(np.concatenate(got))
            if counts is None:            # the card engine's launches only
                counts = launch_counts()
        np.testing.assert_allclose(outs[0], outs[1], rtol=1e-4, atol=1e-5)
        on_card, on_cpu = (e.stats for e in engs)
        for f in ("n_requests", "n_batches", "batches_per_bucket",
                  "padded_rows_total", "cache_hits", "cache_misses",
                  "emb_cache_hits", "emb_cache_misses",
                  "emb_cache_refreshes", "emb_staging_overflows"):
            assert getattr(on_card, f) == getattr(on_cpu, f), f
        steps = on_card.n_batches
        if store == "host":               # overflowing batches: a chunk a step
            steps = counts["mtl_gather_three_level"]
            assert (steps > on_card.n_batches) == (
                on_card.emb_staging_overflows > 0)
        for kernel, per_step in _step_launches(name, store).items():
            assert counts[kernel] == per_step * steps, counts
    finally:
        _stop_host(store_d, store_c)


@pytest.mark.parametrize("mode", ["worker", "shared", "per-engine"])
def test_async_serving_on_cuda_resolves_every_future(cuda, mode):
    """Four submitter threads into a running worker / shared pool /
    per-engine runtime on the card: every future resolves, each score
    within 1e-5 of a one-bucket plan's score for its row, and the launch
    counts are n_batches times the step's."""
    model, _, store, _ = _serving_models("dcnv2", cuda, "cached")
    rows = {t: list(sample_ids(SCHEMA, 40, seed=10 + t, skew="zipf"))
            for t in range(4)}
    policy = BucketedBatch((8, 16, 32))
    if mode == "worker":
        eng = InferenceEngine(model, policy=policy, store=store,
                              worker_tick_ms=0.5, device=cuda)
        submit, rt = eng.submit, None
    else:
        rt = ServingRuntime(scheduler=mode, pool_size=2)
        eng = rt.add_model("dcnv2", model, policy=policy, store=store,
                           worker_tick_ms=0.5, device=cuda)

        def submit(row):
            return rt.submit("dcnv2", row)
    eng.warmup()
    ref = compile_plan(model, "dual", 40, device=cuda,
                       runtime_provider=model.store_runtime_env)
    want = {t: ref.predict(np.stack(r)) for t, r in rows.items()}
    torch.cuda.synchronize()
    reset_launch_counts()
    futs = {}

    def intake(t):
        futs[t] = [submit(r) for r in rows[t]]

    (rt or eng).start()
    threads = [threading.Thread(target=intake, args=(t,)) for t in rows]
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60.0)
            assert not th.is_alive()
        got = {t: np.array([f.result(timeout=60.0) for f in fs])
               for t, fs in futs.items()}
    finally:
        (rt or eng).stop()
    torch.cuda.synchronize()
    counts = launch_counts()
    for t in rows:
        np.testing.assert_allclose(got[t], want[t], rtol=1e-5, atol=1e-6)
    st = eng.stats
    assert st.n_requests == 160 and eng.pending() == 0
    assert counts["mtl_gather_two_level"] == st.n_batches, counts
    assert counts["fused_cross_v2"] == 3 * st.n_batches, counts
    if mode == "shared":
        assert rt.scheduler.n_dispatches == st.n_batches


@pytest.mark.parametrize("store", ["cached", "host"])
def test_refresh_and_push_under_running_worker_bitwise_dense(cuda, store):
    """A worker on the card serves while the engine refreshes every 2
    batches and takes a push between waves: every score is bitwise a
    DenseStore plan of the same bucket replaying the same deltas."""
    model, _, store_d, _ = _serving_models("dcnv2", cuda, store)
    dense = CTR_MODELS["dcnv2"](model.spec, device=cuda)
    dense.load_state_dict(model.state_dict())
    dplan = compile_plan(dense, "dual", 8, device=cuda)
    trainer = SyntheticTrainer(store_d.spec, rows_per_batch=64, n_batches=3,
                               seed=1)
    eng = InferenceEngine(model, policy=FixedBatch(8), store=store_d,
                          refresh_every=2, device=cuda)
    eng.warmup()
    eng.start()
    try:
        for wave in range(3):
            rows = sample_ids(SCHEMA, 32, seed=30 + wave, skew="zipf")
            got = np.array([f.result(timeout=60.0)
                            for f in eng.submit_many(list(rows))])
            want = np.concatenate([dplan.predict(rows[i:i + 8])
                                   for i in range(0, 32, 8)])
            np.testing.assert_array_equal(got, want, f"wave {wave}")
            ids, vals = trainer.next_batch()
            eng.push_update(ids, vals)
            dense.embedding.store.mega_table[
                torch.from_numpy(ids).to(cuda)] = torch.from_numpy(vals).to(
                    cuda)
    finally:
        eng.stop()
        _stop_host(store_d)
    assert eng.stats.emb_version == 3
    assert eng.stats.emb_cache_refreshes >= 4
    assert eng.stats.cache_misses == 1


@pytest.mark.parametrize("staging", [256, 16 * 39])
def test_host_store_staged_loop_through_the_engine(cuda, staging):
    """The engine's staged loop on the card (hint t+1, stage, predict,
    observe; S = 256 overflows and serves in chunks through the same
    plan): scores bitwise a dense plan of each bucket, one K5 launch per
    plan step."""
    model, _, store_d, _ = _serving_models("dcnv2", cuda, "host",
                                           staging=staging)
    dense = CTR_MODELS["dcnv2"](model.spec, device=cuda)
    dense.load_state_dict(model.state_dict())
    dplans = {b: compile_plan(dense, "dual", b, device=cuda)
              for b in (8, 16)}
    eng = InferenceEngine(model, policy=BucketedBatch((8, 16)),
                          store=store_d, refresh_every=3, device=cuda)
    try:
        eng.warmup()
        reset_launch_counts()
        rows = sample_ids(SCHEMA, 40, seed=40, skew="zipf")
        eng.submit_many(list(rows))
        got = eng.serve_pending()
        counts = launch_counts()
        want, i = [], 0
        for b in (16, 16, 8):            # the ladder's drain of 40 rows
            want.append(dplans[b].predict(rows[i:i + b]))
            i += b
        np.testing.assert_array_equal(got, np.concatenate(want))
        st = eng.stats
        assert (st.emb_staging_overflows > 0) == (staging == 256)
        steps = counts["mtl_gather_three_level"]
        assert steps >= st.n_batches == 3
        if staging != 256:
            assert steps == st.n_batches
        assert counts["fused_cross_v2"] == 3 * steps
    finally:
        _stop_host(store_d)


# ---------------------------------------------------------------------------
# training: the kernels' autograd Functions, a step against the CPU, resume
# ---------------------------------------------------------------------------

def _backward(fn, inputs, g):
    """fn(*leaves) and the leaves' gradients for the output gradient g."""
    leaves = [t.detach().clone().requires_grad_(t.is_floating_point())
              for t in inputs]
    out = fn(*leaves)
    out.backward(g)
    return out.detach(), [t.grad for t in leaves if t.is_floating_point()]


@pytest.mark.parametrize("d", [32, 1])
def test_gather_function_backward_on_cuda(cuda, d):
    """K1's Function: the table gradient against autograd through the
    plain version (``index_select``'s backward) on the card, ids repeated
    and out of range; bitwise equal across two calls; one forward launch
    a call."""
    from repro_torch.kernels import autograd as kad
    rng = np.random.default_rng(0)
    table = torch.from_numpy(rng.standard_normal((3000, d)).astype(
        np.float32)).to(cuda)
    offsets = torch.tensor([0, 1000, 2000], dtype=torch.int32, device=cuda)
    ids = torch.from_numpy(rng.integers(-3, 40, (1024, 3)).astype(
        np.int32)).to(cuda)
    g = torch.from_numpy(rng.standard_normal((1024, 3 * d)).astype(
        np.float32)).to(cuda)
    before = mtl_gather.launches
    out, (grad,) = _backward(lambda t: kad.mtl_gather(ids, offsets, t),
                             [table], g)
    assert mtl_gather.launches == before + 1
    want_out, (want,) = _backward(
        lambda t: mtl_gather_plain(ids, offsets, t), [table], g)
    assert torch.equal(out, want_out)
    torch.testing.assert_close(grad, want, rtol=1e-5, atol=1e-5)
    _, (again,) = _backward(lambda t: kad.mtl_gather(ids, offsets, t),
                            [table], g)
    assert torch.equal(grad, again)


@pytest.mark.parametrize("layer0", [True, False])
@pytest.mark.parametrize("kind", ["v2", "v1"])
def test_cross_function_backward_on_cuda(cuda, kind, layer0):
    """K9's and K10's Functions against autograd through their plain
    versions on the card; in layer 0 (``x`` is ``x0``) both gradients
    reach ``x0`` and the kernel takes its layer-0 form."""
    from repro_torch.kernels import autograd as kad
    rng = np.random.default_rng(1)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(cuda)
    b, dim = 1024, 1248
    if kind == "v2":
        args, fn, plain = [t(b, dim), t(b, dim)], kad.fused_cross_v2, \
            fused_cross_v2_plain
    else:
        args, fn, plain = [t(b, dim), t(b, 1), t(dim)], kad.fused_cross_v1, \
            fused_cross_v1_plain
    if not layer0:
        args.append(t(b, dim))

    def call(f):
        return (lambda *a: f(*a, a[0])) if layer0 else f
    g = t(b, dim)
    wrapper = fused_cross_v2 if kind == "v2" else fused_cross_v1
    before = wrapper.launches
    out, grads = _backward(call(fn), args, g)
    assert wrapper.launches == before + 1
    want_out, want = _backward(call(plain), args, g)
    assert torch.equal(out, want_out)
    for got, exp in zip(grads, want):
        torch.testing.assert_close(got, exp, rtol=1e-5, atol=1e-5)


def test_fm_function_backward_on_cuda(cuda):
    from repro_torch.kernels import autograd as kad
    rng = np.random.default_rng(2)
    v = _fm_input(rng, (1024, 39, 32), 0, cuda)
    g = torch.from_numpy(rng.standard_normal((1024, 1)).astype(
        np.float32)).to(cuda)
    out, (grad,) = _backward(kad.fused_fm_second_order, [v], g)
    want_out, (want,) = _backward(fused_fm_second_order_plain, [v], g)
    torch.testing.assert_close(out, want_out, **TOL)
    torch.testing.assert_close(grad, want, **TOL)


def _train_pair(model_name, cuda):
    spec = ctr_spec(model_name, "criteo", **SPEC_KW)
    cpu_model = CTR_MODELS[model_name](spec, device="cpu").init(
        torch.Generator().manual_seed(0))
    model = CTR_MODELS[model_name](spec, device=cuda)
    model.load_state_dict(cpu_model.state_dict())
    return cpu_model, model


@pytest.mark.parametrize("model_name", list(CTR_MODELS))
def test_loss_gradients_on_cuda_match_the_cpu(cuda, model_name):
    """One backward through the card's kernels (their Functions) against
    the CPU's plain versions on the same weights and batch: every leaf gets
    a gradient, within the card-vs-CPU tolerance, the tables' nonzero."""
    from repro_torch.data import synthetic_batch
    cpu_model, model = _train_pair(model_name, cuda)
    batch = synthetic_batch(CRITEO.scaled(2_000), 0, 256, device="cpu")
    grads = {}
    for dev, m in (("cpu", cpu_model), ("cuda", model)):
        tree = m.param_tree()
        reset_launch_counts()
        m.loss({k: v.to(m.device) for k, v in batch.items()}).backward()
        counts = launch_counts()
        grads[dev] = {name: t.grad for name, t in _named_leaves(tree)}
    assert counts["mtl_gather"] == (1 if model_name.startswith("dcn")
                                    else 2)
    assert counts["fused_cross_v2"] == (3 if model_name == "dcnv2" else 0)
    assert counts["fused_cross_v1"] == (3 if model_name == "dcn" else 0)
    assert counts["fused_fm_second_order"] == int(model_name == "deepfm")
    for name, want in grads["cpu"].items():
        got = grads["cuda"][name]
        assert got is not None and want is not None, name
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-5,
                                   msg=lambda m: f"{name}: {m}")
    assert grads["cuda"]["emb/mega_table"].abs().sum() > 0


def _named_leaves(tree):
    from repro_torch.training.optimizer import tree_flatten
    return [("/".join(map(str, p)), t) for p, t in tree_flatten(tree)]


def test_plans_on_cuda_record_no_autograd_graph(cuda):
    _, model = _train_pair("dcnv2", cuda)
    model.param_tree()
    ids = torch.from_numpy(sample_ids(CRITEO.scaled(2_000), 64)).to(cuda)
    out = compile_plan(model, "dual", 64, device=cuda)(ids)
    assert not out.requires_grad and out.grad_fn is None
    assert model(ids).grad_fn is not None


def test_resumed_training_on_cuda_is_bitwise_unbroken(cuda, tmp_path):
    from repro_torch.data import CTRLoader
    from repro_torch.training import (AdamWConfig, TrainLoopConfig,
                                      adamw_init, make_ctr_step,
                                      run_train_loop)
    from repro_torch.training.optimizer import tree_flatten
    opt = AdamWConfig(lr=1e-3)

    def run(total, ckpt):
        _, model = _train_pair("dcnv2", cuda)
        cfg = TrainLoopConfig(total_steps=total, ckpt_every=3,
                              ckpt_dir=str(tmp_path / ckpt), log_every=100)
        state, _ = run_train_loop(
            make_ctr_step(model, opt), adamw_init(model.param_tree(), opt),
            CTRLoader(CRITEO.scaled(2_000), 256, device=cuda), cfg)
        return state

    whole = run(6, "a")
    run(3, "b")
    resumed = run(6, "b")
    for (key, a), (_, b) in zip(tree_flatten(whole), tree_flatten(resumed)):
        assert torch.equal(a, b), key


# ---------------------------------------------------------------------------
# multi-device: mesh positions on one card, and launches on a second card
# ---------------------------------------------------------------------------

MESH_KW = dict(embed_dim=8, hidden=64, max_field=2_001)   # 27,728 rows


def _card_mesh(cuda, shape):
    """``shape`` positions, every one on the card (logical positions)."""
    from repro_torch.distributed import make_mesh
    n = int(np.prod(shape))
    return make_mesh(shape, ("data", "model"),
                     [torch.device("cuda", torch.cuda.current_device())] * n)


@pytest.mark.parametrize("kernel", ["multihot", "two_level", "two_level_q8"])
@pytest.mark.parametrize("h", [1, 5])
def test_tiered_row_shards_on_the_card(cuda, kernel, h):
    """K2-K4 with a row shard: bitwise their plain versions given the same
    shard, and the shards of a split sum to the whole lookup (exactly at
    h = 1, within TOL pooled)."""
    t = (_f32_tier_inputs if kernel != "two_level_q8" else _q8_tier_inputs)(
        np.random.default_rng(11), 64, h, 32, 0, cuda)
    n = t["slot_of_row"].numel()
    ids, mask, offsets = t["ids"], t["mask"], t["offsets"]
    if h == 1:
        ids, mask = ids[..., 0].contiguous(), None

    def run(fn_kernel, fn_plain, lo, hi, shard):
        r = slice(lo, hi)
        out = []
        for fn in (fn_kernel, fn_plain):
            if kernel == "multihot":
                out.append(fn(ids, mask, offsets, t["mega"][r].contiguous(),
                              shard=shard))
            elif kernel == "two_level":
                out.append(fn(ids, offsets, t["slot_of_row"][r],
                              t["cache"].contiguous(), t["mega"][r], mask,
                              shard=shard))
            else:
                out.append(fn(ids, offsets, t["slot_of_row"][r],
                              t["qcache"].contiguous(), t["qscale"],
                              t["q"][r].contiguous(), t["scale"][r], mask,
                              shard=shard))
        return out
    fns = {"multihot": (mtl_gather_multihot, mtl_gather_multihot_plain),
           "two_level": (mtl_gather_two_level, mtl_gather_two_level_plain),
           "two_level_q8": (mtl_gather_two_level_q8,
                            mtl_gather_two_level_q8_plain)}[kernel]
    whole, _ = run(*fns, 0, n, None)
    for cuts in ((0, n // 2, n), (0, 1, n // 3, n - 1, n)):
        total = None
        for lo, hi in zip(cuts, cuts[1:]):
            got, want = run(*fns, lo, hi, (lo, n))
            assert _same_bits(got, want), (lo, hi)
            total = got if total is None else total + got
        finite = torch.isfinite(whole)
        if h == 1:
            assert torch.equal(total[finite], whole[finite])
        torch.testing.assert_close(total[finite], whole[finite], **TOL)


def _mesh_model(name, store, device):
    spec = ctr_spec(name, "criteo", **MESH_KW)
    model = CTR_MODELS[name](spec, device=device).init(
        torch.Generator(device=device).manual_seed(0))
    if store == "cached":
        model.use_store(CachedStore(spec.embedding_spec(), 256,
                                    device=device))
    elif store == "cached_int8":
        model.use_store(CachedStore(spec.embedding_spec(), 256, "int8",
                                    device=device))
    return model


@pytest.mark.parametrize("name,store,compute_dtype", [
    ("dcnv2", "dense", "fp32"), ("dcnv2", "cached", "fp32"),
    ("dcnv2", "cached_int8", "fp32"), ("dcnv2", "dense", "int8"),
    ("dcn", "dense", "fp32"), ("deepfm", "dense", "fp32"),
    ("widedeep", "cached", "int8")])
def test_mesh_plans_on_logical_positions(cuda, name, store, compute_dtype):
    """Four positions on the card: the (1, 4) plan is bitwise the
    mesh-less plan, (2, 2) and (4, 1) within the level ladder's
    tolerance; each step launches one gather a model shard a batch shard
    a table, and the dense kernels once a batch shard."""
    model = _mesh_model(name, store, cuda)
    ids = sample_ids(CRITEO.scaled(2_001), 64, seed=5)
    base = compile_plan(model, "dual", 64, device=cuda,
                        compute_dtype=compute_dtype,
                        runtime_provider=model.store_runtime_env)
    want = base.predict(ids)
    gather = {"dense": "mtl_gather", "cached": "mtl_gather_two_level",
              "cached_int8": "mtl_gather_two_level_q8"}[store]
    tables = 2 if name in ("deepfm", "widedeep") else 1
    for shape in ((1, 4), (2, 2), (4, 1)):
        plan = compile_plan(model, "dual", 64, mesh=_card_mesh(cuda, shape),
                            compute_dtype=compute_dtype,
                            runtime_provider=model.store_runtime_env)
        reset_launch_counts()
        got = plan.predict(ids)
        counts = launch_counts()
        if shape[0] == 1:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        shards = shape[0] * shape[1]
        if tables == 2:                   # the d = 1 table: a dense store
            assert counts["mtl_gather"] == shards * (
                1 if store == "dense" else 0) + shards, counts
            assert counts[gather] >= shards
        else:
            assert counts[gather] == shards, counts
        if name == "dcnv2":
            assert counts["fused_cross_v2"] == 3 * shape[0]
        if compute_dtype == "int8":
            assert counts["dmm_q8"] == 3 * shape[0]


def test_mesh_engine_refresh_and_deltas_on_the_card(cuda):
    """A cached engine over four positions on the card: a refresh is
    bitwise across the swap, a push matches a mesh-less engine given the
    same push, no recompile, the publish placed as the plans record."""
    ids = sample_ids(CRITEO.scaled(2_001), 48, seed=6, skew="zipf")
    engs = []
    for mesh in (_card_mesh(cuda, (2, 2)), None):
        model = _mesh_model("dcnv2", "cached", cuda)
        engs.append(InferenceEngine(model, mesh=mesh, device=cuda,
                                    policy=BucketedBatch((16,))))
    eng, ref = engs
    eng.warmup()
    compiles = eng.stats.cache_misses
    pre = eng.predict(ids)
    eng.refresh_cache()
    np.testing.assert_array_equal(eng.predict(ids), pre)
    rng = np.random.default_rng(8)
    rows = rng.choice(27_727, 500, replace=False)
    vals = rng.normal(size=(500, 8)).astype(np.float32)
    for e in engs:
        e.predict(ids)
        e.push_update(rows, vals)
    np.testing.assert_allclose(eng.predict(ids), ref.predict(ids),
                               rtol=1e-5, atol=1e-6)
    assert eng.stats.cache_misses == compiles
    plan = eng.plan_for(16)
    for edge, placed in eng.published.items():
        assert placed.sharding.is_equivalent_to(
            plan.runtime_shardings[edge], placed.ndim), edge
    backing = eng.published["emb:backing"]
    assert backing.local((0, 1)).shape[0] == 27_728 // 2
    assert backing.local((0, 1)).device == torch.device("cuda", 0)


def test_host_store_mesh_plan_on_the_card(cuda):
    """A host store on four positions of the card: the staged (2, 2) plan
    within tolerance of the mesh-less plan, one K5 a batch shard."""
    model = _mesh_model("dcnv2", "dense", cuda)
    store = HostBackedStore(model.spec.embedding_spec(), 256, 8192,
                            device=cuda)
    model.use_store(store)
    try:
        ids = sample_ids(CRITEO.scaled(2_001), 64, seed=7)
        store.stage(ids)
        want = compile_plan(model, "dual", 64, device=cuda,
                            runtime_provider=model.store_runtime_env
                            ).predict(ids)
        plan = compile_plan(model, "dual", 64, mesh=_card_mesh(cuda, (2, 2)),
                            runtime_provider=model.store_runtime_env)
        reset_launch_counts()
        np.testing.assert_allclose(plan.predict(ids), want, rtol=1e-5,
                                   atol=1e-6)
        assert launch_counts()["mtl_gather_three_level"] == 2
    finally:
        store.pipeline.stop()


def test_compressed_step_on_the_card(cuda):
    from repro_torch.training import make_compressed_dp_step
    g = torch.Generator(device=cuda).manual_seed(0)
    params = {"w": torch.randn(1248, 64, device=cuda, generator=g)}
    batch = {"x": torch.randn(64, 1248, device=cuda, generator=g),
             "y": torch.randn(64, 64, device=cuda, generator=g)}

    def loss_fn(p, b):
        return torch.mean((b["x"] @ p["w"] - b["y"]) ** 2)
    loss, grads = make_compressed_dp_step(
        loss_fn, _card_mesh(cuda, (4, 2)))(params, batch)
    w = params["w"].clone().requires_grad_(True)
    exact = loss_fn({"w": w}, batch)
    grad, = torch.autograd.grad(exact, w)
    exact = float(exact.detach())
    assert abs(float(loss) - exact) < 1e-5 * exact
    assert float((grads["w"] - grad).abs().max() / grad.abs().max()) < 0.02


@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards: a kernel launched on cuda:1 "
                    "tensors while cuda:0 is current")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0), torch.device("cuda", 1)


def test_every_kernel_launches_on_its_tensors_card(two_cards):
    """With cuda:0 current, each wrapper given cuda:1 tensors launches on
    cuda:1 (in ``torch.cuda.device(t.device)``) and matches its plain
    version there."""
    first, second = two_cards
    t = _f32_tier_inputs(np.random.default_rng(12), 32, 1, 32, 0, second)
    q = _q8_tier_inputs(np.random.default_rng(13), 32, 1, 32, 0, second)
    ids, offsets = t["ids"][..., 0].contiguous(), t["offsets"]
    x0, xw = (torch.randn(16, 64, device=second) for _ in range(2))
    bias = torch.randn(64, device=second)
    v = torch.randn(16, 7, 8, device=second)
    h = torch.randn(16, 64, device=second)
    qw, ws = quantize_channels(torch.randn(64, 32, device=second))
    stacked = torch.randn(7, 16, 32, device=second)
    small = torch.randint(0, 16, (32, 7), dtype=torch.int32, device=second)
    cache = t["cache"].contiguous()
    cases = [
        (mtl_gather, mtl_gather_plain, (ids, offsets, t["mega"])),
        (mtl_gather_multihot, mtl_gather_multihot_plain,
         (t["ids"], t["mask"], offsets, t["mega"])),
        (mtl_gather_two_level, mtl_gather_two_level_plain,
         (ids, offsets, t["slot_of_row"], cache, t["mega"])),
        (mtl_gather_two_level_q8, mtl_gather_two_level_q8_plain,
         (ids, offsets, q["slot_of_row"], q["qcache"].contiguous(),
          q["qscale"], q["q"].contiguous(), q["scale"])),
        (mtl_gather_three_level, mtl_gather_three_level_plain,
         (ids, offsets, t["slot_of_row"], t["smap"], cache,
          t["staging"].contiguous())),
        (mtl_gather_three_level_q8, mtl_gather_three_level_q8_plain,
         (ids, offsets, q["slot_of_row"], q["smap"],
          q["qcache"].contiguous(), q["qscale"],
          q["qstaging"].contiguous(), q["qsscale"])),
        (mtl_input_first, mtl_input_first_plain, (ids, offsets, t["mega"])),
        (mtl_onehot, mtl_onehot_plain, (small, stacked)),
        (fused_cross_v2, fused_cross_v2_plain, (x0, xw, h)),
        (fused_cross_v1, fused_cross_v1_plain,
         (x0, xw[:, :1].contiguous(), bias, h)),
        (fused_fm_second_order, fused_fm_second_order_plain, (v,)),
        (quantize_rows_q8, quantize_rows_q8_plain, (h,)),
    ]
    with torch.cuda.device(first):
        for fn, plain, args in cases:
            got, want = fn(*args), plain(*args)
            for g_, w_ in zip(*(o if isinstance(o, tuple) else (o,)
                                for o in (got, want))):
                assert g_.device == second, fn.__name__
                torch.testing.assert_close(g_, w_, rtol=1e-5, atol=1e-5,
                                           equal_nan=True,
                                           msg=fn.__name__)
        hq, hs = quantize_rows_q8_plain(h)
        wp, b32 = pack_weight(qw), bias[:32].reshape(1, 32)
        got = dmm_q8(hq, hs, wp, ws, b32)
        assert got.device == second
        torch.testing.assert_close(got, dmm_q8_plain(hq, hs, wp, ws, b32))
        assert torch.cuda.current_device() == 0
    torch.cuda.synchronize(second)


# ---------------------------------------------------------------------------
# the LM zoo's serving path (no hand kernel: plain tensor ops and cuBLAS)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["llama3-8b", "phi3.5-moe-42b-a6.6b",
                                  "rwkv6-7b", "zamba2-1.2b",
                                  "whisper-small", "pixtral-12b"])
def test_reduced_lm_on_the_card_matches_the_cpu(cuda, arch):
    """A reduced fp32 model of each family with the same weights on the
    card and on the CPU: forward, prefill (logits and cache) and three
    decode steps fed the CPU's greedy tokens, at ``rtol=1e-4,
    atol=1e-5``; then ``generate`` greedy token for token."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import make_lm_model
    from repro_torch.serving import generate

    cfg = get_config(arch).reduced()
    host = make_lm_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    card = make_lm_model(cfg, device=cuda)
    card.load_state_dict(host.state_dict())
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 12)))
    extra = {}
    if cfg.family == "encdec":
        extra["frames"] = torch.from_numpy(
            rng.normal(size=(2, 10, cfg.d_model)).astype(np.float32) * 0.1)
    if cfg.family == "vlm":
        extra["patch_embeds"] = torch.from_numpy(
            rng.normal(size=(2, 4, cfg.d_model)).astype(np.float32) * 0.02)
    moved = {k: v.to(cuda) for k, v in extra.items()}
    tol = dict(rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(card(tokens.to(cuda), *moved.values()).cpu(),
                               host(tokens, *extra.values()), **tol)

    def prefill(m, t, kw):
        if cfg.family == "encdec":
            return m.prefill(t, kw["frames"], m.init_cache(2, 16, 10))
        if cfg.family == "vlm":
            return m.prefill(t, m.init_cache(2, 20), **kw)
        return m.prefill(t, m.init_cache(2, 16))

    def same_cache(a, b):
        for key, val in b.items():
            if isinstance(val, dict):
                same_cache(a[key], val)
            elif key == "index":
                assert a[key] == val
            else:
                torch.testing.assert_close(a[key].cpu(), val, **tol)

    lh, ch = prefill(host, tokens, extra)
    lc, cc = prefill(card, tokens.to(cuda), moved)
    torch.testing.assert_close(lc.cpu(), lh, **tol)
    same_cache(cc, ch)
    for _ in range(3):
        nxt = lh.argmax(-1)[:, None]
        lh, ch = host.decode_step(nxt, ch)
        lc, cc = card.decode_step(nxt.to(cuda), cc)
        torch.testing.assert_close(lc.cpu(), lh, **tol)
    same_cache(cc, ch)
    torch.testing.assert_close(
        generate(card, tokens.to(cuda), max_new=4, **moved).cpu(),
        generate(host, tokens, max_new=4, **extra), rtol=0, atol=0)


def test_lm_flash_attention_on_the_card_matches_sdpa(cuda):
    from repro_torch.models.lm import layers as L

    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((2, 512, 8, 64), generator=g, device=cuda)
    k, v = (torch.randn((2, 512, 2, 64), generator=g, device=cuda)
            for _ in range(2))
    for causal in (True, False):
        got = L.flash_attention(q, k, v, causal=causal, q_chunk=128,
                                k_chunk=64)
        torch.testing.assert_close(got, L._sdpa(q, k, v, causal=causal),
                                   rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(got.cpu(), L.flash_attention(
            q.cpu(), k.cpu(), v.cpu(), causal=causal, q_chunk=128,
            k_chunk=64), rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# LM training (no hand kernel: autograd through plain tensor ops and cuBLAS)
# ---------------------------------------------------------------------------

def _lm_grads(model, batch):
    """(loss, {path: gradient}) of ``model.loss(batch)``."""
    from repro_torch.bridge import _leaves

    tree = model.param_tree()
    loss = model.loss(batch)
    loss.backward()
    grads = {path: t.grad.detach().clone() for path, t in _leaves(tree)}
    for _, t in _leaves(tree):
        t.grad = None
    return loss.detach(), grads


def _lm_pair(cuda, arch, **overrides):
    from repro_torch.configs import get_config
    from repro_torch.launch.train import lm_batch_fn
    from repro_torch.models.lm import make_lm_model

    cfg = get_config(arch).reduced(**overrides)
    host = make_lm_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    card = make_lm_model(cfg, device=cuda)
    card.load_state_dict(host.state_dict())
    batch = lm_batch_fn(cfg, 2, 16, "cpu")(0)
    return host, card, batch, {k: v.to(cuda) for k, v in batch.items()}


@pytest.mark.parametrize("arch", ["llama3-8b", "granite-8b", "smollm-360m",
                                  "qwen3-4b", "pixtral-12b",
                                  "phi3.5-moe-42b-a6.6b",
                                  "llama4-maverick-400b-a17b", "rwkv6-7b",
                                  "zamba2-1.2b", "whisper-small"])
def test_reduced_lm_loss_and_gradients_on_the_card_match_the_cpu(cuda,
                                                                 arch):
    """A reduced fp32 model of each arch with the same weights and batch
    on the card and on the CPU: the loss and every gradient leaf at
    ``rtol=1e-4, atol=1e-5``, with and without remat."""
    for remat in (False, True):
        host, card, batch, moved = _lm_pair(cuda, arch, remat=remat)
        lh, gh = _lm_grads(host, batch)
        lc, gc = _lm_grads(card, moved)
        torch.testing.assert_close(lc.cpu(), lh, rtol=1e-4, atol=1e-5)
        assert gh.keys() == gc.keys()
        for path, g in gh.items():
            torch.testing.assert_close(gc[path].cpu(), g, rtol=1e-4,
                                       atol=1e-5, msg=str(path))


@pytest.mark.parametrize("arch,tied", [("smollm-360m", True),
                                       ("phi3.5-moe-42b-a6.6b", False)])
def test_lm_gradients_on_the_card_are_bitwise_repeatable(cuda, arch, tied):
    """Two backward passes of the same loss on the card: every gradient
    bitwise (the embedding's, gathered rows summed by id, and a tied
    head's included), so a resumed run is bitwise an unbroken one."""
    _, card, _, moved = _lm_pair(cuda, arch, tie_embeddings=tied)
    l1, g1 = _lm_grads(card, moved)
    l2, g2 = _lm_grads(card, moved)
    assert torch.equal(l1, l2)
    for path, g in g1.items():
        assert torch.equal(g, g2[path]), path


# ---------------------------------------------------------------------------
# the LM mesh: the sequence-parallel flash decode on the card
# ---------------------------------------------------------------------------

def _flash_case(devices, b_ax, idx, update, seed=0):
    """``flash_decode_sharded`` over a (2, 2) mesh of ``devices`` (the
    inputs made on the CPU from ``seed``, moved to the first device):
    (out, k cache, v cache), all on the CPU."""
    from repro_torch.distributed import make_mesh
    from repro_torch.models.lm import layers as L

    g = torch.Generator().manual_seed(seed)
    q = torch.randn((4, 1, 8, 16), generator=g)
    kc, vc = (torch.randn((4, 64, 2, 16), generator=g) for _ in range(2))
    kn, vn = (torch.randn((4, 1, 2, 16), generator=g) for _ in range(2))
    mesh = make_mesh((2, 2), ("data", "model"), devices)
    dev = mesh.first_device
    q, kc, vc, kn, vn = (t.to(dev) for t in (q, kc, vc, kn, vn))
    ctx = L.DecodeShardCtx(mesh=mesh, batch_axes=b_ax)
    out, k2, v2 = L.flash_decode_sharded(
        q, kc, vc, kn if update else None, vn if update else None, idx, ctx)
    assert out.device == dev
    return out.cpu(), k2.full("cpu"), v2.full("cpu")


@pytest.mark.parametrize("b_ax", ["data", None])
@pytest.mark.parametrize("idx", [5, 32, 63])
def test_flash_decode_sharded_on_logical_positions_matches_the_cpu(
        cuda, b_ax, idx):
    """Four positions on one card against four on the CPU, the write in
    the first shard, at the boundary and in the last slot: outputs at
    ``rtol 1e-4, atol 1e-5``, the caches bitwise; and with no write."""
    card = [torch.device("cuda", torch.cuda.current_device())] * 4
    for update in (True, False):
        got = _flash_case(card, b_ax, idx, update)
        want = _flash_case("cpu", b_ax, idx, update)
        torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=1e-5)
        assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])


@pytest.mark.parametrize("arch", ["llama3-8b", "zamba2-1.2b",
                                  "whisper-small"])
def test_reduced_sharded_decode_on_the_card_keeps_the_greedy_tokens(cuda,
                                                                    arch):
    """A reduced fp32 decode cell on four positions of the card, 8 steps
    across its sequence shards' boundary: the greedy tokens of the
    mesh-less decode on the same cache, logits at ``rtol 2e-4, atol
    2e-4`` (tests/distributed_inner.py:75)."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import tree_map
    from repro_torch.models.lm import layers as L
    from repro_torch.models.lm import make_lm_model

    cfg = get_config(arch).reduced()
    model = make_lm_model(cfg, device=cuda).init(
        torch.Generator(device=cuda).manual_seed(0))
    g = torch.Generator(device=cuda).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (4, 12), generator=g, device=cuda)
    if cfg.family == "encdec":
        frames = torch.randn((4, 8, cfg.d_model), generator=g,
                             device=cuda) * 0.1
        logits, cache = model.prefill(tokens, frames,
                                      model.init_cache(4, 32, 8))
    else:
        logits, cache = model.prefill(tokens, model.init_cache(4, 32))
    twin = tree_map(lambda t: t.clone() if torch.is_tensor(t) else t, cache)
    ctx = L.DecodeShardCtx(mesh=_card_mesh(cuda, (2, 2)), batch_axes="data")
    for _ in range(8):
        nxt = logits.argmax(-1)[:, None]
        model.decode_ctx = None
        logits, cache = model.decode_step(nxt, cache)
        model.decode_ctx = ctx
        got, twin = model.decode_step(nxt, twin)
        torch.testing.assert_close(got, logits, rtol=2e-4, atol=2e-4)
        assert torch.equal(got.argmax(-1), logits.argmax(-1))


def test_flash_decode_sharded_across_two_cards(two_cards):
    """The four positions over two cards (data shard 0 on the first,
    1 on the second): the same outputs as the CPU, caches bitwise."""
    first, second = two_cards
    devices = [first, first, second, second]
    for idx in (5, 40):
        got = _flash_case(devices, "data", idx, True)
        want = _flash_case("cpu", "data", idx, True)
        torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=1e-5)
        assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])


def _lm_inputs(cfg, b: int, s: int, g) -> dict:
    """A prompt of ``s`` rows a sequence (pixtral: 2 of them patches),
    with whisper's 8 frames, on the CPU."""
    n_img = 2 if cfg.family == "vlm" else 0
    out = {"tokens": torch.randint(0, cfg.vocab, (b, s - n_img),
                                   generator=g)}
    if cfg.family == "encdec":
        out["frames"] = 0.1 * torch.randn(b, 8, cfg.d_model, generator=g)
    if cfg.family == "vlm":
        out["patch_embeds"] = 0.02 * torch.randn(b, n_img, cfg.d_model,
                                                 generator=g)
    return out


def _lm_prefill(model, inputs: dict, s_max: int):
    """``model``'s prefill of ``inputs`` into a fresh ``s_max``-slot
    cache, each family's call."""
    b = inputs["tokens"].shape[0]
    if model.cfg.family == "encdec":
        return model.prefill(inputs["tokens"], inputs["frames"],
                             model.init_cache(b, s_max,
                                              inputs["frames"].shape[1]))
    if model.cfg.family == "vlm":
        return model.prefill(inputs["tokens"], model.init_cache(b, s_max),
                             patch_embeds=inputs["patch_embeds"])
    return model.prefill(inputs["tokens"], model.init_cache(b, s_max))


def _split_case(devices, arch: str):
    """A reduced fp32 arch's prefill and decode cells on a (2, 2) mesh of
    ``devices``, parameters placed (``Cell.place_params``), weights drawn
    on the CPU from one seed: the prefill's logits, then 6 greedy decode
    steps' logits from a prefill of 6 rows into 16 slots, on the CPU
    (whisper with 8 random frames, pixtral with 2 of the rows random
    patches)."""
    import importlib

    import repro_torch.configs as C
    from repro_torch.distributed import make_mesh
    from repro_torch.launch.steps import build_cell
    from repro_torch.models.lm import make_lm_model

    mod = importlib.import_module(f"repro_torch.configs.{C._ARCH_MODULES[arch]}")
    saved, shapes = mod.CONFIG, dict(C.SHAPES)
    mod.CONFIG = saved.reduced()
    C.SHAPES["prefill_32k"] = C.ShapeCell("prefill_32k", 6, 4, "prefill")
    C.SHAPES["decode_32k"] = C.ShapeCell("decode_32k", 16, 4, "decode")
    try:
        mesh = make_mesh((2, 2), ("data", "model"), devices)
        pre = build_cell(arch, "prefill_32k", mesh)
        dec = build_cell(arch, "decode_32k", mesh)
    finally:
        mod.CONFIG = saved
        C.SHAPES.clear()
        C.SHAPES.update(shapes)
    state = make_lm_model(pre.cfg, device="cpu").init(
        torch.Generator().manual_seed(0)).state_dict()
    for cell in (pre, dec):
        cell.model.load_state_dict(state)
        cell.place_params()
    first = mesh.first_device
    inputs = {k: v.to(first) for k, v in _lm_inputs(
        pre.cfg, 4, 6, torch.Generator().manual_seed(1)).items()}
    out = [pre.prefill_fn()(inputs)[0].cpu()]
    logits, cache = _lm_prefill(dec.model, inputs, 16)
    step = dec.decode_fn()
    for _ in range(6):
        nxt = logits.argmax(-1)[:, None]
        logits, cache = step({"tokens": nxt, "cache": cache})
        assert logits.device == first
        out.append(logits.cpu())
    return out


@pytest.mark.parametrize("arch", ["llama3-8b", "phi3.5-moe-42b-a6.6b",
                                  "rwkv6-7b", "zamba2-1.2b"])
def test_split_cells_on_logical_positions_match_the_cpu(cuda, arch):
    """Reduced dense, MoE and recurrent cells with their weights (and
    rwkv6's and zamba2's state caches) split over four positions of the
    card against the same on a CPU mesh: prefill and decode logits at
    ``rtol 1e-4, atol 1e-5``, greedy tokens equal."""
    card = [torch.device("cuda", torch.cuda.current_device())] * 4
    for got, want in zip(_split_case(card, arch), _split_case("cpu", arch)):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
        assert torch.equal(got.argmax(-1), want.argmax(-1))


#: rwkv6 with 4 heads of 16: its reduced single head is ill-conditioned
#: in fp32 (tests/test_torch_lm_tp_train_recurrent.py)
SPLIT_TRAIN_OVERRIDES = {"rwkv6-7b": {"ssm_head_dim": 16}}


def _split_train_case(devices, arch: str):
    """A reduced fp32 train cell (remat on, two microbatches, AdamW eps
    1e-3; ``SPLIT_TRAIN_OVERRIDES``) on a (2, 2) mesh of ``devices``,
    parameters placed
    (``Cell.place_params``), weights and a batch of 8 rows of 8 drawn on
    the CPU from one seed: the loss, every gradient leaf (assembled), the
    gradient norm, then params, m and v after the update, on the CPU;
    the positions holding one slice of the state hold equal tensors."""
    import dataclasses
    import importlib

    import repro_torch.configs as C
    from repro_torch.bridge import _leaves
    from repro_torch.distributed import make_mesh
    from repro_torch.launch.steps import build_cell
    from repro_torch.models.lm import make_lm_model
    from repro_torch.training import adamw_update
    from repro_torch.training.train_loop import loss_and_grads

    mod = importlib.import_module(f"repro_torch.configs.{C._ARCH_MODULES[arch]}")
    saved, shapes = mod.CONFIG, dict(C.SHAPES)
    mod.CONFIG = saved.reduced(remat=True,
                               **SPLIT_TRAIN_OVERRIDES.get(arch, {}))
    C.SHAPES["train_4k"] = C.ShapeCell("train_4k", 8, 8, "train")
    try:
        cell = build_cell(arch, "train_4k",
                          make_mesh((2, 2), ("data", "model"), devices))
    finally:
        mod.CONFIG = saved
        C.SHAPES.clear()
        C.SHAPES.update(shapes)
    cell.model.load_state_dict(make_lm_model(cell.cfg, device="cpu").init(
        torch.Generator().manual_seed(0)).state_dict())
    cell.n_micro = 2
    cell.opt_cfg = dataclasses.replace(cell.opt_cfg, eps=1e-3)
    cell.place_params()
    g = torch.Generator().manual_seed(1)
    first = cell.mesh.first_device
    batch = {k: v.to(first) for k, v in _lm_inputs(cell.cfg, 8, 8,
                                                   g).items()}
    state = cell.train_state()
    loss, grads = loss_and_grads(cell.model, state.params, batch, 2)
    out = [loss.cpu()] + [t.full().cpu() for _, t in _leaves(grads)]
    state, metrics = adamw_update(state, grads, cell.opt_cfg)
    out.append(metrics["grad_norm"].cpu())
    for part in (state.params, state.m, state.v):
        for _, t in _leaves(part):
            out.append(t.full().cpu())
            # the holders of a slice (on another card too) hold it bitwise
            for holders in t.holders().values():
                first = t.local(holders[0]).cpu()
                assert all(torch.equal(t.local(q).cpu(), first)
                           for q in holders[1:])
    return out


@pytest.mark.parametrize("arch", ["llama3-8b", "smollm-360m",
                                  "phi3.5-moe-42b-a6.6b", "whisper-small",
                                  "rwkv6-7b", "zamba2-1.2b"])
def test_split_train_step_on_logical_positions_matches_the_cpu(cuda, arch):
    """A reduced train cell's split step (TP × FSDP: llama3, phi3.5-moe,
    rwkv6, zamba2; pure FSDP: smollm-360m, whisper-small) over four
    positions of the card against the same on a CPU mesh: the loss, every
    gradient, the norm and the updated state at ``rtol 1e-4, atol
    1e-5``."""
    card = [torch.device("cuda", torch.cuda.current_device())] * 4
    got, want = _split_train_case(card, arch), _split_train_case("cpu", arch)
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5, msg=str(i))


@pytest.fixture
def four_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards: one mesh position a card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return [torch.device("cuda", i) for i in range(4)]


LM_ARCHS = ("llama3-8b", "granite-8b", "smollm-360m", "qwen3-4b",
            "pixtral-12b", "phi3.5-moe-42b-a6.6b",
            "llama4-maverick-400b-a17b", "whisper-small", "rwkv6-7b",
            "zamba2-1.2b")


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_split_cells_one_card_a_position_match_the_cpu(four_cards, arch):
    """The ten archs' reduced prefill and decode cells on the (2, 2) mesh
    with position (d, m) on cuda:(2d + m): the same logits as the CPU at
    ``rtol 1e-4, atol 1e-5``, greedy tokens equal."""
    for got, want in zip(_split_case(four_cards, arch),
                         _split_case("cpu", arch), strict=True):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
        assert torch.equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_split_train_step_one_card_a_position_matches_the_cpu(four_cards,
                                                              arch):
    """The ten archs' reduced train cells' split step on the (2, 2) mesh
    with one card a position (gradients reduced across four cards): the
    loss, every gradient, the norm and the updated state as the CPU's at
    ``rtol 1e-4, atol 1e-5``."""
    for got, want in zip(_split_train_case(four_cards, arch),
                         _split_train_case("cpu", arch), strict=True):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def _meta_llama4_case(devices):
    """A reduced llama4-maverick decode cell built on ``meta`` and placed
    from one seed over a (2, 2) mesh of ``devices`` (each position's
    pieces drawn on its device): every position's pieces, then the logits
    of a prefill of 6 rows into 16 slots and of 6 greedy decode steps, on
    the CPU."""
    import importlib

    import numpy as np

    import repro_torch.configs as C
    from repro_torch.bridge import _leaves
    from repro_torch.distributed import make_mesh
    from repro_torch.launch.steps import Cell

    arch = "llama4-maverick-400b-a17b"
    mod = importlib.import_module(f"repro_torch.configs.{C._ARCH_MODULES[arch]}")
    saved, shapes = mod.CONFIG, dict(C.SHAPES)
    mod.CONFIG = saved.reduced()
    C.SHAPES["decode_32k"] = C.ShapeCell("decode_32k", 16, 4, "decode")
    try:
        mesh = make_mesh((2, 2), ("data", "model"), devices)
        cell = Cell(arch, "decode_32k", mesh, device="meta")
    finally:
        mod.CONFIG = saved
        C.SHAPES.clear()
        C.SHAPES.update(shapes)
    tp = cell.place_params(seed=7)
    pieces = [pl.local(pos).cpu() for _, pl in _leaves(tp.tree)
              for pos in np.ndindex(mesh.devices.shape)]
    inputs = {k: v.to(mesh.first_device) for k, v in _lm_inputs(
        cell.cfg, 4, 6, torch.Generator().manual_seed(1)).items()}
    logits, cache = _lm_prefill(cell.model, inputs, 16)
    out, step = [logits.cpu()], cell.decode_fn()
    for _ in range(6):
        logits, cache = step({"tokens": logits.argmax(-1)[:, None],
                              "cache": cache})
        out.append(logits.cpu())
    return pieces, out


def test_meta_placed_llama4_on_four_cards_matches_one_cards_positions(
        four_cards):
    """Drawn on four cards and on four logical positions of cuda:0, from
    one seed: every piece bitwise, and the split prefill's and decode
    steps' logits bitwise (the same ops in the same order on cards of one
    kind)."""
    logical = [four_cards[0]] * 4
    (pa, la), (pb, lb) = (_meta_llama4_case(four_cards),
                          _meta_llama4_case(logical))
    assert len(pa) == len(pb)
    assert all(torch.equal(a, b) for a, b in zip(pa, pb))
    for a, b in zip(la, lb, strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["llama3-8b", "phi3.5-moe-42b-a6.6b",
                                  "rwkv6-7b", "zamba2-1.2b"])
def test_split_cells_across_two_cards(two_cards, arch):
    """The (2, 2) mesh over two cards (data shard 0 on the first, 1 on
    the second): each card holds its positions' weight pieces, the second
    a copy; the same logits as the CPU; and the train cell's split step
    (gradients reduced across the cards) as the CPU's."""
    first, second = two_cards
    devices = [first, first, second, second]
    for got, want in zip(_split_case(devices, arch),
                         _split_case("cpu", arch)):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    for got, want in zip(_split_train_case(devices, arch),
                         _split_train_case("cpu", arch), strict=True):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
