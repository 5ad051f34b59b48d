"""repro_torch on a card: each CUDA kernel against its plain version, the
kernels' stream discipline, and every model's four levels on CUDA against
the CPU path on the same weights.

Every test here needs an NVIDIA card and skips without one; this file
imports no JAX, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py -q

K1, K9 and K10 are bitwise (a copy, and arithmetic rounded in the plain
order without FMA); K11 sums in another order than ``torch.sum``
(``rtol=atol=1e-5``). Whole models cross devices at ``rtol=1e-4,
atol=1e-5``: cuBLAS and the CPU BLAS sum the GEMMs in different orders.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ctr_spec  # noqa: E402
from repro_torch.core import LEVELS, compile_plan  # noqa: E402
from repro_torch.data import CRITEO, sample_ids  # noqa: E402
from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402
from repro_torch.kernels.fused_cross import (  # noqa: E402
    fused_cross_v1, fused_cross_v1_plain, fused_cross_v2, fused_cross_v2_plain)
from repro_torch.kernels.fused_fm import (  # noqa: E402
    fused_fm_second_order, fused_fm_second_order_plain)
from repro_torch.kernels.multi_table_lookup import (  # noqa: E402
    mtl_gather, mtl_gather_plain)
from repro_torch.models.ctr import CTR_MODELS  # noqa: E402

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


@pytest.mark.parametrize("d", [1, 32])
def test_mtl_gather_bitwise(cuda, d):
    rng = np.random.default_rng(d)
    sizes = rng.integers(2, 5000, size=39)
    mega = rng.normal(size=(int(sizes.sum()) + 1, d)).astype(np.float32)
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int32)
    ids = np.stack([rng.integers(0, n, size=256) for n in sizes],
                   axis=1).astype(np.int32)
    ids[0, :3] = [-5, 2**31 - 1, 10**6]                   # clamped rows
    args = [torch.from_numpy(a).to(cuda) for a in (ids, offsets, mega)]
    before = mtl_gather.launches
    got = mtl_gather(*args)
    torch.cuda.synchronize()
    assert mtl_gather.launches == before + 1
    assert torch.equal(got, mtl_gather_plain(*args))


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
