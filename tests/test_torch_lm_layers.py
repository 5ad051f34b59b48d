"""repro_torch's LM building blocks against the reference's
(``repro.models.lm.layers``) on the CPU.

The port's modules draw their weights from a seeded ``torch.Generator``;
the reference gets the same numbers as a dict of arrays, and the same
seeded numpy activations go through both. Everything is fp32, held at
``rtol = atol = 1e-5`` (``tests/test_kernels.py:20``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.models.lm import layers as JL  # noqa: E402
from repro_torch.models.lm import layers as L  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _arr(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def _tree(module) -> dict:
    """The reference's dict of a port module's persistent tensors."""
    return {name: jnp.asarray(t.numpy()) for name, t in
            module.state_dict().items() if "." not in name}


def _attn(dims: L.AttnDims, seed=0):
    p = L.Attention(dims, device="cpu", dtype=torch.float32)
    p.reset_parameters(torch.Generator().manual_seed(seed))
    if dims.qk_norm:   # non-trivial norm gains
        p.q_norm.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(7))
        p.k_norm.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(8))
    return p, _tree(p)


def _jref(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _tt(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# ---------------------------------------------------------------------------
# norms and rotary
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(3, 5, 64), (2, 4, 3, 16)])
def test_rms_norm(shape):
    rng = _rng()
    x, g = _arr(rng, *shape, scale=3.0), _arr(rng, shape[-1])
    _close(L.rms_norm(*_tt(x, g)), JL.rms_norm(*_jref(x, g)))


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0, 500_000.0])
def test_rope_freqs_are_the_reference_table(theta):
    np.testing.assert_array_equal(L.rope_freqs(128, theta),
                                  JL.rope_freqs(128, theta))


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
@pytest.mark.parametrize("positions", ["prefill", "decode"])
def test_apply_rope(theta, positions):
    rng = _rng(1)
    b, s, h, hd = 2, 9, 3, 16
    if positions == "prefill":
        pos = np.arange(s, dtype=np.int32)[None]
        x = _arr(rng, b, s, h, hd)
    else:      # one token at a late position, as attention_decode makes
        pos = np.full((b, 1), 40_000, dtype=np.int32)
        x = _arr(rng, b, 1, h, hd)
    got = L.apply_rope(*_tt(x, pos), theta)
    _close(got, JL.apply_rope(*_jref(x, pos), theta))
    # the module's cached table gives the same rotation
    freqs = torch.from_numpy(L.rope_freqs(hd, theta))
    torch.testing.assert_close(
        L.apply_rope(*_tt(x, pos), theta, freqs=freqs), got, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,kv", [(4, 4), (4, 2), (6, 1)])
def test_sdpa(causal, h, kv):
    rng = _rng(2)
    b, sq, hd = 2, 7, 8
    q, k, v = _arr(rng, b, sq, h, hd), _arr(rng, b, sq, kv, hd), \
        _arr(rng, b, sq, kv, hd)
    _close(L._sdpa(*_tt(q, k, v), causal=causal),
           JL._sdpa(*_jref(q, k, v), causal=causal))


def test_gqa_head_order_is_jnp_repeat():
    """Query head i reads kv head i // (h // kv): the port's grouped view
    equals attention over the reference's repeated k/v."""
    rng = _rng(3)
    q, k, v = _arr(rng, 1, 5, 4, 8), _arr(rng, 1, 5, 2, 8), \
        _arr(rng, 1, 5, 2, 8)
    rep = lambda a: np.repeat(a, 2, axis=2)
    torch.testing.assert_close(
        L._sdpa(*_tt(q, k, v), causal=True),
        L._sdpa(*_tt(q, rep(k), rep(v)), causal=True), **TOL)


@pytest.mark.parametrize("qk_norm", [False, True])
@pytest.mark.parametrize("h,kv", [(4, 2), (4, 4)])
def test_attention_self(qk_norm, h, kv):
    dims = L.AttnDims(n_heads=h, n_kv_heads=kv, head_dim=16, d_model=32,
                      qk_norm=qk_norm, rope_theta=1e6)
    p, jp = _attn(dims)
    x = _arr(_rng(4), 2, 11, 32)
    jdims = JL.AttnDims(**vars(dims))
    _close(L.attention(p, dims, torch.from_numpy(x)),
           JL.attention(jp, jdims, jnp.asarray(x)))


@pytest.mark.parametrize("rope", [True, False])
def test_attention_cross_memory(rope):
    """``memory=`` switches to non-causal cross-attention with no rope."""
    dims = L.AttnDims(n_heads=4, n_kv_heads=2, head_dim=8, d_model=32)
    p, jp = _attn(dims, seed=1)
    rng = _rng(5)
    x, mem = _arr(rng, 2, 6, 32), _arr(rng, 2, 13, 32)
    got = L.attention(p, dims, torch.from_numpy(x),
                      memory=torch.from_numpy(mem), rope=rope)
    _close(got, JL.attention(jp, JL.AttnDims(**vars(dims)), jnp.asarray(x),
                             memory=jnp.asarray(mem), rope=rope))


@pytest.mark.parametrize("index", [0, 5, 11])
def test_attention_decode_against_a_filled_cache(index):
    """One token at ``index`` over a (b, S_max, kv, hd) cache whose slots
    past ``index`` hold junk the mask must hide; the port writes the
    token's k/v in place at ``index``."""
    dims = L.AttnDims(n_heads=4, n_kv_heads=2, head_dim=8, d_model=32,
                      qk_norm=True)
    p, jp = _attn(dims, seed=2)
    rng = _rng(6)
    b, s_max = 2, 12
    x = _arr(rng, b, 1, 32)
    kc, vc = _arr(rng, b, s_max, 2, 8), _arr(rng, b, s_max, 2, 8)
    jout, jk, jv = JL.attention_decode(jp, JL.AttnDims(**vars(dims)),
                                       *_jref(x, kc, vc), jnp.int32(index))
    tk, tv = _tt(kc.copy(), vc.copy())
    out, k2, v2 = L.attention_decode(p, dims, torch.from_numpy(x), tk, tv,
                                     index)
    assert k2 is tk and v2 is tv
    _close(out, jout)
    _close(tk, jk)
    _close(tv, jv)


def test_attention_decode_past_the_cache_raises():
    dims = L.AttnDims(n_heads=2, n_kv_heads=2, head_dim=8, d_model=16)
    p, _ = _attn(dims)
    kc = torch.zeros(1, 4, 2, 8)
    with pytest.raises(IndexError, match="outside the cache's 4 slots"):
        L.attention_decode(p, dims, torch.zeros(1, 1, 16), kc, kc.clone(), 4)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,kv", [(4, 2), (2, 2)])
@pytest.mark.parametrize("chunks", [(4, 4), (8, 2), (16, 16)])
def test_flash_attention(causal, h, kv, chunks):
    rng = _rng(7)
    b, s, hd = 2, 16, 8
    q, k, v = _arr(rng, b, s, h, hd), _arr(rng, b, s, kv, hd), \
        _arr(rng, b, s, kv, hd)
    qc, kc = chunks
    got = L.flash_attention(*_tt(q, k, v), causal=causal, q_chunk=qc,
                            k_chunk=kc)
    _close(got, JL.flash_attention(*_jref(q, k, v), causal=causal,
                                   q_chunk=qc, k_chunk=kc))
    _close(got, JL._sdpa(*_jref(q, k, v), causal=causal))


def test_flash_attention_needs_whole_chunks():
    x = torch.zeros(1, 6, 2, 4)
    with pytest.raises(ValueError, match="seq must divide chunk"):
        L.flash_attention(x, x, x, causal=True, q_chunk=4, k_chunk=4)


def test_attend_switches_to_flash_at_the_threshold(monkeypatch):
    calls = []
    real = L.flash_attention
    monkeypatch.setattr(L, "flash_attention",
                        lambda *a, **kw: calls.append(kw) or real(*a, **kw))
    monkeypatch.setattr(L, "FLASH_THRESHOLD", 8)
    monkeypatch.setattr(L, "FLASH_CHUNK", 4)
    rng = _rng(8)
    q, k, v = _arr(rng, 1, 8, 2, 4), _arr(rng, 1, 8, 2, 4), \
        _arr(rng, 1, 8, 2, 4)
    got = L._attend(*_tt(q, k, v), causal=True)
    assert calls == [dict(causal=True, q_chunk=4, k_chunk=4)]
    _close(got, JL._sdpa(*_jref(q, k, v), causal=True))
    L._attend(*_tt(q[:, :7], k[:, :7], v[:, :7]), causal=True)
    assert len(calls) == 1
    assert (L.FLASH_THRESHOLD, L.FLASH_CHUNK) == (8, 4)


def test_flash_constants_are_the_reference():
    assert (L.FLASH_THRESHOLD, L.FLASH_CHUNK) == (JL.FLASH_THRESHOLD,
                                                  JL.FLASH_CHUNK)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def test_swiglu():
    p = L.SwiGLU(32, 48, device="cpu", dtype=torch.float32)
    p.reset_parameters(torch.Generator().manual_seed(3))
    x = _arr(_rng(9), 2, 5, 32, scale=2.0)
    _close(L.swiglu(p, torch.from_numpy(x)), JL.swiglu(_tree(p),
                                                       jnp.asarray(x)))


def test_gelu_mlp_is_the_tanh_gelu():
    p = L.GeluMLP(32, 48, device="cpu", dtype=torch.float32)
    p.reset_parameters(torch.Generator().manual_seed(4))
    g = torch.Generator().manual_seed(5)
    p.b_in.normal_(generator=g)
    p.b_out.normal_(generator=g)
    x = _arr(_rng(10), 2, 5, 32, scale=2.0)
    got = L.gelu_mlp(p, torch.from_numpy(x))
    _close(got, JL.gelu_mlp(_tree(p), jnp.asarray(x)))
    # PyTorch's default (erf) GELU is another function
    erf = torch.nn.functional.gelu(torch.from_numpy(x) @ p.w_in + p.b_in) \
        @ p.w_out + p.b_out
    assert (erf - got).abs().max() > 1e-4
