"""repro_torch's LM zoo against the reference's (``repro.models.lm``) on
the CPU, all ten architectures at their ``reduced()`` sizes.

The reference model draws its parameters from ``PRNGKey(0)``; the port's
model takes the same tree through ``repro_torch.bridge.load_lm_params``;
the same seeded numpy tokens (and frames or patch embeddings) go through
both. fp32 logits and caches agree within ``rtol = 1e-4, atol = 1e-5``
(two packages, two BLAS orders); bf16 within the reference's own
``5e-2`` (``tests/test_lm_smoke.py:101-104``).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCH_NAMES  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models.lm import make_lm_model as jax_make_lm_model  # noqa: E402
from repro.models.lm import moe as JM  # noqa: E402
from repro.models.lm import zamba2 as JZ  # noqa: E402
from repro_torch.bridge import load_lm_params  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.lm import make_lm_model  # noqa: E402
from repro_torch.models.lm.moe import MoEFFN, capacity, moe_ffn  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)
BF16_TOL = dict(rtol=5e-2, atol=5e-2)
B, S, N_IMG, EXTRA = 2, 16, 4, 4


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, dtype=np.float32), **tol)


class Pair:
    """The reference and the port on one config, the same parameters and
    the same inputs."""

    def __init__(self, arch: str, **overrides):
        self.cfg = get_config(arch).reduced(**overrides)
        jcfg = jax_get_config(arch).reduced(**overrides)
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(self.cfg)
        self.jm = jax_make_lm_model(jcfg)
        self.params = self.jm.init(jax.random.PRNGKey(0))
        self.pm = load_lm_params(make_lm_model(self.cfg, device="cpu"),
                                 jax.tree.map(np.asarray, self.params))
        rng = np.random.default_rng(1)
        self.tokens = rng.integers(0, self.cfg.vocab, (B, S)).astype(np.int32)
        dt = np.float32
        self.extra = {}
        if self.cfg.family == "encdec":
            self.extra["frames"] = (rng.normal(size=(B, S, self.cfg.d_model))
                                    * 0.1).astype(dt)
        if self.cfg.family == "vlm":
            self.extra["patch_embeds"] = (
                rng.normal(size=(B, N_IMG, self.cfg.d_model)) * 0.02
            ).astype(dt)

    def _extras(self, to):
        jdt = jnp.dtype(self.cfg.dtype)
        tdt = getattr(torch, self.cfg.dtype)
        return {k: (jnp.asarray(v, jdt) if to == "jax" else
                    torch.from_numpy(v).to(tdt))
                for k, v in self.extra.items()}

    def forward(self, tokens):
        je, te = self._extras("jax"), self._extras("torch")
        jt, tt = jnp.asarray(tokens), torch.from_numpy(tokens).long()
        return (self.jm.forward(self.params, jt, *je.values()),
                self.pm(tt, *te.values()))

    def prefill(self):
        fam = self.cfg.family
        je, te = self._extras("jax"), self._extras("torch")
        jt, tt = jnp.asarray(self.tokens), torch.from_numpy(self.tokens).long()
        if fam == "encdec":
            args = (B, S + EXTRA, S)
        elif fam == "vlm":
            args = (B, N_IMG + S + EXTRA)
        else:
            args = (B, S + EXTRA)
        jc, tc = self.jm.init_cache(*args), self.pm.init_cache(*args)
        if fam == "encdec":
            jl, jc = self.jm.prefill(self.params, jt, je["frames"], jc)
            tl, tc = self.pm.prefill(tt, te["frames"], tc)
        elif fam == "vlm":
            jl, jc = self.jm.prefill(self.params, jt, jc, **je)
            tl, tc = self.pm.prefill(tt, tc, **te)
        else:
            jl, jc = self.jm.prefill(self.params, jt, jc)
            tl, tc = self.pm.prefill(tt, tc)
        return jl, jc, tl, tc


_PAIRS: dict = {}


@pytest.fixture
def pair():
    def get(arch, **overrides):
        key = (arch, tuple(sorted(overrides.items())))
        if key not in _PAIRS:
            _PAIRS[key] = Pair(arch, **overrides)
        return _PAIRS[key]
    return get


def _cache_close(tc, jc, tol=TOL):
    assert set(tc) == set(jc)
    for key, t in tc.items():
        if key == "index":
            assert t == int(jc[key])
        elif isinstance(t, dict):
            _cache_close(t, jc[key], tol)
        else:
            assert tuple(t.shape) == jc[key].shape, key
            assert t.dtype == getattr(torch, str(jc[key].dtype)), key
            _close(t, jc[key], tol)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_forward(arch, pair):
    p = pair(arch)
    jl, tl = p.forward(p.tokens)
    n = S + (N_IMG if p.cfg.family == "vlm" else 0)
    assert tuple(tl.shape) == (B, n, p.cfg.vocab)
    _close(tl, jl)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_prefill_logits_and_cache(arch, pair):
    jl, jc, tl, tc = pair(arch).prefill()
    assert tuple(tl.shape) == jl.shape
    _close(tl, jl)
    _cache_close(tc, jc)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_three_decode_steps(arch, pair):
    p = pair(arch)
    jl, jc, tl, tc = p.prefill()
    for _ in range(3):
        nxt = np.asarray(jnp.argmax(jl, axis=-1))[:, None].astype(np.int32)
        assert (tl.argmax(-1).numpy() == nxt[:, 0]).all()
        jl, jc = p.jm.decode_step(p.params, jnp.asarray(nxt), jc)
        tl, tc = p.pm.decode_step(torch.from_numpy(nxt).long(), tc)
        _close(tl, jl)
        _cache_close(tc, jc)


@pytest.mark.parametrize("arch", ["llama3-8b", "rwkv6-7b"])
def test_bf16_within_the_reference_tolerance(arch, pair):
    p = pair(arch, dtype="bfloat16")
    assert p.pm.embed.dtype == torch.bfloat16
    jl, tl = p.forward(p.tokens)
    _close(tl, jl, BF16_TOL)
    jl, jc, tl, tc = p.prefill()
    _close(tl, jl, BF16_TOL)
    for _ in range(3):
        nxt = np.asarray(jnp.argmax(jl, axis=-1))[:, None].astype(np.int32)
        jl, jc = p.jm.decode_step(p.params, jnp.asarray(nxt), jc)
        tl, tc = p.pm.decode_step(torch.from_numpy(nxt).long(), tc)
        _close(tl, jl, BF16_TOL)
    assert {k: (t.dtype, t.shape) for k, t in tc.items() if k != "index"} \
        == {k: (getattr(torch, str(a.dtype)), a.shape) for k, a in jc.items()
            if k != "index"}


def test_pixtral_without_patches_is_the_dense_model(pair):
    p = pair("pixtral-12b")
    jt, tt = jnp.asarray(p.tokens), torch.from_numpy(p.tokens).long()
    _close(p.pm(tt), p.jm.forward(p.params, jt))
    jc, tc = p.jm.init_cache(B, S + 1), p.pm.init_cache(B, S + 1)
    jl, jc = p.jm.prefill(p.params, jt, jc)
    tl, tc = p.pm.prefill(tt, tc)
    _close(tl, jl)
    _cache_close(tc, jc)


def test_rwkv_hidden_and_carried_state(pair):
    """``hidden`` is the pre-norm state; a forward on a carried state
    (two halves) equals one forward over the whole sequence."""
    p = pair("rwkv6-7b")
    jt, tt = jnp.asarray(p.tokens), torch.from_numpy(p.tokens).long()
    jx, jst = p.jm.hidden(p.params, jt)
    tx, tst = p.pm.hidden(tt)
    _close(tx, jx)
    _cache_close(tst, jst)
    whole = p.pm(tt)
    first, state = p.pm(tt[:, :7], return_state=True)
    second = p.pm(tt[:, 7:], state=state)
    torch.testing.assert_close(torch.cat([first, second], 1), whole, **TOL)


# ---------------------------------------------------------------------------
# MoE routing
# ---------------------------------------------------------------------------

def _dropped_tokens(probs: np.ndarray, k: int, c: int) -> set:
    """Tokens with a slot past its expert's capacity, by the reference's
    rule written as a loop: within a group, (token, slot) pairs claim
    their expert's places token by token, slot by slot."""
    out = set()
    for g, group in enumerate(probs):
        taken = np.zeros(group.shape[-1], dtype=int)
        for t, row in enumerate(group):
            for e in np.argsort(-row, kind="stable")[:k]:
                if taken[e] >= c:
                    out.add(g * group.shape[0] + t)
                taken[e] += 1
    return out


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b",
                                  "llama4-maverick-400b-a17b"])
@pytest.mark.parametrize("b,s", [(2, 16), (4, 256)])
def test_moe_ffn_drops_the_reference_tokens(arch, b, s):
    """At the default capacity_factor 1.25 (groups of min(512, b·s)
    tokens) some tokens overflow their experts; out and aux equal the
    reference's, and exactly the overflowing tokens differ from a run
    with room for every token."""
    cfg = get_config(arch).reduced()
    assert cfg.capacity_factor == 1.25
    p = MoEFFN(cfg, device="cpu", dtype=torch.float32)
    p.reset_parameters(torch.Generator().manual_seed(2))
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(b, s, cfg.d_model))
         + 3.0 * rng.normal(size=cfg.d_model)).astype(np.float32)
    out, aux = moe_ffn(p, torch.from_numpy(x), cfg)
    jp = {n: jnp.asarray(t.numpy()) for n, t in p.state_dict().items()}
    jout, jaux = JM.moe_ffn(jp, jnp.asarray(x), jax_get_config(arch).reduced())
    _close(out, jout)
    _close(aux, jaux)

    gsz = min(JM.GROUP_SIZE, b * s)
    c = capacity(cfg, gsz)
    probs = torch.softmax(torch.from_numpy(x).reshape(-1, gsz, cfg.d_model)
                          @ p.router, -1).numpy()
    dropped = _dropped_tokens(probs, cfg.top_k, c)
    assert dropped, "the inputs must overflow some expert"
    roomy = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
    full, _ = moe_ffn(p, torch.from_numpy(x), roomy)
    # a dropped slot loses a whole expert's share; elsewhere only the GEMM
    # order of another capacity differs
    changed = (out - full).abs().reshape(b * s, -1).amax(-1) > 1e-3
    assert set(np.flatnonzero(changed.numpy())) == dropped


def test_moe_capacity_is_the_reference():
    for arch in ("phi3.5-moe-42b-a6.6b", "llama4-maverick-400b-a17b"):
        for cf in (1.0, 1.25, 4.0):
            cfg = dataclasses.replace(get_config(arch), capacity_factor=cf)
            jcfg = dataclasses.replace(jax_get_config(arch),
                                       capacity_factor=cf)
            for g in (1, 4, 508, 512):
                assert capacity(cfg, g) == JM.capacity(jcfg, g)


# ---------------------------------------------------------------------------
# Zamba2's shared-block schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("overrides,chunks,n_shared", [
    ({}, [(0, 6), (6, 12), (12, 18), (18, 24), (24, 30), (30, 36),
          (36, 38)], 6),
    ({"n_layers": 36}, [(a, a + 6) for a in range(0, 36, 6)], 6),
    ({"shared_attn_every": 0}, [(0, 38)], 0),
    ({"n_layers": 4, "shared_attn_every": 6}, [(0, 4)], 0),
])
def test_zamba2_chunks(overrides, chunks, n_shared):
    cfg = dataclasses.replace(get_config("zamba2-1.2b"), **overrides)
    jcfg = dataclasses.replace(jax_get_config("zamba2-1.2b"), **overrides)
    small = dict(d_model=64, vocab=32, d_ff=32, n_heads=4, n_kv_heads=4,
                 ssm_state=4, dtype="float32")
    m = make_lm_model(dataclasses.replace(cfg, **small), device="cpu")
    ref = JZ.Zamba2(jcfg)
    assert m.chunks() == ref.chunks() == chunks
    assert m.n_shared() == ref.n_shared() == n_shared
    assert hasattr(m, "shared") == (n_shared > 0)


# ---------------------------------------------------------------------------
# limits the reference clamps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["llama3-8b", "zamba2-1.2b",
                                  "whisper-small"])
def test_decode_past_the_cache_raises(arch):
    cfg = get_config(arch).reduced()
    m = make_lm_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    tok = torch.zeros((1, 4), dtype=torch.long)
    if cfg.family == "encdec":
        frames = torch.zeros(1, 3, cfg.d_model)
        _, cache = m.prefill(tok, frames, m.init_cache(1, 5, 3))
    else:
        _, cache = m.prefill(tok, m.init_cache(1, 5))
    _, cache = m.decode_step(tok[:, :1], cache)
    assert cache["index"] == 5
    with pytest.raises(IndexError, match="outside the cache's 5 slots"):
        m.decode_step(tok[:, :1], cache)
    with pytest.raises(ValueError, match="does not fit"):
        if cfg.family == "encdec":
            m.prefill(torch.zeros((1, 6), dtype=torch.long), frames,
                      m.init_cache(1, 5, 3))
        else:
            m.prefill(torch.zeros((1, 6), dtype=torch.long),
                      m.init_cache(1, 5))


def test_whisper_positions_past_pos_dec_raise():
    from repro_torch.models.lm.whisper import POS_DEC_ROWS
    m = make_lm_model(get_config("whisper-small").reduced(), device="cpu")
    tok = torch.zeros((1, 2), dtype=torch.long)
    assert m._embed_dec(tok, POS_DEC_ROWS - 2).shape == (1, 2, 64)
    with pytest.raises(IndexError, match="outside pos_dec's 65536 rows"):
        m._embed_dec(tok, POS_DEC_ROWS - 1)
