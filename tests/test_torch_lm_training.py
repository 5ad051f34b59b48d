"""repro_torch's LM training path against the reference's on the CPU: the
losses, every gradient leaf, remat, the flash branch under autograd, the
AdamW loop, resume, the launcher and a graph-free serving path after
``param_tree()``.

All ten architectures at their ``reduced()`` fp32 sizes. The reference
model draws its parameters from ``PRNGKey(0)``; the port's model takes the
same tree through ``repro_torch.bridge.load_lm_params``; the same seeded
numpy batch goes through ``jax.value_and_grad(model.loss)`` and the port's
``loss(batch).backward()``. The port's gradients come back to the
reference's stacked layout through ``bridge.stacked_lm_tree``, and every
reference leaf is compared (``rtol = 1e-4, atol = 1e-5``, the LM zoo's
tolerance: two packages, two BLAS orders).
"""

import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCH_NAMES  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models.lm import layers as JL  # noqa: E402
from repro.models.lm import make_lm_model as jax_make_lm_model  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro_torch.bridge import (_leaves, load_lm_params,  # noqa: E402
                                stacked_lm_tree)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.lm import layers as L  # noqa: E402
from repro_torch.models.lm import make_lm_model  # noqa: E402
from repro_torch.serving import generate  # noqa: E402
from repro_torch.training import (AdamWConfig, TrainLoopConfig,  # noqa: E402
                                  adamw_init, make_train_step,
                                  run_train_loop)
from repro_torch.training.optimizer import tree_flatten, tree_map  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-4, atol=1e-5)
B, S, N_IMG = 2, 16, 4
MOE_ARCHS = ["phi3.5-moe-42b-a6.6b", "llama4-maverick-400b-a17b"]


def _batch_np(cfg, seed):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "encdec":
        out["frames"] = (rng.normal(size=(B, S, cfg.d_model))
                         * 0.1).astype(np.float32)
    if cfg.family == "vlm":
        out["patch_embeds"] = (rng.normal(size=(B, N_IMG, cfg.d_model))
                               * 0.02).astype(np.float32)
    return out


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tbatch(batch):
    return {k: (torch.from_numpy(v).long() if k == "tokens"
                else torch.from_numpy(v)) for k, v in batch.items()}


class Pair:
    """The reference and the port on one reduced config and the same
    parameters; ``port()`` builds a fresh port model on them."""

    def __init__(self, arch, **overrides):
        self.cfg = get_config(arch).reduced(**overrides)
        jcfg = jax_get_config(arch).reduced(**overrides)
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(self.cfg)
        self.jm = jax_make_lm_model(jcfg)
        self.params = self.jm.init(jax.random.PRNGKey(0))
        self.np_params = jax.tree.map(np.asarray, self.params)
        self.batch = _batch_np(self.cfg, 1)

    def port(self, **overrides):
        cfg = dataclasses.replace(self.cfg, **overrides)
        return load_lm_params(make_lm_model(cfg, device="cpu"),
                              self.np_params)


_PAIRS: dict = {}


def pair_of(arch, **overrides):
    key = (arch, tuple(sorted(overrides.items())))
    if key not in _PAIRS:
        _PAIRS[key] = Pair(arch, **overrides)
    return _PAIRS[key]


def _ref_paths(tree, path=()):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _ref_paths(tree[key], path + (key,))
    else:
        yield path, np.asarray(tree, dtype=np.float32)


def port_value_and_grad(model, batch, loss=None, unused=()):
    """(loss, gradient tree in the reference's stacked layout) of
    ``loss(model, batch)`` (default ``model.loss(batch)``). Every leaf
    must receive a gradient but those whose path starts with one of
    ``unused``; theirs are zeros, as ``jax.grad`` gives them."""
    tree = model.param_tree()
    value = (loss or (lambda m, b: m.loss(b)))(model, batch)
    value.backward()
    missing = [path for path, t in _leaves(tree) if t.grad is None]
    assert [p for p in missing
            if not any(p[:len(u)] == u for u in unused)] == [], missing
    grads = stacked_lm_tree(tree_map(
        lambda t: torch.zeros_like(t) if t.grad is None else t.grad, tree))
    for _, t in _leaves(tree):
        t.grad = None
    return value.detach(), grads


def assert_same_tree(got, want, tol=TOL):
    """Every leaf of the reference tree ``want`` against ``got``; neither
    has a leaf the other lacks."""
    g, w = dict(_ref_paths(got)), dict(_ref_paths(want))
    assert sorted(g) == sorted(w)
    for path, arr in w.items():
        np.testing.assert_allclose(g[path], arr, err_msg=str(path), **tol)


# ---------------------------------------------------------------------------
# the losses alone
# ---------------------------------------------------------------------------

def test_next_token_loss_and_its_gradient_match_the_reference():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(B, S, 64)).astype(np.float32) * 3
    tokens = rng.integers(0, 64, (B, S)).astype(np.int32)
    jv, jg = jax.value_and_grad(JL.next_token_loss)(jnp.asarray(logits),
                                                    jnp.asarray(tokens))
    t = torch.from_numpy(logits).requires_grad_(True)
    v = L.next_token_loss(t, torch.from_numpy(tokens))
    v.backward()
    np.testing.assert_allclose(v.item(), float(jv), **TOL)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), **TOL)


@pytest.mark.parametrize("chunk", [1, 7, S - 1, 1024])
def test_chunked_ce_loss_and_its_gradients_match_the_reference(chunk):
    """Chunks of 1, 7 (a ragged last chunk) and ``s - 1`` or more (one
    chunk): the value and the gradients of x, gamma and the head."""
    rng = np.random.default_rng(chunk)
    d, v = 32, 96
    x = rng.normal(size=(B, S, d)).astype(np.float32)
    gamma = (1 + 0.1 * rng.normal(size=(d,))).astype(np.float32)
    w = (rng.normal(size=(d, v)) * 0.2).astype(np.float32)
    tokens = rng.integers(0, v, (B, S)).astype(np.int32)

    def jloss(x, gamma, w):
        return JL.chunked_ce_loss(x, gamma, w, jnp.asarray(tokens),
                                  chunk=chunk)
    jv, jg = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(w))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (x, gamma, w)]
    tv = L.chunked_ce_loss(*ts, torch.from_numpy(tokens), chunk=chunk)
    tv.backward()
    np.testing.assert_allclose(tv.item(), float(jv), **TOL)
    for t, g in zip(ts, jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), **TOL)
    # the unchunked loss over the full logits gives the same value
    full = L.next_token_loss(L.rms_norm(ts[0], ts[1]) @ ts[2],
                             torch.from_numpy(tokens))
    np.testing.assert_allclose(full.item(), tv.item(), **TOL)


# ---------------------------------------------------------------------------
# each family's loss and every gradient leaf
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_loss_and_every_gradient_match_the_reference(arch):
    p = pair_of(arch)
    jv, jg = jax.value_and_grad(p.jm.loss)(p.params, _jbatch(p.batch))
    tv, tg = port_value_and_grad(p.port(), _tbatch(p.batch))
    np.testing.assert_allclose(float(tv), float(jv), **TOL)
    assert_same_tree(tg, jg)


def test_tied_head_loss_and_gradients_match_the_reference():
    """No published config ties its head; with ``tie_embeddings`` the
    embedding takes its gradient from the gather and from the head."""
    p = pair_of("smollm-360m", tie_embeddings=True)
    jv, jg = jax.value_and_grad(p.jm.loss)(p.params, _jbatch(p.batch))
    tv, tg = port_value_and_grad(p.port(), _tbatch(p.batch))
    assert "lm_head" not in tg
    np.testing.assert_allclose(float(tv), float(jv), **TOL)
    assert_same_tree(tg, jg)


@pytest.mark.parametrize("scan_layers", [True, False])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_ce_and_aux_terms_match_the_reference_apart(arch, scan_layers):
    """The CE alone (``aux_weight=0``) and the router aux term alone,
    each with its gradients; the aux term's order over layers follows
    ``scan_layers`` (a mean of the stacked terms, or ``aux / L`` added
    layer by layer). The reference's aux comes out as the difference of
    its losses at ``aux_weight`` 1 and 0."""
    p = pair_of(arch, scan_layers=scan_layers)
    jb, tb = _jbatch(p.batch), _tbatch(p.batch)
    jv, jg = jax.value_and_grad(
        lambda prm: p.jm.loss(prm, jb, aux_weight=0.0))(p.params)
    model = p.port()
    tv, tg = port_value_and_grad(model, tb,
                                 lambda m, b: m.loss(b, aux_weight=0.0))
    np.testing.assert_allclose(float(tv), float(jv), **TOL)
    assert_same_tree(tg, jg)

    jv, jg = jax.value_and_grad(
        lambda prm: p.jm.loss(prm, jb, aux_weight=1.0)
        - p.jm.loss(prm, jb, aux_weight=0.0))(p.params)
    # the head and the last layer's experts do not reach the aux term
    last = p.cfg.n_layers - 1
    tv, tg = port_value_and_grad(
        model, tb, lambda m, b: m.loss_terms(b)[1],
        unused=[("final_norm",), ("lm_head",), ("layers", last, "moe",
                                                "w_gate"),
                ("layers", last, "moe", "w_up"),
                ("layers", last, "moe", "w_down")])
    assert float(tv) > 0
    np.testing.assert_allclose(float(tv), float(jv), **TOL)
    assert_same_tree(tg, jg)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_gradients_match_the_reference_when_pairs_drop(arch):
    """At ``capacity_factor = 0.5`` every layer drops (token, slot) pairs
    past its experts' capacity; the loss and every gradient still match
    the reference's, whose dispatch einsum passes nothing through a
    dropped pair."""
    from repro.models.lm import moe as JM

    p = pair_of(arch, capacity_factor=0.5)
    g = B * S
    assert JM.capacity(p.jm.cfg, g) * p.cfg.n_experts < g * p.cfg.top_k
    jv, jg = jax.value_and_grad(p.jm.loss)(p.params, _jbatch(p.batch))
    tv, tg = port_value_and_grad(p.port(), _tbatch(p.batch))
    np.testing.assert_allclose(float(tv), float(jv), **TOL)
    assert_same_tree(tg, jg)


def test_moe_routing_carries_no_gradient_and_drops_pass_none():
    """Under autograd the router learns only through the kept pairs' gate
    values and the aux term: with every token routed over capacity but
    one, a dropped pair's gate value gets no gradient from the output."""
    from repro_torch.models.lm.moe import MoEFFN, moe_ffn

    cfg = get_config("phi3.5-moe-42b-a6.6b").reduced(capacity_factor=0.01)
    ffn = MoEFFN(cfg, device="cpu", dtype=torch.float32)
    ffn.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.randn((1, 8, cfg.d_model), generator=torch.Generator()
                    .manual_seed(1), requires_grad=True)
    router = ffn.router.requires_grad_(True)
    out, aux = moe_ffn(ffn, x, cfg)
    out.sum().backward()
    # capacity 1 an expert: at most n_experts pairs kept; the rest of the
    # tokens' outputs are zero and pass nothing back
    kept_rows = (out.detach().abs().sum(-1) > 0).sum()
    assert 0 < kept_rows < 8
    dropped = out.detach().abs().sum(-1)[0] == 0
    assert torch.all(x.grad[0, dropped] == 0)
    assert router.grad is not None and torch.isfinite(router.grad).all()


# ---------------------------------------------------------------------------
# remat and the flash branch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_remat_gradients_are_bitwise_the_plain_ones(arch):
    """``remat=True`` rematerialises every layer (and each CE chunk); the
    recomputation is bitwise, so loss and gradients are too."""
    p = pair_of(arch)
    tb = _tbatch(p.batch)
    v0, g0 = port_value_and_grad(p.port(remat=False), tb)
    v1, g1 = port_value_and_grad(p.port(remat=True), tb)
    assert torch.equal(v0, v1)
    for (path, a), (_, b) in zip(_ref_paths(g0), _ref_paths(g1)):
        assert np.array_equal(a, b), path


@pytest.mark.parametrize("arch", ["llama3-8b", "whisper-small"])
def test_flash_branch_gradients_match_the_reference(arch, monkeypatch):
    """With both modules' ``FLASH_THRESHOLD`` at 8 and ``FLASH_CHUNK`` at
    4, s = 16 takes the chunked online softmax (every k-block
    rematerialised) in every attention: causal self-attention, and
    whisper's bidirectional encoder and cross-attention."""
    for mod in (JL, L):
        monkeypatch.setattr(mod, "FLASH_THRESHOLD", 8)
        monkeypatch.setattr(mod, "FLASH_CHUNK", 4)
    calls = []
    flash = L.flash_attention
    monkeypatch.setattr(L, "flash_attention",
                        lambda *a, **kw: calls.append(1) or flash(*a, **kw))
    p = pair_of(arch)
    jv, jg = jax.value_and_grad(p.jm.loss)(p.params, _jbatch(p.batch))
    tv, tg = port_value_and_grad(p.port(), _tbatch(p.batch))
    assert len(calls) == p.cfg.n_layers * (1 if arch == "llama3-8b" else 3)
    np.testing.assert_allclose(float(tv), float(jv), **TOL)
    assert_same_tree(tg, jg)


# ---------------------------------------------------------------------------
# the tree, the loop, resume and the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_tree_is_the_models_buffers_in_the_reference_layout(arch):
    p = pair_of(arch)
    model = p.port()
    tree = model.param_tree()
    owned = {id(t) for t in model.state_dict(keep_vars=True).values()}
    leaves = [t for _, t in _leaves(tree)]
    assert {id(t) for t in leaves} == owned and len(leaves) == len(owned)
    assert all(t.requires_grad for t in leaves)
    assert_same_tree(stacked_lm_tree(tree), p.np_params, dict(rtol=0,
                                                             atol=0))


def _ref_step(jm, opt):
    @jax.jit
    def step_fn(state, batch):
        loss, grads = jax.value_and_grad(jm.loss)(state.params, batch)
        state, m = jopt.adamw_update(state, grads, opt)
        return state, {"loss": loss, **m}
    return step_fn


@pytest.mark.parametrize("arch", ["smollm-360m", "rwkv6-7b"])
def test_five_steps_match_the_reference_and_lower_the_loss(arch):
    """Five AdamW steps (lr 1e-3) on one fixed batch: the losses within
    ``rtol = 1e-4`` of the reference's jitted step, and falling."""
    p = pair_of(arch)
    jopt_cfg = jopt.AdamWConfig(lr=1e-3)
    jstate = jopt.adamw_init(p.params, jopt_cfg)
    jstep = _ref_step(p.jm, jopt_cfg)
    model = p.port()
    opt = AdamWConfig(lr=1e-3)
    state = adamw_init(model.param_tree(), opt)
    step = make_train_step(model, opt)
    jb, tb = _jbatch(p.batch), _tbatch(p.batch)
    jl, tl = [], []
    for _ in range(5):
        jstate, jm = jstep(jstate, jb)
        state, m = step(state, tb)
        jl.append(float(jm["loss"]))
        tl.append(float(m["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0]
    assert int(state.step) == int(jstate.step) == 5


def test_gradients_are_repeatable_on_a_many_threaded_cpu():
    """The same loss twice at the launcher's batch (b = 8, s = 64: ids
    repeat): every gradient bitwise, the embedding's (its gathered rows
    summed by id, and a tied head's) included."""
    from repro_torch.launch.train import lm_batch_fn

    p = pair_of("smollm-360m", tie_embeddings=True)
    model = p.port()
    batch = lm_batch_fn(p.cfg, 8, 64, "cpu")(0)
    threads = torch.get_num_threads()
    torch.set_num_threads(max(threads, 4))
    try:
        v1, g1 = port_value_and_grad(model, batch)
        v2, g2 = port_value_and_grad(model, batch)
    finally:
        torch.set_num_threads(threads)
    assert torch.equal(v1, v2)
    for (path, a), (_, b) in zip(_ref_paths(g1), _ref_paths(g2)):
        assert np.array_equal(a, b), path


def test_resume_through_the_loop_is_bitwise(tmp_path):
    """6 steps unbroken equal 3 steps, a fresh model's restore from the
    checkpoint, then 3 more, at the launcher's batch (b = 8, s = 64):
    parameters, moments and step bitwise."""
    from repro_torch.launch.train import lm_batch_fn

    p = pair_of("smollm-360m")
    opt = AdamWConfig(lr=1e-3)

    def run(total, ckpt):
        model = p.port()
        cfg = TrainLoopConfig(total_steps=total, ckpt_every=3,
                              ckpt_dir=str(tmp_path / ckpt), log_every=100)
        return run_train_loop(make_train_step(model, opt),
                              adamw_init(model.param_tree(), opt),
                              lm_batch_fn(p.cfg, 8, 64, "cpu"), cfg)

    s1, h1 = run(6, "a")
    run(3, "b")
    s2, h2 = run(6, "b")
    assert [r["step"] for r in h2] == [4, 5, 6]
    assert [r["loss"] for r in h1[3:]] == [r["loss"] for r in h2]
    for (key, a), (_, b) in zip(tree_flatten(s1), tree_flatten(s2)):
        assert torch.equal(a, b), key


def test_batch_fn_is_a_pure_function_of_the_step():
    from repro_torch.launch.train import lm_batch_fn

    for arch in ("whisper-small", "pixtral-12b"):
        cfg = get_config(arch).reduced()
        fn = lm_batch_fn(cfg, 3, 8, "cpu")
        a, b, c = fn(5), fn(5), fn(6)
        assert set(a) == {"tokens", "frames" if arch == "whisper-small"
                          else "patch_embeds"}
        for key in a:
            assert torch.equal(a[key], b[key])
            assert not torch.equal(a[key], c[key])
        assert a["tokens"].shape == (3, 8)
        assert bool(((a["tokens"] >= 0) & (a["tokens"] < cfg.vocab)).all())


def test_launch_train_runs_on_the_cpu(tmp_path):
    """``python -m repro_torch.launch.train --arch smollm-360m --reduced
    --steps 3 --device cpu``: the reference's last line, and a checkpoint
    at the last step."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "smollm-360m", "--reduced", "--steps", "3", "--device", "cpu",
         "--ckpt-dir", str(tmp_path)],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        capture_output=True, text=True, timeout=300, check=True)
    last = out.stdout.strip().splitlines()[-1]
    assert re.fullmatch(r"\[train\] smollm-360m: loss \d+\.\d{4} -> "
                        r"\d+\.\d{4} over 3 steps", last), out.stdout
    assert (tmp_path / "step_3" / "manifest.json").exists()


# ---------------------------------------------------------------------------
# serving after param_tree() records no graph
# ---------------------------------------------------------------------------

def _cache_tensors(cache):
    for val in cache.values():
        if isinstance(val, dict):
            yield from _cache_tensors(val)
        elif isinstance(val, torch.Tensor):
            yield val


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_serving_records_no_graph_after_param_tree(arch):
    p = pair_of(arch)
    model = p.port()
    model.param_tree()
    tb = _tbatch(p.batch)
    extra = {k: v for k, v in tb.items() if k != "tokens"}
    out = generate(model, tb["tokens"], max_new=3, **extra)
    assert out.grad_fn is None and not out.requires_grad
    fam = p.cfg.family
    if fam == "encdec":
        cache = model.init_cache(B, S + 2, S)
        logits, cache = model.prefill(tb["tokens"], extra["frames"], cache)
    elif fam == "vlm":
        cache = model.init_cache(B, N_IMG + S + 2)
        logits, cache = model.prefill(tb["tokens"], cache, **extra)
    else:
        cache = model.init_cache(B, S + 2)
        logits, cache = model.prefill(tb["tokens"], cache)
    logits2, cache = model.decode_step(logits.argmax(-1)[:, None], cache)
    for t in (logits, logits2, *_cache_tensors(cache)):
        assert t.grad_fn is None and not t.requires_grad


# ---------------------------------------------------------------------------
# the bf16 decode-vs-forward gap beside the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["smollm-360m", "qwen3-4b", "rwkv6-7b",
                                  "zamba2-1.2b"])
def test_bf16_decode_vs_forward_gap_beside_the_reference(arch):
    """The reference's invariant (``tests/test_lm_smoke.py:70-104``) in
    bf16 on the same weights and prompt in both packages: prefill + one
    decode step against the teacher-forced forward's last position. Both
    gaps stay within the reference's 5e-2, both packages pick the same
    next token, and greedy decode agrees with forward in the port
    wherever it does in the reference."""
    cfg = get_config(arch).reduced(dtype="bfloat16")
    jm = jax_make_lm_model(jax_get_config(arch).reduced(dtype="bfloat16"))
    params = jm.init(jax.random.PRNGKey(0))
    model = load_lm_params(make_lm_model(cfg, device="cpu"),
                           jax.tree.map(np.asarray, params))
    toks = _batch_np(cfg, 1)["tokens"]
    cap = 0 if cfg.family == "ssm" else S + 4
    jlp, jc = jm.prefill(params, jnp.asarray(toks), jm.init_cache(B, cap))
    jnxt = jnp.argmax(jlp, -1)[:, None].astype(jnp.int32)
    jld, _ = jm.decode_step(params, jnxt, jc)
    jref = jm.forward(params, jnp.concatenate([jnp.asarray(toks), jnxt],
                                              1))[:, -1]
    tt = torch.from_numpy(toks).long()
    lp, c = model.prefill(tt, model.init_cache(B, cap))
    nxt = lp.float().argmax(-1)[:, None]
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))
    ld, _ = model.decode_step(nxt, c)
    with torch.no_grad():
        ref = model(torch.cat([tt, nxt], 1))[:, -1]
    jgap = np.abs(np.asarray(jld, np.float32) - np.asarray(jref, np.float32))
    gap = (ld.float() - ref.float()).abs().numpy()
    assert jgap.max() <= 5e-2 and gap.max() <= 5e-2, (jgap.max(), gap.max())
    if np.array_equal(np.argmax(np.asarray(jld, np.float32), -1),
                      np.argmax(np.asarray(jref, np.float32), -1)):
        assert torch.equal(ld.float().argmax(-1), ref.float().argmax(-1))
