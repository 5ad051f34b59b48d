"""repro_torch's LM serving path against the reference's on the CPU:
``generate``, the arch registry, the parameter bridge, the port's own
init, and ``serve --mode lm``.

Greedy generation is token for token the reference's for every arch (its
``reduced()`` config in fp32, the reference's parameters loaded through
``load_lm_params``); sampling is the port's own (``torch.multinomial`` on
the caller's generator), so it is held to reproducibility, not to the
reference's ``jax.random.categorical``.
"""

import dataclasses
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.launch import serve as jax_cli  # noqa: E402
from repro.models.lm import make_lm_model as jax_make_lm_model  # noqa: E402
from repro.serving import generate as jax_generate  # noqa: E402
import repro_torch.configs as configs  # noqa: E402
from repro_torch.bridge import load_lm_params  # noqa: E402
from repro_torch.launch import serve as cli  # noqa: E402
from repro_torch.models.lm import FAMILY_CLASSES, make_lm_model  # noqa: E402
from repro_torch.serving import generate  # noqa: E402

B, S, MAX_NEW = 2, 8, 6
FAMILY_ARCH = {"dense": "llama3-8b", "moe": "phi3.5-moe-42b-a6.6b",
               "ssm": "rwkv6-7b", "hybrid": "zamba2-1.2b",
               "encdec": "whisper-small", "vlm": "pixtral-12b"}


def _pair(arch):
    cfg = configs.get_config(arch).reduced()
    jm = jax_make_lm_model(jconfigs.get_config(arch).reduced())
    params = jm.init(jax.random.PRNGKey(0))
    pm = load_lm_params(make_lm_model(cfg, device="cpu"),
                        jax.tree.map(np.asarray, params))
    return cfg, jm, params, pm


def _prompt_kwargs(cfg, rng, with_patches=True):
    if cfg.family == "encdec":
        return {"frames": (rng.normal(size=(B, 12, cfg.d_model))
                           * 0.1).astype(np.float32)}
    if cfg.family == "vlm" and with_patches:
        return {"patch_embeds": (rng.normal(size=(B, 4, cfg.d_model))
                                 * 0.02).astype(np.float32)}
    return {}


# ---------------------------------------------------------------------------
# generate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_greedy_generate_is_the_reference_token_for_token(arch):
    cfg, jm, params, pm = _pair(arch)
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    kw = _prompt_kwargs(cfg, rng)
    want = jax_generate(jm, params, jnp.asarray(prompt), max_new=MAX_NEW,
                        **{k: jnp.asarray(v) for k, v in kw.items()})
    got = generate(pm, torch.from_numpy(prompt), max_new=MAX_NEW,
                   **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert got.dtype == torch.int32 and tuple(got.shape) == (B, S + MAX_NEW)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_greedy_generate_vlm_without_patches():
    cfg, jm, params, pm = _pair("pixtral-12b")
    prompt = np.random.default_rng(5).integers(0, cfg.vocab, (B, S))
    want = jax_generate(jm, params, jnp.asarray(prompt, jnp.int32),
                        max_new=MAX_NEW)
    got = generate(pm, torch.from_numpy(prompt).int(), max_new=MAX_NEW)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_argmax_takes_the_first_of_tied_logits():
    class Flat:
        cfg = configs.get_config("llama3-8b").reduced()

        def init_cache(self, b, n):
            return {"index": 0}

        def prefill(self, tokens, cache):
            return torch.zeros(tokens.shape[0], 5), cache

        def decode_step(self, tokens, cache):
            logits = torch.zeros(tokens.shape[0], 5)
            logits[:, 2:] = 1.0
            return logits, cache

    out = generate(Flat(), torch.zeros((2, 3), dtype=torch.long), max_new=3)
    assert out[:, 3:].tolist() == [[0, 2, 2], [0, 2, 2]]
    assert int(jnp.argmax(jnp.asarray([0.0, 0, 1, 1, 1]))) == 2


@pytest.mark.parametrize("family", sorted(FAMILY_ARCH))
def test_sampling_is_reproducible_for_a_seed(family):
    cfg = configs.get_config(FAMILY_ARCH[family]).reduced()
    m = make_lm_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    rng = np.random.default_rng(6)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)))
    kw = {k: torch.from_numpy(v)
          for k, v in _prompt_kwargs(cfg, rng).items()}
    run = lambda seed, t=1.0: generate(
        m, prompt, max_new=MAX_NEW, temperature=t,
        generator=torch.Generator().manual_seed(seed), **kw)
    a, b, c = run(11), run(11), run(12)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    assert ((a >= 0) & (a < cfg.vocab)).all()
    torch.testing.assert_close(a[:, :S], prompt, rtol=0, atol=0)
    # a vanishing temperature is greedy
    torch.testing.assert_close(run(11, 1e-6), generate(m, prompt,
                                                       max_new=MAX_NEW, **kw),
                               rtol=0, atol=0)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", jconfigs.ARCH_NAMES)
def test_config_and_source_are_the_reference(arch):
    assert dataclasses.asdict(configs.get_config(arch)) == \
        dataclasses.asdict(jconfigs.get_config(arch))
    assert configs.get_source(arch) == jconfigs.get_source(arch)
    assert configs.applicable_shapes(arch) == jconfigs.applicable_shapes(arch)
    assert dataclasses.asdict(configs.get_config(arch).reduced()) == \
        dataclasses.asdict(jconfigs.get_config(arch).reduced())


def test_registry_shapes_and_names_are_the_reference():
    assert configs.ARCH_NAMES == jconfigs.ARCH_NAMES
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    assert set(FAMILY_CLASSES) == {configs.get_config(a).family
                                   for a in configs.ARCH_NAMES}
    spec = configs.ctr_spec("dcnv2", "criteo", embed_dim=8, hidden=64,
                            max_field=2_000)
    assert dataclasses.asdict(spec) == dataclasses.asdict(
        jconfigs.ctr_spec("dcnv2", "criteo", embed_dim=8, hidden=64,
                          max_field=2_000))


# ---------------------------------------------------------------------------
# the bridge
# ---------------------------------------------------------------------------

def _ref_tree(arch="zamba2-1.2b"):
    cfg = configs.get_config(arch).reduced()
    params = jax_make_lm_model(jconfigs.get_config(arch).reduced()).init(
        jax.random.PRNGKey(0))
    return cfg, jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("fault,error,match", [
    ("extra", KeyError, "no counterpart in Zamba2"),
    ("missing", ValueError, "missing from the reference tree"),
    ("shape", ValueError, r"\('final_norm',\): shape \(65,\)"),
    ("stack", ValueError, "does not stack 2 layers"),
    ("twice", ValueError, r"\('alias',\) written twice"),
])
def test_load_lm_params_errors(fault, error, match):
    cfg, tree = _ref_tree()
    model = make_lm_model(cfg, device="cpu")
    if fault == "extra":
        tree["shared"]["attn"]["bogus"] = np.zeros(3, np.float32)
    elif fault == "missing":
        del tree["shared"]["mlp"]["w_up"]
    elif fault == "shape":
        tree["final_norm"] = np.ones(65, np.float32)
    elif fault == "stack":
        tree["mamba"]["ln"] = tree["mamba"]["ln"][:1]
    else:      # a second path to one buffer
        model.__dict__["alias"] = model.final_norm
        tree["alias"] = tree["final_norm"]
    with pytest.raises(error, match=match):
        load_lm_params(model, tree)


def test_load_lm_params_writes_every_layer():
    cfg, tree = _ref_tree("whisper-small")
    m = load_lm_params(make_lm_model(cfg, device="cpu"), tree)
    for i in range(cfg.encoder_layers):
        np.testing.assert_array_equal(m.encoder[i].attn.wq.numpy(),
                                      tree["encoder"]["attn"]["wq"][i])
    for i in range(cfg.n_layers):
        np.testing.assert_array_equal(m.decoder[i].xattn.wo.numpy(),
                                      tree["decoder"]["xattn"]["wo"][i])
    assert m.decoder[0].attn.freqs.shape == (cfg.hd // 2,)


# ---------------------------------------------------------------------------
# the port's own init
# ---------------------------------------------------------------------------

ONES = {"ln", "ln1", "ln2", "ln_x", "ln_y", "ln_in", "final_norm",
        "enc_norm", "dec_norm", "q_norm", "k_norm", "d_skip"}
CONST = {"mu": 0.5, "mu_c": 0.5, "w_base": -2.0, "w_lora_b": 0.0, "u": 0.0,
         "a_log": 0.0, "dt_bias": 0.0, "b_in": 0.0, "b_out": 0.0}
SCALE = {"embed": 0.02, "lm_head": 0.02, "pos_dec": 0.01}
FP32 = {"router", "a_log", "dt_bias"}


@pytest.mark.parametrize("arch", ["qwen3-4b", "phi3.5-moe-42b-a6.6b",
                                  "rwkv6-7b", "zamba2-1.2b",
                                  "whisper-small", "pixtral-12b"])
def test_init_draws_the_reference_distributions(arch):
    cfg = configs.get_config(arch).reduced(dtype="bfloat16")
    m = make_lm_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    seen = set()
    for name, t in m.state_dict().items():
        leaf = name.rsplit(".", 1)[-1]
        seen.add(leaf)
        assert t.dtype == (torch.float32 if leaf in FP32
                           else torch.bfloat16), name
        t = t.float()
        if leaf in ONES:
            assert (t == 1).all(), name
        elif leaf in CONST:
            assert (t == CONST[leaf]).all(), name
        else:       # N(0, 1) x 1/sqrt(fan_in), fan_in the "in" axis
            want = SCALE.get(leaf, float(1 / np.sqrt(t.shape[-2])))
            assert abs(float(t.std()) / want - 1) < 0.1, name
            assert abs(float(t.mean())) < 0.1 * want, name
    again = make_lm_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    other = make_lm_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(1))
    for name, t in m.state_dict().items():
        assert torch.equal(t, again.state_dict()[name]), name
    assert not torch.equal(m.embed, other.embed)
    # the port's tree has the reference's leaves
    ref = jax.eval_shape(lambda: jax_make_lm_model(
        jconfigs.get_config(arch).reduced()).init(jax.random.PRNGKey(0)))
    ref_leaves = {str(getattr(p[-1], "key", p[-1]))
                  for p, _ in jax.tree_util.tree_leaves_with_path(ref)}
    assert seen == ref_leaves


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

LINE = re.compile(r"^\[serve\] smollm-360m \(reduced\): generated \(2, 12\) "
                  r"tokens; head: \[\d+, \d+, \d+, \d+\]$")


def test_serve_lm_prints_the_reference_line(capsys, monkeypatch):
    flags = ["--mode", "lm", "--arch", "smollm-360m", "--batch", "2",
             "--max-new", "4"]
    cli.main([*flags, "--device", "cpu"])
    got = capsys.readouterr().out.strip().splitlines()
    monkeypatch.setattr(sys, "argv", ["serve", *flags])
    jax_cli.main()
    want = capsys.readouterr().out.strip().splitlines()
    assert len(got) == 1 and LINE.match(got[0]), got
    assert LINE.match(want[-1]), want
    # the line is the port's own generation from seeds 0 and 1
    cfg = configs.get_config("smollm-360m").reduced()
    m = make_lm_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    prompt = torch.randint(0, cfg.vocab, (2, 8),
                           generator=torch.Generator().manual_seed(1))
    head = generate(m, prompt, max_new=4)[0, 8:14].tolist()
    assert got[0].endswith(f"head: {head}")


@pytest.mark.parametrize("family", sorted(FAMILY_ARCH))
def test_lm_entry_points_never_fall_back_to_the_cpu(family, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get_config(FAMILY_ARCH[family]).reduced()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_lm_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--mode", "lm", "--arch", FAMILY_ARCH[family],
                  "--batch", "1", "--max-new", "1"])
    assert make_lm_model(cfg, device="cpu").device == torch.device("cpu")
