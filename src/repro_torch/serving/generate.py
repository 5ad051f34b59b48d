"""LM generation driver: prefill + greedy/temperature decode over any
architecture exposing (init_cache, prefill, decode_step).

Counterpart of ``repro.serving.generate``, with its family branches.
Greedy decoding takes ``argmax`` (the first index on ties, as
``jnp.argmax``). Sampling draws from ``softmax(logits / T)`` with the
caller's ``torch.Generator``: reproducible for a seed, not bitwise the
reference's ``jax.random.categorical``. Every step stays on the model's
device; nothing waits for the host.
"""

from __future__ import annotations

import torch

__all__ = ["generate"]


@torch.no_grad()
def generate(model, tokens, *, max_new: int = 32, temperature: float = 0.0,
             generator: torch.Generator | None = None, **prefill_kwargs):
    """tokens (b, s) -> (b, s + max_new). Greedy when temperature == 0."""
    b, s = tokens.shape
    cfg = model.cfg
    if cfg.family == "encdec":
        frames = prefill_kwargs["frames"]
        cache = model.init_cache(b, s + max_new, frames.shape[1])
        logits, cache = model.prefill(tokens, frames, cache)
    elif cfg.family == "ssm":
        cache = model.init_cache(b, 0)
        logits, cache = model.prefill(tokens, cache)
    elif cfg.family == "vlm" and "patch_embeds" in prefill_kwargs:
        patch_embeds = prefill_kwargs["patch_embeds"]
        cache = model.init_cache(b, patch_embeds.shape[1] + s + max_new)
        logits, cache = model.prefill(tokens, cache,
                                      patch_embeds=patch_embeds)
    else:
        cache = model.init_cache(b, s + max_new)
        logits, cache = model.prefill(tokens, cache)

    out = [tokens]
    for i in range(max_new):
        if temperature > 0:
            probs = torch.softmax(logits.float() / temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=generator)
        else:
            nxt = torch.argmax(logits, dim=-1)[:, None]
        nxt = nxt.to(tokens.dtype)
        out.append(nxt)
        if i < max_new - 1:
            logits, cache = model.decode_step(nxt, cache)
    return torch.cat(out, dim=1)
