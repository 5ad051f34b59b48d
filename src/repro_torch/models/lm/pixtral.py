"""Pixtral-12B backbone — mistral-nemo-style decoder with a vision-token
prefix.

Counterpart of ``repro.models.lm.pixtral``. The ViT frontend is a stub,
as in the reference: the caller supplies precomputed patch embeddings
(b, s_img, d_model), concatenated ahead of the text embeddings; everything
downstream is the dense GQA decoder (explicit head_dim = 128 ≠
d_model / n_heads).
"""

from __future__ import annotations

import torch

from repro_torch.distributed.tensor_parallel import Rows

from .transformer import DenseTransformer


class Pixtral(DenseTransformer):
    """DenseTransformer consuming [patch_embeds; text tokens]."""

    def fuse_inputs(self, tokens, patch_embeds):
        """(b, s_txt) tokens + (b, s_img, d) patches -> (b, s_img+s_txt, d)."""
        tx = self.embed_tokens(tokens)
        if isinstance(tx, Rows):
            return tx.tp.split_rows(patch_embeds.to(tx.dtype)).map(
                lambda pe, t: torch.cat([pe, t], dim=1), tx)
        return self.shard(torch.cat([patch_embeds.to(tx.dtype), tx], dim=1),
                          ("batch", "seq", "embed"))

    def forward(self, tokens, patch_embeds=None, positions=None):
        if patch_embeds is None:
            return super().forward(tokens, positions)
        return self.forward_from_x(self.fuse_inputs(tokens, patch_embeds),
                                   positions)

    def loss(self, batch: dict) -> torch.Tensor:
        """Sequence-chunked next-token loss on the text region only."""
        pe = batch.get("patch_embeds")
        if pe is None:
            return super().loss(batch)
        x = self.fuse_inputs(batch["tokens"], pe)
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)[None]
        x = self._run_layers(x, positions)
        return self._ce(x[:, pe.shape[1]:], batch["tokens"])

    @torch.no_grad()
    def prefill(self, tokens, cache, patch_embeds=None):
        if patch_embeds is None:
            return super().prefill(tokens, cache)
        return self.prefill_from_x(self.fuse_inputs(tokens, patch_embeds),
                                   cache)
    # decode_step: inherited — text tokens decode against the joint cache.
