"""Dense GQA decoder-only transformer (granite / smollm / llama3 / qwen3 and
the pixtral text backbone).

Counterpart of ``repro.models.lm.transformer``: an ``nn.Module`` owning
its tensors, the layers an ``nn.ModuleList`` run in a Python loop. The
methods drop the reference's ``params`` argument. A cache is a dict with
the reference's keys and shapes; ``index`` is a Python int, so a decode
step needs no host sync, and prefill and decode write their rows into the
cache in place and return it, without autograd. ``loss`` trains through
``param_tree()``; with ``cfg.remat`` each layer is rematerialised.

``shard`` is called where the reference calls it (``layers``). Set
``decode_ctx`` to a ``layers.DecodeShardCtx`` for the sequence-parallel
decode: ``decode_step`` then places the cache's ``k``/``v`` over its
mesh (``layers.place_kv``) and attends through
``layers.flash_decode_sharded``. Set ``tp`` to a
``distributed.tensor_parallel.TensorParallel`` over this model's tensors
(``Cell.place_params``) and ``prefill``, ``decode_step`` and ``loss``
run on the split weights: the embedding returns a ``Rows`` and the layer
functions take that path.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.distributed.tensor_parallel import Rows, TensorParallel

from . import layers as L
from .config import LMConfig


class DenseLayer(nn.Module):
    """``ln1``, ``attn``, ``ln2`` and a SwiGLU ``mlp``."""

    def __init__(self, cfg: LMConfig, dims: L.AttnDims, *, device, dtype):
        super().__init__()
        L.add_buffers(self, device, dtype, ln1=(cfg.d_model,),
                      ln2=(cfg.d_model,))
        self.attn = L.Attention(dims, device=device, dtype=dtype)
        self.mlp = L.SwiGLU(cfg.d_model, cfg.d_ff, device=device,
                            dtype=dtype)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.ln1.fill_(1)
        self.ln2.fill_(1)
        self.attn.reset_parameters(generator)
        self.mlp.reset_parameters(generator)


class DenseTransformer(L.LMParams, nn.Module):
    def __init__(self, cfg: LMConfig, shard: L.Shard | None = None, *,
                 device=None):
        super().__init__()
        self.cfg = cfg
        self.shard = shard or L.no_shard
        self.decode_ctx: L.DecodeShardCtx | None = None
        self.tp: TensorParallel | None = None
        self.device = resolve_device(device, meta=True)
        self.dtype = L.torch_dtype(cfg.dtype)
        self.dims = L.AttnDims(
            n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
            d_model=cfg.d_model, qk_norm=cfg.qk_norm,
            rope_theta=cfg.rope_theta)
        L.add_buffers(self, self.device, self.dtype,
                      embed=(cfg.vocab, cfg.d_model),
                      final_norm=(cfg.d_model,))
        if not cfg.tie_embeddings:
            L.add_buffers(self, self.device, self.dtype,
                          lm_head=(cfg.d_model, cfg.vocab))
        self.layers = nn.ModuleList(self.init_layer()
                                    for _ in range(cfg.n_layers))

    # -- init -----------------------------------------------------------------
    def init_layer(self) -> nn.Module:
        """One layer's module (its tensors are drawn by ``init``)."""
        return DenseLayer(self.cfg, self.dims, device=self.device,
                          dtype=self.dtype)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "DenseTransformer":
        """Draw every tensor from ``generator`` with the reference's
        distributions (embeddings and head × 0.02, norms ones). Returns
        the model."""
        L.normal_(self.embed, generator, 0.02)
        for layer in self.layers:
            layer.reset_parameters(generator)
        self.final_norm.fill_(1)
        if not self.cfg.tie_embeddings:
            L.normal_(self.lm_head, generator, 0.02)
        return self

    # -- blocks ---------------------------------------------------------------
    def _block(self, x, layer, positions):
        h = L.rms_norm(x, layer.ln1)
        h = L.attention(layer.attn, self.dims, h, shard=self.shard,
                        causal=True, positions=positions)
        x = x + h
        h = L.rms_norm(x, layer.ln2)
        return x + self._mlp(layer, h)

    def _mlp(self, layer, h):
        return L.swiglu(layer.mlp, h, self.shard)

    def _run_layers(self, x, positions):
        for layer in self.layers:
            x = L.remat(self._block, x, layer, positions,
                        enabled=self.cfg.remat)
        return x

    def _head(self, x):
        x = L.rms_norm(x, self.final_norm)
        if isinstance(x, Rows):
            tied = self.cfg.tie_embeddings
            return x.tp.head(x, self.embed if tied else self.lm_head,
                             transposed=tied)
        return self.shard(x @ self.head_weight(), ("batch", "seq", "vocab"))

    # -- public ---------------------------------------------------------------
    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        if self.tp is not None:
            return self.tp.embed(self.embed, tokens)
        return self.shard(L.take_rows(self.embed, tokens),
                          ("batch", "seq", "embed"))

    def forward(self, tokens, positions=None):
        """tokens (b, s) -> logits (b, s, v)."""
        return self.forward_from_x(self.embed_tokens(tokens), positions)

    def forward_from_x(self, x, positions=None):
        """Pre-embedded entry (VLM/audio frontends inject here)."""
        if positions is None:
            positions = torch.arange(x.shape[1], dtype=torch.int32,
                                     device=x.device)[None]
        return self._head(self._run_layers(x, positions))

    def head_weight(self) -> torch.Tensor:
        return self.embed.T if self.cfg.tie_embeddings else self.lm_head

    def loss(self, batch: dict) -> torch.Tensor:
        """Sequence-chunked CE — full (b, s, v) logits never materialize."""
        tokens = batch["tokens"]
        x = self.embed_tokens(tokens)
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=x.device)[None]
        x = self._run_layers(x, positions)
        return self._ce(x, tokens)

    def _ce(self, x, tokens):
        """``layers.chunked_ce_loss`` over the final norm and the head (a
        tied head as the embedding table read transposed)."""
        tied = self.cfg.tie_embeddings
        return L.chunked_ce_loss(x, self.final_norm,
                                 self.embed if tied else self.lm_head,
                                 tokens, shard=self.shard, transposed=tied)

    # -- serving ----------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int) -> dict:
        cfg = self.cfg
        shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
        return {
            "k": torch.zeros(shape, dtype=self.dtype, device=self.device),
            "v": torch.zeros(shape, dtype=self.dtype, device=self.device),
            "index": 0,
        }

    @torch.no_grad()
    def prefill(self, tokens, cache):
        """Full-sequence forward that also fills positions [0, s) of the
        cache (the rest zeroed). Returns (last-position logits (b, v),
        cache)."""
        return self.prefill_from_x(self.embed_tokens(tokens), cache)

    @torch.no_grad()
    def prefill_from_x(self, x, cache):
        s = x.shape[1]
        s_max = cache["k"].shape[2]
        if s > s_max:
            raise ValueError(f"a prefill of {s} positions does not fit the "
                             f"cache's {s_max}")
        positions = torch.arange(s, dtype=torch.int32, device=x.device)[None]
        for i, layer in enumerate(self.layers):
            h = L.rms_norm(x, layer.ln1)
            q, k, v = L._qkv(layer.attn, self.dims, h, positions,
                             shard=self.shard)
            attn = L._attend(q, k, v, causal=True)
            x = x + L._out(layer.attn, attn, self.shard)
            h = L.rms_norm(x, layer.ln2)
            x = x + self._mlp(layer, h)
            cache["k"][i, :, :s] = L.whole(k)
            cache["v"][i, :, :s] = L.whole(v)
        cache["k"][:, :, s:] = 0
        cache["v"][:, :, s:] = 0
        cache["index"] = s
        return self._head(x[:, -1:, :])[:, 0], cache

    @torch.no_grad()
    def decode_step(self, tokens, cache):
        """tokens (b, 1) + cache -> (logits (b, v), cache one row on)."""
        idx = cache["index"]
        if self.decode_ctx is not None:
            L.place_kv(cache, ("k", "v"), self.decode_ctx)
        x = self.embed_tokens(tokens)
        for i, layer in enumerate(self.layers):
            h = L.rms_norm(x, layer.ln1)
            out, _, _ = L.attention_decode(
                layer.attn, self.dims, h, cache["k"][i], cache["v"][i], idx,
                shard=self.shard, decode_ctx=self.decode_ctx)
            x = x + out
            h = L.rms_norm(x, layer.ln2)
            x = x + self._mlp(layer, h)
        cache["index"] = idx + 1
        return self._head(x)[:, 0], cache
