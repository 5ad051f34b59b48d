"""Whisper-small backbone — encoder-decoder transformer.

Counterpart of ``repro.models.lm.whisper``. The audio frontend is a stub,
as in the reference: the caller supplies precomputed frame embeddings (b,
s_enc, d). Encoder: bidirectional MHA + tanh-GELU MLP with sinusoidal
positions. Decoder: causal self-attention + cross-attention over the
encoded memory + GELU MLP, learned positions (``pos_dec``, 65,536 rows).
No RoPE anywhere. Prefill fills the self-attention cache and the
cross-attention k/v (``xk``/``xv``) from the memory once. ``loss`` is the
encoder, the decoder's hidden states and ``chunked_ce_loss`` over
``dec_norm`` and ``lm_head``; with ``cfg.remat`` every encoder and decoder
block is rematerialised. ``shard`` is called where the reference calls
it; a ``decode_ctx`` places the self-attention cache and the
cross-attention ``xk``/``xv`` over its mesh and runs both attentions of a
decode step through ``layers.flash_decode_sharded`` (the cross one with
every memory slot visible and no write). A ``tp``
(``distributed.tensor_parallel.TensorParallel``, ``Cell.place_params``)
runs ``prefill`` and ``decode_step`` on split weights, the encoder
blocks, the decoder's self and cross attention and its MLPs by
``_ENCDEC_RULES``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.distributed.tensor_parallel import Rows, TensorParallel

from . import layers as L
from .config import LMConfig

POS_DEC_ROWS = 65536   # sized for the longest assigned decode cell


def sinusoid_positions(s: int, d: int) -> np.ndarray:
    pos = np.arange(s)[:, None]
    i = np.arange(d // 2)[None, :]
    ang = pos / np.power(10_000.0, 2 * i / d)
    return np.concatenate([np.sin(ang), np.cos(ang)], axis=-1).astype(np.float32)


class WhisperBlock(nn.Module):
    """``ln1``, ``attn``, ``ln2``, GELU ``mlp``; a decoder block adds
    ``ln_x`` and the cross-attention ``xattn``."""

    def __init__(self, cfg: LMConfig, dims: L.AttnDims, cross: bool, *,
                 device, dtype):
        super().__init__()
        L.add_buffers(self, device, dtype, ln1=(cfg.d_model,),
                      ln2=(cfg.d_model,))
        self.attn = L.Attention(dims, device=device, dtype=dtype)
        self.mlp = L.GeluMLP(cfg.d_model, cfg.d_ff, device=device,
                             dtype=dtype)
        self.cross = cross
        if cross:
            L.add_buffers(self, device, dtype, ln_x=(cfg.d_model,))
            self.xattn = L.Attention(dims, device=device, dtype=dtype)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.ln1.fill_(1)
        self.ln2.fill_(1)
        self.attn.reset_parameters(generator)
        self.mlp.reset_parameters(generator)
        if self.cross:
            self.ln_x.fill_(1)
            self.xattn.reset_parameters(generator)


class Whisper(L.LMParams, nn.Module):
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
            d_model=cfg.d_model)
        d = cfg.d_model
        L.add_buffers(self, self.device, self.dtype, embed=(cfg.vocab, d),
                      pos_dec=(POS_DEC_ROWS, d), enc_norm=(d,),
                      dec_norm=(d,), lm_head=(d, cfg.vocab))
        block = lambda cross: WhisperBlock(cfg, self.dims, cross,
                                           device=self.device,
                                           dtype=self.dtype)
        self.encoder = nn.ModuleList(block(False)
                                     for _ in range(cfg.encoder_layers))
        self.decoder = nn.ModuleList(block(True)
                                     for _ in range(cfg.n_layers))

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "Whisper":
        L.normal_(self.embed, generator, 0.02)
        L.normal_(self.pos_dec, generator, 0.01)
        for layer in (*self.encoder, *self.decoder):
            layer.reset_parameters(generator)
        self.enc_norm.fill_(1)
        self.dec_norm.fill_(1)
        L.normal_(self.lm_head, generator, 0.02)
        return self

    # -- encoder ----------------------------------------------------------------
    def _enc_block(self, x, layer):
        h = L.rms_norm(x, layer.ln1)
        x = x + L.attention(layer.attn, self.dims, h, shard=self.shard,
                            causal=False, rope=False)
        h = L.rms_norm(x, layer.ln2)
        return x + L.gelu_mlp(layer.mlp, h, self.shard)

    def encode(self, frames):
        """frames (b, s_enc, d) — stub-frontend output — -> memory."""
        _, s, d = frames.shape
        pos = torch.from_numpy(sinusoid_positions(s, d)).to(frames.device,
                                                            frames.dtype)
        if self.tp is not None:
            frames = self.tp.split_rows(frames)
        x = self.shard(frames + pos[None], ("batch", "seq", "embed"))
        for layer in self.encoder:
            x = L.remat(self._enc_block, x, layer, enabled=self.cfg.remat)
        return L.rms_norm(x, self.enc_norm)

    # -- decoder ----------------------------------------------------------------
    def _embed_rows(self, tokens, pos0=0):
        """Token embeddings plus ``pos_dec`` rows [pos0, pos0 + s). Rows
        past the table raise (the reference's ``dynamic_slice_in_dim``
        clamps the start instead)."""
        s = tokens.shape[1]
        if not 0 <= pos0 <= POS_DEC_ROWS - s:
            raise IndexError(f"decoder positions [{pos0}, {pos0 + s}) are "
                             f"outside pos_dec's {POS_DEC_ROWS} rows")
        if self.tp is not None:
            return self.tp.embed(self.embed, tokens).map(
                lambda t, pd: t + pd[pos0:pos0 + s][None], self.pos_dec)
        return (L.take_rows(self.embed, tokens)
                + self.pos_dec[pos0:pos0 + s][None])

    def _embed_dec(self, tokens, pos0=0):
        return self.shard(self._embed_rows(tokens, pos0),
                          ("batch", "seq", "embed"))

    def _dec_block(self, x, layer, memory):
        h = L.rms_norm(x, layer.ln1)
        x = x + L.attention(layer.attn, self.dims, h, shard=self.shard,
                            causal=True, rope=False)
        h = L.rms_norm(x, layer.ln_x)
        x = x + L.attention(layer.xattn, self.dims, h, shard=self.shard,
                            memory=memory, rope=False)
        h = L.rms_norm(x, layer.ln2)
        return x + L.gelu_mlp(layer.mlp, h, self.shard)

    def _decoder_hidden(self, tokens, memory):
        """Teacher-forced decoder hidden states (pre-norm, pre-head)."""
        x = self._embed_dec(tokens)
        for layer in self.decoder:
            x = L.remat(self._dec_block, x, layer, memory,
                        enabled=self.cfg.remat)
        return x

    def decode_full(self, tokens, memory):
        """Teacher-forced decoder (prefill math)."""
        x = self._decoder_hidden(tokens, memory)
        return self.shard(L.rms_norm(x, self.dec_norm) @ self.lm_head,
                          ("batch", "seq", "vocab"))

    def _logits(self, x):
        """``x @ lm_head``, vocab-parallel on a split step."""
        if isinstance(x, Rows):
            return x.tp.head(x, self.lm_head)
        return x @ self.lm_head

    def forward(self, tokens, frames):
        return self.decode_full(tokens, self.encode(frames))

    def loss(self, batch: dict) -> torch.Tensor:
        memory = self.encode(batch["frames"])
        x = self._decoder_hidden(batch["tokens"], memory)
        return L.chunked_ce_loss(x, self.dec_norm, self.lm_head,
                                 batch["tokens"], shard=self.shard)

    # -- serving ----------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, mem_len: int) -> dict:
        cfg = self.cfg
        kv = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
        xkv = (cfg.n_layers, batch, mem_len, cfg.n_kv_heads, cfg.hd)
        zeros = lambda shape: torch.zeros(shape, dtype=self.dtype,
                                          device=self.device)
        return {"k": zeros(kv), "v": zeros(kv), "xk": zeros(xkv),
                "xv": zeros(xkv), "index": 0}

    @torch.no_grad()
    def prefill(self, tokens, frames, cache):
        """Encode + teacher-forced prefix + cache self/cross K/V."""
        s = tokens.shape[1]
        if s > cache["k"].shape[2]:
            raise ValueError(f"a prefill of {s} positions does not fit the "
                             f"cache's {cache['k'].shape[2]}")
        memory = self.encode(frames)
        x = self._embed_dec(tokens)
        positions = torch.arange(s, dtype=torch.int32, device=x.device)[None]
        for i, layer in enumerate(self.decoder):
            h = L.rms_norm(x, layer.ln1)
            q, k, v = L._qkv(layer.attn, self.dims, h, positions, rope=False,
                             shard=self.shard)
            attn = L._attend(q, k, v, causal=True)
            x = x + L._out(layer.attn, attn)
            h = L.rms_norm(x, layer.ln_x)
            qx, xk, xv = L._qkv_cross(layer.xattn, self.dims, h, memory)
            attn = L._attend(qx, xk, xv, causal=False)
            x = x + L._out(layer.xattn, attn)
            h = L.rms_norm(x, layer.ln2)
            x = x + L.gelu_mlp(layer.mlp, h, self.shard)
            cache["k"][i, :, :s] = L.whole(k)
            cache["v"][i, :, :s] = L.whole(v)
            cache["xk"][i] = L.whole(xk)
            cache["xv"][i] = L.whole(xv)
        cache["k"][:, :, s:] = 0
        cache["v"][:, :, s:] = 0
        cache["index"] = s
        x = L.rms_norm(x, self.dec_norm)
        return self._logits(x[:, -1:, :])[:, 0], cache

    @torch.no_grad()
    def decode_step(self, tokens, cache):
        idx = cache["index"]
        ctx = self.decode_ctx
        if ctx is not None:
            L.place_kv(cache, ("k", "v", "xk", "xv"), ctx)
        x = self._embed_rows(tokens, idx)
        for i, layer in enumerate(self.decoder):
            h = L.rms_norm(x, layer.ln1)
            out, _, _ = L.attention_decode(
                layer.attn, self.dims, h, cache["k"][i], cache["v"][i], idx,
                shard=self.shard, rope=False, decode_ctx=ctx)
            x = x + out
            h = L.rms_norm(x, layer.ln_x)
            x = x + L.cross_attention_decode(layer.xattn, self.dims, h,
                                             cache["xk"][i], cache["xv"][i],
                                             ctx)
            h = L.rms_norm(x, layer.ln2)
            x = x + L.gelu_mlp(layer.mlp, h, self.shard)
        cache["index"] = idx + 1
        x = L.rms_norm(x, self.dec_norm)
        return self._logits(x)[:, 0], cache
