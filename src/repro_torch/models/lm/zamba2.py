"""Zamba2 hybrid — Mamba2 backbone with a *shared* attention block applied
after every full chunk of N layers (zamba2-1.2b: 38 mamba layers, shared
block every 6, so 6 applications and none after the last 2 layers).

Counterpart of ``repro.models.lm.zamba2``. Mamba2 block (SSD form, one
B/C group): in-proj → short causal depthwise conv (a sum of shifted
slices) → selective state-space recurrence with per-head scalar decay
``exp(dt·A)``, ``dt = softplus(dt + dt_bias)`` and ``A = −exp(a_log)`` in
fp32, over a (head_dim × ssm_state) fp32 state → gated RMS-norm →
out-proj. The recurrence is a Python loop over time. The shared block
takes ``concat(h, x_embed)`` projected back to d_model; it has one set of
weights but its own KV cache at each application. A serving cache's
states are updated in place; ``loss`` (from zero Mamba states, each Mamba
layer rematerialised with ``cfg.remat``, as the reference's scan step)
carries them as new tensors. ``shard`` is called where the reference
calls it; a ``decode_ctx`` runs the shared block's decode attention
through ``layers.flash_decode_sharded`` over its placed KV caches.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import resolve_device

from . import layers as L
from .config import LMConfig


class MambaLayer(nn.Module):
    def __init__(self, cfg: LMConfig, d_in: int, n_heads: int,
                 conv_dim: int, *, device, dtype):
        super().__init__()
        d, n = cfg.d_model, cfg.ssm_state
        proj_out = 2 * d_in + 2 * n + n_heads        # z, x, B, C, dt
        L.add_buffers(self, device, dtype, ln=(d,), w_in=(d, proj_out),
                      conv_w=(cfg.conv_kernel, conv_dim), d_skip=(n_heads,),
                      ln_y=(d_in,), w_out=(d_in, d))
        L.add_buffers(self, device, torch.float32, a_log=(n_heads,),
                      dt_bias=(n_heads,))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.ln.fill_(1)
        L.normal_(self.w_in, generator,
                  float(1.0 / np.sqrt(self.w_in.shape[0])))
        L.normal_(self.conv_w, generator,
                  float(1.0 / np.sqrt(self.conv_w.shape[0])))
        self.a_log.zero_()
        self.dt_bias.zero_()
        self.d_skip.fill_(1)
        self.ln_y.fill_(1)
        L.normal_(self.w_out, generator,
                  float(1.0 / np.sqrt(self.w_out.shape[0])))


class SharedBlock(nn.Module):
    """``ln_in`` (2d), ``w_in`` (2d, d), ``ln1``, ``ln2``, ``attn``, SwiGLU
    ``mlp``."""

    def __init__(self, cfg: LMConfig, dims: L.AttnDims, *, device, dtype):
        super().__init__()
        d = cfg.d_model
        L.add_buffers(self, device, dtype, ln_in=(2 * d,), w_in=(2 * d, d),
                      ln1=(d,), ln2=(d,))
        self.attn = L.Attention(dims, device=device, dtype=dtype)
        self.mlp = L.SwiGLU(d, cfg.d_ff, device=device, dtype=dtype)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for ln in (self.ln_in, self.ln1, self.ln2):
            ln.fill_(1)
        L.normal_(self.w_in, generator,
                  float(1.0 / np.sqrt(self.w_in.shape[0])))
        self.attn.reset_parameters(generator)
        self.mlp.reset_parameters(generator)


class Zamba2(L.LMParams, nn.Module):
    def __init__(self, cfg: LMConfig, shard: L.Shard | None = None, *,
                 device=None):
        super().__init__()
        self.cfg = cfg
        self.shard = shard or L.no_shard
        self.decode_ctx: L.DecodeShardCtx | None = None
        self.device = resolve_device(device, meta=True)
        self.dtype = L.torch_dtype(cfg.dtype)
        self.d_in = cfg.ssm_expand * cfg.d_model
        self.hd = cfg.ssm_head_dim
        self.n_heads_m = self.d_in // self.hd
        self.conv_dim = self.d_in + 2 * cfg.ssm_state
        self.attn_dims = L.AttnDims(
            n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.d_model // cfg.n_heads, d_model=cfg.d_model,
            rope_theta=cfg.rope_theta)
        L.add_buffers(self, self.device, self.dtype,
                      embed=(cfg.vocab, cfg.d_model),
                      final_norm=(cfg.d_model,),
                      lm_head=(cfg.d_model, cfg.vocab))
        self.mamba = nn.ModuleList(
            MambaLayer(cfg, self.d_in, self.n_heads_m, self.conv_dim,
                       device=self.device, dtype=self.dtype)
            for _ in range(cfg.n_layers))
        if self.n_shared():
            self.shared = SharedBlock(cfg, self.attn_dims,
                                      device=self.device, dtype=self.dtype)

    # chunk boundaries between shared-attention applications
    def chunks(self) -> list[tuple[int, int]]:
        cfg = self.cfg
        if not cfg.shared_attn_every:
            return [(0, cfg.n_layers)]
        out, a = [], 0
        while a < cfg.n_layers:
            b = min(a + cfg.shared_attn_every, cfg.n_layers)
            out.append((a, b))
            a = b
        return out

    def n_shared(self) -> int:
        cfg = self.cfg
        if not cfg.shared_attn_every:
            return 0
        return sum(1 for (a, b) in self.chunks()
                   if b - a == cfg.shared_attn_every)

    def _shared_after(self, a: int, b: int) -> bool:
        return b - a == self.cfg.shared_attn_every and self.n_shared() > 0

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "Zamba2":
        L.normal_(self.embed, generator, 0.02)
        for layer in self.mamba:
            layer.reset_parameters(generator)
        self.final_norm.fill_(1)
        L.normal_(self.lm_head, generator, 0.02)
        if self.n_shared():
            self.shared.reset_parameters(generator)
        return self

    # -- mamba core -----------------------------------------------------------
    def _split_proj(self, z):
        din, n = self.d_in, self.cfg.ssm_state
        zg = z[..., :din]
        xs = z[..., din:2 * din]
        bb = z[..., 2 * din:2 * din + n]
        cc = z[..., 2 * din + n:2 * din + 2 * n]
        dt = z[..., 2 * din + 2 * n:]
        return zg, xs, bb, cc, dt

    def _conv(self, conv_in, conv_w, conv_state):
        """Causal depthwise conv; returns (out, new_state (b, k-1, C))."""
        k = conv_w.shape[0]
        full = torch.cat([conv_state, conv_in], dim=1)
        s = conv_in.shape[1]
        out = sum(full[:, j:j + s, :] * conv_w[j][None, None, :]
                  for j in range(k))
        return out, full[:, -(k - 1):, :]

    def _ssm_scan(self, xh, bb, cc, dt, a_log, d_skip, state):
        """xh (b,s,h,hd); bb/cc (b,s,n) fp32; dt (b,s,h) fp32; state
        (b,h,hd,n) fp32."""
        a = -torch.exp(a_log)                                # (h,)
        S = state
        ys = []
        for t in range(xh.shape[1]):
            x_t, b_t, c_t, dt_t = xh[:, t], bb[:, t], cc[:, t], dt[:, t]
            decay = torch.exp(dt_t * a[None, :])             # (b,h)
            contrib = (dt_t[..., None, None]
                       * x_t[..., :, None] * b_t[:, None, None, :])
            S = decay[..., None, None] * S + contrib
            ys.append(torch.matmul(S, c_t[:, None, :, None])[..., 0])
        y = torch.stack(ys, dim=1)                           # (b,s,h,hd)
        return y + d_skip[None, None, :, None] * xh, S

    def _mamba_block(self, layer, x, st):
        cfg = self.cfg
        b, s, d = x.shape
        h, hd = self.n_heads_m, self.hd
        xin = L.rms_norm(x, layer.ln)
        z = xin @ layer.w_in
        zg, xs_, bb, cc, dt = self._split_proj(z)
        conv_in = torch.cat([xs_, bb, cc], dim=-1)
        conv_out, conv_state = self._conv(conv_in, layer.conv_w, st["conv"])
        conv_out = F.silu(conv_out)
        xs_, bb, cc = (conv_out[..., :self.d_in],
                       conv_out[..., self.d_in:self.d_in + cfg.ssm_state],
                       conv_out[..., self.d_in + cfg.ssm_state:])
        dt = F.softplus(dt.float() + layer.dt_bias[None, None, :])
        xh = xs_.reshape(b, s, h, hd)
        y, ssm_state = self._ssm_scan(xh, bb.float(), cc.float(), dt,
                                      layer.a_log, layer.d_skip, st["ssm"])
        y = y.reshape(b, s, self.d_in).to(x.dtype)
        y = L.rms_norm(y, layer.ln_y) * F.silu(zg)
        out = self.shard(y @ layer.w_out, ("batch", "seq", "embed"))
        return x + out, {"conv": conv_state, "ssm": ssm_state}

    def _zero_mamba_state(self, b):
        cfg = self.cfg
        return {
            "conv": torch.zeros((b, cfg.conv_kernel - 1, self.conv_dim),
                                dtype=self.dtype, device=self.device),
            "ssm": torch.zeros((b, self.n_heads_m, self.hd, cfg.ssm_state),
                               dtype=torch.float32, device=self.device),
        }

    def _mamba_layers(self, x, states, a, b):
        """Layers [a, b) from ``states`` (stacked per layer; None: zeros).
        Returns x and the layers' new states, a list; nothing is written
        in place."""
        new = []
        for i in range(a, b):
            st = (self._zero_mamba_state(x.shape[0]) if states is None
                  else {k: v[i] for k, v in states.items()})
            x, st = L.remat(self._mamba_block, self.mamba[i], x, st,
                            enabled=self.cfg.remat)
            new.append(st)
        return x, new

    @staticmethod
    def _store_states(states, a: int, new: list) -> None:
        """Write layers [a, a + len(new))'s new states into the stacked
        ``states`` (a serving cache) in place."""
        for j, st in enumerate(new):
            for key, val in st.items():
                states[key][a + j] = val

    # -- shared attention block -------------------------------------------------
    def _shared_block(self, p, x, x0, kv=None, idx=None):
        """Full-seq when kv is None; cached decode otherwise."""
        h = torch.cat([x, x0], dim=-1)
        h = L.rms_norm(h, p.ln_in) @ p.w_in
        a_in = L.rms_norm(h, p.ln1)
        if kv is None:
            attn = L.attention(p.attn, self.attn_dims, a_in,
                               shard=self.shard, causal=True)
        else:
            attn, _, _ = L.attention_decode(
                p.attn, self.attn_dims, a_in, kv[0], kv[1], idx,
                shard=self.shard, decode_ctx=self.decode_ctx)
        h = h + attn
        h = h + L.swiglu(p.mlp, L.rms_norm(h, p.ln2), self.shard)
        return x + h

    # -- forward ----------------------------------------------------------------
    def _run(self, x, states, shared_kv=None, idx=None):
        """``states``: stacked (L, ...) mamba states, updated in place, or
        None for zeros; ``shared_kv``: the n_shared k/v caches (decode at
        ``idx``, written in place) or None for full-sequence attention."""
        x0 = x
        si = 0
        for (a, b) in self.chunks():
            x, new = self._mamba_layers(x, states, a, b)
            if states is not None:
                self._store_states(states, a, new)
            if self._shared_after(a, b):
                kv = None if shared_kv is None else (shared_kv["k"][si],
                                                     shared_kv["v"][si])
                x = self._shared_block(self.shared, x, x0, kv=kv, idx=idx)
                si += 1
        return x

    def _embed(self, tokens):
        return self.shard(L.take_rows(self.embed, tokens),
                          ("batch", "seq", "embed"))

    def forward(self, tokens, positions=None):
        x = self._run(self._embed(tokens), None)
        return self.shard(L.rms_norm(x, self.final_norm) @ self.lm_head,
                          ("batch", "seq", "vocab"))

    def loss(self, batch: dict) -> torch.Tensor:
        tokens = batch["tokens"]
        x = self._run(self._embed(tokens), None)
        return L.chunked_ce_loss(x, self.final_norm, self.lm_head, tokens,
                                 shard=self.shard)

    # -- serving ----------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int) -> dict:
        cfg = self.cfg
        cache = {
            "mamba": {k: z.expand(cfg.n_layers, *z.shape).clone()
                      for k, z in self._zero_mamba_state(batch).items()},
            "index": 0,
        }
        ns = self.n_shared()
        if ns:
            kv_shape = (ns, batch, max_len, cfg.n_kv_heads,
                        self.attn_dims.head_dim)
            cache["shared"] = {
                "k": torch.zeros(kv_shape, dtype=self.dtype,
                                 device=self.device),
                "v": torch.zeros(kv_shape, dtype=self.dtype,
                                 device=self.device)}
        return cache

    @torch.no_grad()
    def prefill(self, tokens, cache):
        """Full-sequence mamba + full attention, writing each shared-block
        application's k/v at positions [0, s) of its cache (the rest
        zeroed)."""
        b, s = tokens.shape
        x = L.take_rows(self.embed, tokens)
        x0 = x
        states = cache["mamba"]
        if self.n_shared() and s > cache["shared"]["k"].shape[2]:
            raise ValueError(f"a prefill of {s} positions does not fit the "
                             f"cache's {cache['shared']['k'].shape[2]}")
        positions = torch.arange(s, dtype=torch.int32, device=x.device)[None]
        si = 0
        for (a, bnd) in self.chunks():
            x, new = self._mamba_layers(x, states, a, bnd)
            self._store_states(states, a, new)
            if self._shared_after(a, bnd):
                p = self.shared
                h = torch.cat([x, x0], dim=-1)
                h = L.rms_norm(h, p.ln_in) @ p.w_in
                a_in = L.rms_norm(h, p.ln1)
                q, k, v = L._qkv(p.attn, self.attn_dims, a_in, positions,
                                 shard=self.shard)
                attn = L._attend(q, k, v, causal=True)
                h = h + attn.reshape(b, s, -1) @ p.attn.wo
                h = h + L.swiglu(p.mlp, L.rms_norm(h, p.ln2), self.shard)
                x = x + h
                cache["shared"]["k"][si, :, :s] = k
                cache["shared"]["v"][si, :, :s] = v
                si += 1
        if si:
            cache["shared"]["k"][:, :, s:] = 0
            cache["shared"]["v"][:, :, s:] = 0
        x = L.rms_norm(x, self.final_norm)
        cache["index"] = s
        return (x[:, -1:, :] @ self.lm_head)[:, 0], cache

    @torch.no_grad()
    def decode_step(self, tokens, cache):
        idx = cache["index"]
        if self.decode_ctx is not None and "shared" in cache:
            L.place_kv(cache["shared"], ("k", "v"), self.decode_ctx)
        x = L.take_rows(self.embed, tokens)
        x = self._run(x, cache["mamba"], shared_kv=cache.get("shared"),
                      idx=idx)
        x = L.rms_norm(x, self.final_norm)
        cache["index"] = idx + 1
        return (x @ self.lm_head)[:, 0], cache
