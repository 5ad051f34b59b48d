"""RWKV6 "Finch" — attention-free RNN with data-dependent decay (rwkv6-7b).

Counterpart of ``repro.models.lm.rwkv6``: token-shift lerps, r/k/v/g
projections, per-channel decay w_t = exp(−exp(w_base + LoRA(x))) computed
in fp32, the bonus-u WKV recurrence  S_t = diag(w_t)·S_{t−1} + k_tᵀ v_t,
o_t = r_t·(S_{t−1} + u∘k_tᵀ v_t)  with an fp32 state, and the
squared-ReLU channel mix. The recurrence is a Python loop over time (the
reference's ``lax.scan``). Prefill and decode both run ``forward`` on the
cache's state, which is updated in place: O(1) in sequence length.
``loss`` carries each layer's state as a new tensor instead (autograd
keeps what it read), from zeros, rematerialising each layer with
``cfg.remat``. ``shard`` is called where the reference calls it; the
family has no attention, so no ``decode_ctx``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import resolve_device

from . import layers as L
from .config import LMConfig

LORA_R = 32

_LINEARS = ("wr", "wk", "wv", "wg", "wo", "w_lora_a", "wck", "wcv", "wcr")


class RWKVLayer(nn.Module):
    def __init__(self, cfg: LMConfig, h: int, hd: int, *, device, dtype):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        L.add_buffers(
            self, device, dtype, ln1=(d,), ln2=(d,),
            mu=(5, d),                                   # r,k,v,g,w shifts
            wr=(d, d), wk=(d, d), wv=(d, d), wg=(d, d), wo=(d, d),
            w_base=(d,), w_lora_a=(d, LORA_R), w_lora_b=(LORA_R, d),
            u=(h, hd), ln_x=(d,),                        # post-wkv norm
            mu_c=(2, d),                                 # channel-mix k,r
            wck=(d, f), wcv=(f, d), wcr=(d, d))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for name in ("ln1", "ln2", "ln_x"):
            getattr(self, name).fill_(1)
        self.mu.fill_(0.5)
        self.mu_c.fill_(0.5)
        for name in _LINEARS:
            w = getattr(self, name)
            L.normal_(w, generator, float(1.0 / np.sqrt(w.shape[0])))
        self.w_base.fill_(-2.0)
        self.w_lora_b.zero_()
        self.u.zero_()


class RWKV6(L.LMParams, nn.Module):
    def __init__(self, cfg: LMConfig, shard: L.Shard | None = None, *,
                 device=None):
        super().__init__()
        self.cfg = cfg
        self.shard = shard or L.no_shard
        self.device = resolve_device(device, meta=True)
        self.dtype = L.torch_dtype(cfg.dtype)
        self.hd = cfg.ssm_head_dim
        self.n_heads_tm = cfg.d_model // self.hd
        L.add_buffers(self, self.device, self.dtype,
                      embed=(cfg.vocab, cfg.d_model),
                      final_norm=(cfg.d_model,),
                      lm_head=(cfg.d_model, cfg.vocab))
        self.layers = nn.ModuleList(
            RWKVLayer(cfg, self.n_heads_tm, self.hd, device=self.device,
                      dtype=self.dtype) for _ in range(cfg.n_layers))

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "RWKV6":
        L.normal_(self.embed, generator, 0.02)
        for layer in self.layers:
            layer.reset_parameters(generator)
        self.final_norm.fill_(1)
        L.normal_(self.lm_head, generator, 0.02)
        return self

    # -- pieces ---------------------------------------------------------------
    def _decay(self, layer, xw):
        """Data-dependent per-channel decay in (0, 1), fp32."""
        lo = torch.tanh(xw @ layer.w_lora_a) @ layer.w_lora_b
        return torch.exp(-torch.exp((layer.w_base + lo).float()))

    def _wkv_scan(self, r, k, v, w, u, state):
        """Recurrence over time.

        r/k/v/w: (b, s, h, hd); u: (h, hd); state: (b, h, hd, hd) fp32.
        Returns (out (b, s, h, hd) fp32, final state).
        """
        S = state
        outs = []
        for t in range(r.shape[1]):
            r_t, k_t, v_t, w_t = r[:, t], k[:, t], v[:, t], w[:, t]
            kv = k_t[..., :, None] * v_t[..., None, :]     # (b, h, hd, hd)
            o = torch.matmul(r_t.float()[..., None, :],
                             S + u[None, :, :, None] * kv)[..., 0, :]
            S = w_t[..., :, None] * S + kv
            outs.append(o)
        return torch.stack(outs, dim=1), S

    def _time_mix(self, layer, x, x_prev, state):
        """x (b, s, d); x_prev (b, d) last token of the previous segment."""
        b, s, d = x.shape
        h, hd = self.n_heads_tm, self.hd
        xs = torch.cat([x_prev[:, None, :], x[:, :-1, :]], dim=1)
        mu = layer.mu
        xr, xk, xv, xg, xw = (x + mu[i] * (xs - x) for i in range(5))
        r = (xr @ layer.wr).reshape(b, s, h, hd)
        k = (xk @ layer.wk).reshape(b, s, h, hd)
        v = (xv @ layer.wv).reshape(b, s, h, hd)
        g = xg @ layer.wg
        w = self._decay(layer, xw).reshape(b, s, h, hd).to(x.dtype)
        out, state = self._wkv_scan(r, k, v, w, layer.u, state)
        out = out.reshape(b, s, d).to(x.dtype)       # state math stays fp32
        out = L.rms_norm(out, layer.ln_x)
        out = (out * F.silu(g)) @ layer.wo
        return self.shard(out, ("batch", "seq", "embed")), x[:, -1, :], state

    def _channel_mix(self, layer, x, x_prev):
        xs = torch.cat([x_prev[:, None, :], x[:, :-1, :]], dim=1)
        mu = layer.mu_c
        xk = x + mu[0] * (xs - x)
        xr = x + mu[1] * (xs - x)
        kk = self.shard(torch.square(torch.relu(xk @ layer.wck)),
                        ("batch", "seq", "mlp"))
        out = torch.sigmoid(xr @ layer.wcr) * (kk @ layer.wcv)
        return self.shard(out, ("batch", "seq", "embed")), x[:, -1, :]

    def _block(self, layer, x, st):
        h1, tm_prev, tm_state = self._time_mix(
            layer, L.rms_norm(x, layer.ln1), st["tm_prev"], st["tm_state"])
        x = x + h1
        h2, cm_prev = self._channel_mix(
            layer, L.rms_norm(x, layer.ln2), st["cm_prev"])
        x = x + h2
        return x, {"tm_prev": tm_prev, "tm_state": tm_state,
                   "cm_prev": cm_prev}

    def _zero_state(self, b):
        cfg = self.cfg
        h, hd = self.n_heads_tm, self.hd
        zeros = lambda shape, dt: torch.zeros(shape, dtype=dt,
                                              device=self.device)
        return {
            "tm_prev": zeros((b, cfg.d_model), self.dtype),
            "tm_state": zeros((b, h, hd, hd), torch.float32),
            "cm_prev": zeros((b, cfg.d_model), self.dtype),
        }

    # -- public ---------------------------------------------------------------
    def _embed(self, tokens):
        return self.shard(L.take_rows(self.embed, tokens),
                          ("batch", "seq", "embed"))

    def _layers(self, x, state):
        """``x`` through every layer from ``state`` (stacked per layer, as
        ``init_cache``; None: zeros). Returns x and each layer's new
        state, a list; nothing is written in place."""
        new = []
        for i, layer in enumerate(self.layers):
            st = (self._zero_state(x.shape[0]) if state is None
                  else {k: v[i] for k, v in state.items()})
            x, st = L.remat(self._block, layer, x, st,
                            enabled=self.cfg.remat)
            new.append(st)
        return x, new

    def hidden(self, tokens, state=None):
        """Final hidden states (pre-norm, pre-head) and the state after
        ``tokens``, stacked per layer. A given ``state`` (a serving cache)
        is updated in place; None starts from zeros and stacks a new
        one."""
        x, new = self._layers(self._embed(tokens), state)
        if state is None:
            return x, {k: torch.stack([st[k] for st in new]) for k in new[0]}
        for i, st in enumerate(new):
            for key, val in st.items():
                state[key][i] = val
        return x, state

    def forward(self, tokens, state=None, return_state=False):
        x, state = self.hidden(tokens, state)
        logits = self.shard(L.rms_norm(x, self.final_norm) @ self.lm_head,
                            ("batch", "seq", "vocab"))
        if return_state:
            return logits, state
        return logits

    def loss(self, batch: dict) -> torch.Tensor:
        tokens = batch["tokens"]
        x, _ = self._layers(self._embed(tokens), None)
        return L.chunked_ce_loss(x, self.final_norm, self.lm_head, tokens,
                                 shard=self.shard)

    # -- serving ----------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int) -> dict:
        del max_len  # O(1) state!
        return {k: z.expand(self.cfg.n_layers, *z.shape).clone()
                for k, z in self._zero_state(batch).items()}

    @torch.no_grad()
    def prefill(self, tokens, cache):
        logits, state = self.forward(tokens, state=cache, return_state=True)
        return logits[:, -1], state

    @torch.no_grad()
    def decode_step(self, tokens, cache):
        logits, state = self.forward(tokens, state=cache, return_state=True)
        return logits[:, 0], state
