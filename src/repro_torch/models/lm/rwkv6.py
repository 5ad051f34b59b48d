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

Set ``tp`` to a ``distributed.tensor_parallel.TensorParallel`` over this
model's tensors (``Cell.place_params``) and ``prefill``/``decode_step``
run on the split weights, the cache's states placed by ``cache_specs``
(``tm_state`` heads over ``model``, ``tm_prev``/``cm_prev`` by batch):
r, k, v and g column-parallel, the decay whole on the row's first
position (its LoRA is FSDP-split) and each site's heads sliced from it,
the WKV scan at ``TensorParallel.head_sites`` on each site's ``u`` and
state slice (``TensorParallel.scan_sites``: a one-row trace scans a
row's sites as one, their inputs joined along the heads), ``ln_x`` over
the whole d from sums of squares joined in model order
(``layers.rms_norm`` of a ``Cols``), ``wo`` row-parallel; in the channel
mix the sigmoid gate's columns join the row-parallel value on the row's
first position. ``loss`` on the split weights (a train cell's
``place_params``) runs the same blocks with no cache (``_block_split``):
each row's token shifts and each head site's scan start from zeros made
where they are read, nothing is written, each layer is rematerialised
with ``cfg.remat``, and the CE is vocab-parallel; the decay reaches each
site through a send, whose gradient comes back.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.distributed.tensor_parallel import (Cols, Rows,
                                                      TensorParallel)

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
        self.tp: TensorParallel | None = None
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
    @staticmethod
    def _decay(xw, w_lora_a, w_lora_b, w_base):
        """Data-dependent per-channel decay in (0, 1), fp32."""
        lo = torch.tanh(xw @ w_lora_a) @ w_lora_b
        return torch.exp(-torch.exp((w_base + lo).float()))

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
        w = self._decay(xw, layer.w_lora_a, layer.w_lora_b,
                        layer.w_base).reshape(b, s, h, hd).to(x.dtype)
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

    # -- split weights ----------------------------------------------------------
    @staticmethod
    def _shifted(x: Rows, prev: list) -> Rows:
        """Each row's ``cat(prev[i], x[:, :-1])`` on its first position,
        ``prev[i]`` (b, d) the token before the row's first."""
        return Rows(x.tp, [torch.cat([p[:, None], part[:, :-1]], dim=1)
                           for p, part in zip(prev, x.parts)])

    @staticmethod
    def _prev(x: Rows, pl) -> list:
        """Each row's token-shift state: its slice of the placed ``pl``
        (B, d) on its first position, or (``pl`` None) zeros there."""
        tp = x.tp
        if pl is None:
            return [p.new_zeros(p.shape[0], p.shape[-1]) for p in x.parts]
        return [tp.state_at(pl, i, row[0], (0, x.shape[-1]))
                for i, row in enumerate(tp.rows)]

    @staticmethod
    def _last(x: Rows) -> list[tuple]:
        """``write_state`` pieces: each row's last token, where it is."""
        b = x.parts[0].shape[0]
        return [(x.tp.rows[i][0], ((i * b, (i + 1) * b),), p[:, -1])
                for i, p in enumerate(x.parts)]

    def _wkv_inputs(self, layer, r: Cols, k: Cols, v: Cols, w: Rows, i: int,
                    pos: tuple, lo: int, hi: int) -> tuple:
        """What heads ``[lo, hi)`` of batch row ``i`` scan at ``pos``: their
        r, k and v columns and decays sent there, each (b, s, hi − lo,
        hd), and ``u``'s rows read there."""
        tp, hd = r.tp, self.hd
        b, s = w.parts[i].shape[:2]
        c0, c1 = lo * hd, hi * hd
        heads = lambda t: t.reshape(b, s, hi - lo, hd)      # noqa: E731
        rj, kj, vj = (heads(c.take(i, c0, c1, pos, "heads"))
                      for c in (r, k, v))
        wj = heads(tp.send("heads", w.parts[i][..., c0:c1], tp.rows[i][0],
                           pos))
        return rj, kj, vj, wj, tp.cols(layer.u, lo, hi, pos, 0)

    def _time_mix_split(self, layer, x: Rows, st: dict | None) -> Rows:
        """``_time_mix`` on the split weights from the layer's placed
        states ``st``, written in place; ``st`` None (a train step) starts
        from zeros made where they are read (the token shift on each row's
        first position, each head site's scan state there, fp32) and
        keeps no state. A row's sites scan through
        ``TensorParallel.scan_sites``: each site's inputs, then the scans,
        then each site's outputs."""
        tp, hd = x.tp, self.hd
        xs = self._shifted(x, self._prev(
            x, None if st is None else st["tm_prev"]))
        xr, xk, xv, xg, xw = (x.map(lambda a, c, mu: a + mu[i] * (c - a),
                                    xs, layer.mu) for i in range(5))
        r, k, v, g = (tp.col_linear(a, wt) for a, wt in (
            (xr, layer.wr), (xk, layer.wk), (xv, layer.wv), (xg, layer.wg)))
        w = xw.map(lambda a, la, lb, base: self._decay(a, la, lb, base).to(
            x.dtype), layer.w_lora_a, layer.w_lora_b, layer.w_base)
        outs, gates, states = [], [], []
        for i, sites in enumerate(tp.head_sites(self.n_heads_tm)):
            b, s = x.parts[i].shape[:2]
            args = []
            for pos, lo, hi in sites:
                held = (torch.zeros(b, hi - lo, hd, hd, dtype=torch.float32,
                                    device=tp.mesh.devices[pos])
                        if st is None else
                        tp.state_at(st["tm_state"], i, pos, (lo, hi)))
                args.append((*self._wkv_inputs(layer, r, k, v, w, i, pos,
                                               lo, hi), held))
            scanned = tp.scan_sites(self._wkv_scan, sites, args,
                                    (2, 2, 2, 2, 0, 1))
            row_out, row_gate = [], []
            for (pos, lo, hi), (out, state) in zip(sites, scanned):
                c0, c1 = lo * hd, hi * hd
                states.append((pos, ((i * b, (i + 1) * b), (lo, hi)), state))
                row_out.append((pos, c0, c1,
                                out.reshape(b, s, c1 - c0).to(x.dtype)))
                row_gate.append((pos, c0, c1, F.silu(
                    g.take(i, c0, c1, pos, "heads"))))
            outs.append(row_out)
            gates.append(row_gate)
        if st is not None:
            tp.write_state(st["tm_state"], states)
            tp.write_state(st["tm_prev"], self._last(x))
        out = L.rms_norm(Cols(tp, outs), layer.ln_x).map(torch.mul,
                                                          Cols(tp, gates))
        return tp.row_linear(out, layer.wo)

    def _channel_mix_split(self, layer, x: Rows, st: dict | None) -> Rows:
        """``_channel_mix`` on the split weights, its token shift as in
        ``_time_mix_split``."""
        tp = x.tp
        xs = self._shifted(x, self._prev(
            x, None if st is None else st["cm_prev"]))
        xk = x.map(lambda a, c, mu: a + mu[0] * (c - a), xs, layer.mu_c)
        xr = x.map(lambda a, c, mu: a + mu[1] * (c - a), xs, layer.mu_c)
        kk = tp.col_linear(xk, layer.wck).map(
            lambda t: torch.square(torch.relu(t)))
        value = tp.row_linear(kk, layer.wcv, kind="tp_reduce")
        gate = tp.col_linear(xr, layer.wcr).map(torch.sigmoid)
        if st is not None:
            tp.write_state(st["cm_prev"], self._last(x))
        return gate.to_rows("tp_reduce").map(lambda a, c: a * c, value)

    def _block_split(self, x: Rows, layer, st: dict | None = None) -> Rows:
        """``_block`` on the split weights: from the layer's placed states
        ``st``, written in place, or (None, a train step) from zeros."""
        x = x + self._time_mix_split(layer, L.rms_norm(x, layer.ln1), st)
        return x + self._channel_mix_split(layer, L.rms_norm(x, layer.ln2),
                                           st)

    def _hidden_split(self, tokens, state: dict):
        """``hidden`` on the split weights: the cache's states placed
        (``TensorParallel.place_states``) and written in place."""
        tp = self.tp
        state = tp.place_states(state)
        x = tp.embed(self.embed, tokens)
        for i, layer in enumerate(self.layers):
            x = self._block_split(x, layer, {k: v[i] for k, v in
                                             state.items()})
        return x, state

    def place_states(self, cache: dict) -> dict:
        """The cache's states placed over ``tp``'s mesh, in the dict."""
        return self.tp.place_states(cache)

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
        one. With ``tp`` set the step runs on the split weights and
        ``x`` is a ``Rows``."""
        if self.tp is not None:
            return self._hidden_split(tokens, self.init_cache(
                tokens.shape[0], 0) if state is None else state)
        x, new = self._layers(self._embed(tokens), state)
        if state is None:
            return x, {k: torch.stack([st[k] for st in new]) for k in new[0]}
        for i, st in enumerate(new):
            for key, val in st.items():
                state[key][i] = val
        return x, state

    def forward(self, tokens, state=None, return_state=False):
        x, state = self.hidden(tokens, state)
        if isinstance(x, Rows):
            logits = x.tp.head(L.rms_norm(x, self.final_norm), self.lm_head)
            return (logits, state) if return_state else logits
        logits = self.shard(L.rms_norm(x, self.final_norm) @ self.lm_head,
                            ("batch", "seq", "vocab"))
        if return_state:
            return logits, state
        return logits

    def loss(self, batch: dict) -> torch.Tensor:
        """Sequence-chunked CE from zero states. With ``tp`` set, on the
        split weights: each layer from zeros (``_block_split``),
        rematerialised with ``cfg.remat``, and the vocab-parallel CE."""
        tokens = batch["tokens"]
        if self.tp is not None:
            x = self.tp.embed(self.embed, tokens)
            for layer in self.layers:
                x = L.remat(self._block_split, x, layer,
                            enabled=self.cfg.remat)
        else:
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
