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

Set ``tp`` to a ``distributed.tensor_parallel.TensorParallel`` over this
model's tensors (``Cell.place_params``) and ``prefill``/``decode_step``
run on the split weights, the Mamba states placed by ``cache_specs``
(``ssm`` heads over ``model``; ``conv``, whose spec puts ``model`` on its
k−1 axis, which ``fit_spec`` drops, by batch). Each Mamba block's heads
run at ``TensorParallel.head_sites``: a site takes the columns of the
column-parallel ``w_in`` projection (z | x | B | C | dt) that its heads
read, wherever the split cut them (its z, x and dt columns and all of B
and C), and the ``conv_w`` columns of its x, B and C channels; it convolves
those channels from the replicated conv state, scans its heads from its
``ssm`` slice (``TensorParallel.scan_sites``: a one-row trace scans a
row's sites as one, their inputs joined along the heads and B and C
read from the first site's), and norms ``ln_y`` over the whole d_in
from sums of squares joined in model order; ``w_out`` is row-parallel.
The shared block runs as the dense layers do (``layers._qkv_split``,
``flash_decode_sharded``, the split SwiGLU), its ``w_in``
column-parallel, joined on the row's first position. ``loss`` on the
split weights (a train cell's ``place_params``) embeds vocab-parallel
and runs each Mamba block with no cache: every head site convolves and
scans from zeros made on its device and writes nothing, each layer
rematerialised with ``cfg.remat``; the shared block runs full-sequence
split attention at each application, its one set of weights read afresh
each time (the gradients of the applications sum in
``TensorParallel.grads``).
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
        self.tp: TensorParallel | None = None
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

    def _mamba_inputs(self, layer, z: Cols, i: int, pos: tuple, lo: int,
                      hi: int, conv0, ssm0) -> tuple:
        """Heads ``[lo, hi)`` of batch row ``i`` at ``pos`` up to their
        scan: the ``w_in`` columns they read (their x and dt, all of B and
        C) sent there and convolved from ``conv0`` (b, k−1, their x
        channels then B and C). Returns the scan's arguments (x (b, s,
        hi − lo, hd), B and C (b, s, n) fp32, dt (b, s, hi − lo) fp32,
        ``a_log``, ``d_skip``, ``ssm0`` (b, hi − lo, hd, n) fp32) and the
        final conv state."""
        tp, n, hd, din = z.tp, self.cfg.ssm_state, self.hd, self.d_in
        c0, c1 = lo * hd, hi * hd
        chans = ((c0, c1), (din, din + 2 * n))
        conv_in = torch.cat([z.take(i, din + a, din + e, pos, "heads")
                             for a, e in chans], -1)
        conv_w = torch.cat([tp.cols(layer.conv_w, a, e, pos, 1)
                            for a, e in chans], -1)
        out, conv_state = self._conv(conv_in, conv_w, conv0)
        b, s = out.shape[:2]
        out = F.silu(out)
        xs_, bb, cc = (out[..., :c1 - c0], out[..., c1 - c0:c1 - c0 + n],
                       out[..., c1 - c0 + n:])
        dt0 = 2 * din + 2 * n
        dt = F.softplus(z.take(i, dt0 + lo, dt0 + hi, pos, "heads").float()
                        + tp.cols(layer.dt_bias, lo, hi, pos,
                                  0)[None, None, :])
        return ((xs_.reshape(b, s, hi - lo, hd), bb.float(), cc.float(), dt,
                 tp.cols(layer.a_log, lo, hi, pos, 0),
                 tp.cols(layer.d_skip, lo, hi, pos, 0), ssm0), conv_state)

    def _mamba_block_split(self, layer, x: Rows, st: dict | None = None
                           ) -> Rows:
        """``_mamba_block`` on the split weights: from the layer's placed
        states ``st``, written in place, or (``st`` None, a train step)
        from zeros made on each site's device (the conv state in the model
        dtype, the ssm slice in fp32), keeping no state. A row's sites
        scan through ``TensorParallel.scan_sites``: each site's inputs
        (``_mamba_inputs``), then the scans, then each site's outputs."""
        tp, n, hd, din = x.tp, self.cfg.ssm_state, self.hd, self.d_in
        k1 = self.cfg.conv_kernel - 1
        bc = (din, din + 2 * n)
        z = tp.col_linear(L.rms_norm(x, layer.ln), layer.w_in)
        ys, gates, convs, ssms = [], [], [], []
        for i, sites in enumerate(tp.head_sites(self.n_heads_m)):
            b, s = x.parts[i].shape[:2]
            rows = (i * b, (i + 1) * b)
            args = []
            for j, (pos, lo, hi) in enumerate(sites):
                c0, c1 = lo * hd, hi * hd
                if st is None:
                    dev = tp.mesh.devices[pos]
                    conv0 = torch.zeros(b, k1, c1 - c0 + 2 * n,
                                        dtype=self.dtype, device=dev)
                    ssm0 = torch.zeros(b, hi - lo, hd, n,
                                       dtype=torch.float32, device=dev)
                else:
                    held = tp.state_at(st["conv"], i, pos, (0, k1),
                                       (0, self.conv_dim))
                    conv0 = torch.cat([held[..., a:e]
                                       for a, e in ((c0, c1), bc)], -1)
                    ssm0 = tp.state_at(st["ssm"], i, pos, (lo, hi))
                site_args, conv_state = self._mamba_inputs(
                    layer, z, i, pos, lo, hi, conv0, ssm0)
                args.append(site_args)
                convs.append((pos, (rows, (0, k1), (c0, c1)),
                              conv_state[..., :c1 - c0]))
                if j == 0:      # B and C's conv state: the row's first site
                    convs.append((pos, (rows, (0, k1), bc),
                                  conv_state[..., c1 - c0:]))
            # B and C (None): each site's copy is the same value
            scanned = tp.scan_sites(self._ssm_scan, sites, args,
                                    (2, None, None, 2, 0, 0, 1))
            row_y, row_gate = [], []
            for (pos, lo, hi), (y, ssm_state) in zip(sites, scanned):
                c0, c1 = lo * hd, hi * hd
                ssms.append((pos, (rows, (lo, hi)), ssm_state))
                row_y.append((pos, c0, c1,
                              y.reshape(b, s, c1 - c0).to(x.dtype)))
                row_gate.append((pos, c0, c1,
                                 F.silu(z.take(i, c0, c1, pos, "heads"))))
            ys.append(row_y)
            gates.append(row_gate)
        if st is not None:
            tp.write_state(st["conv"], convs)
            tp.write_state(st["ssm"], ssms)
        y = L.rms_norm(Cols(tp, ys), layer.ln_y).map(torch.mul,
                                                      Cols(tp, gates))
        return x + tp.row_linear(y, layer.w_out)

    def place_states(self, cache: dict) -> dict:
        """The cache's Mamba states placed over ``tp``'s mesh, in the
        dict (the shared block's k/v as ``decode_ctx`` places them)."""
        self.tp.place_states(cache["mamba"])
        return cache

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
        in place. A split step's ``x`` (a ``Rows``) runs on the placed
        ``states``, written in place, and returns no list; from None (a
        train step) each layer starts from zeros, rematerialised with
        ``cfg.remat``, and keeps no state."""
        if isinstance(x, Rows):
            for i in range(a, b):
                if states is None:
                    x = L.remat(self._mamba_block_split, self.mamba[i], x,
                                enabled=self.cfg.remat)
                else:
                    x = self._mamba_block_split(
                        self.mamba[i], x, {k: v[i] for k, v in
                                           states.items()})
            return x, None
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
        ``states`` (a serving cache) in place (a split step's ``new`` is
        None: written already)."""
        for j, st in enumerate(new or ()):
            for key, val in st.items():
                states[key][a + j] = val

    # -- shared attention block -------------------------------------------------
    @staticmethod
    def _shared_in(p, x, x0):
        """``rms_norm(cat(x, x0)) @ w_in``; on a split step column-parallel,
        the columns joined on each row's first position."""
        if isinstance(x, Rows):
            h = L.rms_norm(x.map(lambda a, e: torch.cat([a, e], dim=-1), x0),
                           p.ln_in)
            return x.tp.col_linear(h, p.w_in).to_rows("tp_reduce")
        h = torch.cat([x, x0], dim=-1)
        return L.rms_norm(h, p.ln_in) @ p.w_in

    def _shared_block(self, p, x, x0, kv=None, idx=None):
        """Full-seq when kv is None; cached decode otherwise."""
        h = self._shared_in(p, x, x0)
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
        """Sequence-chunked CE from zero Mamba states; with ``tp`` set, on
        the split weights (``_mamba_layers`` from None, the shared block's
        full-sequence split attention at each application, the
        vocab-parallel CE)."""
        tokens = batch["tokens"]
        x = self._run(self._tokens(tokens) if self.tp is not None
                      else self._embed(tokens), None)
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
        if self.tp is not None:
            self.place_states(cache)
        x = self._tokens(tokens)
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
                h = self._shared_in(p, x, x0)
                a_in = L.rms_norm(h, p.ln1)
                q, k, v = L._qkv(p.attn, self.attn_dims, a_in, positions,
                                 shard=self.shard)
                attn = L._attend(q, k, v, causal=True)
                h = h + L._out(p.attn, attn)
                h = h + L.swiglu(p.mlp, L.rms_norm(h, p.ln2), self.shard)
                x = x + h
                cache["shared"]["k"][si, :, :s] = L.whole(k)
                cache["shared"]["v"][si, :, :s] = L.whole(v)
                si += 1
        if si:
            cache["shared"]["k"][:, :, s:] = 0
            cache["shared"]["v"][:, :, s:] = 0
        x = L.rms_norm(x, self.final_norm)
        cache["index"] = s
        return self._head(x[:, -1:, :])[:, 0], cache

    @torch.no_grad()
    def decode_step(self, tokens, cache):
        idx = cache["index"]
        if self.decode_ctx is not None and "shared" in cache:
            L.place_kv(cache["shared"], ("k", "v"), self.decode_ctx)
        if self.tp is not None:
            self.place_states(cache)
        x = self._tokens(tokens)
        x = self._run(x, cache["mamba"], shared_kv=cache.get("shared"),
                      idx=idx)
        x = L.rms_norm(x, self.final_norm)
        cache["index"] = idx + 1
        return self._head(x)[:, 0], cache

    def _tokens(self, tokens):
        """A serving step's token rows: a ``Rows`` on split weights."""
        if self.tp is not None:
            return self.tp.embed(self.embed, tokens)
        return L.take_rows(self.embed, tokens)

    def _head(self, x):
        if isinstance(x, Rows):
            return x.tp.head(x, self.lm_head)
        return x @ self.lm_head
