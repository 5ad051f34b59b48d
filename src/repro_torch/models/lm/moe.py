"""Mixture-of-Experts transformer (phi3.5-moe 16e top-2, llama4 128e top-1).

Counterpart of ``repro.models.lm.moe``: capacity-based token dispatch in
the grouped-einsum form. Tokens are cut into GROUP_SIZE-token routing
groups; each group routes on its own with capacity C = ceil(g·k·cf / E),
and (token, slot) pairs past an expert's capacity are dropped (they fall
through the residual). Every expert runs its C slots, empty or not. The
router is fp32. On split weights (``TensorParallel``) ``moe_ffn`` takes
``_moe_split``'s layout. Under autograd the routing (``topk``'s indices, the
one-hots, the capacity cumsum, the keep mask) carries no gradient, as in
the reference: the router learns through the kept pairs' gate values in
``combine`` and through the aux term's mean probabilities.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed.sharding import axis_line
from repro_torch.distributed.tensor_parallel import Rows

from . import layers as L
from .config import LMConfig
from .transformer import DenseTransformer


class MoEFFN(nn.Module):
    """``router`` (d, e) fp32, ``w_gate``/``w_up`` (e, d, f), ``w_down``
    (e, f, d) (``init_moe_ffn``)."""

    def __init__(self, cfg: LMConfig, *, device, dtype):
        super().__init__()
        e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
        L.add_buffers(self, device, torch.float32, router=(d, e))
        L.add_buffers(self, device, dtype, w_gate=(e, d, f), w_up=(e, d, f),
                      w_down=(e, f, d))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        _, d, f = self.w_gate.shape
        s_in, s_out = float(1.0 / np.sqrt(d)), float(1.0 / np.sqrt(f))
        L.normal_(self.router, generator, s_in)
        L.normal_(self.w_gate, generator, s_in)
        L.normal_(self.w_up, generator, s_in)
        L.normal_(self.w_down, generator, s_out)


def capacity(cfg: LMConfig, tokens_per_group: int) -> int:
    c = int(np.ceil(tokens_per_group * cfg.top_k * cfg.capacity_factor
                    / cfg.n_experts))
    return max(c, 1)


GROUP_SIZE = 512      # routing-group length: caps the capacity buffers


def moe_ffn(p: MoEFFN, x: torch.Tensor, cfg: LMConfig,
            shard: L.Shard = L.no_shard
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (b, s, d) -> (out (b, s, d), aux_loss scalar).

    Groups are cut from the flattened token stream, so at decode (s == 1)
    all b tokens route as one group. A (token, slot) pair's place in its
    expert's buffer is a cumsum over the group's (token, slot) pairs,
    token-major, so which pairs drop is the reference's, pair for pair.
    The expert buffers' token axis is ``batch`` unless
    ``cfg.moe_token_replicate`` replicates it (llama4). A :class:`Rows`
    ``x`` (split weights) takes :func:`_moe_split`, whose aux term is
    None when serving.
    """
    if isinstance(x, Rows):
        return _moe_split(p, x, cfg)
    b, s, d = x.shape
    gsz = _group_size(b, s)
    xg = x.reshape((b * s) // gsz, gsz, d)
    dispatch, combine, probs, expert_mask = _routing(xg, p.router, cfg)
    dispatch = shard(dispatch, ("batch", None, "experts", None))
    combine = shard(combine, ("batch", None, "experts", None))

    xin = torch.einsum("gsec,gsd->gecd", dispatch, xg)           # (G, e, c, d)
    tok_axis = None if cfg.moe_token_replicate else "batch"
    xin = shard(xin, (tok_axis, "experts", None, None))
    g_ = torch.einsum("gecd,edf->gecf", xin, p.w_gate)
    u = torch.einsum("gecd,edf->gecf", xin, p.w_up)
    h = shard(F.silu(g_) * u, (tok_axis, "experts", None, "expert_mlp"))
    eo = shard(torch.einsum("gecf,efd->gecd", h, p.w_down),
               (tok_axis, "experts", None, None))
    out = torch.einsum("gsec,gecd->gsd", combine, eo).reshape(b, s, d)
    out = shard(out, ("batch", "seq", "embed"))

    # load-balancing auxiliary loss (Switch-style)
    e = cfg.n_experts
    frac_tokens = expert_mask.sum(dim=2).mean(dim=(0, 1))        # (e,)
    frac_probs = probs.mean(dim=(0, 1))                          # (e,)
    aux = e * torch.sum(frac_tokens * frac_probs)
    return out, aux


def _group_size(b: int, s: int) -> int:
    gsz = min(GROUP_SIZE, b * s)
    if (b * s) % gsz:
        raise ValueError(f"{b * s} tokens do not cut into routing groups "
                         f"of {gsz}")
    return gsz


def _routing(xg: torch.Tensor, router: torch.Tensor, cfg: LMConfig):
    """xg (G, g, d) -> (dispatch, combine (G, g, e, c) in ``xg``'s
    dtype, the router's probabilities, the top-k one-hots)."""
    ng, gsz, _ = xg.shape
    e, k = cfg.n_experts, cfg.top_k
    c = capacity(cfg, gsz)
    dtype = xg.dtype
    gate_logits = xg.float() @ router                            # (G, g, e)
    probs = torch.softmax(gate_logits, dim=-1)
    top_vals, top_idx = torch.topk(probs, k, dim=-1)             # (G, g, k)

    # position of each (token, slot) inside its expert's capacity buffer
    expert_mask = F.one_hot(top_idx, e).float()                  # (G, g, k, e)
    flat_mask = expert_mask.reshape(ng, gsz * k, e)
    pos = torch.cumsum(flat_mask, dim=1) * flat_mask - 1.0
    pos = pos.reshape(ng, gsz, k, e)
    keep = (pos >= 0) & (pos < c)
    pos = torch.where(keep, pos, 0.0).long()

    cap_oh = F.one_hot(pos, c).float() * keep[..., None].float()  # (G, g, k, e, c)
    dispatch = cap_oh.sum(dim=2).to(dtype)                       # (G, g, e, c)
    combine = (cap_oh * top_vals[..., None, None]).sum(dim=2).to(dtype)
    return dispatch, combine, probs, expert_mask


def _experts(x: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    """The experts' SwiGLU on their slots ``x`` (G, e, c, d)."""
    g_ = torch.einsum("gecd,edf->gecf", x, w_gate)
    u = torch.einsum("gecd,edf->gecf", x, w_up)
    return torch.einsum("gecf,efd->gecd", F.silu(g_) * u, w_down)


def _moe_unit(p: MoEFFN, tp, cfg: LMConfig, xu, row, s: int, d: int,
              gsz: int, f_split: bool, experts_split: bool, at0: tuple,
              stats: list) -> torch.Tensor:
    """One routing unit of :func:`_moe_split`: ``xu`` (its rows' tokens,
    on the row's first position ``row[0]``) routed, run through the
    experts of ``row``'s model positions, and combined there; a train
    step's aux sums go to ``at0`` (appended to ``stats``)."""
    home = row[0]
    xg = xu.reshape(xu.shape[0] * s // gsz, gsz, d)
    dispatch, combine, probs, expert_mask = _routing(
        xg, tp.weight(p.router, home), cfg)
    if tp.train:
        stats.append((tp.send_fixed("moe_tokens",
                                    expert_mask.sum(dim=(0, 1, 2)), home,
                                    at0),
                      tp.send_fixed("moe_tokens", probs.sum(dim=(0, 1)),
                                    home, at0)))
    xin = torch.einsum("gsec,gsd->gecd", dispatch, xg)       # (G, e, c, d)
    out = None
    for j, col in enumerate(row if experts_split else row[:1]):
        lo, hi = (tp.model_range(p.w_gate, j) if experts_split
                  else (0, cfg.n_experts))
        holders = (axis_line(tp.mesh, col, "data") if f_split
                   else [col])
        eo = tp.partials_summed(
            _experts, xin[:, lo:hi], (p.w_gate, p.w_up, p.w_down), home,
            col, holders, ("moe_tokens", "tp_reduce"), gather=not f_split)
        cj = tp.send("moe_tokens", combine[:, :, lo:hi], home, col)
        part = tp.send("tp_reduce", torch.einsum("gsec,gecd->gsd", cj, eo),
                       col, home)
        out = part if out is None else out + part
    return out.reshape(-1, s, d)


def _moe_split(p: MoEFFN, x: Rows, cfg: LMConfig
               ) -> tuple[Rows, torch.Tensor | None]:
    """``moe_ffn``'s output on split weights (``P("model", "data",
    None)`` for ``w_gate``/``w_up``, ``P("model", None, "data")`` for
    ``w_down``; llama4's ``P("model", None, "data")`` and ``P("model",
    "data", None)``).

    A routing group's tokens route together where they are: each batch
    shard alone when its rows cut into whole groups, else every shard's
    rows on the first one's first position (``moe_tokens``), in batch
    order, so the groups are the whole batch's. There the replicated
    router gives ``dispatch``, ``combine`` and the expert buffers
    ``xin``. Each model position of that row takes ``xin``'s slots of its
    experts (``moe_tokens``) and its ``combine`` columns, runs its
    experts and its partial of the combine einsum; the partials add on
    the row's first position in model order (``tp_reduce``). Weights with
    the data split on D (or E whole over the model axis) are gathered
    over data first; llama4's, with F over data, stay split: the expert
    slots go to every position along the data axis (the reference's
    replicated token buffers), each runs its F slice, and the partial
    expert outputs add in data order before the combine (``tp_reduce``).
    Outputs return to each shard's first position (``moe_tokens``).

    A train cell's step (``tp.train``) computes the aux term too: each
    routing unit's sums of its kept one-hots and its probabilities over
    its tokens go to the mesh's first position (``moe_tokens``), add in
    unit order, and are divided by the batch's tokens there
    (``moe_ffn``'s means); serving's is None."""
    tp = x.tp
    b, s, d = x.shape
    gsz = _group_size(b, s)
    b_row = x.parts[0].shape[0]
    per_row = (b_row * s) % gsz == 0
    units = ([[i] for i in range(len(tp.rows))] if per_row
             else [list(range(len(tp.rows)))])
    f_split = tp.placed(p.w_gate).split_dim("data") == 2
    experts_split = tp.model_dim(p.w_gate) == 0
    outs = [None] * len(tp.rows)
    at0 = (0,) * tp.mesh.devices.ndim
    stats = []
    for unit in units:
        row = tp.rows[unit[0]]
        home = row[0]
        if per_row:
            xu = tp.send("moe_tokens", x.parts[unit[0]], home, home)
        else:                       # every row's tokens, on (0, ..., 0)
            xu = x.whole("moe_tokens")
        with contextlib.nullcontext() if per_row else tp.every_row():
            out = _moe_unit(p, tp, cfg, xu, row, s, d, gsz, f_split,
                            experts_split, at0, stats)
        for k, i in enumerate(unit):
            part = out[k * b_row:(k + 1) * b_row]
            outs[i] = (tp.send("moe_tokens", part, home, home) if per_row
                       else tp.send_fixed("moe_tokens", part, home,
                                          tp.rows[i][0], moving="dst"))
    if not stats:
        return Rows(tp, outs), None
    tok_sum, prob_sum = stats[0]
    for t, pr in stats[1:]:
        tok_sum, prob_sum = tok_sum + t, prob_sum + pr
    n = b * s
    aux = cfg.n_experts * torch.sum((tok_sum / n) * (prob_sum / n))
    return Rows(tp, outs), aux


class MoELayer(nn.Module):
    """``ln1``, ``attn``, ``ln2`` and the experts ``moe``."""

    def __init__(self, cfg: LMConfig, dims: L.AttnDims, *, device, dtype):
        super().__init__()
        L.add_buffers(self, device, dtype, ln1=(cfg.d_model,),
                      ln2=(cfg.d_model,))
        self.attn = L.Attention(dims, device=device, dtype=dtype)
        self.moe = MoEFFN(cfg, device=device, dtype=dtype)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.ln1.fill_(1)
        self.ln2.fill_(1)
        self.attn.reset_parameters(generator)
        self.moe.reset_parameters(generator)


class MoETransformer(DenseTransformer):
    """DenseTransformer with the FFN swapped for capacity-routed experts."""

    def init_layer(self) -> nn.Module:
        return MoELayer(self.cfg, self.dims, device=self.device,
                        dtype=self.dtype)

    def _mlp(self, layer, h):
        out, _aux = moe_ffn(layer.moe, h, self.cfg, self.shard)
        return out

    def _aux_block(self, x, layer, positions):
        """``_block`` that also returns the layer's router aux loss."""
        h = L.rms_norm(x, layer.ln1)
        x = x + L.attention(layer.attn, self.dims, h, shard=self.shard,
                            causal=True, positions=positions)
        out, aux = moe_ffn(layer.moe, L.rms_norm(x, layer.ln2), self.cfg,
                           self.shard)
        return x + out, aux

    def loss_terms(self, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """(next-token CE, the router load-balancing aux term averaged over
        the layers). With ``cfg.scan_layers`` the mean is over the stacked
        per-layer terms (the reference's ``jnp.mean`` of the scan's
        outputs); without, ``aux / n_layers`` is added layer by layer, as
        the reference's unrolled loop does."""
        cfg = self.cfg
        tokens = batch["tokens"]
        x = self.embed_tokens(tokens)
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=x.device)[None]
        auxes = []
        for layer in self.layers:
            x, a = L.remat(self._aux_block, x, layer, positions,
                           enabled=cfg.remat)
            auxes.append(a)
        if cfg.scan_layers:
            aux = torch.stack(auxes).mean()
        else:
            aux = 0.0
            for a in auxes:
                aux = aux + a / cfg.n_layers
        return self._ce(x, tokens), aux

    def loss(self, batch: dict, aux_weight: float = 0.01) -> torch.Tensor:
        """Next-token loss + router load-balancing aux term."""
        ce, aux = self.loss_terms(batch)
        return ce + aux_weight * aux
