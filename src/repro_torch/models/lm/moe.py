"""Mixture-of-Experts transformer (phi3.5-moe 16e top-2, llama4 128e top-1).

Counterpart of ``repro.models.lm.moe``: capacity-based token dispatch in
the grouped-einsum form. Tokens are cut into GROUP_SIZE-token routing
groups; each group routes on its own with capacity C = ceil(g·k·cf / E),
and (token, slot) pairs past an expert's capacity are dropped (they fall
through the residual). Every expert runs its C slots, empty or not. The
router is fp32. Under autograd the routing (``topk``'s indices, the
one-hots, the capacity cumsum, the keep mask) carries no gradient, as in
the reference: the router learns through the kept pairs' gate values in
``combine`` and through the aux term's mean probabilities.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

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
    ``cfg.moe_token_replicate`` replicates it (llama4).
    """
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    gsz = min(GROUP_SIZE, b * s)
    if (b * s) % gsz:
        raise ValueError(f"{b * s} tokens do not cut into routing groups "
                         f"of {gsz}")
    ng = (b * s) // gsz
    c = capacity(cfg, gsz)
    dtype = x.dtype
    xg = x.reshape(ng, gsz, d)

    gate_logits = xg.float() @ p.router                          # (G, g, e)
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
    frac_tokens = expert_mask.sum(dim=2).mean(dim=(0, 1))        # (e,)
    frac_probs = probs.mean(dim=(0, 1))                          # (e,)
    aux = e * torch.sum(frac_tokens * frac_probs)
    return out, aux


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
        ce = L.chunked_ce_loss(x, self.final_norm, self.head_weight(),
                               tokens, shard=self.shard)
        return ce, aux

    def loss(self, batch: dict, aux_weight: float = 0.01) -> torch.Tensor:
        """Next-token loss + router load-balancing aux term."""
        ce, aux = self.loss_terms(batch)
        return ce + aux_weight * aux
