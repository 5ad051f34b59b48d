"""Shared transformer building blocks of the LM zoo, and its losses.

Counterpart of ``repro.models.lm.layers``. The functions are the
reference's, over ``nn.Module``s that own their tensors: ``p.wq`` where the
reference reads ``p["wq"]``. Weights keep the reference's ``(in, out)``
layout and apply as ``x @ w``; the GEMMs are ``torch.matmul`` (cuBLAS on
the card), as the reference's are XLA dots.

Attention is plain tensor ops in the reference's order: logits in fp32,
the −1e30 mask, the softmax cast to ``v``'s dtype. GQA keeps the
reference's head order (``_expand_gqa`` is ``jnp.repeat``: query head
``i`` reads kv head ``i // (h // kv)``) through a grouped view — the
queries of one kv head side by side — so a KV cache is never repeated
per group.

Training: a model's tensors are buffers; ``LMParams.param_tree`` marks
them ``requires_grad`` and hands them to the optimizer as the reference's
tree. ``remat`` is the reference's ``jax.checkpoint``: under autograd a
rematerialised function keeps only its inputs and runs again in the
backward (``torch.utils.checkpoint``, non-reentrant). Nothing on the LM
forward draws random numbers, so the recomputation is bitwise the first
run and no RNG state is stashed. ``chunked_ce_loss`` rematerialises every
chunk, ``flash_attention`` every k-block, and each family every layer when
``cfg.remat`` is set; without autograd (serving) nothing is.

The LM mesh (``DecodeShardCtx``, ``flash_decode_sharded``, the ``shard``
callable) is still to be ported.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.bridge import _as_lists, _leaves

__all__ = ["AttnDims", "Attention", "SwiGLU", "GeluMLP", "LMParams",
           "rms_norm", "rope_freqs", "apply_rope", "attention",
           "attention_decode", "flash_attention", "swiglu", "gelu_mlp",
           "next_token_loss", "chunked_ce_loss", "remat", "take_rows",
           "FLASH_THRESHOLD", "FLASH_CHUNK"]


def torch_dtype(name: str) -> torch.dtype:
    """``LMConfig.dtype`` ("bfloat16", "float32") as a torch dtype."""
    return getattr(torch, name)


def add_buffers(module: nn.Module, device, dtype, **shapes) -> None:
    """Register a zero buffer of each ``name=shape`` on ``module``."""
    for name, shape in shapes.items():
        module.register_buffer(name, torch.zeros(shape, dtype=dtype,
                                                 device=device))


def normal_(t: torch.Tensor, generator: torch.Generator,
            scale: float) -> None:
    """``t`` <- N(0, 1) · ``scale``, drawn in ``t``'s dtype (the reference's
    ``jax.random.normal(key, shape, dtype) * scale``)."""
    t.normal_(generator=generator).mul_(scale)


def take_rows(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]`` (the reference's ``jnp.take``) as an embedding
    lookup: the same rows, and a backward that sums a repeated id's rows
    in a fixed order. The backward of ``table[tokens]``, an accumulating
    ``index_put_``, sums them in a changing order on a many-threaded CPU,
    so a resumed run would not be bitwise an unbroken one."""
    return F.embedding(tokens, table)


def remat(fn, *args, enabled: bool = True):
    """``fn(*args)``; when ``enabled`` and autograd is recording, its
    intermediates are dropped and recomputed in the backward (the
    reference's ``jax.checkpoint``)."""
    if enabled and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


class LMParams:
    """The trainable view of an LM family's ``nn.Module``."""

    def tensor_tree(self) -> dict:
        """The reference's parameter tree by key (``embed``, ``layers``,
        ``final_norm``, ``mamba``, ``shared``, ``encoder``, ...) over this
        model's own buffers. A stacked group of the reference
        (``bridge.STACKED``) is a list of per-layer dicts: the optimizer
        writes in place, so a leaf is never a stacked copy. Derived
        buffers (the RoPE tables) are not parameters."""
        tree: dict = {}
        for name, t in self.state_dict(keep_vars=True).items():
            *parents, leaf = name.split(".")
            node = tree
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = t
        return _as_lists(tree)

    def param_tree(self) -> dict:
        """``tensor_tree()`` with every leaf marked ``requires_grad`` for
        a trainer (``training.make_train_step``), which updates them in
        place. Serving stays graph-free: ``prefill``, ``decode_step`` and
        ``generate`` run without autograd."""
        tree = self.tensor_tree()
        for _, t in _leaves(tree):
            t.requires_grad_(True)
        return tree


# ---------------------------------------------------------------------------
# norms & rotary
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * gamma.float()).to(dt)


def rope_freqs(head_dim: int, theta: float = 10_000.0) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32)
                            / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0, *,
               freqs: torch.Tensor | None = None) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (..., S) integers. Split-half
    rotation in fp32. ``freqs`` is ``rope_freqs(hd, theta)`` already on
    ``x``'s device (an ``Attention``'s own table), made here when None."""
    if freqs is None:
        freqs = torch.from_numpy(rope_freqs(x.shape[-1], theta)).to(x.device)
    ang = positions[..., None].float() * freqs              # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]                      # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention (GQA, optional qk-norm) — full / causal / cached-decode
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnDims:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_model: int
    qk_norm: bool = False
    rope_theta: float = 10_000.0


class Attention(nn.Module):
    """``wq`` (d, h·hd), ``wk``/``wv`` (d, kv·hd), ``wo`` (h·hd, d) and,
    with qk-norm, ``q_norm``/``k_norm`` (hd,) (``init_attn``). ``freqs``,
    the RoPE table, is derived from the dims and is not a parameter."""

    def __init__(self, dims: AttnDims, *, device, dtype):
        super().__init__()
        d, h, kv, hd = (dims.d_model, dims.n_heads, dims.n_kv_heads,
                        dims.head_dim)
        self.dims = dims
        add_buffers(self, device, dtype, wq=(d, h * hd), wk=(d, kv * hd),
                    wv=(d, kv * hd), wo=(h * hd, d))
        if dims.qk_norm:
            add_buffers(self, device, dtype, q_norm=(hd,), k_norm=(hd,))
        self.register_buffer(
            "freqs", torch.from_numpy(rope_freqs(hd, dims.rope_theta))
            .to(device), persistent=False)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        dims = self.dims
        s = float(1.0 / np.sqrt(dims.d_model))
        for w in (self.wq, self.wk, self.wv):
            normal_(w, generator, s)
        normal_(self.wo, generator,
                float(1.0 / np.sqrt(dims.n_heads * dims.head_dim)))
        if dims.qk_norm:
            self.q_norm.fill_(1)
            self.k_norm.fill_(1)


def _qkv(p: Attention, dims: AttnDims, x: torch.Tensor,
         positions: torch.Tensor, rope: bool = True):
    b, s, _ = x.shape
    h, kv, hd = dims.n_heads, dims.n_kv_heads, dims.head_dim
    q = (x @ p.wq).reshape(b, s, h, hd)
    k = (x @ p.wk).reshape(b, s, kv, hd)
    v = (x @ p.wv).reshape(b, s, kv, hd)
    if dims.qk_norm:
        q = rms_norm(q, p.q_norm)
        k = rms_norm(k, p.k_norm)
    if rope:
        q = apply_rope(q, positions, dims.rope_theta, freqs=p.freqs)
        k = apply_rope(k, positions, dims.rope_theta, freqs=p.freqs)
    return q, k, v


def _grouped(q: torch.Tensor, kv: int) -> torch.Tensor:
    """(b, sq, h, hd) -> fp32 (b, kv, h/kv, sq, hd): each kv head's query
    heads side by side, in ``jnp.repeat``'s order."""
    b, sq, h, hd = q.shape
    return q.reshape(b, sq, kv, h // kv, hd).permute(0, 2, 3, 1, 4).to(
        torch.float32, memory_format=torch.contiguous_format)


def _ungrouped(o: torch.Tensor) -> torch.Tensor:
    """(b, kv, g, sq, hd) -> (b, sq, kv·g, hd)."""
    b, kv, g, sq, hd = o.shape
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, kv * g, hd)


def _sdpa_decode(q, k, v, valid):
    """softmax(q·kᵀ/√hd, masked) · v with GQA by grouping: q (b, sq, h,
    hd) over k/v (b, sk, kv, hd), ``valid`` a bool tensor broadcasting to
    (sq, sk) (at decode, the (S_max,) slots written so far) or None.
    Logits in fp32, probabilities in ``v``'s dtype."""
    b, sq, h, hd = q.shape
    _, sk, kv, _ = k.shape
    g = h // kv
    qg = _grouped(q, kv).reshape(b, kv, g * sq, hd)
    kt = k.permute(0, 2, 3, 1).to(torch.float32,
                                  memory_format=torch.contiguous_format)
    logits = (torch.matmul(qg, kt) * float(1.0 / np.sqrt(hd))).reshape(
        b, kv, g, sq, sk)
    if valid is not None:
        logits = logits.masked_fill(~valid, -1e30)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.matmul(probs.reshape(b, kv, g * sq, sk),
                       v.permute(0, 2, 1, 3).contiguous())
    return _ungrouped(out.reshape(b, kv, g, sq, hd))


def _sdpa(q, k, v, *, causal: bool, q_pos=None, k_pos=None):
    """q: (b, sq, h, hd); k/v: (b, sk, kv, hd)."""
    mask = None
    if causal:
        qp = torch.arange(q.shape[1], device=q.device) if q_pos is None \
            else q_pos
        kp = torch.arange(k.shape[1], device=q.device) if k_pos is None \
            else k_pos
        mask = qp[:, None] >= kp[None, :]
    return _sdpa_decode(q, k, v, mask)


# sequences at or above this length use chunked online-softmax attention
# (direct attention would materialize an s×s score tensor)
FLASH_THRESHOLD = 4096
FLASH_CHUNK = 1024


def _attend(q, k, v, *, causal: bool):
    if q.shape[1] >= FLASH_THRESHOLD or k.shape[1] >= FLASH_THRESHOLD:
        return flash_attention(q, k, v, causal=causal,
                               q_chunk=FLASH_CHUNK, k_chunk=FLASH_CHUNK)
    return _sdpa(q, k, v, causal=causal)


def attention(p: Attention, dims: AttnDims, x: torch.Tensor, *,
              causal: bool = True, positions: torch.Tensor | None = None,
              memory: torch.Tensor | None = None,
              rope: bool = True) -> torch.Tensor:
    """Full (prefill) attention; ``memory`` switches to cross-attention."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=x.device)[None]
    if memory is None:
        q, k, v = _qkv(p, dims, x, positions, rope)
    else:
        # cross attention: q from x, k/v from memory (no rope on memory)
        h, kv, hd = dims.n_heads, dims.n_kv_heads, dims.head_dim
        sm = memory.shape[1]
        q = (x @ p.wq).reshape(b, s, h, hd)
        k = (memory @ p.wk).reshape(b, sm, kv, hd)
        v = (memory @ p.wv).reshape(b, sm, kv, hd)
        causal = False
    out = _attend(q, k, v, causal=causal)
    return out.reshape(b, s, dims.n_heads * dims.head_dim) @ p.wo


def attention_decode(p: Attention, dims: AttnDims, x: torch.Tensor,
                     k_cache: torch.Tensor, v_cache: torch.Tensor,
                     cache_index: int, *, rope: bool = True):
    """One-token decode against a (b, S_max, kv, hd) KV cache.

    Writes this token's k/v at ``cache_index`` in place and returns (out
    (b, 1, d), k_cache, v_cache). Masking is positional: slots past
    ``cache_index`` are excluded, so a zeroed cache needs no validity map.
    A position past the cache raises (the reference's
    ``dynamic_update_slice`` would clamp it onto the last slot).
    """
    b = x.shape[0]
    s_max = k_cache.shape[1]
    if not 0 <= cache_index < s_max:
        raise IndexError(f"decode position {cache_index} is outside the "
                         f"cache's {s_max} slots")
    positions = torch.full((b, 1), cache_index, dtype=torch.int32,
                           device=x.device)
    q, k, v = _qkv(p, dims, x, positions, rope)
    k_cache[:, cache_index] = k[:, 0]
    v_cache[:, cache_index] = v[:, 0]
    valid = torch.arange(s_max, device=x.device) <= cache_index
    out = _sdpa_decode(q, k_cache, v_cache, valid)
    out = out.reshape(b, 1, dims.n_heads * dims.head_dim) @ p.wo
    return out, k_cache, v_cache


# ---------------------------------------------------------------------------
# chunked (online-softmax / "flash") attention — long-context prefill
# ---------------------------------------------------------------------------

def flash_attention(q, k, v, *, causal: bool, q_chunk: int = 1024,
                    k_chunk: int = 1024) -> torch.Tensor:
    """Exact attention with O(s·chunk) memory via online softmax.

    q (b, sq, h, hd); k/v (b, sk, kv, hd). The reference's chunked loop
    (a ``lax.map`` over q chunks of a ``lax.scan`` over k chunks) as plain
    Python loops: every k chunk runs, the causal mask comes from the
    chunks' positions, the accumulator is fp32 and the denominator is
    floored at 1e-30.
    """
    b, sq, h, hd = q.shape
    _, sk, kv, _ = k.shape
    g = h // kv
    qc = min(q_chunk, sq)
    kc = min(k_chunk, sk)
    nq, nk = sq // qc, sk // kc
    if sq % qc or sk % kc:
        raise ValueError("seq must divide chunk")
    scale = float(1.0 / np.sqrt(hd))
    dev = q.device

    qg = _grouped(q, kv)                                  # (b, kv, g, sq, hd)
    kt = k.permute(0, 2, 3, 1).to(torch.float32,
                                  memory_format=torch.contiguous_format)
    vf = v.permute(0, 2, 1, 3).to(torch.float32,
                                  memory_format=torch.contiguous_format)
    outs = []
    for qi in range(nq):
        q_blk = qg[:, :, :, qi * qc:(qi + 1) * qc].reshape(b, kv, g * qc, hd)
        m = torch.full((b, kv, g, qc), -math.inf, device=dev)
        l = torch.zeros((b, kv, g, qc), device=dev)
        acc = torch.zeros((b, kv, g, qc, hd), device=dev)
        for ki in range(nk):
            ks = slice(ki * kc, (ki + 1) * kc)
            mask = None
            if causal:
                qpos = qi * qc + torch.arange(qc, device=dev)
                kpos = ki * kc + torch.arange(kc, device=dev)
                mask = qpos[:, None] >= kpos[None, :]
            # the reference checkpoints every k-block (``layers.py:328``)
            m, l, acc = remat(_flash_k_block, q_blk, kt[..., ks],
                              vf[:, :, ks], m, l, acc, mask, scale)
        outs.append(acc / torch.clamp_min(l[..., None], 1e-30))
    return _ungrouped(torch.cat(outs, dim=3)).to(q.dtype)


def _flash_k_block(q_blk, kt_blk, v_blk, m, l, acc, mask, scale: float):
    """One k-block of the online softmax: q_blk (b, kv, g·qc, hd) fp32,
    kt_blk (b, kv, hd, kc), v_blk (b, kv, kc, hd); the running max ``m``,
    denominator ``l`` (b, kv, g, qc) and ``acc`` (b, kv, g, qc, hd)
    updated; ``mask`` (qc, kc) or None."""
    b, kv, g, qc, hd = acc.shape
    kc = kt_blk.shape[-1]
    logits = (torch.matmul(q_blk, kt_blk) * scale).reshape(b, kv, g, qc, kc)
    if mask is not None:
        logits = logits.masked_fill(~mask, -1e30)
    m_new = torch.maximum(m, logits.amax(dim=-1))
    corr = torch.exp(m - m_new)
    p = torch.exp(logits - m_new[..., None])
    l = l * corr + p.sum(dim=-1)
    pv = torch.matmul(p.reshape(b, kv, g * qc, kc), v_blk)
    acc = acc * corr[..., None] + pv.reshape(b, kv, g, qc, hd)
    return m_new, l, acc


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

class SwiGLU(nn.Module):
    """``w_gate``/``w_up`` (d, f), ``w_down`` (f, d) (``init_swiglu``)."""

    def __init__(self, d_model: int, d_ff: int, *, device, dtype):
        super().__init__()
        add_buffers(self, device, dtype, w_gate=(d_model, d_ff),
                    w_up=(d_model, d_ff), w_down=(d_ff, d_model))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        d_model, d_ff = self.w_gate.shape
        s_in, s_out = float(1.0 / np.sqrt(d_model)), float(1.0 / np.sqrt(d_ff))
        normal_(self.w_gate, generator, s_in)
        normal_(self.w_up, generator, s_in)
        normal_(self.w_down, generator, s_out)


def swiglu(p: SwiGLU, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ p.w_gate) * (x @ p.w_up)) @ p.w_down


class GeluMLP(nn.Module):
    """``w_in`` (d, f), ``b_in`` (f,), ``w_out`` (f, d), ``b_out`` (d,)
    (``init_gelu_mlp``)."""

    def __init__(self, d_model: int, d_ff: int, *, device, dtype):
        super().__init__()
        add_buffers(self, device, dtype, w_in=(d_model, d_ff), b_in=(d_ff,),
                    w_out=(d_ff, d_model), b_out=(d_model,))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        d_model, d_ff = self.w_in.shape
        normal_(self.w_in, generator, float(1.0 / np.sqrt(d_model)))
        self.b_in.zero_()
        normal_(self.w_out, generator, float(1.0 / np.sqrt(d_ff)))
        self.b_out.zero_()


def gelu_mlp(p: GeluMLP, x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(x @ p.w_in + p.b_in, approximate="tanh")
    return h @ p.w_out + p.b_out


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def next_token_loss(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Shifted cross entropy; logits (b, s, v), tokens (b, s)."""
    logits = logits[:, :-1].float()
    targets = tokens[:, 1:].long()
    logz = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, targets[..., None])[..., 0]
    return (logz - tgt).mean()


def _chunk_loss(xc, gamma, w_head, targets):
    """Summed next-token CE of one chunk: norm, head GEMM, fp32 logits."""
    logits = (rms_norm(xc, gamma) @ w_head).float()
    logz = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, targets[..., None])[..., 0]
    return (logz - tgt).sum()


def chunked_ce_loss(x: torch.Tensor, gamma: torch.Tensor,
                    w_head: torch.Tensor, tokens: torch.Tensor, *,
                    chunk: int = 1024) -> torch.Tensor:
    """Next-token CE directly from final hidden states x (b, s, d),
    sequence-chunked so the (b, s, vocab) fp32 logits never exist at once.

    A Python loop over [lo, hi) chunks of the s - 1 positions that have a
    target; each chunk is rematerialised under autograd, so its (b, chunk,
    vocab) fp32 logits are not kept for the backward across chunks. The
    sum over chunks is divided by b·(s - 1), as in the reference.
    """
    b, s, _ = x.shape
    s_eff = s - 1                              # last position has no target
    chunk = min(chunk, s_eff)
    targets = tokens.long()
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for lo in range(0, s_eff, chunk):
        hi = min(lo + chunk, s_eff)
        total = total + remat(_chunk_loss, x[:, lo:hi], gamma, w_head,
                              targets[:, lo + 1:hi + 1])
    return total / (b * s_eff)
