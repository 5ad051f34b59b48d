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
backward (``torch.utils.checkpoint``, non-reentrant; a split step's,
reentrant: :func:`_remat_split`). Nothing on the LM
forward draws random numbers, so the recomputation is bitwise the first
run and no RNG state is stashed. ``chunked_ce_loss`` rematerialises every
chunk, ``flash_attention`` every k-block, and each family every layer when
``cfg.remat`` is set; without autograd (serving) nothing is.

Sharding is injected, as in the reference: the functions take ``shard``,
a callable ``(x, logical_axes) -> x`` called where the reference calls
it (``no_shard`` by default; ``distributed.sharding.make_shard_fn`` on a
mesh, which checks the axes and changes no value). With a
:class:`DecodeShardCtx`, ``attention_decode`` runs
:func:`flash_decode_sharded`: each (batch shard, sequence shard) of a
placed KV cache attends over its own slots, and the partial softmax
states merge over the sequence shards in shard order.
"""

from __future__ import annotations

import dataclasses
import math
from collections import Counter
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.bridge import _as_lists, _leaves
from repro_torch.device import cpu_trig
from repro_torch.distributed.tensor_parallel import Cols, Rows

__all__ = ["AttnDims", "Attention", "SwiGLU", "GeluMLP", "LMParams",
           "rms_norm", "rope_freqs", "apply_rope", "attention",
           "attention_decode", "flash_attention", "swiglu", "gelu_mlp",
           "next_token_loss", "chunked_ce_loss", "remat", "take_rows",
           "FLASH_THRESHOLD", "FLASH_CHUNK", "Shard", "no_shard",
           "DecodeShardCtx", "flash_decode_sharded", "place_kv",
           "cross_attention_decode", "whole"]

Shard = Callable[[torch.Tensor, tuple], torch.Tensor]


def no_shard(x: torch.Tensor, logical_axes: tuple) -> torch.Tensor:
    return x


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
    reference's ``jax.checkpoint``). A split step's function (a
    :class:`Rows` among ``args``) takes :func:`_remat_split`."""
    if not (enabled and torch.is_grad_enabled()):
        return fn(*args)
    if any(isinstance(a, Rows) for a in args):
        return _remat_split(fn, args)
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def _remat_split(fn, args: tuple):
    """:func:`remat` of a split step's function: ``checkpoint``'s
    reentrant form over the parts of the :class:`Rows` arguments, ``fn``
    returning a ``Rows``, a tensor, or a tuple of them and None. The
    first run is under ``no_grad``; the backward runs ``fn`` again, to its
    end, inside one autograd node, so it repeats every send and weight
    gather of the first run. (The non-reentrant form recomputes from a
    saved-tensor hook, which a backward spanning several cards enters
    from each card's autograd thread, and two threads can both recompute
    one region.)"""
    rows = [i for i, a in enumerate(args) if isinstance(a, Rows)]
    tp = args[rows[0]].tp
    layout: list = []

    def run(_anchor, *parts):
        it = iter(parts)
        call = list(args)
        for i in rows:
            call[i] = Rows(tp, [next(it) for _ in args[i].parts])
        out = fn(*call)
        outs = out if isinstance(out, tuple) else (out,)
        layout[:] = [*(len(o.parts) if isinstance(o, Rows) else o is None
                       for o in outs), isinstance(out, tuple)]
        return tuple(t for o in outs for t in (
            o.parts if isinstance(o, Rows) else () if o is None else (o,)))

    # the anchor (a leaf that requires grad) makes the outputs require
    # grad when no input does (the encoder's frames): the weights' uses
    # are inside
    flat = iter(checkpoint(run, tp._anchor,
                           *(p for i in rows for p in args[i].parts),
                           use_reentrant=True, preserve_rng_state=False))
    outs = []
    for kind in layout[:-1]:
        if kind is True:                       # a None output
            outs.append(None)
        elif kind is False:                    # a tensor output
            outs.append(next(flat))
        else:
            outs.append(Rows(tp, [next(flat) for _ in range(kind)]))
    return tuple(outs) if layout[-1] else outs[0]


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

    def to_placed_device(self, device) -> None:
        """Run on ``device`` from now on, the weights being placed pieces
        (a model built on ``meta``): its caches and outputs go there, and
        each module whose buffers derive from no parameter makes them
        there anew through its ``derive(device)`` (an attention's RoPE
        table)."""
        self.device = device
        for m in self.modules():
            if m is not self and hasattr(m, "derive"):
                m.derive(device)


# ---------------------------------------------------------------------------
# norms & rotary
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    if isinstance(x, Rows):
        return x.map(rms_norm, gamma, eps=eps)
    if isinstance(x, Cols):
        return _rms_norm_cols(x, gamma, eps)
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * gamma.float()).to(dt)


def _rms_norm_cols(x: Cols, gamma: torch.Tensor, eps: float) -> Cols:
    """:func:`rms_norm` over the whole last dim of a row split into column
    pieces (a recurrent block's heads on their positions): a row in one
    piece is normed where it is; otherwise each piece's fp32 sum of
    squares goes to the row's first position (``tp_reduce``), the sums
    add in model order, and the row's ``rsqrt`` goes back to each piece,
    which scales its columns by it and by its columns of ``gamma``."""
    tp, n = x.tp, gamma.shape[-1]
    out = []
    for i, row in enumerate(x.pieces):
        edges = [(lo, hi) for _, lo, hi, _ in row]
        if (edges[0][0], edges[-1][1]) != (0, n) or any(
                a[1] != b[0] for a, b in zip(edges, edges[1:])):
            raise ValueError(f"pieces {edges} do not cover the {n} normed "
                             "columns")
        if len(row) == 1:
            pos, lo, hi, t = row[0]
            out.append([(pos, lo, hi, rms_norm(t, tp.cols(gamma, lo, hi, pos,
                                                            0), eps))])
            continue
        home = tp.rows[i][0]
        f = [t.float() for *_, t in row]
        ss = None
        for (pos, *_), fj in zip(row, f):
            part = tp.send("tp_reduce", (fj * fj).sum(dim=-1, keepdim=True),
                           pos, home)
            ss = part if ss is None else ss + part
        scale = torch.rsqrt(ss / n + eps)
        out.append([(pos, lo, hi, (fj * tp.send("tp_reduce", scale, home, pos)
                                   * tp.cols(gamma, lo, hi, pos, 0).float()
                                   ).to(t.dtype))
                    for (pos, lo, hi, t), fj in zip(row, f)])
    return Cols(tp, out, x.dim)


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
    cos = cpu_trig(torch.cos, ang)[..., None, :]            # (..., S, 1, hd/2)
    sin = cpu_trig(torch.sin, ang)[..., None, :]
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
        self.register_buffer("freqs", None, persistent=False)
        self.derive(device)

    def derive(self, device) -> None:
        """Make ``freqs`` on ``device`` (anew for a model built on
        ``meta`` whose weights are placed pieces: it runs its steps
        there)."""
        self.freqs = torch.from_numpy(rope_freqs(
            self.dims.head_dim, self.dims.rope_theta)).to(device)

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
         positions: torch.Tensor, rope: bool = True, *,
         shard: Shard = no_shard):
    if isinstance(x, Rows):
        return _qkv_split(p, dims, x, positions, rope)
    b, s, _ = x.shape
    h, kv, hd = dims.n_heads, dims.n_kv_heads, dims.head_dim
    q = (x @ p.wq).reshape(b, s, h, hd)
    k = (x @ p.wk).reshape(b, s, kv, hd)
    v = (x @ p.wv).reshape(b, s, kv, hd)
    # q is head-sharded; k/v keep their kv heads whole
    q = shard(q, ("batch", "seq", "heads", None))
    if dims.qk_norm:
        q = rms_norm(q, p.q_norm)
        k = rms_norm(k, p.k_norm)
    if rope:
        q = apply_rope(q, positions, dims.rope_theta, freqs=p.freqs)
        k = apply_rope(k, positions, dims.rope_theta, freqs=p.freqs)
    return q, k, v


def _qkv_cross(p: Attention, dims: AttnDims, x: torch.Tensor,
               memory: torch.Tensor):
    """Cross attention's q from ``x``, k/v from ``memory`` (no RoPE, no
    qk-norm)."""
    if isinstance(x, Rows):
        return _qkv_split(p, dims, x, None, False, memory=memory)
    b, s, _ = x.shape
    h, kv, hd = dims.n_heads, dims.n_kv_heads, dims.head_dim
    sm = memory.shape[1]
    q = (x @ p.wq).reshape(b, s, h, hd)
    k = (memory @ p.wk).reshape(b, sm, kv, hd)
    v = (memory @ p.wv).reshape(b, sm, kv, hd)
    return q, k, v


def _qkv_split(p: Attention, dims: AttnDims, x: Rows, positions, rope: bool,
               *, memory: Rows | None = None, assemble: bool = False):
    """``_qkv`` (``_qkv_cross`` with ``memory``) on split weights: q, k, v
    as :class:`Cols` of whole heads, (b, s, heads, hd) pieces.

    The projections are column-parallel. Where the split falls on kv-group
    boundaries (wq, wk and wv each split over the row's m model positions,
    m dividing the kv heads) and ``assemble`` is False, each position keeps
    its own heads: q heads [j·h/m, (j+1)·h/m) read kv heads [j·kv/m,
    (j+1)·kv/m), the pairs ``_grouped`` makes. Otherwise every position's
    columns go to the row's first position (``heads``), which then holds
    whole heads. The per-head work (qk-norm, RoPE) runs where the heads
    are."""
    tp = x.tp
    hd = dims.head_dim
    q = tp.col_linear(x, p.wq)
    k = tp.col_linear(x if memory is None else memory, p.wk)
    v = tp.col_linear(x if memory is None else memory, p.wv)
    per_head = (not assemble and dims.n_kv_heads % tp.n_model == 0
                and all(tp.model_dim(w) == 1 for w in (p.wq, p.wk, p.wv)))
    if not per_head:
        q, k, v = (c.gathered("heads") for c in (q, k, v))
    q, k, v = (c.map(lambda t: t.reshape(*t.shape[:2], -1, hd), dim=2)
               for c in (q, k, v))
    if memory is None and dims.qk_norm:
        q = q.map(rms_norm, p.q_norm)
        k = k.map(rms_norm, p.k_norm)
    if rope:
        q, k = (c.map(lambda t, pos, f: apply_rope(
            t, pos, dims.rope_theta, freqs=f), positions, p.freqs)
            for c in (q, k))
    return q, k, v


def _out(p: Attention, attn, shard: Shard = no_shard):
    """Attention's (b, s, h, hd) output through ``wo``; on a split step,
    row-parallel (``TensorParallel.row_linear``), the heads of each
    position matching ``wo``'s rows there or sent there."""
    flat = lambda t: t.reshape(*t.shape[:2], -1)   # noqa: E731
    if isinstance(attn, Rows):
        return attn.tp.row_linear(attn.map(flat), p.wo)
    if isinstance(attn, Cols):
        return attn.tp.row_linear(attn.map(flat, dim=-1), p.wo)
    b, s = attn.shape[:2]
    return shard(attn.reshape(b, s, -1) @ p.wo, ("batch", "seq", "embed"))


def whole(t):
    """A split step's activation (q/k/v heads for a prefill's cache)
    assembled on the mesh's first device (``heads``); a tensor as it
    is."""
    return t.whole("heads") if isinstance(t, (Rows, Cols)) else t


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


def _grouped_logits(q, k):
    """fp32 q·kᵀ/√hd, grouped: q (b, sq, h, hd) over k (b, sk, kv, hd)
    -> (b, kv, h/kv, sq, sk)."""
    b, sq, h, hd = q.shape
    _, sk, kv, _ = k.shape
    g = h // kv
    qg = _grouped(q, kv).reshape(b, kv, g * sq, hd)
    kt = k.permute(0, 2, 3, 1).to(torch.float32,
                                  memory_format=torch.contiguous_format)
    return (torch.matmul(qg, kt) * float(1.0 / np.sqrt(hd))).reshape(
        b, kv, g, sq, sk)


def _grouped_pv(probs, v):
    """probs (b, kv, g, sq, sk) in ``v``'s dtype times v (b, sk, kv, hd)
    -> (b, sq, kv·g, hd)."""
    b, kv, g, sq, sk = probs.shape
    out = torch.matmul(probs.reshape(b, kv, g * sq, sk),
                       v.permute(0, 2, 1, 3).contiguous())
    return _ungrouped(out.reshape(b, kv, g, sq, v.shape[-1]))


def _sdpa_decode(q, k, v, valid):
    """softmax(q·kᵀ/√hd, masked) · v with GQA by grouping: q (b, sq, h,
    hd) over k/v (b, sk, kv, hd), ``valid`` a bool tensor broadcasting to
    (sq, sk) (at decode, the (S_max,) slots written so far) or None.
    Logits in fp32, probabilities in ``v``'s dtype."""
    logits = _grouped_logits(q, k)
    if valid is not None:
        logits = logits.masked_fill(~valid, -1e30)
    return _grouped_pv(torch.softmax(logits, dim=-1).to(v.dtype), v)


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
    if isinstance(q, Cols):
        return q.map(lambda a, b, c: _attend(a, b, c, causal=causal), k, v)
    if q.shape[1] >= FLASH_THRESHOLD or k.shape[1] >= FLASH_THRESHOLD:
        return flash_attention(q, k, v, causal=causal,
                               q_chunk=FLASH_CHUNK, k_chunk=FLASH_CHUNK)
    return _sdpa(q, k, v, causal=causal)


def attention(p: Attention, dims: AttnDims, x: torch.Tensor, *,
              shard: Shard = no_shard, causal: bool = True,
              positions: torch.Tensor | None = None,
              memory: torch.Tensor | None = None,
              rope: bool = True) -> torch.Tensor:
    """Full (prefill) attention; ``memory`` switches to cross-attention."""
    s = x.shape[1]
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=x.device)[None]
    if memory is None:
        q, k, v = _qkv(p, dims, x, positions, rope, shard=shard)
    else:
        # cross attention: q from x, k/v from memory (no rope on memory)
        q, k, v = _qkv_cross(p, dims, x, memory)
        causal = False
    return _out(p, _attend(q, k, v, causal=causal), shard)


@dataclasses.dataclass(frozen=True)
class DecodeShardCtx:
    """Sequence-parallel decode over a placed KV cache: the cache's batch
    splits over ``batch_axes`` (a mesh axis, a tuple of them, or None
    when the batch is not split) and its sequence over ``seq_axis``.

    ``moved`` counts the bytes :func:`flash_decode_sharded` sends between
    mesh positions, by position (``np.ndindex`` tuples), each copy under
    its source and its destination; a copy within a position is not
    counted. It grows until the caller clears it."""
    mesh: object
    batch_axes: tuple | str | None
    seq_axis: str = "model"
    moved: Counter = dataclasses.field(default_factory=Counter,
                                       compare=False, hash=False, repr=False)

    def send(self, t: torch.Tensor, src: tuple, dst: tuple) -> None:
        if src != dst:
            n = t.numel() * t.element_size()
            self.moved[src] += n
            self.moved[dst] += n


def flash_decode_sharded(q, k_cache, v_cache, k_new, v_new,
                         cache_index: int, ctx: DecodeShardCtx):
    """One-token attention over a sequence-split KV cache, with this
    token's k/v written at ``cache_index`` in the one sequence shard that
    owns it (``k_new`` None: no write, ``cache_index`` only bounds the
    visible slots).

    q (b, 1, h, hd) whole on the mesh's first device, or a split step's
    :class:`Rows` (each batch shard's rows on its row's first position;
    ``k_new``/``v_new`` alike); caches (b, S, kv, hd), ``Placed`` as
    ``P(batch_axes, seq_axis, None, None)`` (a tensor or another layout is
    placed so, a copy). Every (batch shard, sequence shard) position takes
    its fp32 logits at the global slots, −1e30 past ``cache_index``, and
    its local max; within each batch row, as the reference's ``pmax`` and
    ``psum`` over the sequence axis do, the row's first position takes
    the max over the row's sequence shards, each position its
    unnormalised ``p``, ``l = Σp`` and ``o = p·v`` (p in ``v``'s dtype),
    and ``l`` and ``o`` sum in shard order 0…n−1 on the row's first
    position, where ``o / max(l, 1e-30)`` stays (a :class:`Rows`) or, for
    a whole ``q``, joins the other rows in order on the mesh's first
    device. A write at or past ``S`` raises ``IndexError`` (the reference
    drops it). Returns (out, k_cache, v_cache), the caches ``Placed`` and
    written in place.

    Every copy between positions goes into ``ctx.moved`` (and, for a
    :class:`Rows`, its ``TensorParallel``'s ``merge`` count): the new k/v
    rows to the position that owns the slot, ``qi`` to each position of
    its row, each local max to the row's first position and the row's
    max back, ``l`` and ``o`` to the row's first position, and, for a
    whole ``q``, each row's output to the first device.
    """
    from repro_torch.distributed.sharding import P, _axes, data_groups, place

    mesh, ax = ctx.mesh, ctx.seq_axis
    split = isinstance(q, Rows)

    def send(t, src, dst):
        ctx.send(t, src, dst)
        if split:
            return q.tp.send("merge", t, src, dst)
        return t.to(mesh.devices[dst])

    spec = P(ctx.batch_axes, ax, None, None)
    kc, vc = place(k_cache, mesh, spec), place(v_cache, mesh, spec)
    s_max = kc.shape[1]
    s_local = s_max // mesh.shape[ax]
    at0 = (0,) * mesh.devices.ndim              # the first device's position
    groups = data_groups(mesh, model_axis=ax,
                         batch_axes=_axes(ctx.batch_axes))
    if split:
        if q.tp.n_rows != len(groups):
            raise ValueError(f"{q.tp.n_rows} batch shards of q for a "
                             f"cache split {len(groups)} ways")
        # the rows that run (row 0 alone in a one-row trace, which counts
        # the others by symmetry)
        groups = q.tp.rows
    # where each batch row's q, k_new and v_new are
    homes = [row[0] for row in groups] if split else [at0] * len(groups)
    b_local = q.parts[0].shape[0] if split else q.shape[0] // len(groups)

    def row_of(t, i):
        return t.parts[i] if split else t[i * b_local:(i + 1) * b_local]

    if k_new is not None:
        if not 0 <= cache_index < s_max:
            raise IndexError(f"decode position {cache_index} is outside "
                             f"the cache's {s_max} slots")
        written = set()
        for pos in np.ndindex(mesh.devices.shape):
            slots = kc.sharding.local_slices(pos, kc.shape)[1]
            if not slots.start <= cache_index < slots.stop:
                continue
            i = kc.sharding.shard_index(pos, 0)
            if i >= len(groups):
                continue
            for cache, new in ((kc, k_new), (vc, v_new)):
                t = cache.local(pos)
                if id(t) not in written:
                    written.add(id(t))
                    t[:, cache_index - slots.start] = send(
                        row_of(new, i)[:, 0], homes[i], pos)
    outs = []
    for i, row in enumerate(groups):
        head = row[0]
        qi = row_of(q, i)
        parts = []
        for j, pos in enumerate(row):
            dev = mesh.devices[pos]
            logits = _grouped_logits(send(qi, homes[i], pos), kc.local(pos))
            kpos = j * s_local + torch.arange(s_local, device=dev)
            parts.append((logits.masked_fill(~(kpos <= cache_index), -1e30),
                          vc.local(pos), pos))
        m = None
        for logits, _, pos in parts:
            m_j = send(logits.amax(dim=-1), pos, head)
            m = m_j if m is None else torch.maximum(m, m_j)
        l = o = None
        for logits, v, pos in parts:
            p = torch.exp(logits - send(m, head, pos)[..., None])
            l_j = send(p.sum(dim=-1), pos, head)
            o_j = send(_grouped_pv(p.to(v.dtype), v), pos, head)
            l, o = (l_j, o_j) if l is None else (l + l_j, o + o_j)
        l = _ungrouped(l[..., None])                      # (b, sq, h, 1)
        out = o / torch.clamp_min(l, 1e-30).to(o.dtype)
        outs.append(out if split else send(out, head, at0))
    return (Rows(q.tp, outs) if split else torch.cat(outs)), kc, vc


def place_kv(cache: dict, keys, ctx: DecodeShardCtx) -> dict:
    """Place each stacked (L, b, S, kv, hd) cache ``cache[key]`` over
    ``ctx``'s mesh, batch over its batch axes and sequence over its
    sequence axis, in the dict (once: a cache placed so stays as it is),
    so that :func:`flash_decode_sharded`'s writes land in the cache the
    caller holds. Returns ``cache``."""
    from repro_torch.distributed.sharding import P, place

    spec = P(None, ctx.batch_axes, ctx.seq_axis, None, None)
    for key in keys:
        cache[key] = place(cache[key], ctx.mesh, spec)
    return cache


def attention_decode(p: Attention, dims: AttnDims, x: torch.Tensor,
                     k_cache, v_cache, cache_index: int, *,
                     shard: Shard = no_shard, rope: bool = True,
                     decode_ctx: DecodeShardCtx | None = None):
    """One-token decode against a (b, S_max, kv, hd) KV cache.

    Writes this token's k/v at ``cache_index`` in place and returns (out
    (b, 1, d), k_cache, v_cache). Masking is positional: slots past
    ``cache_index`` are excluded, so a zeroed cache needs no validity map.
    A position past the cache raises (the reference's
    ``dynamic_update_slice`` would clamp it onto the last slot). With
    ``decode_ctx`` the caches are placed over its mesh and attention runs
    through :func:`flash_decode_sharded`.
    """
    b = x.shape[0]
    s_max = k_cache.shape[1]
    if not 0 <= cache_index < s_max:
        raise IndexError(f"decode position {cache_index} is outside the "
                         f"cache's {s_max} slots")
    if isinstance(x, Rows):
        # q, k_new, v_new whole on each row's first position
        if decode_ctx is None:
            raise ValueError("a split decode step attends through a "
                             "decode_ctx")
        positions = torch.full((x.parts[0].shape[0], 1), cache_index,
                               dtype=torch.int32, device=x.device)
        q, k, v = (c.to_rows("heads") for c in _qkv_split(
            p, dims, x, positions, rope, assemble=True))
        out, k_cache, v_cache = flash_decode_sharded(
            q, k_cache, v_cache, k, v, cache_index, decode_ctx)
        return _out(p, out), k_cache, v_cache
    positions = torch.full((b, 1), cache_index, dtype=torch.int32,
                           device=x.device)
    q, k, v = _qkv(p, dims, x, positions, rope, shard=shard)
    if decode_ctx is not None:
        out, k_cache, v_cache = flash_decode_sharded(
            q, k_cache, v_cache, k, v, cache_index, decode_ctx)
    else:
        k_cache[:, cache_index] = k[:, 0]
        v_cache[:, cache_index] = v[:, 0]
        valid = torch.arange(s_max, device=x.device) <= cache_index
        out = _sdpa_decode(q, k_cache, v_cache, valid)
    return _out(p, out, shard), k_cache, v_cache


def cross_attention_decode(p: Attention, dims: AttnDims, x: torch.Tensor,
                           xk, xv, decode_ctx: DecodeShardCtx | None = None):
    """One token's cross attention over a (b, S_mem, kv, hd) memory's k/v:
    every slot visible, nothing written (through
    :func:`flash_decode_sharded` with ``decode_ctx``). Returns (b, 1,
    d)."""
    if isinstance(x, Rows):
        if decode_ctx is None:
            raise ValueError("a split decode step attends through a "
                             "decode_ctx")
        hd = dims.head_dim
        q = x.tp.col_linear(x, p.wq).to_rows("heads").map(
            lambda t: t.reshape(*t.shape[:2], -1, hd))
    else:
        q = (x @ p.wq).reshape(x.shape[0], 1, dims.n_heads, dims.head_dim)
    if decode_ctx is not None:
        attn, _, _ = flash_decode_sharded(q, xk, xv, None, None,
                                          xk.shape[1] + 1, decode_ctx)
    else:
        attn = _attend(q, xk, xv, causal=False)
    return _out(p, attn)


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


def swiglu(p: SwiGLU, x: torch.Tensor,
           shard: Shard = no_shard) -> torch.Tensor:
    if isinstance(x, Rows):
        tp = x.tp
        h = tp.col_linear(x, p.w_gate).map(lambda g, u: F.silu(g) * u,
                                           tp.col_linear(x, p.w_up))
        return tp.row_linear(h, p.w_down, kind="tp_reduce")
    h = shard(F.silu(x @ p.w_gate) * (x @ p.w_up), ("batch", "seq", "mlp"))
    return shard(h @ p.w_down, ("batch", "seq", "embed"))


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


def gelu_mlp(p: GeluMLP, x: torch.Tensor,
             shard: Shard = no_shard) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    if isinstance(x, Rows):
        tp = x.tp
        h = tp.col_linear(x, p.w_in, p.b_in).map(
            lambda t: F.gelu(t, approximate="tanh"))
        return tp.row_linear(h, p.w_out, p.b_out, kind="tp_reduce")
    h = F.gelu(x @ p.w_in + p.b_in, approximate="tanh")
    h = shard(h, ("batch", "seq", "mlp"))
    return shard(h @ p.w_out + p.b_out, ("batch", "seq", "embed"))


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


def _chunk_loss(xc, gamma, w_head, targets, shard: Shard = no_shard):
    """Summed next-token CE of one chunk: norm, head GEMM, fp32 logits."""
    logits = shard((rms_norm(xc, gamma) @ w_head).float(),
                   ("batch", "seq", "vocab"))
    logz = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, targets[..., None])[..., 0]
    return (logz - tgt).sum()


def chunked_ce_loss(x: torch.Tensor, gamma: torch.Tensor,
                    w_head: torch.Tensor, tokens: torch.Tensor, *,
                    chunk: int = 1024, shard: Shard = no_shard,
                    transposed: bool = False) -> torch.Tensor:
    """Next-token CE directly from final hidden states x (b, s, d),
    sequence-chunked so the (b, s, vocab) fp32 logits never exist at once.

    A Python loop over [lo, hi) chunks of the s - 1 positions that have a
    target; each chunk is rematerialised under autograd, so its (b, chunk,
    vocab) fp32 logits are not kept for the backward across chunks. The
    sum over chunks is divided by b·(s - 1), as in the reference.
    ``transposed``: ``w_head`` is a (vocab, d) table read as ``w_head.T``
    (a tied head). A split step's ``x`` (:class:`Rows`) takes
    :func:`_chunked_ce_split`.
    """
    if isinstance(x, Rows):
        return _chunked_ce_split(x, gamma, w_head, tokens, chunk,
                                 transposed)
    if transposed:
        w_head = w_head.T
    b, s, _ = x.shape
    s_eff = s - 1                              # last position has no target
    chunk = min(chunk, s_eff)
    targets = tokens.long()
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for lo in range(0, s_eff, chunk):
        hi = min(lo + chunk, s_eff)
        total = total + remat(_chunk_loss, x[:, lo:hi], gamma, w_head,
                              targets[:, lo + 1:hi + 1], shard)
    return total / (b * s_eff)


def _chunk_loss_split(xc: Rows, gamma, w, targets: Rows, transposed: bool):
    """:func:`_chunk_loss` of one chunk on split weights, summed per batch
    row, vocab-parallel: each model position of a row multiplies the
    row's normed chunk (sent there, ``tp_reduce``) by its vocab columns
    and sends its fp32 row max, its sum of ``exp(logit - max)`` and the
    target's logit where the target is in its range (else 0) to the row's
    first position (``vocab``), which forms ``logsumexp`` from them (the
    maxes are constants to autograd, as ``logsumexp``'s own shift is).
    No position holds more than its own vocab columns of the logits."""
    tp = xc.tp
    xn = rms_norm(xc, gamma)
    vdim = 0 if transposed else 1
    split = tp.model_dim(w) == vdim
    out = []
    for i, row in enumerate(tp.rows):
        home = row[0]
        tgt_i = targets.parts[i]
        maxes, sums, tgts = [], [], []
        for j, pos in enumerate(row if split else row[:1]):
            lo, hi = (tp.model_range(w, j) if split
                      else (0, tp.placed(w).shape[vdim]))
            wj = tp.weight(w, pos)
            logits = (xn.at(i, j) @ (wj.T if transposed else wj)).float()
            m = logits.amax(dim=-1).detach()
            t = tp.send("vocab", tgt_i, home, pos)
            ins = (t >= lo) & (t < hi)
            picked = torch.gather(logits, -1, torch.where(
                ins, t - lo, 0).long()[..., None])[..., 0]
            maxes.append(tp.send("vocab", m, pos, home))
            sums.append(tp.send("vocab", torch.exp(
                logits - m[..., None]).sum(dim=-1), pos, home))
            tgts.append(tp.send("vocab", torch.where(ins, picked, 0.0), pos,
                                home))
        mx = maxes[0]
        for m in maxes[1:]:
            mx = torch.maximum(mx, m)
        z = tgt = None
        for m, sm, tg in zip(maxes, sums, tgts):
            zj = sm * torch.exp(m - mx)
            z = zj if z is None else z + zj
            tgt = tg if tgt is None else tgt + tg
        out.append((mx + torch.log(z) - tgt).sum())
    return Rows(tp, out)


def _chunked_ce_split(x: Rows, gamma, w, tokens, chunk: int,
                      transposed: bool) -> torch.Tensor:
    """:func:`chunked_ce_loss` on split weights: each batch row's chunks
    rematerialised (:func:`_chunk_loss_split`) and summed on the row's
    first position, the rows' sums sent to the mesh's first position
    (``vocab``) and added in row order there, then divided by
    b·(s - 1)."""
    tp = x.tp
    b, s, _ = x.shape
    s_eff = s - 1
    chunk = min(chunk, s_eff)
    targets = tp.split_rows(tokens)
    totals = None
    for lo in range(0, s_eff, chunk):
        hi = min(lo + chunk, s_eff)
        part = remat(_chunk_loss_split, x[:, lo:hi], gamma, w,
                     targets[:, lo + 1:hi + 1], transposed)
        totals = part if totals is None else totals + part
    at0 = (0,) * tp.mesh.devices.ndim
    total = None
    for i, t in enumerate(totals.parts):
        t = tp.send_fixed("vocab", t, tp.rows[i][0], at0)
        total = t if total is None else total + t
    return total / (b * s_eff)
