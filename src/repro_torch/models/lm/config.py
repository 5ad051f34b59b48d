"""LMConfig — one static description shared by every assigned architecture.

Counterpart of ``repro.models.lm.config``, field for field. The port's
layers are an ``nn.ModuleList`` run in a Python loop. ``remat`` keeps the
reference's meaning under autograd: each layer is rematerialised in the
backward (``layers.remat``); serving never records a graph, so it is
unaffected. ``scan_layers`` only picks the order in which
``MoETransformer.loss_terms`` averages the layers' aux terms.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None    # defaults to d_model // n_heads
    qk_norm: bool = False
    tie_embeddings: bool = False
    # --- moe ---
    n_experts: int = 0
    top_k: int = 1
    capacity_factor: float = 1.25
    # H3: replicate dispatched token buffers over the data axis instead
    # of gathering d-sharded expert weights (right when weights >> tokens)
    moe_token_replicate: bool = False
    # --- ssm / hybrid ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    conv_kernel: int = 4
    shared_attn_every: int = 0     # zamba2: one shared attn block per N layers
    # --- enc-dec ---
    encoder_layers: int = 0
    # --- vlm ---
    patch_frontend: bool = False
    # --- numerics / compile ---
    dtype: str = "bfloat16"
    rope_theta: float = 10_000.0
    remat: bool = True
    scan_layers: bool = True
    # attention flavour: "full" | "none" (ssm) — long_500k eligibility
    attention: str = "full"

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else (
            self.d_model // self.n_heads)

    def reduced(self, **overrides) -> "LMConfig":
        """Tiny same-family variant for CPU smoke tests."""
        base = dict(
            n_layers=2,
            d_model=64,
            n_heads=4,
            n_kv_heads=2 if self.n_kv_heads < self.n_heads else 4,
            d_ff=128,
            vocab=256,
            head_dim=16 if self.head_dim is not None else None,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            shared_attn_every=2 if self.shared_attn_every else 0,
            encoder_layers=2 if self.encoder_layers else 0,
            dtype="float32",
            remat=False,
        )
        base.update(overrides)
        return dataclasses.replace(self, **base)
