"""rwkv6-7b - [arXiv:2404.05892; hf] Finch - data-dependent decay, attn-free"""

from repro_torch.models.lm.config import LMConfig

SOURCE = "[arXiv:2404.05892; hf] Finch - data-dependent decay, attn-free"

CONFIG = LMConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,             # wkv heads = d_model / ssm_head_dim
    n_kv_heads=64,
    d_ff=14336,
    vocab=65536,
    ssm_head_dim=64,
    attention="none",
)
