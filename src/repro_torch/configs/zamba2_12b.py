"""zamba2-1.2b - [arXiv:2411.15242; hf] Mamba2 + shared attn blocks"""

from repro_torch.models.lm.config import LMConfig

SOURCE = "[arXiv:2411.15242; hf] Mamba2 + shared attn blocks"

CONFIG = LMConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32000,
    ssm_state=64,
    ssm_head_dim=64,
    shared_attn_every=6,
    attention="hybrid",
)
