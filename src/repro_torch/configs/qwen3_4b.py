"""qwen3-4b - [hf:Qwen/Qwen3-8B; hf] qk_norm, GQA"""

from repro_torch.models.lm.config import LMConfig

SOURCE = "[hf:Qwen/Qwen3-8B; hf] qk_norm, GQA"

CONFIG = LMConfig(
    name="qwen3-4b",
    family="dense",
    n_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_ff=9728,
    vocab=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1_000_000.0,
)
