"""llama4-maverick-400b-a17b - [hf:meta-llama/Llama-4-Scout-17B-16E; unverified] MoE, early fusion"""

from repro_torch.models.lm.config import LMConfig

SOURCE = "[hf:meta-llama/Llama-4-Scout-17B-16E; unverified] MoE, early fusion"

CONFIG = LMConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab=202048,
    n_experts=128,
    top_k=1,
    moe_token_replicate=True,
)
