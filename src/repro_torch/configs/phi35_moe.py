"""phi3.5-moe-42b-a6.6b - [hf:microsoft/Phi-3.5-MoE-instruct; hf] 16 experts top-2"""

from repro_torch.models.lm.config import LMConfig

SOURCE = "[hf:microsoft/Phi-3.5-MoE-instruct; hf] 16 experts top-2"

CONFIG = LMConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6400,
    vocab=32064,
    n_experts=16,
    top_k=2,
)
