"""pixtral-12b - [hf:mistralai/Pixtral-12B-2409; unverified] pixtral-ViT (stub) + mistral-nemo backbone"""

from repro_torch.models.lm.config import LMConfig

SOURCE = "[hf:mistralai/Pixtral-12B-2409; unverified] pixtral-ViT (stub) + mistral-nemo backbone"

CONFIG = LMConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=131072,
    head_dim=128,
    patch_frontend=True,
    rope_theta=1_000_000.0,
)
