"""llama3-8b - [arXiv:2407.21783; unverified] GQA 128k vocab"""

from repro_torch.models.lm.config import LMConfig

SOURCE = "[arXiv:2407.21783; unverified] GQA 128k vocab"

CONFIG = LMConfig(
    name="llama3-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=128256,
    rope_theta=500_000.0,
)
