"""granite-8b - [arXiv:2405.04324; hf] dense llama-arch, code"""

from repro_torch.models.lm.config import LMConfig

SOURCE = "[arXiv:2405.04324; hf] dense llama-arch, code"

CONFIG = LMConfig(
    name="granite-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=49152,
)
