"""smollm-360m - [hf:HuggingFaceTB/SmolLM-135M; hf] dense llama-arch small"""

from repro_torch.models.lm.config import LMConfig

SOURCE = "[hf:HuggingFaceTB/SmolLM-135M; hf] dense llama-arch small"

CONFIG = LMConfig(
    name="smollm-360m",
    family="dense",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    d_ff=2560,
    vocab=49152,
)
