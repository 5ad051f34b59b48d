"""whisper-small - [arXiv:2212.04356; unverified] enc-dec, conv frontend (stub)"""

from repro_torch.models.lm.config import LMConfig

SOURCE = "[arXiv:2212.04356; unverified] enc-dec, conv frontend (stub)"

CONFIG = LMConfig(
    name="whisper-small",
    family="encdec",
    n_layers=12,            # decoder
    encoder_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab=51865,
)
