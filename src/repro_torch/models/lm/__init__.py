"""The LM zoo's serving path.

Counterpart of ``repro.models.lm``. Families: dense GQA decoder,
capacity-routed MoE, RWKV6 (attention-free), Zamba2 (Mamba2 + shared
attention), Whisper (enc-dec), Pixtral (VLM). Each is an ``nn.Module``
owning its tensors on one device: ``init(generator)`` draws them,
``forward``, ``init_cache``, ``prefill`` and ``decode_step`` serve, and
``loss(batch)`` trains through ``param_tree()``. ``shard`` is the
reference's activation hook (``distributed.sharding.make_shard_fn`` on a
mesh) and a model's ``decode_ctx`` its sequence-parallel decode
(``layers.DecodeShardCtx``); ``launch.steps.build_cell`` sets both.
"""

from .config import LMConfig
from .moe import MoETransformer
from .pixtral import Pixtral
from .rwkv6 import RWKV6
from .transformer import DenseTransformer
from .whisper import Whisper
from .zamba2 import Zamba2

FAMILY_CLASSES = {
    "dense": DenseTransformer,
    "moe": MoETransformer,
    "ssm": RWKV6,
    "hybrid": Zamba2,
    "encdec": Whisper,
    "vlm": Pixtral,
}


def make_lm_model(cfg: LMConfig, shard=None, *, device=None):
    """The family's model for ``cfg`` on ``device`` (CUDA by default;
    raises without a card unless ``device="cpu"``; ``"meta"`` holds
    shapes and no storage), its tensors zero until ``init(generator)`` or
    ``bridge.load_lm_params``. ``shard`` (default: none) is called on the
    activations where the reference calls its hook."""
    return FAMILY_CLASSES[cfg.family](cfg, shard, device=device)


__all__ = ["LMConfig", "DenseTransformer", "MoETransformer", "RWKV6",
           "Zamba2", "Whisper", "Pixtral", "FAMILY_CLASSES", "make_lm_model"]
