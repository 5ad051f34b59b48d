"""CTR model zoo — the paper's four evaluation models."""

from .common import CTRModel, CTRModelSpec
from .dcn import DCN
from .dcnv2 import DCNv2
from .deepfm import DeepFM
from .widedeep import WideDeep

CTR_MODELS = {
    "dcn": DCN,
    "dcnv2": DCNv2,
    "widedeep": WideDeep,
    "deepfm": DeepFM,
}

__all__ = ["CTRModel", "CTRModelSpec", "CTR_MODELS", "DCN", "DCNv2",
           "WideDeep", "DeepFM"]
