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


def make_ctr_model(name: str, spec: CTRModelSpec, *, device=None) -> CTRModel:
    """The model ``name`` of ``CTR_MODELS`` for ``spec`` on ``device``
    (CUDA by default)."""
    return CTR_MODELS[name](spec, device=device)

__all__ = ["CTRModel", "CTRModelSpec", "CTR_MODELS", "make_ctr_model",
           "DCN", "DCNv2",
           "WideDeep", "DeepFM"]
