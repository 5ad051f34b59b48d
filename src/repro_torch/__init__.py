"""repro_torch — DPIFrame's CTR inference path in PyTorch, with hand-written
CUDA kernels for Hopper (``sm_90a``).

It mirrors ``repro``'s module layout so each module's counterpart is easy
to find:

  kernels/      plain PyTorch versions (``ref.py``), the CUDA sources
                (``csrc/``), their ctypes wrappers and strategy dispatch
  embedding/    FusedEmbeddingSpec, DenseStore, FusedEmbeddingCollection
  core/         OpGraph + C5 fusion, Alg.-2 scheduler, the executor
                (two CUDA streams at level "dual"), compile_plan
  models/ctr/   DCN, DCNv2, DeepFM, Wide&Deep as ``nn.Module``s
  configs.py    ``ctr_spec``
  data/         dataset schemas and a numpy-seeded id sampler
  bridge.py     loads a reference parameter tree (numpy leaves)

Entry points take ``device=`` and default to ``torch.device("cuda")``;
without a card they raise unless the caller passes ``device="cpu"``.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
