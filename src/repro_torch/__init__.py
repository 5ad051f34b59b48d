"""repro_torch — DPIFrame's CTR inference path in PyTorch, with hand-written
CUDA kernels for Hopper (``sm_90a``), and the LM zoo's serving path.

It mirrors ``repro``'s module layout so each module's counterpart is easy
to find:

  kernels/      plain PyTorch versions (``ref.py``), the CUDA sources
                (``csrc/``), their ctypes wrappers and strategy dispatch
  embedding/    FusedEmbeddingSpec, DenseStore, FusedEmbeddingCollection
  core/         OpGraph + C5 fusion, Alg.-2 scheduler, the executor
                (two CUDA streams at level "dual"), compile_plan
  models/ctr/   DCN, DCNv2, DeepFM, Wide&Deep as ``nn.Module``s
  models/lm/    the LM zoo: dense, MoE, RWKV6, Zamba2, Whisper, Pixtral
  serving/      batching policies, InferenceEngine, DeviceScheduler,
                ServingRuntime, delta sources, LM ``generate``
  launch/       the serving CLI (``python -m repro_torch.launch.serve``)
  configs/      ``ctr_spec`` and the ten LM architectures
  data/         dataset schemas, numpy-seeded id samplers (``zipf_ids``)
  bridge.py     loads a reference parameter tree (numpy leaves)

Entry points take ``device=`` and default to ``torch.device("cuda")``;
without a card they raise unless the caller passes ``device="cpu"``.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
