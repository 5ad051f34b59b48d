"""Launch surface: mesh construction (``mesh.py``), the per-cell step
builder (``steps.py``: ``build_cell``), the serving driver (``python -m
repro_torch.launch.serve``, ``--mesh`` for multi-device serving), the CTR
training driver (``python -m repro_torch.launch.train_ctr``) and the LM
training driver (``python -m repro_torch.launch.train``). The dry run is
still to be ported."""

from .mesh import make_production_mesh, make_test_mesh

__all__ = ["make_production_mesh", "make_test_mesh"]
