"""Launch surface: mesh construction (``mesh.py``), the per-cell step
builder (``steps.py``: ``build_cell``), the serving driver (``python -m
repro_torch.launch.serve``, ``--mesh`` for multi-device serving), the CTR
training driver (``python -m repro_torch.launch.train_ctr``) and the LM
training driver (``python -m repro_torch.launch.train``) and the dry run
(``python -m repro_torch.launch.dryrun``: roofline records of every
cell from meta traces of its step)."""

from .mesh import make_production_mesh, make_test_mesh

__all__ = ["make_production_mesh", "make_test_mesh"]
