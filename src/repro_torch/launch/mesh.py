"""Production meshes of the LM zoo.

Counterpart of ``repro.launch.mesh``:

    single pod:  (data=16, model=16)           = 256 positions
    multi-pod :  (pod=2, data=16, model=16)    = 512 positions

``devices`` is :func:`repro_torch.distributed.make_mesh`'s: ``None``
needs one CUDA card a position and raises, naming the count, on a host
with fewer; ``"meta"`` builds the mesh on the meta device, which holds no
storage, for the dry run and ``Cell.lower()``.
"""

from __future__ import annotations

from repro_torch.distributed.mesh import Mesh, make_mesh, make_test_mesh

__all__ = ["make_production_mesh", "make_test_mesh"]


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices)
