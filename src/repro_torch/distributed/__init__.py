"""Multi-device CTR: a single-controller device mesh, the sharding rules
of the CTR path and placed tensors (``mesh.py``, ``sharding.py``).

Counterpart of ``repro.distributed`` and ``repro.launch.mesh`` for the
CTR path. One process drives every mesh position; see ``mesh.py``.
"""

from .mesh import Mesh, make_mesh, make_test_mesh
from .sharding import (NamedSharding, P, Placed, batch_specs,
                       ctr_param_specs, data_groups, drop_axis, fit_spec,
                       fit_spec_tree, input_shardings, mesh_batch_axes,
                       place, place_tree, to_named)

__all__ = ["Mesh", "make_mesh", "make_test_mesh", "NamedSharding", "P",
           "Placed", "batch_specs", "ctr_param_specs", "data_groups",
           "drop_axis", "fit_spec", "fit_spec_tree", "input_shardings",
           "mesh_batch_axes", "place", "place_tree", "to_named"]
