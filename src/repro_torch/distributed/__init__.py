"""Multi-device paths: a single-controller device mesh, the sharding
rules of the CTR path and the LM zoo, and placed tensors (``mesh.py``,
``sharding.py``).

Counterpart of ``repro.distributed``. One process drives every mesh
position; see ``mesh.py``.
"""

from .mesh import Mesh, make_mesh, make_test_mesh
from .sharding import (LOGICAL_RULES, LOGICAL_RULES_FSDP, NamedSharding, P,
                       Placed, batch_specs, cache_specs, ctr_param_specs,
                       data_groups, drop_axis, fit_spec, fit_spec_tree,
                       fsdp_param_specs, input_shardings, make_shard_fn,
                       mesh_batch_axes, param_specs, place, place_tree,
                       to_named)

__all__ = ["Mesh", "make_mesh", "make_test_mesh", "NamedSharding", "P",
           "Placed", "batch_specs", "ctr_param_specs", "data_groups",
           "drop_axis", "fit_spec", "fit_spec_tree", "input_shardings",
           "mesh_batch_axes", "place", "place_tree", "to_named",
           "LOGICAL_RULES", "LOGICAL_RULES_FSDP", "make_shard_fn",
           "fsdp_param_specs", "param_specs", "cache_specs"]
