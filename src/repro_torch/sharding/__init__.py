"""Logical-axis sharding rules on a ``torch.distributed`` ``DeviceMesh``
(torch counterpart of ``repro/sharding``)."""
from repro_torch.sharding.rules import (PartitionSpec, activation_sharding,
                                        constrain, default_rules, local_shape,
                                        placements, spec_for, tree_specs)

__all__ = ["PartitionSpec", "activation_sharding", "constrain",
           "default_rules", "local_shape", "placements", "spec_for",
           "tree_specs"]
