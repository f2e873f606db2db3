"""The mesh layer of the port: a ``torch.distributed`` mesh
(:mod:`.compat`), the error-free collectives the sharded emulation sums
with (:mod:`.collectives`) and the logical-axis rule tables
(:mod:`.sharding`)."""
from repro_torch.distributed.sharding import (SINGLE_POD_RULES,
                                              MULTI_POD_RULES, use_rules,
                                              get_rules, logical_to_pspec,
                                              spec_tree)
from repro_torch.distributed import collectives, compat
