"""Multi-device training on a (data, model) grid of ranks: `mesh.py` (the
grid and its process groups, batch reconciliation, the shard seed rule and
collectives with a backward), `data_parallel.py` (gradient reduction,
ZeRO-1 and the global norm) and `tensor_parallel.py` (the model axis:
the placement rule table, tensor and sequence parallelism).

Counterpart of openasr_tpu/parallel/.  The pipe axis (GPipe) is ROADMAP
queue 1 item 15c.
"""

from openasr_torch.parallel.mesh import (  # noqa: F401
    DataGroup,
    Grid,
    all_gather_host,
    init_distributed,
    new_group,
    partition_seed,
    reconcile_batch,
)
