"""Multi-device training on a (pipe, data, model) grid of ranks: `mesh.py`
(the grid and its process groups, batch reconciliation, the shard seed
rule and collectives with a backward), `data_parallel.py` (gradient
reduction, ZeRO-1 and the global norm), `tensor_parallel.py` (the model
axis: the placement rule table, tensor and sequence parallelism) and
`pipeline.py` (the pipe axis: GPipe over a stacked encoder and the
stacked package layout).

Counterpart of openasr_tpu/parallel/.
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
