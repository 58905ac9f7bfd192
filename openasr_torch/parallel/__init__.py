"""Multi-device training: the data axis (`mesh.py`: the process group,
batch reconciliation, the shard seed rule and collectives with a backward;
`data_parallel.py`: gradient reduction, ZeRO-1 and the global norm).

Counterpart of the data axis of openasr_tpu/parallel/.  The model axis
(tensor and sequence parallelism) and the pipe axis (GPipe) are ROADMAP
queue 1 items 15b and 15c.
"""

from openasr_torch.parallel.mesh import (  # noqa: F401
    DataGroup,
    all_gather_host,
    init_distributed,
    new_group,
    partition_seed,
    reconcile_batch,
)
