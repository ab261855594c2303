from dtdl_tpu_torch.runtime.bootstrap import (  # noqa: F401
    BarrierTimeoutError, barrier, initialize, is_leader, process_count,
    process_index,
)
from dtdl_tpu_torch.runtime.mesh import (  # noqa: F401
    DATA_AXIS, DCN_AXIS, MODEL_AXIS, Mesh, batch_sharded, build_mesh,
    ShrinkMeshError, hybrid_mesh, local_mesh, replicated, shrink_mesh,
)
from dtdl_tpu_torch.runtime.topology import describe_topology  # noqa: F401
