from dtdl_tpu_torch.runtime.bootstrap import (  # noqa: F401
    BarrierTimeoutError, barrier, initialize, is_leader, process_count,
    process_index,
)
from dtdl_tpu_torch.runtime.mesh import (  # noqa: F401
    DATA_AXIS, Mesh, build_mesh, hybrid_mesh, local_mesh, shrink_mesh,
)
from dtdl_tpu_torch.runtime.topology import describe_topology  # noqa: F401
