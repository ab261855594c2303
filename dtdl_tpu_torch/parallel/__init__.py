from dtdl_tpu_torch.parallel import collectives  # noqa: F401
from dtdl_tpu_torch.parallel.strategy import (  # noqa: F401
    AutoSharded, DataParallel, MeshStrategy, SingleDevice, Strategy,
    check_strategy, choose_strategy, data_parallel_local,
    distributed_data_parallel,
)
from dtdl_tpu_torch.parallel.kvstore import (  # noqa: F401
    KVStore, KVStoreStrategy, kvstore_strategy,
)
