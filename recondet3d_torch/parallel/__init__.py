"""Data and tensor parallelism over ``torch.distributed`` (port of
``recondet3d/parallel``): the ``(data, model)`` mesh, the batch-global
reductions over ``data`` and the Megatron-style layout of the DA3 blocks
over ``model`` (``tp.py``)."""

from recondet3d_torch.parallel.distributed import (
    init_distributed,
    is_distributed,
    is_main_process,
    process_device,
    process_info,
)
from recondet3d_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    autoscale_lr,
    data_parallel_size,
    data_sharding,
    get_active_mesh,
    global_cat,
    global_sum,
    local_mesh_context,
    make_mesh,
    replicated,
    shard_batch,
    world_size,
)
from recondet3d_torch.parallel.tp import da3_param_shardings, shard_params
