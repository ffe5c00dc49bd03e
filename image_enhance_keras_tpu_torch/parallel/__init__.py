"""Scale-out (mirror of ``parallel/``): meshes, the multi-process bootstrap,
the sharded engine and the data-parallel train steps."""

from image_enhance_keras_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    device_count,
    make_dcn_mesh,
    make_hybrid_mesh,
    make_mesh,
)
from image_enhance_keras_tpu_torch.parallel.distributed import maybe_init_distributed  # noqa: F401
from image_enhance_keras_tpu_torch.parallel.data_parallel import (  # noqa: F401
    ShardedResolver,
    shard_batch,
    shard_eval_step,
    shard_train_step,
)
