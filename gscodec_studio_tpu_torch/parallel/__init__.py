from gscodec_studio_tpu_torch.parallel.distributed import (  # noqa: F401
    Mesh,
    distributed_render,
    distributed_train_step,
    make_mesh,
    rasterize_sharded,
    sharded_rasterization,
)
