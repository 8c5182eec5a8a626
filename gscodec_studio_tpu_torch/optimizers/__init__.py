from gscodec_studio_tpu_torch.optimizers.builders import (  # noqa: F401
    apply_updates,
    build_splat_optimizers,
)
