from gscodec_studio_tpu_torch.optimizers.builders import (  # noqa: F401
    apply_updates,
    build_splat_optimizers,
)
from gscodec_studio_tpu_torch.optimizers.selective_adam import (  # noqa: F401,E501
    selective_adam_step,
)
