from gscodec_studio_tpu_torch.compression_sim.ops import (  # noqa: F401
    fake_quantize_ste,
    inverse_log_transform,
    log_transform,
    ste_binary,
)
from gscodec_studio_tpu_torch.compression_sim.entropy_model import (  # noqa: F401,E501
    factorized_bits,
    init_factorized,
)
from gscodec_studio_tpu_torch.compression_sim.ada_mask import (  # noqa: F401
    annealing_mask_apply,
    annealing_mask_sparsity_loss,
)
from gscodec_studio_tpu_torch.compression_sim.simulation import (  # noqa: F401,E501
    CompressionSimulation,
    STGCompressionSimulation,
)
