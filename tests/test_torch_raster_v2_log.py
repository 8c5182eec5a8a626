"""The log-space transmittance scan (log_composite) of
gscodec_studio_tpu_torch's fused rasterizer against the JAX package, whose
Pallas kernels run in interpret mode on the CPU: alone, and with bf16
attribute rows, u16 positions and bf16 gradient rows together (bench.py's
packed configuration, with the u16 positions as well). The tolerances are
those of test_torch_raster_v2_packed.py."""

import pytest

from tests.test_torch_raster_v2_packed import check_images_and_gradients


@pytest.mark.parametrize("name,ts,cutoff", [
    ("log", 16, "exact"), ("log", 32, "soft"),
    ("all_bf16_grads", 16, "exact"), ("all_bf16_grads", 32, "soft"),
])
def test_images_and_gradients_match_jax(rng, name, ts, cutoff):
    check_images_and_gradients(rng, name, ts, cutoff)
