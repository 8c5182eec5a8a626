"""PyTorch / CUDA port of ``gscodec_studio_tpu`` for one NVIDIA H100.

The layout follows the JAX package, module for module. Plain tensor math is
PyTorch; the TPU's Pallas kernels become CUDA kernels written for
``sm_90a`` (``csrc/``, built at first use by :mod:`.native`). Entry points
run on the card unless the caller passes ``device="cpu"``, which selects the
kernels' plain PyTorch versions (the CPU tests use them).
"""
