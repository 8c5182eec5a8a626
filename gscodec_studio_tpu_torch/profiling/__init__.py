"""Microbenchmarks of the kernels on the card (kernel_skel_bench)."""
