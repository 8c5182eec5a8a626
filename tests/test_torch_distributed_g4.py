"""tests/test_torch_distributed.py's render check at 4 ranks (4 spawned
gloo processes against JAX's make_mesh(4)), in a file of its own to keep
each file's time down; the same tolerances."""

from tests.test_torch_distributed import check_renders


def test_distributed_render_matches_jax_4_ranks():
    check_renders(4)
