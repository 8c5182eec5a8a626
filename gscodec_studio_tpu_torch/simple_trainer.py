"""Static 3DGS training from a COLMAP scene (port of
examples/simple_trainer.py), on the CUDA card unless ``--device cpu``:

    python -m gscodec_studio_tpu_torch.simple_trainer default \
        --data-dir data/garden --max-steps 30000
    python -m gscodec_studio_tpu_torch.simple_trainer mcmc \
        --data-dir data/garden --compression-sim true --entropy-model-opt true

Every field of ``training.trainer.Config`` is a flag (``--field-name``).
After training it evaluates the validation views, writes the checkpoint
result_dir/ckpts/ckpt_<max_steps>.npz and (but under ``--app-opt``, whose
splats have no SH colours) result_dir/point_cloud.ply, and under
``--compression-sim`` compresses the scene with the PNG codec.
"""

from __future__ import annotations

import argparse
import os

from gscodec_studio_tpu_torch.training.trainer import Config, Runner
from gscodec_studio_tpu_torch.utils.cli import parse_config

PRESETS = {
    "default": Config(strategy="default"),
    "mcmc": Config(
        strategy="mcmc", opacity_reg=0.01, scale_reg=0.01, init_opa=0.5,
        init_scale=0.1,
    ),
}


def main(argv=None) -> Runner:
    """Trains as the command line ``argv`` (sys.argv[1:] when None) says;
    returns the Runner."""
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default=None,
                     help="torch device (default: the CUDA card)")
    ns, rest = pre.parse_known_args(argv)
    cfg = parse_config(Config, PRESETS, rest)
    runner = Runner(cfg, device=ns.device)
    runner.train()
    print("eval:", runner.eval(), flush=True)
    runner.save_checkpoint(cfg.max_steps)
    if cfg.app_opt:
        # the JAX entry point's save_ply fails here (no sh0 under app_opt)
        print("point_cloud.ply not written: the Inria PLY holds SH colours, "
              "and app_opt's colours come from features through an MLP",
              flush=True)
    else:
        runner.save_ply(os.path.join(cfg.result_dir, "point_cloud.ply"))
    if cfg.compression_sim:
        print("compression:", runner.run_compression(cfg.max_steps, "png"),
              flush=True)
    return runner


if __name__ == "__main__":
    main()
