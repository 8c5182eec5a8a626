"""One full training step of the mesh Runner over G ranks (port of
__graft_entry__.dryrun_multichip): MCMC with the compression simulation
and its entropy models, 100,000 Gaussians rendered at 256x256, the
capacity-bounded exchange at 4,096 rows a destination, which the visible
rows overflow.

    python -m gscodec_studio_tpu_torch.parallel.dryrun --ranks 2 \\
        --backend gloo [--device cpu] [--n-gauss 100000] [--size 256]

spawns the ranks on this machine; under torchrun
(``torchrun --nproc_per_node=G -m gscodec_studio_tpu_torch.parallel.dryrun``)
each process is one rank of the group torchrun describes.
"""

from __future__ import annotations

import argparse
import json
import tempfile
from typing import Optional

import numpy as np
import torch

EXCHANGE_CAP = 4096  # well below the visible rows: the overflow fires


class _Parser:
    """The dryrun's point cloud: N points in a 4-unit cube, seeded."""

    def __init__(self, rng, n: int):
        self.points = ((rng.random((n, 3)) - 0.5) * 4).astype(np.float32)
        self.points_rgb = (rng.random((n, 3)) * 255).astype(np.uint8)
        self.points_err = np.zeros(n)
        self.scene_scale = 2.0


class _Views:
    """n views 6 units behind the cloud, with random targets."""

    def __init__(self, rng, n_views: int, width: int, height: int):
        K = np.array([[1.2 * width, 0, width / 2],
                      [0, 1.2 * width, height / 2], [0, 0, 1]], np.float32)
        self.items = []
        for i in range(n_views):
            c2w = np.eye(4, dtype=np.float32)
            c2w[:3, 3] = [0.05 * i, 0.0, -6.0]
            self.items.append({
                "K": K, "camtoworld": c2w,
                "image": rng.random((height, width, 3)).astype(np.float32),
                "image_id": i})

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def dryrun_multichip(n_devices: int, n_gauss: int = 100_000, wh=(256, 256),
                     device=None, result_dir: Optional[str] = None,
                     exchange_cap: int = EXCHANGE_CAP) -> dict:
    """Runs in every rank of a process group of ``n_devices`` ranks: one
    step of the mesh Runner with the JAX dryrun's configuration (the data
    drawn from the same seed, with numpy). Returns the step's loss and the
    exchange's diagnostics; raises if the loss is not finite."""
    from gscodec_studio_tpu_torch.training.trainer import Config, Runner

    rng = np.random.default_rng(0)
    G, N = n_devices, n_gauss
    W, H = wh
    parser = _Parser(rng, N)
    trainset = _Views(rng, max(G, 2), W, H)
    valset = _Views(rng, 1, W, H)
    cfg = Config(
        result_dir=result_dir or tempfile.mkdtemp(prefix="gsc_dryrun_"),
        max_steps=1, batch_size=G, sh_degree=1, sh_degree_interval=1,
        strategy="mcmc", mcmc_cap_max=N, isect_capacity=1 << 17,
        steps_per_dispatch=1, mesh_devices=G, exchange_cap=exchange_cap,
        compression_sim=True, entropy_model_opt=True, eval_steps=(),
        save_steps=(), tb_every=0)
    runner = Runner(cfg, parser=parser, trainset=trainset, valset=valset,
                    device=device)
    B = cfg.batch_size
    idx = [runner.view_order[j % len(runner.view_order)] for j in range(B)]
    out = runner.train_step(idx, 0, 0)
    if not np.isfinite(out["loss"]) or out["skipped"]:
        raise AssertionError(f"dryrun_multichip({G}): step {out}")
    return dict(loss=out["loss"], n_isects=out["n_isects"],
                exchange=out["exchange"], gaussians=N, width=W, height=H,
                exchange_cap=exchange_cap, ranks=G)


def _rank(rank: int, world: int, n_gauss: int, size: int,
          device: Optional[str]):
    if device is None:
        torch.cuda.set_device(0 if torch.cuda.device_count() == 1 else rank)
    return dryrun_multichip(world, n_gauss, (size, size), device=device)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ranks", type=int, default=2)
    p.add_argument("--backend", default="nccl")
    p.add_argument("--device", default=None,
                   help="cpu, or the card (cuda:rank) when not given")
    p.add_argument("--n-gauss", type=int, default=100_000)
    p.add_argument("--size", type=int, default=256)
    args = p.parse_args(argv)
    from gscodec_studio_tpu_torch.parallel import launcher

    if launcher.init_multihost(args.backend):  # under torchrun
        try:
            rank = torch.distributed.get_rank()
            out = dryrun_multichip(
                torch.distributed.get_world_size(), args.n_gauss,
                (args.size, args.size),
                device=args.device or launcher.local_devices()[0])
        finally:
            torch.distributed.destroy_process_group()
        if rank == 0:
            print(json.dumps(out), flush=True)
        return out
    out = launcher.spawn(_rank, args.ranks, args.n_gauss, args.size,
                         args.device, backend=args.backend)[0]
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
