"""Rank functions for the port's mesh tests (tests/test_torch_distributed*.py,
tests/test_torch_train_mesh.py). The ranks run in processes that
``gscodec_studio_tpu_torch.parallel.launcher.spawn`` starts, which import
this module by name: it imports neither JAX nor the JAX package, so a rank
starts in a second or two. Every scene is made from a seed with numpy,
as the tests make the JAX side's."""

import dataclasses
import os
import sys

import numpy as np
import torch

from gscodec_studio_tpu_torch.optimizers import build_splat_optimizers
from gscodec_studio_tpu_torch.parallel.distributed import (
    distributed_render, distributed_train_step, make_mesh, shard_rows)


def _cpu(tree):
    return {k: v.detach().cpu().clone() for k, v in tree.items()}


def render_ranks(rank, world, splats, viewmats, Ks, W, H, caps):
    """distributed_render of the numpy ``splats`` at each exchange cap of
    ``caps`` (None: the dense exchange), gathered; with the rank's
    exchange diagnostics of each."""
    torch.set_num_threads(1)
    from gscodec_studio_tpu_torch.parallel.distributed import (
        rasterize_sharded)
    from gscodec_studio_tpu_torch.models.splats import splat_activations

    mesh = make_mesh(world, device="cpu")
    loc = {k: shard_rows(mesh, torch.as_tensor(v)) for k, v in splats.items()}
    out = []
    for cap in caps:
        img = distributed_render(mesh, loc, viewmats, Ks, W, H, sh_degree=1,
                                 isect_capacity=8192, exchange_cap=cap)
        with torch.no_grad():
            m, q, s, o = splat_activations(loc)
            _, _, diag = rasterize_sharded(
                mesh, m, q, s, o, torch.cat([loc["sh0"], loc["shN"]], 1),
                torch.as_tensor(viewmats), torch.as_tensor(Ks), W, H, 1,
                8192, exchange_cap=cap)
        out.append((img, {k: int(v) for k, v in diag.items()}))
    return out


def step_ranks(rank, world, splats, images, viewmats, Ks, caps):
    """One distributed_train_step from the numpy ``splats`` (fresh Adam
    state) at each exchange cap of ``caps``: (loss, gathered parameters,
    diagnostics)."""
    torch.set_num_threads(1)
    mesh = make_mesh(world, device="cpu")
    loc = {k: shard_rows(mesh, torch.as_tensor(v)) for k, v in splats.items()}
    out = []
    for cap in caps:
        groups, states = build_splat_optimizers(loc)
        p, _, loss, diag = distributed_train_step(
            mesh, loc, states, groups, images, viewmats, Ks, sh_degree=1,
            isect_capacity=4096, exchange_cap=cap)
        out.append((float(loss), {k: mesh.all_gather(v) for k, v in
                                  p.items()},
                    {k: int(v) for k, v in diag.items()}))
    return out


class MeshScene:
    """A small scene for the Runner: ``n`` points, ``n_views`` cameras on
    an arc looking at them, random targets (so that the loss depends only
    on the splats and the step's arithmetic)."""

    def __init__(self, seed=7, n=96, n_views=5, width=32, height=24):
        rng = np.random.default_rng(seed)
        self.points = ((rng.random((n, 3)) - 0.5) * 2).astype(np.float32)
        self.points_rgb = (rng.random((n, 3)) * 255).astype(np.uint8)
        self.points_err = np.zeros(n)
        self.scene_scale = 1.5
        f = 0.9 * width
        K = np.array([[f, 0, width / 2], [0, f, height / 2], [0, 0, 1]],
                     np.float32)
        self.camtoworlds = []
        for i in range(n_views):
            a = 0.15 * (i - n_views / 2)
            c2w = np.eye(4, dtype=np.float32)
            c2w[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                           [-np.sin(a), 0, np.cos(a)]]
            c2w[:3, 3] = [4.0 * np.sin(a), 0.0, -4.0 * np.cos(a)]
            self.camtoworlds.append(c2w)
        self.camtoworlds = np.stack(self.camtoworlds)
        self.items = [{"K": K, "camtoworld": c2w,
                       "image": rng.random((height, width, 3)).astype(
                           np.float32), "image_id": i}
                      for i, c2w in enumerate(self.camtoworlds)]

    def split(self):
        return _Views(self.items[:-1]), _Views(self.items[-1:])


class _Views:
    def __init__(self, items):
        self.items = items

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def mesh_config(tmp, **kw):
    from gscodec_studio_tpu_torch.training.trainer import Config

    base = dict(result_dir=tmp, batch_size=2, sh_degree=1, capacity=256,
                isect_capacity=8192, eval_steps=(), save_steps=(),
                tb_every=0, skip_probe=False)
    base.update(kw)
    return Config(**base)


def _runner(cfg):
    # no TensorBoard events: importing torch.utils.tensorboard loads
    # TensorFlow (seconds); the logger writes its JSON lines alone
    sys.modules["torch.utils.tensorboard"] = None
    from gscodec_studio_tpu_torch.training.trainer import Runner

    scene = MeshScene()
    trainset, valset = scene.split()
    runner = Runner(cfg, parser=scene, trainset=trainset, valset=valset,
                    device="cpu")
    # anisotropic scales: the k-NN ones are isotropic, which makes the
    # quaternions' true gradient zero and the computed one rounding noise
    rng = np.random.default_rng(3)
    full = torch.as_tensor(rng.normal(-2.5, 0.4, (runner.cap, 3)).astype(
        np.float32))
    runner.splats["scales"] = runner._shard({"scales": full})["scales"]
    return runner


def runner_step_ranks(rank, world, tmp):
    """Rank 0 runs the single-device Runner's first step; then every rank
    runs the mesh Runner's (mesh_devices = world) on the same batch.
    Returns each's loss, render of the batch, grad2d statistic and
    parameters after the step (the mesh's gathered)."""
    torch.set_num_threads(1)
    import gscodec_studio_tpu_torch.training.trainer as T

    renders = []

    def recording(fn):
        def wrapped(*a, **k):
            out = fn(*a, **k)
            renders.append(out[0].detach())
            return out
        return wrapped

    T.rasterization = recording(T.rasterization)
    T.sharded_rasterization = recording(T.sharded_rasterization)
    res = {}
    if rank == 0:
        single = _runner(mesh_config(f"{tmp}/single"))
        out = single.train_step([0, 1], 1, 0)
        res["single"] = dict(loss=out["loss"], render=renders.pop(),
                             grad2d=single.strategy_state["grad2d"].clone(),
                             splats=_cpu(single.splats))
    runner = _runner(mesh_config(f"{tmp}/mesh", mesh_devices=world))
    out = runner.train_step([0, 1], 1, 0)
    res["mesh"] = dict(
        loss=out["loss"], exchange=out["exchange"],
        render=runner.mesh.all_gather(renders.pop()),
        grad2d=runner._gather(runner.strategy_state)["grad2d"],
        splats=_cpu(runner._gather(runner.splats)))
    return res


def runner_refine_ranks(rank, world, tmp, strategy):
    """The mesh Runner trains 4 steps with a refine after steps 2 and 4
    (the growth threshold lowered so that the refine grows); returns the
    rank's gathered replicated state: splats, Adam moments, strategy
    state, the simulation's parameters, the losses, the events and the
    eval; then, as whole-model work under the mesh, a checkpoint saved and
    loaded back, the PLY and, for the default strategy, the PNG codec's
    run, with which files rank 0 wrote."""
    torch.set_num_threads(1)
    kw = dict(refine_start_iter=0, refine_every=2, strategy=strategy,
              mesh_devices=world)
    if strategy == "mcmc":
        kw.update(mcmc_cap_max=256, compression_sim=True,
                  entropy_model_opt=True)
    runner = _runner(mesh_config(tmp, **kw))
    if strategy == "default":
        runner.strategy = dataclasses.replace(runner.strategy,
                                              grow_grad2d=1e-7)
    losses = runner.train(max_steps=4, log_every=0)
    moments = {k: {m: v for m, v in s.items() if m != "count"}
               for k, s in runner._gather(runner.opt_states).items()}
    out = dict(losses=losses, events=runner.events,
               splats=_cpu(runner._gather(runner.splats)),
               moments={k: _cpu(v) for k, v in moments.items()},
               strategy_state=_cpu(runner._gather(runner.strategy_state)),
               sim=_cpu(runner.sim_params),
               eval=runner.eval("after"))
    local = _cpu(runner.splats)
    path = runner.save_checkpoint(4)
    runner.mesh.barrier()
    for v in runner.splats.values():
        v.zero_()
    out["ckpt_step"] = runner.load_checkpoint(path)
    out["reloaded"] = all(torch.equal(runner.splats[k].cpu(), local[k])
                          for k in local)
    runner.save_ply(os.path.join(tmp, "point_cloud.ply"))
    if strategy == "default":
        out["compression"] = runner.run_compression(4, "png")
    runner.mesh.barrier()
    out["files"] = sorted(os.listdir(tmp))
    return out


def runner_losses_ranks(rank, world, tmp, init, steps):
    """The mesh Runner (mesh_devices = world) from the splats ``init`` (the
    whole model, numpy): the losses of ``steps`` steps."""
    torch.set_num_threads(1)
    runner = _runner(mesh_config(tmp, mesh_devices=world, max_steps=steps))
    runner.splats = runner._shard({k: torch.as_tensor(v)
                                   for k, v in init.items()})
    return runner.train(max_steps=steps, log_every=0)
