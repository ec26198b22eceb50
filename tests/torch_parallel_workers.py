"""Multi-rank runs of the port for the parallel parity tests
(tests/test_torch_parallel_*.py).

The ranks are spawned processes joined over gloo on the CPU through a
file rendezvous in the test's tmp_path (no fixed port, so parallel test
workers never collide). This module imports numpy, torch and the port
only: a spawned rank never imports JAX (each checks). Each worker takes numpy inputs
and returns numpy results; the test compares them with the JAX package in
its own process.
"""

import dataclasses
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# every worker's ranks must be done within this many seconds
RANK_TIMEOUT_S = 240


def _rank_main(rank, world, store, fn, args, queue):
    try:
        torch.set_num_threads(1)
        from omnigs_torch.parallel.distributed import initialize

        initialize("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
        try:
            result = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        jax_side = [k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib", "omnigs_tpu")]
        if jax_side:
            raise RuntimeError(f"a rank imported the JAX side: {jax_side}")
        queue.put((rank, result))
    except BaseException:
        queue.put((rank, RuntimeError(f"rank {rank}:\n{traceback.format_exc()}")))
        raise


def run_ranks(tmp_path, world, fn, *args):
    """``fn(rank, *args)`` on ``world`` gloo ranks → the results by rank."""
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    store = tmp_path / f"store_{fn.__name__}_{world}"
    procs = [
        ctx.Process(target=_rank_main, args=(r, world, str(store), fn, args, queue))
        for r in range(world)
    ]
    for p in procs:
        p.start()
    results = {}
    try:
        for _ in procs:
            rank, res = queue.get(timeout=RANK_TIMEOUT_S)
            if isinstance(res, BaseException):
                raise res
            results[rank] = res
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    return [results[r] for r in range(world)]


# ---- inputs ----


def _model(fields, mesh):
    from omnigs_torch.model.gaussians import GaussianModel, shard_numpy
    from omnigs_torch.parallel.mesh import GAUSS_AXIS, axis_index, axis_size

    g, n = axis_index(mesh, GAUSS_AXIS), axis_size(mesh, GAUSS_AXIS)
    return GaussianModel.from_numpy(shard_numpy(fields, g, n), device="cpu")


def _gathered(t, mesh):
    from omnigs_torch.parallel.mesh import GAUSS_AXIS, all_gather

    return all_gather(t.detach(), mesh, GAUSS_AXIS).numpy()


def scene_np(seed, width, height, n_views):
    """A small training scene as numpy: ``n_views`` poses (small rotations
    about the origin), each ground truth the port's render of a seeded
    48-Gaussian cloud, and a noisy SfM cloud from its means with dc colors
    (the recipe of tests/test_trainer.py::_make_scene, rendered by the
    port so that no JAX compile is needed)."""
    from omnigs_torch.cameras import Camera, CameraType
    from omnigs_torch.model.gaussians import GaussianModel
    from omnigs_torch.ops.rasterize import RasterConfig
    from omnigs_torch.train.renderer import render_model

    from torch_helpers import random_model_np

    rng = np.random.default_rng(seed)
    f = random_model_np(seed + 100, 48, 48)
    gt = GaussianModel.from_numpy(f, device="cpu")
    cam = Camera(CameraType.LONLAT, width, height)
    views = []
    for _ in range(n_views):
        a = rng.normal() * 0.2
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]],
                     np.float32)
        t = (rng.normal(size=3) * 0.1).astype(np.float32)
        vm = np.eye(4, dtype=np.float32)
        vm[:3, :3], vm[:3, 3] = R, t
        with torch.inference_mode():
            img = render_model(
                gt, cam, torch.from_numpy(vm), torch.from_numpy(-R.T @ t), torch.zeros(3), 3,
                RasterConfig(max_instances=1 << 14, tile_cap=128, chunk=8),
            ).image
        views.append((width, height, R, t, img.permute(1, 2, 0).numpy().copy()))
    points = (f["xyz"] + rng.normal(size=(48, 3)) * 0.05).astype(np.float32)
    colors = np.clip(f["features_dc"][:, 0] * 0.28209479177387814 + 0.5, 0, 1)
    return dict(views=views, points=points, colors=colors.astype(np.float32))


def _scene(scene_np):
    from omnigs_torch.cameras import Camera, CameraType
    from omnigs_torch.scene.keyframe import Keyframe
    from omnigs_torch.scene.scene import Scene

    scene = Scene()
    for fid, (w, h, R, t, img) in enumerate(scene_np["views"]):
        scene.add_keyframe(Keyframe(fid, Camera(CameraType.LONLAT, w, h), R, t, image=img))
    scene.points, scene.colors = scene_np["points"], scene_np["colors"]
    return scene


def _config(tpu, opt):
    from omnigs_torch.config import Config

    cfg = Config()
    cfg.tpu = dataclasses.replace(cfg.tpu, **tpu)
    for k, v in opt.items():
        setattr(cfg.opt, k, v)
    return cfg


# ---- workers ----


def render_worker(rank, data, gauss, fields, wh, vm, campos, bg, sh_degree, cfgs):
    """The sharded render of one pose under each RasterConfig kwargs of
    ``cfgs`` → [image]."""
    from omnigs_torch.cameras import Camera, CameraType
    from omnigs_torch.ops.rasterize import RasterConfig
    from omnigs_torch.parallel.mesh import make_mesh
    from omnigs_torch.parallel.shard import sharded_render

    mesh = make_mesh(data, gauss)
    model = _model(fields, mesh)
    cam = Camera(CameraType.LONLAT, *wh)
    return [
        sharded_render(
            mesh, model, torch.from_numpy(vm), torch.from_numpy(campos), cam,
            torch.from_numpy(bg), sh_degree, RasterConfig(**kw),
        ).numpy()
        for kw in cfgs
    ]


def step_worker(rank, data, gauss, fields, wh, views, cfg_kw, step_kw):
    """One `sharded_train_step` (Adam on, step 1) of this rank's views
    ``views[d·V:(d+1)·V]`` → the loss, the gathered Adam first moments
    (0.1 × the gradient) and statistics, on every rank."""
    from omnigs_torch.cameras import Camera, CameraType
    from omnigs_torch.model import optimizer as opt_ops
    from omnigs_torch.ops.rasterize import RasterConfig
    from omnigs_torch.parallel.distributed import local_data_rows
    from omnigs_torch.parallel.mesh import make_mesh
    from omnigs_torch.parallel.shard import sharded_train_step

    mesh = make_mesh(data, gauss)
    model = _model(fields, mesh)
    state = opt_ops.init_adam(model.params())
    per = len(views) // data
    mine = [views[d * per + v] for d in local_data_rows(mesh) for v in range(per)]
    vms, cps, gts = (torch.as_tensor(np.stack([v[i] for v in mine])) for i in range(3))
    aux = sharded_train_step(
        mesh, model, state, vms, cps, gts, 1,
        camera=Camera(CameraType.LONLAT, *wh), raster_cfg=RasterConfig(**cfg_kw),
        lr_cfg=opt_ops.LRConfig(), bg=torch.zeros(3), **step_kw,
    )
    out = {f"mu/{k}": _gathered(v, mesh) for k, v in state.mu.items()}
    for k in ("xyz_gradient_accum", "denom", "max_radii2d"):
        out[k] = _gathered(getattr(model, k), mesh)
    out["loss"] = aux["loss"].numpy()
    out["local_rows"] = np.array(local_data_rows(mesh))
    return out


def densify_worker(rank, gauss, fields, opt_np, noise, kw):
    """`sharded_densify` of a gauss-sharded state, the split noise of gauss
    rank g given as ``noise[g]`` → the gathered model and Adam state and
    the summed counts."""
    from omnigs_torch.model import densify as densify_ops
    from omnigs_torch.model import optimizer as opt_ops
    from omnigs_torch.model.gaussians import FIELD_NAMES, shard_numpy
    from omnigs_torch.parallel.mesh import GAUSS_AXIS, axis_index, make_mesh
    from omnigs_torch.parallel.shard import sharded_densify

    mesh = make_mesh(1, gauss)
    g = axis_index(mesh, GAUSS_AXIS)
    model = _model(fields, mesh)
    state = opt_ops.AdamState.from_numpy(shard_numpy(opt_np, g, gauss), device="cpu")
    densify_ops._split_noise = lambda gen, p: torch.from_numpy(noise[g])
    stats = sharded_densify(mesh, model, state, torch.Generator(), **kw)
    out = {k: _gathered(getattr(model, k), mesh) for k in FIELD_NAMES}
    out.update({f"mu/{k}": _gathered(v, mesh) for k, v in state.mu.items()})
    out.update({f"nu/{k}": _gathered(v, mesh) for k, v in state.nu.items()})
    out["stats"] = [int(s) for s in stats]
    return out


def trainer_worker(rank, scene_np, tpu, opt, seed, plan, ckpt=None):
    """A `ParallelTrainer` run: ``plan`` is a list of ("step", n) and
    ("window", k) items → every rank's logged losses, and on rank 0 the
    gathered model (and, with ``ckpt``, the checkpoint written there)."""
    from omnigs_torch.train.trainer_parallel import ParallelTrainer

    tr = ParallelTrainer(_scene(scene_np), _config(tpu, opt), seed=seed, device="cpu")
    tr.init_from_sfm()
    for kind, n in plan:
        if kind == "step":
            for _ in range(n):
                tr.train_iteration()
        else:
            done = 0
            while done < n:
                took = tr.train_window(n - done)
                if took == 0:
                    tr.train_iteration()
                    took = 1
                done += took
    losses = np.array([float(x) for x, _, _ in tr._pending_losses])
    tr.drain_losses()
    if ckpt is not None:
        tr.save_checkpoint(ckpt)
    return dict(losses=losses, model=tr.host_model(), iteration=tr.iteration,
                truncated=tr.total_truncated, n_active=int(tr.model.num_active))


def single_vs_trainer_worker(rank, scene_np, tpu, opt, seed, n, ckpt):
    """A (1, 1) `ParallelTrainer` and a `Trainer` over the same ``n``
    iterations → both losses, models and Adam states; then the parallel
    run's checkpoint loaded into a `Trainer` and a `Trainer`'s checkpoint
    loaded back into a `ParallelTrainer`."""
    from omnigs_torch.train.trainer import Trainer
    from omnigs_torch.train.trainer_parallel import ParallelTrainer

    out = {}
    for name, cls in (("parallel", ParallelTrainer), ("single", Trainer)):
        tr = cls(_scene(scene_np), _config(tpu, opt), seed=seed, device="cpu")
        tr.init_from_sfm()
        for _ in range(n):
            tr.train_iteration()
        out[name] = dict(
            losses=np.array([float(x) for x, _, _ in tr._pending_losses]),
            model=tr.model.to_numpy(), opt=tr.opt_state.to_numpy(),
        )
        if name == "parallel":
            tr.save_checkpoint(ckpt)
            par = tr
    back = Trainer(_scene(scene_np), _config(tpu, opt), seed=seed, device="cpu")
    back.load_checkpoint(ckpt)
    out["loaded_into_trainer"] = dict(
        model=back.model.to_numpy(), opt=back.opt_state.to_numpy(),
        iteration=back.iteration,
    )
    back.save_checkpoint(str(ckpt) + ".trainer")
    par.load_checkpoint(str(ckpt) + ".trainer")
    out["loaded_into_parallel"] = dict(
        model=par.model.to_numpy(), opt=par.opt_state.to_numpy(),
        iteration=par.iteration,
    )
    return out


def load_worker(rank, scene_np, tpu, opt, ckpt):
    """A `ParallelTrainer` restored from the checkpoint ``ckpt`` → on rank 0
    its gathered model and Adam moments and the iteration."""
    from omnigs_torch.train.trainer_parallel import ParallelTrainer

    tr = ParallelTrainer(_scene(scene_np), _config(tpu, opt), seed=0, device="cpu")
    tr.load_checkpoint(ckpt)
    moments = {f"mu/{k}": v for k, v in tr.opt_state.mu.items()}
    moments.update({f"nu/{k}": v for k, v in tr.opt_state.nu.items()})
    return dict(model=tr.host_model(), opt=tr._gathered(moments), iteration=tr.iteration)
