"""Data-parallel training on a (4, 1) mesh (`ParallelTrainer`, four gloo
ranks on the CPU, `parallel/shard.py`'s sharded step) against the plain
float32 reference of the benchmark (`omnibench/reference/train.py`
`run_steps`: the mean loss and gradient of each batch of views, Adam), on
the same four-view batches; every replica bit for bit the same; the
window bit for bit its `train_iteration`s; and the mesh's collective
counters.

A 64×32 lonlat scene of four keyframes (the parallel tests' seeded
48-Gaussian cloud rendered by the port), a start model of 1,024 seeded
Gaussians in 2,048 slots at iteration 1000 (SH degree 1), densify every
four iterations, the 360Roam YAML's bottom crop."""

import numpy as np
import pytest
import torch

from omnibench.reference import render as R
from omnibench.reference import train as RT

from torch_helpers import random_model_np
from torch_parallel_workers import collective_worker, dp_worker, run_ranks, scene_np

W, H, N_LIVE, CAPACITY, SEED, START = 64, 32, 1024, 2048, 7, 1001
WORLD = 4
TPU = dict(capacity=CAPACITY, max_instances=1 << 15, mesh_data=WORLD, mesh_gauss=1,
           fuse_steps=4)
# the prunes by size left out: the cloud's Gaussians are large against a
# scene of cameras 0.1 apart, and the densify is to split them
OPT = dict(densify_from_iter=500, densification_interval=4, densify_until_iter=5000,
           opacity_reset_interval=0, skip_bottom_ratio=0.063, prune_by_extent=False,
           prune_big_point_after_iter=100000)
# float32 sums in another order than the reference's (per tile against its
# dense chunks, the loss's fixed tree against `mean`). Read here: loss 2.5e-7,
# gradient 5.9e-6, change 1.1e-5 (the benchmark's 1920×960 cell: ≤ 1.5e-5,
# 5.1e-5, 8.5e-6); a view from the wrong keyframe, a missing ÷ 4 or an
# unchanged state is off by ≥ 1e-2. The change is held to the benchmark's
# own limit; loss and gradient to ~20-40 times their readings
LOSS_RTOL = 1e-5
# each leaf's gradient and change against the reference, as a norm of the
# difference over the larger of that leaf's norm and the median leaf's
# (a leaf of rounding alone — features_rest at SH degree 1 has 3 of its 15
# rows live — is held to the median's scale, as the benchmark holds it)
GRAD_RTOL = 1e-4
STEP_RTOL = 8e-5


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    fields = random_model_np(SEED, CAPACITY, N_LIVE)
    out = run_ranks(tmp_path_factory.mktemp("dp"), WORLD, dp_worker,
                    scene_np(SEED, W, H, 4), TPU, OPT, SEED, START, fields)
    return fields, out


def _gap(prog, ref):
    med = float(np.median([np.linalg.norm(v) for v in ref.values()]))
    return {k: float(np.linalg.norm(prog[k] - ref[k]) / max(np.linalg.norm(ref[k]), med))
            for k in ref}


def test_mesh_steps_match_the_reference(ranks):
    """Three Adam steps and the event iteration's loss against `run_steps`
    over the same four-view batches (draw 4i + d is data row d's view of
    iteration i)."""
    fields, out = ranks
    r0 = out[0]
    assert r0["window_mode"] == "eager"
    scene = scene_np(SEED, W, H, 4)
    gts = {f: torch.from_numpy(v[4]).permute(2, 0, 1).contiguous()
           for f, v in enumerate(scene["views"])}
    views = [(torch.from_numpy(r0["poses"][f][0]), torch.from_numpy(r0["poses"][f][1]), gts[f])
             for f in r0["draws"]]
    batches = [views[i * WORLD:(i + 1) * WORLD] for i in range(4)]
    n = N_LIVE
    params = {k: torch.from_numpy(fields[k][:n].copy()) for k in RT.PARAMS}
    start = {k: v.clone() for k, v in params.items()}
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    opt = dict(position_lr_init=0.00016, position_lr_final=0.0000016, position_lr_max_steps=30000,
               feature_lr=0.0025, opacity_lr=0.05, scaling_lr=0.005, rotation_lr=0.001,
               lambda_dssim=0.2)
    extent = RT.scene_extent([p[1] for p in r0["poses"].values()])
    assert extent == pytest.approx(r0["extent"], rel=1e-6)
    skip, sh, bg = int(round(H * 0.063)), 1, torch.zeros(3)
    with R.matmul_precision(tf32=False):
        steps = RT.run_steps(params, mu, nu, START - 1, batches[:3], range(START, START + 3),
                             W, H, sh, opt, extent, skip, bg)
        event = sum(float(RT.loss_fn(gt, 0.2, skip)(R.render(params, W, H, vm, cp, bg, sh)[0]))
                    for vm, cp, gt in batches[3]) / WORLD
    ref_losses = [s["loss"] for s in steps] + [event]
    np.testing.assert_allclose(r0["losses"], ref_losses, rtol=LOSS_RTOL)
    grad = _gap({k: r0["grad"][k][:n] for k in RT.PARAMS},
                {k: steps[0]["grads"][k].numpy() for k in RT.PARAMS})
    assert max(grad.values()) < GRAD_RTOL, grad
    change = _gap({k: r0["params3"][k][:n] - fields[k][:n] for k in RT.PARAMS},
                  {k: (params[k] - start[k]).numpy() for k in RT.PARAMS})
    assert max(change.values()) < STEP_RTOL, change


def test_every_replica_is_bitwise_rank_0s(ranks):
    """After windows around one more densify event every rank's model
    fields, Adam moments and step count equal rank 0's bit for bit, and
    every rank logged the same losses; the densify changed the live set."""
    _, out = ranks
    for r in out[1:]:
        assert set(r["state"]) == set(out[0]["state"])
        for k, v in r["state"].items():
            np.testing.assert_array_equal(v, out[0]["state"][k], err_msg=k)
        np.testing.assert_array_equal(r["losses"], out[0]["losses"])
        assert r["live"] == out[0]["live"]
    live = out[0]["live"]
    assert live[0] > 0 and live[1] != live[0], live


def test_window_is_bitwise_its_iterations(ranks):
    """On each rank the loop's windows (eager under gloo) and the event
    iteration leave the state and losses of four `train_iteration`s."""
    _, out = ranks
    for r in out:
        np.testing.assert_array_equal(r["losses"], r["twin_losses"])
        for k, v in r["window_state"].items():
            np.testing.assert_array_equal(v, r["twin_state"][k], err_msg=k)


def test_a_mesh_step_counts_its_collectives(tmp_path):
    """A (2, 1) gloo step all-reduces the loss and its L1 (2 floats), the
    two capacity counters (2 int32), the six gradient leaves (59 floats a
    row) and the three statistics (a float each a row): eleven collectives
    on each rank, nothing gathered or scattered (one gauss rank)."""
    cap = 64
    fields = random_model_np(3, cap, 40)
    rng = np.random.default_rng(4)
    views = []
    for _ in range(2):
        vm = np.eye(4, dtype=np.float32)
        vm[:3, 3] = rng.normal(size=3).astype(np.float32) * 0.1
        views.append((vm, -vm[:3, 3].copy(), rng.uniform(size=(3, 16, 32)).astype(np.float32)))
    got = run_ranks(tmp_path, 2, collective_worker, fields, (32, 16), views,
                    dict(max_instances=1 << 12, tile_cap=64, chunk=8),
                    dict(sh_degree=3, spatial_lr_scale=1.0))
    grads = cap * (3 + 3 + 45 + 1 + 3 + 4) * 4
    stats = cap * 3 * 4
    for r in got:
        assert r == dict(collectives=1 + 1 + 6 + 3, allreduce_bytes=8 + 8 + grads + stats,
                         gather_bytes=0, scatter_bytes=0), r
