"""The port's `ParallelTrainer` against its own `Trainer`, its checkpoints,
and the per-shard densify against JAX's `densify_and_prune`.

* A (1, 1) mesh takes the `Trainer`'s steps: the same losses and the same
  model and Adam state, bit for bit, across a densify and an opacity
  reset, on the production (segmented) path through its plain versions.
* A sharded run's checkpoint loads into `Trainer` as the gathered state
  (`torch.equal`), and back into a sharded `ParallelTrainer`.
* `sharded_densify` on mesh (1, 2) equals JAX's `densify_and_prune` run on
  each shard's rows with that shard's noise (`fold_in(key, g)`, the JAX
  sharded densify's), at the bars of tests/test_torch_model_train.py.
"""

import jax
import numpy as np
import torch

from omnigs_torch.model.gaussians import FIELD_NAMES as FIELDS
from omnigs_torch.model.gaussians import shard_numpy
from omnigs_torch.train.trainer import Trainer
from omnigs_tpu.model import densify as jdens

from test_torch_model_train import FLOAT_FIELDS, _densify_inputs, _jmodel, _jstate, _jstate_np
from torch_parallel_workers import (
    _config,
    _scene,
    densify_worker,
    load_worker,
    run_ranks,
    scene_np,
    single_vs_trainer_worker,
    trainer_worker,
)

TPU = dict(capacity=64, max_instances=1 << 12)
# densify at 3 and 6, an opacity reset at 5
OPT = dict(densify_from_iter=2, densification_interval=3, densify_until_iter=25,
           opacity_reset_interval=5, position_lr_max_steps=30)


def _scene_data(seed=0):
    return scene_np(seed, 64, 32, 3)


def _unshard(shards):
    """The shards' rows joined in rank order (inverse of `shard_numpy`)."""
    return {
        k: np.concatenate([np.asarray(s[k]) for s in shards]) if np.ndim(v) else np.asarray(v)
        for k, v in shards[0].items()
    }


def _equal(a, b, what):
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(a[k], b[k]), (what, k)


def test_single_rank_mesh_equals_trainer(tmp_path):
    out = run_ranks(tmp_path, 1, single_vs_trainer_worker, _scene_data(), TPU, OPT, 3, 7,
                    str(tmp_path / "ckpt.pt"))[0]
    par, single = out["parallel"], out["single"]
    assert np.array_equal(par["losses"], single["losses"])
    _equal(par["model"], single["model"], "model")
    _equal(par["opt"], single["opt"], "adam")
    # the checkpoint both ways
    for name in ("loaded_into_trainer", "loaded_into_parallel"):
        assert out[name]["iteration"] == 7
        _equal(out[name]["model"], par["model"], name)
        _equal(out[name]["opt"], par["opt"], name)


def test_sharded_checkpoint_round_trips_into_trainer(tmp_path):
    scene_np = _scene_data(1)
    tpu = dict(TPU, mesh_data=1, mesh_gauss=2)
    ckpt = tmp_path / "sharded.pt"
    run = run_ranks(tmp_path, 2, trainer_worker, scene_np, tpu, OPT, 0, [("step", 3)], str(ckpt))
    gathered = run[0]["model"]
    tr = Trainer(_scene(scene_np), _config(tpu, OPT), device="cpu")
    tr.load_checkpoint(ckpt)
    assert tr.iteration == 3
    for k, v in gathered.items():
        assert torch.equal(getattr(tr.model, k), torch.from_numpy(v)), k
    # and back onto two shards: the gathered state is the file's
    back = run_ranks(tmp_path, 2, load_worker, scene_np, tpu, OPT, str(ckpt))[0]
    assert back["iteration"] == 3
    _equal(back["model"], gathered, "model")
    want = tr.opt_state.to_numpy()
    for k, v in back["opt"].items():
        assert np.array_equal(v, want[k]), k


def test_sharded_densify_matches_jax_per_shard(tmp_path):
    f, state = _densify_inputs()
    kw = dict(max_grad=2e-4, min_opacity=0.2, max_screen_size=20, percent_dense=0.08,
              prune_by_extent=True, iteration=321, extent=1.0)
    key = jax.random.PRNGKey(5)
    shards, noise, stats = [], [], 0
    for g in range(2):
        fg, sg = shard_numpy(f, g, 2), shard_numpy(state, g, 2)
        kg = jax.random.fold_in(key, g)
        jm, jst, js = jdens.densify_and_prune(_jmodel(fg), _jstate(sg), kg, **kw)
        shards.append((jm, _jstate_np(jst)))
        noise.append(np.array(jax.random.normal(kg, (2, 24, 3))))
        stats = stats + np.array([int(x) for x in js])
    got = run_ranks(tmp_path, 2, densify_worker, 2, f, state, noise, kw)[0]
    assert got["stats"] == list(stats)
    assert min(stats) > 0, stats  # clones, splits, prunes and drops all occur
    want = _unshard([{**{k: np.asarray(getattr(jm, k)) for k in FIELDS}, **st}
                    for jm, st in shards])
    for k in ("active", "exist_since_iter"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in FLOAT_FIELDS:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, err_msg=k)
    for k in got:
        if k.startswith(("mu/", "nu/")):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
