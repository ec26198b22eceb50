"""The sharded training window's capture key and the staged index of the
windows (omnigs_torch/parallel/shard.py `sharded_train_steps_fused`,
omnigs_torch/train/trainer.py `capture_key`, `window_index`, `StepGraph`).

The windows themselves are held against JAX's `ParallelTrainer.train_window`
and against single steps in tests/test_torch_parallel_trainer.py; on the
card, the captured window against eager iterations in
tests/test_torch_kernels_gpu.py. Here: the key of a sharded window changes
with what a captured sharded step bakes in (its views a rank, the mesh's
shape, the SH degree, λ, the banks' addresses) and stays through a densify
and an opacity reset, which write in place; the `Trainer`'s staged index
keeps its (k, 3) layout and its CPU window captures nothing."""

import numpy as np
import torch

from omnigs_torch.train import trainer as ttrainer

from test_torch_trainer_window import _port_trainer
from torch_parallel_workers import capture_key_worker, run_ranks, scene_np

TPU = dict(capacity=64, max_instances=1 << 12, tile_cap=64, chunk=8, backend="xla",
           tight_culling=False, mesh_data=2, mesh_gauss=1)
OPT = dict(densify_from_iter=100, densification_interval=100, densify_until_iter=500,
           opacity_reset_interval=0)


def test_sharded_capture_key_follows_what_a_step_bakes_in(tmp_path):
    """On both ranks of a (2, 1) mesh of four keyframes (a ground-truth
    bank of two rows a rank, grown once a data row has drawn three)."""
    ranks = run_ranks(tmp_path, 2, capture_key_worker, scene_np(4, 32, 16, 4), TPU, OPT)
    for r in ranks:
        assert r["same"] and r["densify_reset_same"], r
        assert r["views"] and r["mesh"] and r["sh_degree"] and r["lambda"], r
        assert r["bank_rows"] == [2, 4] and r["grows"] == 1 and r["bank_grew"], r


def test_window_index_layouts():
    """The `Trainer`'s (k, 3) rows (pose row, ground-truth row, step) and a
    sharded step's (k, 2·V + 1) rows."""
    got = ttrainer.window_index(np.array([4, 1, 2]), np.array([0, 1, 2]), 7)
    np.testing.assert_array_equal(got, [[4, 0, 8], [1, 1, 9], [2, 2, 10]])
    assert got.dtype == np.int64
    got = ttrainer.window_index(np.array([[4, 1], [2, 0]]), np.array([[0, 1], [2, 3]]), 7)
    np.testing.assert_array_equal(got, [[4, 1, 0, 1, 8], [2, 0, 2, 3, 9]])


def test_trainer_cpu_window_captures_nothing():
    """A CPU `Trainer` window runs its steps eagerly: its `StepGraph` stays
    empty, and the bank rows it took are the keyframes the sampler drew."""
    tr = _port_trainer(3, densify_from_iter=100, densification_interval=100,
                       densify_until_iter=500, opacity_reset_interval=0)
    assert tr.train_window(4) == 4
    g = tr.step_graph
    assert g.graph is None and g.rows is None and g.captures == g.replays == 0
    assert tr._pending_losses[0][0].shape == (4,)
    assert bool(torch.isfinite(tr._pending_losses[0][0]).all())
