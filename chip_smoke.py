#!/usr/bin/env python3
"""Drive the PyTorch port's render and training paths on one CUDA card and
check them.

    python3 chip_smoke.py

Phases, each printed as one JSON line; any failed check raises, so the
script exits non-zero:

1. device — the card's name and power limit (nvidia-smi), PyTorch's view,
   and whether PIL and cv2 import and the native image loader loads (the
   training CLI path reads and writes its PNGs through PIL; cv2 and the
   loader are information only).
2. build  — every CUDA kernel of the paths, built from the repository's
   sources in parallel (`omnigs_torch/cuda_build.py`), with nvcc's register
   and shared-memory report; the compositing kernels #1-#4 (the two
   sources of each layout, on one walk; #5 shares #4's source), #6's two
   kernels and #8's six modes may use no stack and spill nothing; the
   `ptxas` line holds the report of #4, #5, #6's two kernels and #8.
3. kernel — at full width (1920×960 lonlat, P = 131,072 at SH degree 3):
   the instance slab of one pose through the port's preprocess, binning
   and re-lay; the forward CUDA kernel against its plain PyTorch version on
   it, bit for bit (and max |Δ| ≤ 1e-4, 99.9th percentile ≤ 1e-5 over
   image and final_T); both timed with CUDA events; the work this slab
   needs, for the bound; the warp-instance pairs the kernel's warps visit,
   of those the ones a pixel of the warp composites and the ones its strip
   masks drop; the spread of the segment lengths; a digest of the kernel's
   output bytes (the same seed gives the same slab, so two builds of the
   kernel can be compared bit for bit).
   Then the device time of each stage of that render (CUDA events).
4. grad   — the backward CUDA kernel on the same slab, with a seeded
   dL/dcolor, against its plain version, bit for bit (and rows 0..8 over
   the segment lanes, max |Δ| ≤ 1e-4 and 99.9th percentile ≤ 1e-5, each
   relative to the row's max |plain|); both timed; its work counts, warp
   pairs and bound; a digest of its output; kernel + reduction run twice
   must give bitwise-equal Gaussian gradients.
   seg_compare — when an earlier tree's sources are in
   build/seg_before/omnigs_torch/csrc: kernels #1/#2 built from them and
   from the present sources with one design element of the shared walk
   taken out (`omnigs_torch/utils/kernel_variants.py`), every build's
   output bytes equal to the production build's, ms in turns (earlier
   sources first and last), each build's ptxas report.
5. render — four serving requests through `render_model` with the
   production config of cfg/lonlat/360roam_lonlat.yaml under
   `torch.inference_mode()`, with the launch counters set to 0 just before
   and read just after: every kernel of the path must have launched, no
   instance may be truncated, every image must be finite.
6. ply    — save → load → render one pose again: bit-identical image.
7. train  — a `Scene` of the four poses, each ground truth the port's own
   render of the model; `Trainer.init_from_sfm` from the noisy means and dc
   colors (knn at N = 131,072, capacity 524,288); iterations 3001–3012 at
   SH degree 3 with densify every 4 (at 3004, 3008, 3012). One line per
   iteration (host ms, loss, live Gaussians, truncated, launches); the
   launch counters set to 0 just before and read just after: the backward
   kernel once per iteration, the forward at least once, densify three
   times, finite losses and parameters, nothing truncated. Then the
   `train_stages` line: device ms per stage of non-densify steps.
7b. parallel — the multi-device path (`omnigs_torch/parallel/`): a
   `ParallelTrainer` on a (1, 1) mesh of one NCCL rank in this process,
   iterations 3001–3012 of the train phase's scene: its losses within
   rtol 1e-5 and its parameters within the gradient bar (rtol 2e-3, atol
   1e-4·max) of the `Trainer`'s, host ms per iteration beside the
   Trainer's, #1/#2 launches. parallel_pair — two spawned processes on
   cuda:0 joined over gloo (NCCL refuses two ranks on one card), meshes
   (1, 2) and (2, 1): each mesh's sharded render of pose 0 (segmented and
   tile-major) within 1e-5 of the single-device render; on rank 1's tile
   window (`tile_lo` > 0) kernels #1, #2 and #3 against their plain
   versions bit for bit on the inputs the path gave them, with digests;
   one step's gathered gradients (Adam's first moments) within the
   gradient bar of the single-device gradient of the mean loss; four
   `ParallelTrainer` iterations finite, lock-step bitwise across the ranks,
   nothing truncated, #1/#2 launched on each rank. The line names the
   backend and the collectives the path handed gloo, each on CUDA
   tensors; the port stages no collective through the host. scaling —
   `omnigs_torch.scripts.scaling_bench --meshes 1x1 --iters 10` through its
   `main`: pixels/s and the shard tax. point_ops — `model/transform` and
   `ops/stereo` on the card against the same calls on the CPU (capacity
   524,288, 4,096 appended points, a 1920×960 depth map, 2,000 keypoints;
   1e-5 of each array's max, masks and counts equal), device ms.

8. tile_kernel — the tile-major path (`Tpu.want_ncontrib: 1` on the same
   YAML): the compact slab of pose 0 through the port's preprocess, binning
   (with the survivor-rank payload) and `_build_inst`; the tile-major
   forward kernel #3 against its plain version bit for bit (image, final_T
   and n_contrib; and max |Δ| ≤ 1e-4, 99.9th percentile ≤ 1e-5), one
   launch without n_contrib (zeros, the same image bit for bit), times,
   work counts, warp-instance pairs visited / live / culled (at the tiles'
   origins), a digest of the output bytes, bound.
9. tile_grad — the tile-major backward kernel #4 on that slab against its
   plain version bit for bit (and the relative bars of `grad`), its warp
   pairs and digest; kernel + scatter reduction
   bitwise repeatable; the fused backward kernel against its plain version
   (plain backward + scatter reduction) and against backward kernel +
   scatter reduction, the gather reduction against the scatter reduction,
   and all three reductions against the float64 sum of the same rows
   (rtol 2e-3, atol 1e-4 of each row's max |ref|); times and bounds; the
   instances whose rows are all zero (#5's table sink adds nothing for
   them).
   tile_compare — as seg_compare, for #3 (with n_contrib), #4 and #5 on
   that slab; #5 also in the ablations of its table sink (`scalar_sink`:
   nine scalar atomics into a (P, 9) table; `b_vec4`; `no_skip`), each
   build's output against the float64 sum at the reduction bar (its
   atomics add in no fixed order), #4 of those builds bytes equal. Then
   `tile_stages`: the device time of each stage of that render.
10. tile_render — four `render_model` requests through the tile-major
   config: the tile-major forward kernel once each (the segmented one never),
   truncated 0, n_contrib's max and mean, image and final_T within 1e-5 of
   the segmented render of the same pose.
11. tile_train — a `Trainer` on the train phase's scene through the
   tile-major config, iterations 3001–3006 with densify at 3004: each
   iteration launches the tile-major forward and backward kernels once,
   finite losses and parameters, nothing truncated, and the first loss
   within 1e-5 relative of the segmented Trainer's at iteration 3001. Then
   the `tile_train_stages` line.
12. tile_fused — one `train_step` of the render model (P = 131,072, under
   the fused route's limit) with `fused_reduce=True`: the fused backward
   kernel launches once and the unfused one never; its Adam moments against
   the same step through backward + scatter reduction (gradient bars).
13. tile_gather — the gather reduction against the scatter reduction where
   the routing rule takes the gather: `train_step` of the render model
   (P = 131,072, the capacity of cfg/lonlat/synthetic_fullres.yaml) at
   that config's instance cap 2^21, `gather_reduce` on and off, two copies
   stepped in turn. One line per step pair with each reduction's device ms
   and each step's host ms, and after the first step the two Adam moments'
   distance in units of the gradient bar (reported: the gather's blocked
   prefixes carry other Gaussians' rows, see `tile_grad`'s float64 line);
   each copy takes its route every step, nothing is truncated, and the
   losses agree within 1e-5 relative at every step.
14. ghost — four requests through the ghost-aligned layout (no depth
   presort, the tile-major kernels): image and final_T within 1e-5 of the
   segmented renders, truncated 0; one `train_step` whose Adam moments lie
   within 2e-3 of each parameter's max of the segmented step's.
15. fallback_segmented / fallback_tile — the YAML with
   `Tpu.depth_presort: 0` (the 2-key binning), without and with
   `Tpu.want_ncontrib: 1`: four requests each within 1e-5 of the
   packed-key renders, one launch of the path's forward kernel each.
16. xla — `backend="xla"`: two requests within rtol 1e-5, atol 1e-5 of
   the segmented renders, no kernel launched; one float32 step and the same
   step in float64; both float32 steps (XLA and segmented) hold the float64
   step's Adam moments at rtol 2e-3, atol 2e-4 of each parameter's max.
   Then `xla_gap`: of the parameter farthest from the float64 step, the
   Gaussians whose float32 XLA moments miss the JAX bar (rtol 1e-3, atol
   1e-4·max), and how many of them the two precisions cull differently
   (radii or rect) or have a pixel in their tiles that stops at another
   instance (a stop decision); reported, not gated.
17. reduce, emit, ablate — the port's copies of the benchmark scripts
   (`omnigs_torch/scripts/`), each run through its `main` with the launch
   counters set to 0 just before and read just after, then its kernel
   against its plain version at the script's sizes (#6 against a float64
   sum at the reduction bar, #7 bit for bit, #8 per mode bit for bit and
   at the forward bars, with its pairs, warp-lane pairs visited / live /
   culled, digest and its bound beside the all-lanes count), times, bound and
   library call. ablate_compare — #8 of the earlier sources (when
   present), the present ones, the walk's `no_cull` and `fwd_rows_1` and
   its own ablations (`no_count_trim`, `no_live_skip`, `no_warp_stop`,
   `dma_per_thread`) in each mode on the script's slab: every build's
   bytes and digest those of production, ms in turns. reduce_compare — #6 of the
   earlier sources (when present), the present ones and the `scalar_table`
   ablation (16 scalar atomics into the (P, 16) table) on the script's
   uniform ids, on Zipf-like ids and on the live lanes of pose 0's
   tile-major slab (`tile_grad`'s ids and rows), each against the float64
   sum at the reduction bar, ms in turns, with `_scatter_reduce` of the
   same rows beside them.
18. card_tests — `tests/test_torch_kernels_gpu.py -m gpu` in a child
   process: every test must pass, none skip.
19. scene_synth — the quality gate's pinned scene (seed 1234, 512×256, 12
   train / 4 test views) through the port's script
   (`omnigs_torch/scripts/make_synthetic_scene.py`, its renders on the
   tile-major forward kernel): seconds, and the sha256 of points.ply and of
   both sfm_data JSONs without root_path, which must equal the JAX
   script's (PINNED_SHA256).
20. quality — `omnigs_torch/scripts/quality_check.sh` step for step through
   the CLIs' `main`s (launch counters set to 0 before each, read after):
   the training CLI for seeds 1 and 2 (1,500 iterations of
   cfg/lonlat/synthetic_medium.yaml, windows of `Tpu.fuse_steps`), the test
   CLI on each run's last PLY, then the port's `psnr_gate` at GATE_BAR
   (16.57). Per seed: host ms/iteration, windows and single steps, EMA
   loss, live Gaussians, launches, peak memory, held-out PSNR; then the
   median and the verdict. Raises when the gate fails.
21. cli_full — a 1920×960 scene from the port's script; the training CLI
   with cfg/lonlat/synthetic_fullres.yaml for 200 iterations (windows, the
   densify at 200, the shutdown record) and the test CLI; then a
   full-width `Trainer` saved at iteration 100, run to 124, loaded and run
   to 124 again: every parameter and Adam moment `torch.equal`.
   ms/iteration, PSNR, peak memory and `DevicePeakUsageMB.txt`.
22. pinhole — the render model through a distorted pinhole camera
   (1920×1080, f = 1200, k1 = 0.3, k2 = 0.05) from the four request poses,
   `full_proj` from a `Keyframe`, the production segmented config: host ms,
   truncated 0, one #1 launch a request, each image and final_T bitwise
   the render through the plain versions (`plain_segmented_kernels`); one
   L1 + SSIM backward of the masked render through #2, every gradient
   bitwise the plain path's, finite and nonzero; the time of cv2's maps and
   mask and of undistorting one frame.
23. pinhole_scene — a four-view `pinhole_radial_k3` openMVG scene written
   from those renders and loaded: the mask, each loaded frame
   `torch.equal` to `undistort_image` of its PNG, and
   `Trainer.train_iteration` raising the JAX package's ValueError
   ("pinhole camera requires full_proj": neither trainer passes it).
24. pyramid — cli_full's scene through the training CLI with
   `GausPyramid.do: 1`, two sub-levels of 8 uses: 200 iterations, each
   timed (synchronised) under its level (480×240, 960×480, 1920×960),
   `train_window` 0 throughout, #1/#2 launched, finite loss.
25. viewer — `omnigs_torch.examples.view_result` serving the render
   model's PLY at 1920×960 on 127.0.0.1 from a thread: eight POST /render
   (color and depth, scale 1 and 0.5, two poses), each a JPEG and one #3
   launch; host ms per request, render and encode timed apart; the first
   color frame within JPEG error of `render_model` (PSNR ≥ 30 dB).
26. live_viewer — `start_live_viewer` on a full-width Trainer of that
   scene: 210 iterations (across the densify at 200) while a client thread
   requests frames, POST /params changing lambda_dssim at iteration 100;
   then the same run without the viewer: every parameter and Adam moment
   `torch.equal`; frames served and their host ms.
27. trace — one `train_window` of that Trainer under `profiling.trace`:
   from the Chrome trace, the device busy share of the window, kernels and
   launch calls per step, the five longest device ops and idle gaps.
28. examples — `omnigs_torch.examples.simple_cloud` at 2000×1000 (one #3
   launch, truncated 0, the image's sha256) and `ImagePool` over the pinned
   scene's PNGs, each image `torch.equal` to `load_image`.

Then the `kernels` line, nvidia-smi's line, and last the result line
{"ok": true, "device": {...}}. Without a CUDA device, or without the
package beside this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
WIDTH, HEIGHT = 1920, 960
P = 1 << 17
SH_DEGREE = 3
SEED = 0
N_REQUESTS = 4
CONFIG = REPO / "cfg" / "lonlat" / "360roam_lonlat.yaml"
# an earlier tree's CUDA sources for the seg_compare phase (gitignored; e.g.
# `git archive <commit> omnigs_torch/csrc | tar -x -C build/seg_before`)
SEG_BEFORE = REPO / "build" / "seg_before" / "omnigs_torch" / "csrc"
# H100 SXM published peaks (dense): f32 outside the tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# fp32 operations per pixel-instance pair in the forward kernel: every
# visited pair (dx, dy, quadratic form, clamp, exp, opacity, clamp, two
# tests) and every live pair on top (log1p, exp of the log-T, test, weight,
# 3 color multiply-adds, 2 log sums); a transcendental counts as one
OPS_PER_VISITED_PAIR = 17
OPS_PER_LIVE_PAIR = 13
# the backward kernel: the forward's 17 per visited pair; per live
# (contributing) pair log1p, exp, the stop test (3), weight, u (5), the w·u
# prefix (2), dL·B, dL/dα (3, one division), V, the nine partials (10) and
# the log-T sum = 30, plus ~9 adds of the nine pixel reductions = 39; per
# instance the eight warp partials of nine rows (63 adds) and the row
# combination (9)
BWD_OPS_PER_LIVE_PAIR = 39
BWD_OPS_PER_INSTANCE = 72
# the tile-major forward: one integer move per composited pair for n_contrib
TILE_NC_OPS_PER_LIVE_PAIR = 1
# the fused backward: nine atomic adds per instance
FUSED_OPS_PER_INSTANCE = 9
MAX_ERR_BAR = 1e-4
P999_ERR_BAR = 1e-5
# reductions of the same rows in another order (tests/test_gather_reduce.py)
REDUCE_RTOL = 2e-3
REDUCE_ATOL = 1e-4
# the tile-major first training loss against the segmented one
LOSS_RTOL = 1e-5
# the training phase: iterations 3001..3012 (SH degree 3 from 3000 on),
# densify every 4th iteration
TRAIN_START = 3000
TRAIN_ITERS = 12
TILE_TRAIN_ITERS = 6
# the gather phase: the cap under which the routing rule keeps the gather
# reduction (GATHER_REDUCE_MAX_R; Tpu.max_instances of synthetic_fullres.yaml,
# whose Tpu.capacity is the render model's P)
GATHER_CAP = 1 << 21
GATHER_ITERS = 5
DENSIFY_EVERY = 4
INIT_NOISE = 0.02
# the ghost-aligned phase: the instance cap of its RasterConfig and
# check_jit_parity's gradient bar (max |Δ| ≤ 2e-3 of each parameter's max)
GHOST_CAP = 1 << 22
GHOST_GRAD_REL = 2e-3
# the XLA phase: the JAX package's Pallas-vs-XLA gradient bars
# (tests/test_pallas_raster.py:94) for the compositor's gradients; the Adam
# moments after one step, of the XLA and of the kernel path, are held
# against the same step in float64 at twice that bar, since at full size
# float32 reaches only 1.40× (kernel path) and 1.64× (XLA) of it there
# (PERF.md §6)
XLA_GRAD_RTOL = 1e-3
XLA_GRAD_ATOL = 1e-4
XLA_STEP_RTOL = 2e-3
XLA_STEP_ATOL = 2e-4
# kernel #8: fp32 operations (a transcendental or a bf16 rounding counts as
# one) per lane-pixel pair with the lane below the tile's count in a
# visited chunk, the α math (dx, dy, the quadratic form 8, clamp, exp,
# opacity, clamp, three tests, select = 19); and per live pair (a > 0) the
# mode's tail: alpha +1 (the lane sum); notrans +11 (prefix, 1 + cs, N·,
# a·, three multiply-adds 6, Σa); nocumsum +11 (log1p, Σl, exp, N·, a·, 6);
# lowprec +17 (log1p, Σl, round, prefix, exp, N·, a·, round, three rgb
# rounds, 6); full +16 (log1p, Σl, prefix, exp, N·, 1 − a, division, test,
# a·, mask, 6). The earlier count, which charged 19 + the tail per pair of
# all 128 lanes of every visited chunk, stays beside it on the ablate line
# (`bound_ms_all_lanes`).
ABLATE_ALPHA_OPS = 19
ABLATE_TAIL_OPS = {"alpha": 1, "notrans": 11, "nocumsum": 11, "lowprec": 17, "full": 16}
# reduce_compare's skewed ids: Zipf's exponent over P ranks
ZIPF_S = 1.0
# the card tests' child process
CARD_TEST_TIMEOUT_S = 600


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def synthetic_model(np, device):
    """P Gaussians around the origin, all active, from a fixed seed: the
    distribution of the JAX package's bench model (unit directions at radius
    1–5, log-scales N(−3.5, 0.3), opacity logits N(0, 1), dc N(0, 0.5)),
    plus small degree-1..3 coefficients so SH degree 3 does real work."""
    from omnigs_torch.model.gaussians import GaussianModel

    rng = np.random.default_rng(SEED)
    d = rng.normal(size=(P, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True) + 1e-9
    fields = dict(
        xyz=d * (1.0 + rng.uniform(size=(P, 1)) * 4.0),
        features_dc=rng.normal(size=(P, 1, 3)) * 0.5,
        features_rest=rng.normal(size=(P, 15, 3)) * 0.05,
        scaling=rng.normal(size=(P, 3)) * 0.3 - 3.5,
        rotation=rng.normal(size=(P, 4)),
        opacity=rng.normal(size=(P, 1)),
        max_radii2d=np.zeros(P),
        xyz_gradient_accum=np.zeros(P),
        denom=np.zeros(P),
    )
    fields = {k: v.astype(np.float32) for k, v in fields.items()}
    fields["active"] = np.ones(P, bool)
    fields["exist_since_iter"] = np.zeros(P, np.int32)
    return GaussianModel.from_numpy(fields, device=device)


def poses(torch, device):
    """Request k looks along yaw k·90° with a small pitch and offset."""
    out = []
    for k in range(N_REQUESTS):
        yaw, pitch = k * math.pi / 2, 0.1 * (k - 1.5)
        cy, sy, cp, sp = math.cos(yaw), math.sin(yaw), math.cos(pitch), math.sin(pitch)
        ry = torch.tensor([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        rx = torch.tensor([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
        rot = (rx @ ry).to(torch.float32)
        campos = torch.tensor([0.05 * k, -0.03 * k, 0.02 * k])
        vm = torch.eye(4)
        vm[:3, :3] = rot
        vm[:3, 3] = -rot @ campos
        out.append((vm.to(device), campos.to(device)))
    return out


def slab_for(model, camera, vm, campos, cfg, mark=None):
    """The compositor's inputs for one pose, through the port's own chain
    (preprocess → bin_instances_packed → segment_relay → _build_inst_seg);
    ``mark(stage)`` is called after each stage."""
    import torch

    from omnigs_torch.ops.binning import bin_instances_packed, segment_relay
    from omnigs_torch.ops.composite_seg import CHUNK, _build_inst_seg
    from omnigs_torch.ops.preprocess import preprocess, tile_grid

    mark = mark or (lambda stage: None)
    gx, gy = tile_grid(camera)
    prep = preprocess(
        model.xyz, model.get_scaling(), model.get_rotation(),
        model.get_opacity(), model.get_features(), camera, vm, campos,
        SH_DEGREE, active_mask=model.active, tight_culling=cfg.tight_culling,
    )
    mark("preprocess")
    inst = bin_instances_packed(
        prep, gx, gy, cfg.max_instances, tile_cull=cfg.tile_culling
    )
    mark("bin_instances_packed")
    r8 = cfg.aligned_cap or -(-cfg.max_instances // CHUNK) * CHUNK
    seg = segment_relay(
        inst.sorted_g, inst.starts, inst.counts, r8, P, inst.sorted_key
    )
    mark("segment_relay")
    slab = _build_inst_seg(
        prep.means2d, prep.conic, prep.rgb, prep.opacity, seg.sorted_g8,
        inst.perm, seg.ride_d, seg.ride_t,
    )
    mark("_build_inst_seg")
    torch.cuda.synchronize()
    return slab, seg, inst, gx, gx * gy


def stage_phase(torch, model, camera, pose, cfg, reps=3):
    """Device time of each stage of one render (CUDA events between the
    stages, launch gaps included), averaged over ``reps`` after a warm-up."""
    from omnigs_torch.ops import composite_seg as cs
    from omnigs_torch.ops.rasterize import _tiles_to_image

    vm, campos = pose
    bg = torch.zeros(3, device=vm.device)
    totals = {}
    for rep in range(reps + 1):
        events = [("start", torch.cuda.Event(enable_timing=True))]
        events[0][1].record()

        def mark(stage):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append((stage, ev))

        with torch.inference_mode():
            slab, seg, _, gx, num_tiles = slab_for(
                model, camera, vm, campos, cfg, mark
            )
            mark("sync")
            color, final_t = cs.composite_seg_fwd(
                slab, seg.starts8, seg.counts, seg.live8, num_tiles, gx
            )
            mark("composite_seg_fwd")
            color = color + final_t[:, None, :] * bg[None, :, None]
            _tiles_to_image(color, gx, num_tiles // gx, WIDTH, HEIGHT)
            _tiles_to_image(final_t, gx, num_tiles // gx, WIDTH, HEIGHT)
            mark("blend+_tiles_to_image")
        torch.cuda.synchronize()
        if rep == 0:
            continue
        for (_, a), (stage, b) in zip(events, events[1:]):
            if stage != "sync":
                totals[stage] = totals.get(stage, 0.0) + a.elapsed_time(b) / reps
    emit({"phase": "stages", "pose": 0, "stage_ms": totals,
          "sum_ms": sum(totals.values())})
    return totals


def time_ms(torch, fn, reps, warmup=2):
    from omnigs_torch.utils.profiling import mean_ms

    return mean_ms(fn, "cuda", reps=reps, warmup=warmup)


def _bound(ops, nbytes):
    """(bound ms, what bounds it) of work of ``ops`` fp32 operations that
    moves ``nbytes`` bytes."""
    t_ops, t_bytes = ops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def ptxas_clean(lines):
    """True when ptxas reported stack frames and spills, and all are 0."""
    found = [re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                       r"(\d+) bytes spill loads", line) for line in lines]
    found = [m for m in found if m]
    return bool(found) and all(int(x) == 0 for m in found for x in m.groups())


def ptxas_of(lines, kernel):
    """The ptxas report lines of one kernel (by the name in its mangled
    symbol) within a source's report."""
    out, current = [], None
    for line in lines:
        m = re.search(r"(?:entry function|Function properties for) '?(\w+)", line)
        if m:
            current = m.group(1)
        if current is not None and kernel in current:
            out.append(line)
    return out


def _digest(*tensors):
    """sha256 (16 hex digits) of the tensors' bytes, as the build
    comparisons of `kernel_variants` take it."""
    from omnigs_torch.utils.kernel_variants import digest

    return digest(tensors)


def warp_pairs(torch, slab, starts, counts, x0, y0, n_used, gate, strip_rows):
    """Warp-instance pairs of a compositing kernel whose warps hold
    ``strip_rows`` pixel rows, on tiles at pixel origins ``x0``, ``y0``:
    (visited — instances up to the last one a pixel of the warp needs, from
    the plain walk's ``n_used`` —, live — of those, the ones that a pixel of
    the warp composites, from the plain walk's ``gate`` bits per two rows
    —, culled — of the visited, the ones whose strip bit the kernels'
    staging test clears, `_strip_masks`)."""
    from omnigs_torch.ops import composite_seg as cs

    num_tiles = n_used.shape[0]
    nw = 16 // strip_rows
    dev = slab.device
    counts64 = counts.to(torch.int64)
    tile_of = torch.repeat_interleave(torch.arange(num_tiles, device=dev), counts64)
    pos = torch.arange(tile_of.shape[0], device=dev) - (torch.cumsum(counts64, 0) - counts64)[tile_of]
    lane = starts.to(torch.int64)[tile_of] + pos
    need = n_used.reshape(num_tiles, nw, -1).amax(dim=2)
    visited = pos[:, None] < need[tile_of]  # (L, warps)
    w = torch.arange(nw, device=dev)
    mask = cs._strip_masks(slab, starts, counts, x0, y0, strip_rows)[lane]
    kept = ((mask[:, None] >> w) & 1).bool()
    per = strip_rows // cs.BWD_STRIP  # gate bits per strip
    g = gate[lane][:, None] >> (w * per)
    live = (g & ((1 << per) - 1)) != 0
    return {"warp_pairs_visited": int(visited.sum()),
            "warp_pairs_live": int((visited & live).sum()),
            "warp_pairs_culled": int((visited & ~kept).sum()),
            "warp_rows": strip_rows}


def segment_spread(torch, counts):
    """Mean, 99th percentile and max of the tiles' segment lengths."""
    c = torch.sort(counts.to(torch.float64)).values
    return {"counts_mean": float(c.mean()),
            "counts_p99": float(c[int(0.99 * (c.numel() - 1))]),
            "counts_max": int(c[-1])}


def kernel_phase(torch, model, camera, pose, cfg):
    from omnigs_torch.ops import composite_seg as cs
    from omnigs_torch.ops import composite_tile as ct

    vm, campos = pose
    with torch.inference_mode():
        slab, seg, inst, gx, num_tiles = slab_for(model, camera, vm, campos, cfg)
        args = (slab, seg.starts8, seg.counts, seg.live8, num_tiles, gx)
        kc, kt = cs.composite_seg_fwd(*args)
        torch.cuda.synchronize()
        gate = torch.zeros(slab.shape[1], dtype=torch.int32, device=slab.device)
        pc, pt, n_used, n_live = cs.composite_seg_fwd_plain(
            slab, seg.starts8, seg.counts, num_tiles, gx, warp_gate=gate
        )
        diff = torch.cat([(kc - pc).abs().flatten(), (kt - pt).abs().flatten()])
        max_err = float(diff.max())
        p999 = float(torch.sort(diff).values[int(0.999 * (diff.numel() - 1))])
        bitwise_plain = bool(torch.equal(kc, pc) and torch.equal(kt, pt))
        finite = bool(torch.isfinite(kc).all() and torch.isfinite(kt).all())
        digest = _digest(kc, kt)
        x0, y0 = ct.tile_origins(gx, num_tiles // gx, slab.device)
        pairs = {rows: warp_pairs(torch, slab, seg.starts8, seg.counts, x0, y0, n_used,
                                  gate, rows)
                 for rows in (cs.FWD_STRIP, cs.BWD_STRIP)}
        del gate, pc, pt
        kernel_ms = time_ms(torch, lambda: cs.composite_seg_fwd(*args), reps=20)
        plain_ms = time_ms(
            torch,
            lambda: cs.composite_seg_fwd_plain(
                slab, seg.starts8, seg.counts, num_tiles, gx
            ),
            reps=3, warmup=1,
        )
    visited = int(n_used.to(torch.int64).sum())
    live = int(n_live.to(torch.int64).sum())
    instances = int(seg.counts.to(torch.int64).sum())
    ops = visited * OPS_PER_VISITED_PAIR + live * OPS_PER_LIVE_PAIR
    nbytes = 9 * 4 * instances + 2 * 4 * num_tiles + 4 * 4 * 256 * num_tiles
    bound_ms, bound_by = _bound(ops, nbytes)
    result = {
        "phase": "kernel",
        "name": "composite_seg_fwd",
        "tiles": num_tiles,
        "gx": gx,
        "emitted_instances": int(inst.num_instances),
        "segment_instances": instances,
        "live8": int(seg.live8),
        "visited_pairs": visited,
        "live_pairs": live,
        **pairs[cs.FWD_STRIP],
        **segment_spread(torch, seg.counts),
        "ops": ops,
        "bytes": nbytes,
        "max_abs_err": max_err,
        "p999_abs_err": p999,
        "bitwise_equal_plain": bitwise_plain,
        "kernel_ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "digest": digest,
    }
    emit(result)
    if not finite:
        raise RuntimeError("kernel output is not finite")
    if max_err > MAX_ERR_BAR or p999 > P999_ERR_BAR or not bitwise_plain:
        raise RuntimeError(
            f"kernel disagrees with its plain version: max {max_err:.3g} "
            f"(bar {MAX_ERR_BAR}), p99.9 {p999:.3g} (bar {P999_ERR_BAR}), "
            f"bitwise equal {bitwise_plain}"
        )
    return result, (slab, seg, inst, kc, kt, pairs[cs.BWD_STRIP])


def segment_lanes(torch, starts, counts, width):
    """(width,) bool: the slab lanes inside some tile's segment."""
    dev = starts.device
    delta = torch.zeros(width + 1, dtype=torch.int32, device=dev)
    ones = torch.ones_like(counts)
    delta.index_add_(0, starts.to(torch.int64), ones)
    delta.index_add_(0, (starts + counts).to(torch.int64), -ones)
    return torch.cumsum(delta, 0, dtype=torch.int32)[:width] > 0


def grad_phase(torch, kres, slab_data):
    """The backward kernel on the kernel phase's slab against its plain
    version; timings; work counts and bound; a bitwise repeat of kernel +
    reduction."""
    from omnigs_torch.ops import composite_seg as cs

    slab, seg, inst, kc, kt, pairs = slab_data
    num_tiles, gx = kres["tiles"], kres["gx"]
    dev = slab.device
    with torch.inference_mode():
        color_full = kc.contiguous()  # bg = 0: color_full is the color
        gen = torch.Generator(device=dev).manual_seed(SEED)
        dcolor = torch.randn(color_full.shape, generator=gen, device=dev)
        args = (slab, seg.starts8, seg.counts, seg.live8, color_full, dcolor,
                num_tiles, gx)
        got = cs.composite_seg_bwd(*args)
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        ref = cs.composite_seg_bwd_plain(
            slab, seg.starts8, seg.counts, color_full, dcolor, num_tiles, gx
        )
        end.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(end)  # the plain version runs once
        lanes = segment_lanes(torch, seg.starts8, seg.counts, slab.shape[1])
        scale = ref[: cs.NGRAD].abs().amax(dim=1, keepdim=True)
        rel = ((got[: cs.NGRAD] - ref[: cs.NGRAD]).abs() / scale)[:, lanes]
        max_rel = float(rel.max())
        p999 = float(torch.sort(rel.flatten()).values[int(0.999 * (rel.numel() - 1))])
        max_abs = float((got[: cs.NGRAD] - ref[: cs.NGRAD]).abs().max())
        bitwise_plain = bool(torch.equal(got, ref))
        outside_zero = bool((got[:, ~lanes] == 0).all() and (got[cs.NGRAD:] == 0).all())
        finite = bool(torch.isfinite(got).all())
        digest = _digest(got)
        del ref, rel
        kernel_ms = time_ms(torch, lambda: cs.composite_seg_bwd(*args), reps=20)
        repeat = []
        for _ in range(2):
            acc = cs._reduce_rows(cs.composite_seg_bwd(*args), seg.sorted_g8, P)
            repeat.append(acc[inst.inv_perm.to(torch.int64)])
        bitwise = bool(torch.equal(repeat[0], repeat[1]))
        reduce_ms = time_ms(
            torch, lambda: cs._reduce_rows(got, seg.sorted_g8, P), reps=10
        )
    instances = kres["segment_instances"]
    live = kres["live_pairs"]
    ops = (kres["visited_pairs"] * OPS_PER_VISITED_PAIR
           + live * BWD_OPS_PER_LIVE_PAIR + instances * BWD_OPS_PER_INSTANCE)
    nbytes = (18 * 4 * instances + 2 * 4 * num_tiles + 6 * 4 * 256 * num_tiles
              + slab.numel() * 4)  # + the zero fill of the (16, R8) output
    bound_ms, bound_by = _bound(ops, nbytes)
    result = {
        "phase": "grad",
        "name": "composite_seg_bwd",
        "tiles": num_tiles,
        "segment_instances": instances,
        "visited_pairs": kres["visited_pairs"],
        "live_pairs": live,
        **pairs,
        **segment_spread(torch, seg.counts),
        "ops": ops,
        "bytes": nbytes,
        "max_abs_err": max_abs,
        "max_rel_err": max_rel,
        "p999_rel_err": p999,
        "bitwise_equal_plain": bitwise_plain,
        "kernel_ms": kernel_ms,
        "plain_ms": plain_ms,
        "reduce_ms": reduce_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "bitwise_repeat": bitwise,
        "digest": digest,
    }
    emit(result)
    if not finite or not outside_zero:
        raise RuntimeError("backward kernel: non-finite rows or nonzero lanes "
                           "outside the segments")
    if max_rel > MAX_ERR_BAR or p999 > P999_ERR_BAR or not bitwise_plain:
        raise RuntimeError(
            f"backward kernel disagrees with its plain version: max {max_rel:.3g} "
            f"(bar {MAX_ERR_BAR}), p99.9 {p999:.3g} (bar {P999_ERR_BAR}), relative; "
            f"bitwise equal {bitwise_plain}"
        )
    if not bitwise:
        raise RuntimeError("kernel + reduction is not bitwise repeatable")
    return result, (color_full, dcolor)


def _compare_line(phase, res, refs):
    """Emit a `kernel_variants` comparison with each kernel's bound and
    production digest (``refs``: kernel → its phase result); raise unless
    every build gave the production build's bytes, or (#5, #6) held the
    float bar."""
    line = {"phase": phase, "before": str(SEG_BEFORE.relative_to(REPO))}
    for kernel, ref in refs.items():
        line[kernel] = {"bound_ms": ref["bound_ms"], "digest_new": ref.get("digest"),
                        **res[kernel]}
    emit(line)
    builds = [(k, v, r) for k in res for v, r in res[k].items() if v != "order"]
    bad = [f"{k}/{v}" for k, v, r in builds
           if not r.get("bytes_equal_new", True) or r.get("tol_ratio", 0.0) > 1.0]
    if bad:
        raise RuntimeError(f"builds whose outputs differ from the production build's "
                           f"(bytes, or the float bar for #5/#6): {bad}")
    return line


def seg_compare_phase(torch, slab_data, kres, gres, grad_inputs):
    """Kernels #1/#2 of the earlier sources in ``SEG_BEFORE`` (when that copy
    exists) and of the present sources with one design element of the
    shared walk `csrc/composite_seg_walk.cuh` taken out, against the
    production build on the kernel/grad slab
    (`omnigs_torch/utils/kernel_variants.py`): every build's output bytes
    must equal the production build's; ms in turns (earlier sources first
    and last), ptxas per build, the unchanged bound."""
    if not SEG_BEFORE.is_dir():
        emit({"phase": "seg_compare", "before": None})
        return None
    from omnigs_torch.utils import kernel_variants as kv

    slab, seg, _, _, _, _ = slab_data
    color_full, dcolor = grad_inputs
    res = kv.compare_seg(SEG_BEFORE, slab, seg.starts8, seg.counts, color_full, dcolor,
                         kres["tiles"], kres["gx"])
    return _compare_line("seg_compare", res,
                         {"composite_seg_fwd": kres, "composite_seg_bwd": gres})


def render_phase(torch, model, camera, pose_list, cfg):
    from omnigs_torch.ops import composite_seg as cs
    from omnigs_torch.train.renderer import render_model

    bg = torch.zeros(3, device=model.xyz.device)
    # the layout counts of each request, computed outside the timed region
    layout = []
    with torch.inference_mode():
        for vm, campos in pose_list:
            _, seg, inst, _, _ = slab_for(model, camera, vm, campos, cfg)
            layout.append((int(inst.num_instances), int(seg.live8)))
    images = []
    torch.cuda.reset_peak_memory_stats()
    cs.composite_seg_fwd.launches = 0
    for k, (vm, campos) in enumerate(pose_list):
        before = cs.composite_seg_fwd.launches
        t0 = time.perf_counter()
        with torch.inference_mode():
            res = render_model(model, camera, vm, campos, bg, SH_DEGREE, cfg)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        img = res.image
        emit({
            "phase": "render",
            "request": k,
            "host_ms": host_ms,
            "emitted_instances": layout[k][0],
            "live8": layout[k][1],
            "truncated": int(res.truncated),
            "kernel_launches": cs.composite_seg_fwd.launches - before,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            "image_min": float(img.min()),
            "image_mean": float(img.mean()),
            "image_max": float(img.max()),
        })
        if int(res.truncated) != 0:
            raise RuntimeError(f"request {k}: {int(res.truncated)} instances truncated")
        if not bool(torch.isfinite(img).all()):
            raise RuntimeError(f"request {k}: image is not finite")
        if tuple(img.shape) != (3, HEIGHT, WIDTH):
            raise RuntimeError(f"request {k}: image shape {tuple(img.shape)}")
        images.append(res)
    launches = cs.composite_seg_fwd.launches
    if launches != len(pose_list):
        raise RuntimeError(
            f"composite_seg_fwd launched {launches} times in {len(pose_list)} requests"
        )
    return images, launches


def ply_phase(torch, model, camera, pose, cfg, image0):
    from omnigs_torch.io.ply import load_gaussian_ply, save_gaussian_ply
    from omnigs_torch.train.renderer import render_model

    path = REPO / "build" / "omnigs_torch" / "chip_smoke.ply"
    path.parent.mkdir(parents=True, exist_ok=True)
    try:
        save_gaussian_ply(path, model)
        loaded = load_gaussian_ply(path, device=model.xyz.device)
    finally:
        path.unlink(missing_ok=True)
    vm, campos = pose
    with torch.inference_mode():
        res = render_model(
            loaded, camera, vm, campos, torch.zeros(3, device=vm.device), SH_DEGREE, cfg
        )
    torch.cuda.synchronize()
    identical = bool(torch.equal(res.image, image0))
    emit({"phase": "ply", "gaussians": loaded.capacity, "bit_identical": identical})
    if not identical:
        diff = float((res.image - image0).abs().max())
        raise RuntimeError(f"PLY round trip changed the render (max |Δ| {diff})")


class Probe:
    """Wraps module functions so each call records a CUDA event on entry
    (``<label>:in``) and exit (``<label>:out``); restores them on exit.
    Used only to split a training step into stages."""

    def __init__(self, torch, targets):
        self.torch = torch
        self.targets = targets  # [(module, attribute, label)]
        self.events = {}
        self.saved = []

    def mark(self, label):
        ev = self.torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events[label] = ev

    def _wrap(self, fn, label):
        # functools.wraps also copies a kernel wrapper's launch counter, so
        # the wrapped function's own `+= 1` finds it
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            self.mark(label + ":in")
            out = fn(*args, **kwargs)
            self.mark(label + ":out")
            return out

        return wrapped

    def __enter__(self):
        for mod, attr, label in self.targets:
            fn = getattr(mod, attr)
            self.saved.append((mod, attr, fn))
            setattr(mod, attr, self._wrap(fn, label))
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in self.saved:
            setattr(mod, attr, fn)
        self.saved = []

    def ms(self, a, b):
        return self.events[a].elapsed_time(self.events[b])


def train_scene(torch, np, model, camera, pose_list, cfg):
    """Four keyframes at the poses, each ground truth the port's render of
    ``model``; the SfM cloud is the model's means plus N(0, INIT_NOISE)
    noise with the dc colors."""
    from omnigs_torch.ops.sh import sh2rgb
    from omnigs_torch.scene.keyframe import Keyframe
    from omnigs_torch.scene.scene import Scene
    from omnigs_torch.train.renderer import render_model

    scene = Scene()
    bg = torch.zeros(3, device=model.xyz.device)
    for fid, (vm, campos) in enumerate(pose_list):
        with torch.inference_mode():
            res = render_model(model, camera, vm, campos, bg, SH_DEGREE, cfg)
        vm_np = vm.cpu().numpy()
        scene.add_keyframe(Keyframe(
            fid, camera, vm_np[:3, :3].copy(), vm_np[:3, 3].copy(),
            image=res.image.permute(1, 2, 0).cpu().numpy(),
        ))
    rng = np.random.default_rng(SEED + 1)
    xyz = model.xyz.detach().cpu().numpy()
    scene.points = (xyz + rng.normal(size=xyz.shape) * INIT_NOISE).astype(np.float32)
    dc = model.features_dc.detach()[:, 0]
    scene.colors = torch.clamp(sh2rgb(dc), 0.0, 1.0).cpu().numpy()
    return scene


def train_config():
    """The production YAML on the train phase's compressed schedule."""
    from omnigs_torch.config import load_config

    cfg = load_config(CONFIG)
    # compressed schedule: densify at 3004, 3008 and 3012, no opacity reset
    cfg.opt.densification_interval = DENSIFY_EVERY
    cfg.opt.densify_until_iter = 4000
    cfg.opt.opacity_reset_interval = 0
    # the four poses lie within 0.1 of each other, so the world-size prune
    # (max scale > 0.1·extent ≈ 0.01) would remove nearly every Gaussian of
    # this cloud at the first densify; keep it off so densify grows the model
    cfg.opt.prune_big_point_after_iter = 4000
    return cfg


def train_phase(torch, scene, device):
    from omnigs_torch.model import densify as densify_ops
    from omnigs_torch.ops import composite_seg as cs
    from omnigs_torch.train.trainer import Trainer

    cfg = train_config()
    t0 = time.perf_counter()
    tr = Trainer(scene, cfg, seed=SEED, device=device)
    tr.init_from_sfm()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tr.iteration = TRAIN_START  # SH degree 3 from iteration 3000 on
    if tr.sh_degree != SH_DEGREE:
        raise RuntimeError(f"sh_degree {tr.sh_degree} at iteration {tr.iteration}")

    densified = []
    densify = densify_ops.densify_and_prune

    def counting_densify(*args, **kwargs):
        stats = densify(*args, **kwargs)
        densified.append({k: int(v) for k, v in stats._asdict().items()})
        return stats

    densify_ops.densify_and_prune = counting_densify
    torch.cuda.reset_peak_memory_stats()
    lines = []
    try:
        cs.composite_seg_fwd.launches = 0
        cs.composite_seg_bwd.launches = 0
        for _ in range(TRAIN_ITERS):
            fwd0, bwd0 = cs.composite_seg_fwd.launches, cs.composite_seg_bwd.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            aux = tr.train_iteration()
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3
            line = {
                "phase": "train",
                "iteration": tr.iteration,
                "host_ms": host_ms,
                "loss": float(aux["loss"]),
                "num_active": int(tr.model.num_active),
                "truncated": int(aux["truncated"]),
                "fwd_launches": cs.composite_seg_fwd.launches - fwd0,
                "bwd_launches": cs.composite_seg_bwd.launches - bwd0,
                "densified": densified[-1] if tr.iteration % DENSIFY_EVERY == 0
                and densified else None,
            }
            emit(line)
            lines.append(line)
        launches = {"composite_seg_fwd": cs.composite_seg_fwd.launches,
                    "composite_seg_bwd": cs.composite_seg_bwd.launches}
    finally:
        densify_ops.densify_and_prune = densify
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    finite = all(bool(torch.isfinite(p).all()) for p in tr.model.params().values())
    summary = {
        "phase": "train_summary",
        "iterations": TRAIN_ITERS,
        "init_from_sfm_s": init_s,
        "capacity": tr.model.capacity,
        "raster_max_instances": tr.raster_cfg.max_instances,
        "launches": launches,
        "densify_calls": len(densified),
        "peak_mem_gib": peak_gib,
        "params_finite": finite,
        "drained_loss": tr.drain_losses(),
        "total_truncated": tr.total_truncated,
    }
    emit(summary)
    if not finite or not all(math.isfinite(x["loss"]) for x in lines):
        raise RuntimeError("training produced a non-finite loss or parameter")
    if any(x["truncated"] for x in lines) or tr.total_truncated:
        raise RuntimeError("training truncated instances")
    if any(x["bwd_launches"] != 1 or x["fwd_launches"] < 1 for x in lines):
        raise RuntimeError("a training iteration skipped a kernel")
    if launches["composite_seg_bwd"] != TRAIN_ITERS or len(densified) != 3:
        raise RuntimeError(f"launches {launches}, densify ran {len(densified)} times")
    # what the parallel phase's (1, 1) ParallelTrainer is held to
    ref = {"losses": [x["loss"] for x in lines], "host_ms": [x["host_ms"] for x in lines],
           "model": {k: v.detach().clone() for k, v in tr.model.params().items()}}
    ref["model"]["active"] = tr.model.active.clone()
    return tr, launches, lines[0]["loss"], ref


def train_stages(torch, tr, reps=3):
    """Device ms of each stage of ``reps`` non-densify training iterations
    (CUDA events at the entry and exit of each stage's function)."""
    from omnigs_torch.model import densify as densify_ops
    from omnigs_torch.model import optimizer as opt_ops
    from omnigs_torch.ops import composite_seg as cs
    from omnigs_torch.ops import loss as loss_ops
    from omnigs_torch.ops import rasterize as rz

    targets = [
        (rz, "preprocess", "preprocess"), (rz, "bin_instances_packed", "binning"),
        (rz, "segment_relay", "relay"), (cs, "_build_inst_seg", "slab"),
        (cs, "composite_seg_fwd", "fwd"), (loss_ops, "l1_loss", "l1"),
        (loss_ops, "ssim", "ssim"), (cs, "composite_seg_bwd", "bwd"),
        (cs, "_reduce_rows", "reduce"),
        (densify_ops, "add_densification_stats", "stats"),
        (opt_ops, "adam_step", "adam"),
    ]
    totals = {}
    done = 0
    while done < reps:
        if (tr.iteration + 1) % DENSIFY_EVERY == 0:
            tr.train_iteration()  # a densify step: not measured
            continue
        with Probe(torch, targets) as pr:
            pr.mark("start")
            tr.train_iteration()
            pr.mark("end")
            torch.cuda.synchronize()
            stages = {
                "preprocess": pr.ms("preprocess:in", "preprocess:out"),
                "binning": pr.ms("binning:in", "binning:out"),
                "relay": pr.ms("relay:in", "relay:out"),
                "slab": pr.ms("slab:in", "slab:out"),
                "fwd_kernel": pr.ms("fwd:in", "fwd:out"),
                "blend": pr.ms("fwd:out", "l1:in"),
                "loss": pr.ms("l1:in", "ssim:out"),
                "bwd_kernel": pr.ms("bwd:in", "bwd:out"),
                "reduction": pr.ms("reduce:in", "reduce:out"),
                "autograd_rest": pr.ms("ssim:out", "bwd:in")
                + pr.ms("reduce:out", "stats:in"),
                "stats": pr.ms("stats:in", "stats:out"),
                "adam": pr.ms("adam:in", "adam:out"),
            }
            stages["other"] = pr.ms("start", "end") - sum(stages.values())
        for k, v in stages.items():
            totals[k] = totals.get(k, 0.0) + v / reps
        done += 1
    emit({"phase": "train_stages", "steps": reps, "stage_ms": totals,
          "sum_ms": sum(totals.values())})
    return totals


def tile_yaml():
    """The production YAML with `Tpu.want_ncontrib: 1`: the tile-major path."""
    from omnigs_torch.config import load_config

    cfg = load_config(CONFIG)
    cfg.tpu.want_ncontrib = True
    return cfg


def tile_slab_for(model, camera, vm, campos, cfg, with_emission=True, mark=None):
    """The tile-major compositor's inputs for one pose, through the port's
    chain (preprocess → bin_instances_packed, with the survivor-rank payload
    of the gather reduction when asked → _build_inst); the config's cap keeps
    every tile (no aligned_cap). ``mark(stage)`` is called after each
    stage."""
    import torch

    from omnigs_torch.ops import composite_tile as ct
    from omnigs_torch.ops.binning import bin_instances_packed
    from omnigs_torch.ops.preprocess import preprocess, tile_grid

    if cfg.aligned_cap is not None:
        raise RuntimeError("the tile phases expect an uncapped slab")
    mark = mark or (lambda stage: None)
    gx, gy = tile_grid(camera)
    prep = preprocess(
        model.xyz, model.get_scaling(), model.get_rotation(),
        model.get_opacity(), model.get_features(), camera, vm, campos,
        SH_DEGREE, active_mask=model.active, tight_culling=cfg.tight_culling,
    )
    mark("preprocess")
    inst = bin_instances_packed(
        prep, gx, gy, cfg.max_instances, tile_cull=cfg.tile_culling,
        with_emission=with_emission,
    )
    mark("bin_instances_packed")
    live = torch.amax(inst.starts + inst.counts)
    slab = ct._build_inst(
        prep.means2d, prep.conic, prep.rgb, prep.opacity, inst.sorted_g, live,
        inst.perm,
    )
    x0, y0 = ct.tile_origins(gx, gy, slab.device)
    mark("_build_inst")
    torch.cuda.synchronize()
    return dict(slab=slab, inst=inst, live=live, x0=x0, y0=y0, gx=gx,
                num_tiles=gx * gy)


def _plain_ms(torch, fn):
    """(result, device ms) of one call of a plain version."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def tile_kernel_phase(torch, model, camera, pose, cfg):
    """The tile-major forward kernel #3 against its plain version on pose
    0's compact slab, bit for bit (n_contrib included); a launch without
    n_contrib; times, work counts, warp pairs, digest and bound."""
    from omnigs_torch.ops import composite_seg as cs
    from omnigs_torch.ops import composite_tile as ct

    vm, campos = pose
    with torch.inference_mode():
        d = tile_slab_for(model, camera, vm, campos, cfg)
        inst, num_tiles = d["inst"], d["num_tiles"]
        args = (d["slab"], inst.starts, inst.counts, d["x0"], d["y0"], num_tiles)
        kc, kt, kn = ct.composite_tile_fwd(*args, True)
        k0c, k0t, k0n = ct.composite_tile_fwd(*args, False)
        torch.cuda.synchronize()
        gate = torch.zeros(d["slab"].shape[1], dtype=torch.int32, device=kc.device)
        (pc, pt, pn, n_used, n_live), plain_ms = _plain_ms(
            torch, lambda: ct.composite_tile_fwd_plain(*args, True, warp_gate=gate)
        )
        diff = torch.cat([(kc - pc).abs().flatten(), (kt - pt).abs().flatten()])
        max_err = float(diff.max())
        p999 = float(torch.sort(diff).values[int(0.999 * (diff.numel() - 1))])
        bitwise_plain = bool(torch.equal(kc, pc) and torch.equal(kt, pt))
        nc_equal = bool(torch.equal(kn, pn))
        nc_off_ok = bool(
            not k0n.any() and torch.equal(k0c, kc) and torch.equal(k0t, kt)
        )
        finite = bool(torch.isfinite(kc).all() and torch.isfinite(kt).all())
        digest = _digest(kc, kt, kn)
        pairs = {rows: warp_pairs(torch, d["slab"], inst.starts, inst.counts, d["x0"],
                                  d["y0"], n_used, gate, rows)
                 for rows in (cs.FWD_STRIP, cs.BWD_STRIP)}
        del gate, pc, pt, pn
        kernel_ms = time_ms(torch, lambda: ct.composite_tile_fwd(*args, True), reps=20)
        kernel_ms_off = time_ms(torch, lambda: ct.composite_tile_fwd(*args, False), reps=20)
    visited = int(n_used.to(torch.int64).sum())
    live = int(n_live.to(torch.int64).sum())
    instances = int(inst.counts.to(torch.int64).sum())
    ops = (visited * OPS_PER_VISITED_PAIR
           + live * (OPS_PER_LIVE_PAIR + TILE_NC_OPS_PER_LIVE_PAIR))
    nbytes = 9 * 4 * instances + 4 * 4 * num_tiles + 5 * 4 * 256 * num_tiles
    bound_ms, bound_by = _bound(ops, nbytes)
    result = {
        "phase": "tile_kernel",
        "name": "composite_tile_fwd",
        "tiles": num_tiles,
        "emitted_instances": int(inst.num_instances),
        "segment_instances": instances,
        "live": int(d["live"]),
        "max_count": int(inst.counts.max()),
        "visited_pairs": visited,
        "live_pairs": live,
        **pairs[cs.FWD_STRIP],
        **segment_spread(torch, inst.counts),
        "ops": ops,
        "bytes": nbytes,
        "max_abs_err": max_err,
        "p999_abs_err": p999,
        "bitwise_equal_plain": bitwise_plain,
        "n_contrib_bitwise": nc_equal,
        "n_contrib_max": int(kn.max()),
        "no_ncontrib_zeros_and_same_image": nc_off_ok,
        "kernel_ms": kernel_ms,
        "kernel_ms_no_ncontrib": kernel_ms_off,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "digest": digest,
    }
    emit(result)
    if not finite:
        raise RuntimeError("tile-major kernel output is not finite")
    if max_err > MAX_ERR_BAR or p999 > P999_ERR_BAR or not bitwise_plain:
        raise RuntimeError(
            f"tile-major kernel disagrees with its plain version: max {max_err:.3g} "
            f"(bar {MAX_ERR_BAR}), p99.9 {p999:.3g} (bar {P999_ERR_BAR}), "
            f"bitwise equal {bitwise_plain}"
        )
    if not nc_equal or not nc_off_ok:
        raise RuntimeError("n_contrib differs from the plain version's, or the "
                           "launch without it is not zeros with the same image")
    d["color"] = kc
    d["pairs"] = pairs[cs.BWD_STRIP]
    return result, d


def _reduce_close(torch, got, ref):
    """Max over the rows of max |got − ref| / (atol·max|ref| + rtol·|ref|)
    per column: ≤ 1 passes the gradient bars."""
    scale = ref.abs().amax(dim=0, keepdim=True)
    tol = REDUCE_ATOL * scale + REDUCE_RTOL * ref.abs()
    err = (got - ref).abs()
    # an all-zero column has a zero bar: equal entries pass, others fail
    return float(torch.where(err == 0, 0.0, err / tol).max())


def tile_grad_phase(torch, kres, d):
    """The tile-major backward kernel against its plain version; kernel +
    scatter reduction bitwise repeatable; the fused kernel against its plain
    version and against kernel + scatter reduction; the gather reduction
    against the scatter reduction; all three reductions against the float64
    sum of the same rows; times and bounds."""
    from omnigs_torch.ops import composite_tile as ct

    slab, inst, num_tiles = d["slab"], d["inst"], d["num_tiles"]
    dev = slab.device
    base = (inst.starts, inst.counts, d["x0"], d["y0"])
    with torch.inference_mode():
        color_full = d["color"].contiguous()  # bg = 0: color_full is the color
        gen = torch.Generator(device=dev).manual_seed(SEED + 2)
        dcolor = torch.randn(color_full.shape, generator=gen, device=dev)
        args = (slab, *base, color_full, dcolor, num_tiles)
        got = ct.composite_tile_bwd(*args)
        torch.cuda.synchronize()
        ref, plain_ms = _plain_ms(torch, lambda: ct.composite_tile_bwd_plain(*args))
        lanes = segment_lanes(torch, inst.starts, inst.counts, slab.shape[1])
        scale = ref[: ct.NGRAD].abs().amax(dim=1, keepdim=True)
        rel = ((got[: ct.NGRAD] - ref[: ct.NGRAD]).abs() / scale)[:, lanes]
        max_rel = float(rel.max())
        p999 = float(torch.sort(rel.flatten()).values[int(0.999 * (rel.numel() - 1))])
        max_abs = float((got[: ct.NGRAD] - ref[: ct.NGRAD]).abs().max())
        bitwise_plain = bool(torch.equal(got, ref))
        outside_zero = bool((got[:, ~lanes] == 0).all() and (got[ct.NGRAD:] == 0).all())
        finite = bool(torch.isfinite(got).all())
        digest = _digest(got)
        del ref, rel
        kernel_ms = time_ms(torch, lambda: ct.composite_tile_bwd(*args), reps=20)

        def scatter(dinst):
            return ct._scatter_reduce(dinst, inst.sorted_g, d["live"], P)

        repeat = [scatter(ct.composite_tile_bwd(*args))[inst.inv_perm.to(torch.int64)]
                  for _ in range(2)]
        bitwise = bool(torch.equal(repeat[0], repeat[1]))
        acc = scatter(got)
        rows = got[: ct.NGRAD, : inst.sorted_g.shape[0]].T
        gathered = ct.gather_reduce_rows(rows, inst.sorted_e, inst.seg_lo, inst.seg_hi)
        fargs = (slab, inst.sorted_g, *base, color_full, dcolor, num_tiles, P)
        fused = ct.composite_tile_bwd_fused(*fargs)
        fplain, fused_plain_ms = _plain_ms(
            torch, lambda: ct.composite_tile_bwd_fused_plain(*fargs)
        )
        gather_err = _reduce_close(torch, gathered, acc)
        # each reduction against the float64 sum of the same rows (#5
        # computes #4's rows bit for bit and sums them in its own order)
        lane = torch.arange(rows.shape[0], device=dev)
        exact = torch.zeros(P, ct.NGRAD, dtype=torch.float64, device=dev)
        exact.index_add_(0, inst.sorted_g[lane < d["live"]].to(torch.int64),
                         rows[lane < d["live"]].to(torch.float64))
        exact = exact.to(torch.float32)
        vs_f64 = {name: _reduce_close(torch, x, exact)
                  for name, x in (("scatter", acc), ("gather", gathered), ("fused", fused))}
        d["fused_exact"] = exact
        fused_plain_err = _reduce_close(torch, fused, fplain)
        fused_err = _reduce_close(torch, fused, acc)
        fused_max_abs = float((fused - fplain).abs().max())
        fused_finite = bool(torch.isfinite(fused).all())
        del fplain
        reduce_ms = time_ms(torch, lambda: scatter(got), reps=3)
        gather_ms = time_ms(
            torch,
            lambda: ct.gather_reduce_rows(rows, inst.sorted_e, inst.seg_lo, inst.seg_hi),
            reps=3,
        )
        fused_ms = time_ms(torch, lambda: ct.composite_tile_bwd_fused(*fargs), reps=3)
        # the instances whose nine rows are all zero (no pixel composited
        # them): #5's table sink adds nothing for them
        zero_rows = int((got[: ct.NGRAD, lanes] == 0).all(dim=0).sum())
        # the live lanes' ids and rows, for reduce_compare
        d["reduce_inputs"] = (inst.sorted_g[: int(d["live"])].contiguous(),
                              got[:, : int(d["live"])].contiguous())
    instances = kres["segment_instances"]
    pair_ops = (kres["visited_pairs"] * OPS_PER_VISITED_PAIR
                + kres["live_pairs"] * BWD_OPS_PER_LIVE_PAIR
                + instances * BWD_OPS_PER_INSTANCE)
    pix_bytes = 4 * 4 * num_tiles + 6 * 4 * 256 * num_tiles
    bwd_bytes = 18 * 4 * instances + pix_bytes + slab.numel() * 4  # + zero fill
    fused_ops = pair_ops + (instances - zero_rows) * FUSED_OPS_PER_INSTANCE
    fused_bytes = (9 + 1) * 4 * instances + pix_bytes + P * 9 * 4
    bound_ms, bound_by = _bound(pair_ops, bwd_bytes)
    fbound_ms, fbound_by = _bound(fused_ops, fused_bytes)
    result = {
        "phase": "tile_grad",
        "name": "composite_tile_bwd",
        "tiles": num_tiles,
        "segment_instances": instances,
        "visited_pairs": kres["visited_pairs"],
        "live_pairs": kres["live_pairs"],
        **d["pairs"],
        "ops": pair_ops,
        "bytes": bwd_bytes,
        "max_abs_err": max_abs,
        "max_rel_err": max_rel,
        "p999_rel_err": p999,
        "bitwise_equal_plain": bitwise_plain,
        "kernel_ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "bitwise_repeat": bitwise,
        "digest": digest,
        "scatter_reduce_ms": reduce_ms,
        "gather_reduce_ms": gather_ms,
        "gather_vs_scatter_tol_ratio": gather_err,
        "vs_float64_tol_ratio": vs_f64,
        "fused": {
            "name": "composite_tile_bwd_fused",
            "ops": fused_ops,
            "bytes": fused_bytes,
            "vs_plain_tol_ratio": fused_plain_err,
            "max_abs_err": fused_max_abs,
            "vs_bwd_scatter_tol_ratio": fused_err,
            "vs_bwd_scatter_max_abs": float((fused - acc).abs().max()),
            "instances_all_zero_rows": zero_rows,
            "kernel_ms": fused_ms,
            "plain_ms": fused_plain_ms,
            "bound_ms": fbound_ms,
            "bound_by": fbound_by,
        },
    }
    emit(result)
    if not finite or not outside_zero or not fused_finite:
        raise RuntimeError("tile-major backward: non-finite rows or nonzero lanes "
                           "outside the segments")
    if max_rel > MAX_ERR_BAR or p999 > P999_ERR_BAR or not bitwise_plain:
        raise RuntimeError(
            f"tile-major backward disagrees with its plain version: max {max_rel:.3g} "
            f"(bar {MAX_ERR_BAR}), p99.9 {p999:.3g} (bar {P999_ERR_BAR}), relative; "
            f"bitwise equal {bitwise_plain}"
        )
    if not bitwise:
        raise RuntimeError("tile-major kernel + reduction is not bitwise repeatable")
    if gather_err > 1.0 or fused_plain_err > 1.0 or fused_err > 1.0 or max(
            vs_f64.values()) > 1.0:
        raise RuntimeError(
            f"reductions disagree: gather {gather_err:.3g}, fused vs plain "
            f"{fused_plain_err:.3g}, fused vs kernel + scatter {fused_err:.3g}, vs "
            f"float64 {vs_f64} of the bar (rtol {REDUCE_RTOL}, atol {REDUCE_ATOL}·max)"
        )
    return result, (color_full, dcolor)


def tile_compare_phase(torch, d, tk, tg, grad_inputs):
    """Kernels #3/#4 of the earlier sources in ``SEG_BEFORE`` (when that
    copy exists) and of the present sources with one design element of the
    shared walk taken out, against the production build on the tile_kernel
    / tile_grad slab (`kernel_variants.compare_tile`), as
    `seg_compare_phase`."""
    if not SEG_BEFORE.is_dir():
        emit({"phase": "tile_compare", "before": None})
        return None
    from omnigs_torch.utils import kernel_variants as kv

    inst = d["inst"]
    color_full, dcolor = grad_inputs
    exact = d["fused_exact"]
    res = kv.compare_tile(SEG_BEFORE, d["slab"], inst.starts, inst.counts, d["x0"], d["y0"],
                          color_full, dcolor, inst.sorted_g, P,
                          lambda out: _reduce_close(torch, out, exact), d["num_tiles"])
    return _compare_line("tile_compare", res,
                         {"composite_tile_fwd": tk, "composite_tile_bwd": tg,
                          "composite_tile_bwd_fused": tg["fused"]})


def tile_stage_phase(torch, model, camera, pose, cfg, reps=3):
    """Device time of each stage of one tile-major render, as `stage_phase`
    (the 2^22 cap demotes the gather reduction: no emission payload)."""
    from omnigs_torch.ops import composite_tile as ct
    from omnigs_torch.ops.rasterize import _tiles_to_image

    vm, campos = pose
    bg = torch.zeros(3, device=vm.device)
    totals = {}
    for rep in range(reps + 1):
        events = [("start", torch.cuda.Event(enable_timing=True))]
        events[0][1].record()

        def mark(stage):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append((stage, ev))

        with torch.inference_mode():
            d = tile_slab_for(model, camera, vm, campos, cfg, False, mark)
            mark("sync")
            inst, num_tiles, gx = d["inst"], d["num_tiles"], d["gx"]
            color, final_t, ncontrib = ct.composite_tile_fwd(
                d["slab"], inst.starts, inst.counts, d["x0"], d["y0"], num_tiles,
                cfg.want_ncontrib,
            )
            mark("composite_tile_fwd")
            color = color + final_t[:, None, :] * bg[None, :, None]
            for t in (color, final_t, ncontrib):
                _tiles_to_image(t, gx, num_tiles // gx, WIDTH, HEIGHT)
            mark("blend+_tiles_to_image")
        torch.cuda.synchronize()
        if rep == 0:
            continue
        for (_, a), (stage, b) in zip(events, events[1:]):
            if stage != "sync":
                totals[stage] = totals.get(stage, 0.0) + a.elapsed_time(b) / reps
    emit({"phase": "tile_stages", "pose": 0, "stage_ms": totals,
          "sum_ms": sum(totals.values())})
    return totals


def tile_render_phase(torch, model, camera, pose_list, cfg, seg_renders):
    """Four requests through the tile-major config, each against the
    segmented render of the same pose."""
    from omnigs_torch.ops import composite_seg as cs
    from omnigs_torch.ops import composite_tile as ct
    from omnigs_torch.train.renderer import render_model

    bg = torch.zeros(3, device=model.xyz.device)
    cs.composite_seg_fwd.launches = 0
    ct.composite_tile_fwd.launches = 0
    for k, (vm, campos) in enumerate(pose_list):
        t0 = time.perf_counter()
        with torch.inference_mode():
            res = render_model(model, camera, vm, campos, bg, SH_DEGREE, cfg)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        seg = seg_renders[k]
        d_img = float((res.image - seg.image).abs().max())
        d_t = float((res.final_T - seg.final_T).abs().max())
        nc = res.n_contrib.to(torch.float64)
        emit({
            "phase": "tile_render",
            "request": k,
            "host_ms": host_ms,
            "truncated": int(res.truncated),
            "n_contrib_max": int(res.n_contrib.max()),
            "n_contrib_mean": float(nc.mean()),
            "vs_segmented_max_abs_image": d_img,
            "vs_segmented_max_abs_final_T": d_t,
            "bitwise_equal_segmented": bool(
                torch.equal(res.image, seg.image) and torch.equal(res.final_T, seg.final_T)
            ),
        })
        if int(res.truncated) != 0:
            raise RuntimeError(f"tile request {k}: {int(res.truncated)} instances truncated")
        if not bool(torch.isfinite(res.image).all()) or tuple(res.image.shape) != (3, HEIGHT, WIDTH):
            raise RuntimeError(f"tile request {k}: image not finite or shape {tuple(res.image.shape)}")
        if d_img > P999_ERR_BAR or d_t > P999_ERR_BAR or int(res.n_contrib.max()) <= 0:
            raise RuntimeError(
                f"tile request {k}: {d_img:.3g} / {d_t:.3g} from the segmented render "
                f"(bar {P999_ERR_BAR}) or no n_contrib"
            )
    launches = ct.composite_tile_fwd.launches
    if launches != len(pose_list) or cs.composite_seg_fwd.launches != 0:
        raise RuntimeError(
            f"tile requests launched composite_tile_fwd {launches} and "
            f"composite_seg_fwd {cs.composite_seg_fwd.launches} times"
        )
    return launches


def tile_train_phase(torch, scene, device, seg_loss):
    """A Trainer on the train phase's scene through the tile-major config."""
    from omnigs_torch.model import densify as densify_ops
    from omnigs_torch.ops import composite_seg as cs
    from omnigs_torch.ops import composite_tile as ct
    from omnigs_torch.train.trainer import Trainer

    cfg = tile_yaml()
    cfg.opt.densification_interval = DENSIFY_EVERY
    cfg.opt.densify_until_iter = 4000
    cfg.opt.opacity_reset_interval = 0
    cfg.opt.prune_big_point_after_iter = 4000  # as in train_phase
    tr = Trainer(scene, cfg, seed=SEED, device=device)
    tr.init_from_sfm()
    tr.iteration = TRAIN_START
    if tr.raster_cfg.segmented or not tr.raster_cfg.want_ncontrib:
        raise RuntimeError(f"the Trainer did not take the tile-major path: {tr.raster_cfg}")
    densified = []
    densify = densify_ops.densify_and_prune

    def counting_densify(*args, **kwargs):
        densified.append(densify(*args, **kwargs))
        return densified[-1]

    densify_ops.densify_and_prune = counting_densify
    counters = (ct.composite_tile_fwd, ct.composite_tile_bwd,
                ct.composite_tile_bwd_fused, cs.composite_seg_fwd, cs.composite_seg_bwd)
    lines = []
    try:
        for c in counters:
            c.launches = 0
        for _ in range(TILE_TRAIN_ITERS):
            before = [c.launches for c in counters]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            aux = tr.train_iteration()
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3
            delta = [c.launches - b for c, b in zip(counters, before)]
            line = {
                "phase": "tile_train",
                "iteration": tr.iteration,
                "host_ms": host_ms,
                "loss": float(aux["loss"]),
                "num_active": int(tr.model.num_active),
                "truncated": int(aux["truncated"]),
                "fwd_launches": delta[0],
                "bwd_launches": delta[1],
                "densified": tr.iteration % DENSIFY_EVERY == 0,
            }
            emit(line)
            lines.append((line, delta))
        launches = {c.__name__: c.launches for c in counters}
    finally:
        densify_ops.densify_and_prune = densify
    finite = all(bool(torch.isfinite(p).all()) for p in tr.model.params().values())
    first = lines[0][0]["loss"]
    loss_rel = abs(first - seg_loss) / abs(seg_loss)
    emit({"phase": "tile_train_summary", "iterations": TILE_TRAIN_ITERS,
          "launches": launches, "densify_calls": len(densified),
          "params_finite": finite, "first_loss": first, "segmented_first_loss": seg_loss,
          "first_loss_rel_diff": loss_rel, "total_truncated": tr.total_truncated})
    if not finite or not all(math.isfinite(x["loss"]) for x, _ in lines):
        raise RuntimeError("tile-major training produced a non-finite loss or parameter")
    if any(x["truncated"] for x, _ in lines) or tr.total_truncated:
        raise RuntimeError("tile-major training truncated instances")
    if any(dl[:2] != [1, 1] or any(dl[2:]) for _, dl in lines) or len(densified) != 1:
        raise RuntimeError(f"tile-major training launches {[dl for _, dl in lines]}, "
                           f"densify ran {len(densified)} times")
    if loss_rel > LOSS_RTOL:
        raise RuntimeError(f"first tile-major loss {first} vs segmented {seg_loss}")
    return tr, launches


def tile_train_stages(torch, tr, reps=2):
    """Device ms of each stage of ``reps`` non-densify tile-major steps."""
    from omnigs_torch.model import densify as densify_ops
    from omnigs_torch.model import optimizer as opt_ops
    from omnigs_torch.ops import composite_tile as ct
    from omnigs_torch.ops import loss as loss_ops
    from omnigs_torch.ops import rasterize as rz

    targets = [
        (rz, "preprocess", "preprocess"), (rz, "bin_instances_packed", "binning"),
        (ct, "_build_inst", "slab"), (ct, "composite_tile_fwd", "fwd"),
        (loss_ops, "l1_loss", "l1"), (loss_ops, "ssim", "ssim"),
        (ct, "composite_tile_bwd", "bwd"),
        # whichever reduction the config routes to (the scatter at 2^22)
        (ct, "_scatter_reduce", "reduce"), (ct, "gather_reduce_rows", "reduce"),
        (densify_ops, "add_densification_stats", "stats"),
        (opt_ops, "adam_step", "adam"),
    ]
    totals = {}
    done = 0
    while done < reps:
        if (tr.iteration + 1) % DENSIFY_EVERY == 0:
            tr.train_iteration()  # a densify step: not measured
            continue
        with Probe(torch, targets) as pr:
            pr.mark("start")
            tr.train_iteration()
            pr.mark("end")
            torch.cuda.synchronize()
            stages = {
                "preprocess": pr.ms("preprocess:in", "preprocess:out"),
                "binning": pr.ms("binning:in", "binning:out"),
                "slab": pr.ms("slab:in", "slab:out"),
                "fwd_kernel": pr.ms("fwd:in", "fwd:out"),
                "blend": pr.ms("fwd:out", "l1:in"),
                "loss": pr.ms("l1:in", "ssim:out"),
                "bwd_kernel": pr.ms("bwd:in", "bwd:out"),
                "reduction": pr.ms("reduce:in", "reduce:out"),
                "autograd_rest": pr.ms("ssim:out", "bwd:in")
                + pr.ms("reduce:out", "stats:in"),
                "stats": pr.ms("stats:in", "stats:out"),
                "adam": pr.ms("adam:in", "adam:out"),
            }
            stages["other"] = pr.ms("start", "end") - sum(stages.values())
        for k, v in stages.items():
            totals[k] = totals.get(k, 0.0) + v / reps
        done += 1
    emit({"phase": "tile_train_stages", "steps": reps, "stage_ms": totals,
          "sum_ms": sum(totals.values())})
    return totals


def tile_fused_phase(torch, model, camera, pose_list, cfg):
    """One `train_step` of the render model (P = 131,072) with
    fused_reduce=True through the fused backward kernel, against the same
    step through the backward kernel + scatter reduction."""
    from omnigs_torch.model.gaussians import GaussianModel
    from omnigs_torch.model.optimizer import LRConfig, init_adam
    from omnigs_torch.ops import composite_tile as ct
    from omnigs_torch.train.renderer import render_model
    from omnigs_torch.train.trainer import train_step

    if P > ct.FUSED_REDUCE_MAX_P:
        raise RuntimeError("the render model is above the fused route's limit")
    fields = model.to_numpy()
    dev = model.xyz.device
    vm, campos = pose_list[0]
    vm1, campos1 = pose_list[1]
    with torch.no_grad():
        # ground truth: the model seen from the next pose, so the step has
        # a real gradient (no_grad, not inference mode: the loss saves it)
        gt = render_model(
            model, camera, vm1, campos1, torch.zeros(3, device=dev), SH_DEGREE, cfg
        ).image
    steps = {}
    for fused in (True, False):
        m = GaussianModel.from_numpy(fields, device=dev)
        st = init_adam(m.params())
        kernels = (ct.composite_tile_bwd_fused, ct.composite_tile_bwd, ct.composite_tile_fwd)
        for k in kernels:
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        aux = train_step(
            m, st, vm, campos, gt, TRAIN_START + 1, camera=camera,
            sh_degree=SH_DEGREE,
            # no emission payload: the fused route's condition (the 2^22
            # cap demotes the gather reduction anyway)
            raster_cfg=dataclasses.replace(cfg, fused_reduce=fused, gather_reduce=False),
            lr_cfg=LRConfig(), spatial_lr_scale=1.0,
            bg=torch.zeros(3, device=dev),
        )
        torch.cuda.synchronize()
        steps[fused] = dict(
            host_ms=(time.perf_counter() - t0) * 1e3, loss=float(aux["loss"]),
            launches=tuple(k.launches for k in kernels),
            mu=st.mu,
        )
    ratios = {
        k: _reduce_close(torch, steps[True]["mu"][k].reshape(P, -1),
                         steps[False]["mu"][k].reshape(P, -1))
        for k in steps[True]["mu"]
    }
    emit({"phase": "tile_fused", "host_ms": steps[True]["host_ms"],
          "unfused_host_ms": steps[False]["host_ms"], "loss": steps[True]["loss"],
          "launches_fused_bwd_fwd": steps[True]["launches"],
          "mu_vs_unfused_tol_ratio": ratios})
    if steps[True]["launches"] != (1, 0, 1) or steps[False]["launches"] != (0, 1, 1):
        raise RuntimeError(f"fused step launches {steps[True]['launches']}, "
                           f"unfused {steps[False]['launches']}")
    if max(ratios.values()) > 1.0 or not math.isfinite(steps[True]["loss"]):
        raise RuntimeError(f"fused step disagrees with the unfused one: {ratios}")
    fused_bwd, _, fwd = steps[True]["launches"]
    return {"composite_tile_bwd_fused": fused_bwd, "composite_tile_fwd": fwd}


def tile_gather_phase(torch, model, camera, pose_list, cfg):
    """The gather reduction against the scatter reduction where the routing
    rule takes the gather: `train_step` of the render model (P = 131,072,
    the capacity of cfg/lonlat/synthetic_fullres.yaml) at that config's
    instance cap GATHER_CAP, ``gather_reduce`` on and off, on two copies of
    the model stepped in turn (the order alternating)."""
    from omnigs_torch.model.gaussians import GaussianModel
    from omnigs_torch.model.optimizer import LRConfig, init_adam
    from omnigs_torch.ops import composite_tile as ct
    from omnigs_torch.ops.rasterize import GATHER_REDUCE_MAX_R
    from omnigs_torch.train.renderer import render_model
    from omnigs_torch.train.trainer import train_step

    if GATHER_CAP > GATHER_REDUCE_MAX_R:
        raise RuntimeError("the gather phase's cap is above the gather route's limit")
    dev = model.xyz.device
    bg = torch.zeros(3, device=dev)
    vm, campos = pose_list[0]
    vm1, campos1 = pose_list[1]
    with torch.no_grad():
        # ground truth: the model seen from the next pose, as in tile_fused
        gt = render_model(model, camera, vm1, campos1, bg, SH_DEGREE, cfg).image
    fields = model.to_numpy()
    runs = {}
    for route, gather in (("gather", True), ("scatter", False)):
        m = GaussianModel.from_numpy(fields, device=dev)
        rcfg = dataclasses.replace(cfg, max_instances=GATHER_CAP, gather_reduce=gather)
        runs[route] = (m, init_adam(m.params()), rcfg)
    targets = [(ct, "gather_reduce_rows", "gather"), (ct, "_scatter_reduce", "scatter")]
    lines, ratios = [], {}
    for i in range(GATHER_ITERS):
        line = {"phase": "tile_gather", "step": i + 1}
        order = ("gather", "scatter") if i % 2 == 0 else ("scatter", "gather")
        for route in order:
            m, st, rcfg = runs[route]
            with Probe(torch, targets) as pr:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                aux = train_step(
                    m, st, vm, campos, gt, TRAIN_START + i + 1, camera=camera,
                    sh_degree=SH_DEGREE, raster_cfg=rcfg, lr_cfg=LRConfig(),
                    spatial_lr_scale=1.0, bg=bg,
                )
                torch.cuda.synchronize()
                host_ms = (time.perf_counter() - t0) * 1e3
            taken = [r for r in ("gather", "scatter") if f"{r}:in" in pr.events]
            line[route] = {
                "host_ms": host_ms,
                "reduce_ms": pr.ms(f"{route}:in", f"{route}:out")
                if taken == [route] else None,
                "routes": taken,
                "loss": float(aux["loss"]),
                "truncated": int(aux["truncated"]),
            }
        if i == 0:
            mu_g, mu_s = runs["gather"][1].mu, runs["scatter"][1].mu
            ratios = {
                k: _reduce_close(torch, mu_g[k].reshape(P, -1), mu_s[k].reshape(P, -1))
                for k in mu_g
            }
            line["mu_gather_vs_scatter_tol_ratio"] = ratios
        emit(line)
        lines.append(line)
    summary = {"phase": "tile_gather_summary", "cap": GATHER_CAP,
               "steps_averaged": GATHER_ITERS - 1}
    for route in ("gather", "scatter"):
        later = [x[route] for x in lines[1:]]
        summary[route] = {
            "reduce_ms_mean": sum(x["reduce_ms"] or 0.0 for x in later) / len(later),
            "host_ms_mean": sum(x["host_ms"] for x in later) / len(later),
        }
    for x in lines:
        for route in ("gather", "scatter"):
            r = x[route]
            if r["routes"] != [route] or r["truncated"] or not math.isfinite(r["loss"]):
                raise RuntimeError(f"gather phase, step {x['step']}: {route} step took "
                                   f"{r['routes']}, truncated {r['truncated']}, "
                                   f"loss {r['loss']}")
    loss_rel = max(abs(x["gather"]["loss"] - x["scatter"]["loss"]) / abs(x["scatter"]["loss"])
                   for x in lines)
    summary["max_loss_rel_diff"] = loss_rel
    emit(summary)
    if loss_rel > LOSS_RTOL:
        raise RuntimeError(f"gather and scatter steps disagree: loss {loss_rel:.3g} "
                           f"relative (bar {LOSS_RTOL})")
    return summary


def kernel_counters():
    """Every kernel wrapper of the port, by name (each counts its launches
    in ``.launches``)."""
    from omnigs_torch.ops import composite_seg as cs
    from omnigs_torch.ops import composite_tile as ct
    from omnigs_torch.scripts import bucket_emit_bench as be
    from omnigs_torch.scripts import kernel_ablate as ka
    from omnigs_torch.scripts import reduce_bench as rb

    fns = (cs.composite_seg_fwd, cs.composite_seg_bwd, ct.composite_tile_fwd,
           ct.composite_tile_bwd, ct.composite_tile_bwd_fused, rb.reduce_accum,
           be.bucket_emit, ka.kernel_ablate)
    return {f.__name__: f for f in fns}


def reset_launches():
    for f in kernel_counters().values():
        f.launches = 0


def read_launches():
    return {name: f.launches for name, f in kernel_counters().items()}


def _only(counts, expected):
    """True when exactly the kernels of ``expected`` launched, that often."""
    return all(counts[k] == expected.get(k, 0) for k in counts)


def _requests(torch, model, camera, pose_list, cfg, seg_renders, phase, n=None):
    """``n`` (all by default) `render_model` requests through ``cfg`` with
    the launch counters set to 0 just before and read just after, each
    against the segmented render of its pose → (lines, launches)."""
    from omnigs_torch.train.renderer import render_model

    bg = torch.zeros(3, device=model.xyz.device)
    lines = []
    poses_run = pose_list[: n or len(pose_list)]
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    for k, (vm, campos) in enumerate(poses_run):
        t0 = time.perf_counter()
        with torch.inference_mode():
            res = render_model(model, camera, vm, campos, bg, SH_DEGREE, cfg)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        seg = seg_renders[k]
        d_img = (res.image - seg.image).abs()
        line = {
            "phase": phase,
            "request": k,
            "host_ms": host_ms,
            "truncated": int(res.truncated),
            "overflow": int(res.overflow),
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            "vs_segmented_max_abs_image": float(d_img.max()),
            "vs_segmented_max_abs_final_T": float((res.final_T - seg.final_T).abs().max()),
            # the XLA backend's bar (tests/test_pallas_raster.py): atol + rtol
            "vs_segmented_tol_ratio": float((d_img / (1e-5 + 1e-5 * seg.image.abs())).max()),
            "bitwise_equal_segmented": bool(torch.equal(res.image, seg.image)),
            "finite": bool(torch.isfinite(res.image).all()),
        }
        emit(line)
        lines.append(line)
        if line["truncated"] or not line["finite"] or tuple(res.image.shape) != (3, HEIGHT, WIDTH):
            raise RuntimeError(f"{phase} request {k}: truncated {line['truncated']}, "
                               f"finite {line['finite']}, shape {tuple(res.image.shape)}")
    return lines, read_launches()


def _step(torch, fields, camera, pose_list, gt, rcfg):
    """One `train_step` of a fresh copy of the render model through
    ``rcfg`` with the launch counters set to 0 just before and read just
    after → dict(host ms, loss, Adam first moments, launches, peak GiB).
    It runs in ``gt``'s dtype, with float64 ``fields`` for a float64 step."""
    from omnigs_torch.model.gaussians import GaussianModel
    from omnigs_torch.model.optimizer import LRConfig, init_adam
    from omnigs_torch.train.trainer import train_step

    dev = gt.device
    vm, campos = pose_list[0]
    vm, campos = vm.to(gt.dtype), campos.to(gt.dtype)
    m = GaussianModel.from_numpy(fields, device=dev)
    st = init_adam(m.params())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    aux = train_step(
        m, st, vm, campos, gt, TRAIN_START + 1, camera=camera, sh_degree=SH_DEGREE,
        raster_cfg=rcfg, lr_cfg=LRConfig(), spatial_lr_scale=1.0,
        bg=torch.zeros(3, device=dev, dtype=gt.dtype),
    )
    torch.cuda.synchronize()
    return dict(host_ms=(time.perf_counter() - t0) * 1e3, loss=float(aux["loss"]),
                truncated=int(aux["truncated"]), mu=st.mu, launches=read_launches(),
                peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)


def _mu_rows(torch, got, ref, rtol, atol):
    """Per parameter, per Gaussian: max |got − ref| / (atol·max|ref| +
    rtol·|ref|) of the Adam first moments (0.1·gradient after one step);
    ≤ 1 passes."""
    out = {}
    for k in ref:
        r, g = ref[k].reshape(P, -1), got[k].reshape(P, -1)
        tol = atol * r.abs().max() + rtol * r.abs()
        err = (g - r).abs()
        out[k] = torch.where(err == 0, 0.0, err / tol).amax(dim=1)
    return out


def _mu_ratio(torch, got, ref, rtol, atol):
    """Per parameter: the largest of `_mu_rows`."""
    return {k: float(v.max()) for k, v in _mu_rows(torch, got, ref, rtol, atol).items()}


def layout_steps(torch, model, camera, pose_list, cfg):
    """The segmented step that the ghost and XLA steps are held against, and
    what they share: the model's fields and the ground truth (the model
    seen from the next pose, as in tile_fused)."""
    from omnigs_torch.train.renderer import render_model

    vm1, campos1 = pose_list[1]
    dev = model.xyz.device
    with torch.no_grad():
        gt = render_model(model, camera, vm1, campos1, torch.zeros(3, device=dev),
                          SH_DEGREE, cfg).image
    fields = model.to_numpy()
    return fields, gt, _step(torch, fields, camera, pose_list, gt, cfg)


def ghost_phase(torch, model, camera, pose_list, cfg, seg_renders, steps):
    """The ghost-aligned layout through the tile-major kernels (the pairing
    of scripts/check_jit_parity.py:196-205): four requests against the
    segmented renders, one `train_step` against the segmented step."""
    gcfg = dataclasses.replace(
        cfg, ghost_align=True, depth_presort=False, segmented=False,
        gather_reduce=False, want_ncontrib=False, aligned_cap=None,
        max_instances=GHOST_CAP,
    )
    lines, launches = _requests(torch, model, camera, pose_list, gcfg, seg_renders, "ghost")
    fields, gt, seg_step = steps
    st = _step(torch, fields, camera, pose_list, gt, gcfg)
    # check_jit_parity's bar: max |Δ| ≤ 2e-3 of each parameter's max
    ratio = _mu_ratio(torch, st["mu"], seg_step["mu"], 0.0, GHOST_GRAD_REL)
    summary = {
        "phase": "ghost_summary", "requests": len(lines),
        "host_ms": [x["host_ms"] for x in lines], "launches": launches,
        "step_host_ms": st["host_ms"], "step_loss": st["loss"],
        "segmented_step_loss": seg_step["loss"], "step_launches": st["launches"],
        "mu_vs_segmented_rel_ratio": ratio,
    }
    emit(summary)
    worst = max(max(x["vs_segmented_max_abs_image"], x["vs_segmented_max_abs_final_T"])
                for x in lines)
    if worst > P999_ERR_BAR:
        raise RuntimeError(f"ghost renders {worst:.3g} from the segmented ones")
    if not _only(launches, {"composite_tile_fwd": len(lines)}) or not _only(
            st["launches"], {"composite_tile_fwd": 1, "composite_tile_bwd": 1}):
        raise RuntimeError(f"ghost launches {launches}, step {st['launches']}")
    if st["truncated"] or max(ratio.values()) > 1.0:
        raise RuntimeError(f"ghost step: truncated {st['truncated']}, {ratio}")
    return launches["composite_tile_fwd"] + st["launches"]["composite_tile_fwd"], st


def fallback_phase(torch, model, camera, pose_list, seg_renders):
    """The production YAML with `Tpu.depth_presort: 0` (the compact 2-key
    binning), segmented and with `Tpu.want_ncontrib: 1`: four requests
    each, against the packed-key segmented renders."""
    from omnigs_torch.config import load_config, raster_config_from

    out = {}
    for name, ncontrib, kernel in (("segmented", False, "composite_seg_fwd"),
                                   ("tile", True, "composite_tile_fwd")):
        yaml = load_config(CONFIG)
        yaml.tpu.depth_presort = False
        yaml.tpu.want_ncontrib = ncontrib
        fcfg = raster_config_from(yaml)
        if fcfg.depth_presort or fcfg.segmented == ncontrib:
            raise RuntimeError(f"Tpu.depth_presort: 0 gave {fcfg}")
        lines, launches = _requests(torch, model, camera, pose_list, fcfg, seg_renders,
                                    f"fallback_{name}")
        worst = max(max(x["vs_segmented_max_abs_image"], x["vs_segmented_max_abs_final_T"])
                    for x in lines)
        if worst > P999_ERR_BAR or not _only(launches, {kernel: len(lines)}):
            raise RuntimeError(f"fallback {name}: {worst:.3g} from the packed renders, "
                               f"launches {launches}")
        out[name] = launches[kernel]
    emit({"phase": "fallback_summary", "launches": out})
    return out


def _screen_grads(torch, model, camera, pose, rcfg):
    """Gradients of a seeded weighted sum of one render's per-tile colors
    w.r.t. the compositor's inputs (means2d, conic, rgb, opacity), through
    ``rcfg``'s binning and compositor: what the compositor itself
    computes, before `preprocess`'s Jacobians."""
    from omnigs_torch.ops import rasterize as rz
    from omnigs_torch.ops.preprocess import preprocess, tile_grid

    vm, campos = pose
    gx, gy = tile_grid(camera)
    with torch.no_grad():
        prep = preprocess(
            model.xyz, model.get_scaling(), model.get_rotation(),
            model.get_opacity(), model.get_features(), camera, vm, campos,
            SH_DEGREE, active_mask=model.active, tight_culling=rcfg.tight_culling,
        )
    names = ("means2d", "conic", "rgb", "opacity")
    leaves = [getattr(prep, k).detach().clone().requires_grad_(True) for k in names]
    prep = prep._replace(conic=leaves[1], opacity=leaves[3])
    color = rz._composite(rcfg, prep, leaves[0], leaves[2], torch.zeros(3, device=vm.device),
                          gx, gy)[0]
    gen = torch.Generator(device=vm.device).manual_seed(SEED + 3)
    w = torch.rand(color.shape, generator=gen, device=vm.device)
    grads = torch.autograd.grad((color * w).sum(), leaves)
    torch.cuda.synchronize()
    return dict(zip(names, grads))


def _xla_decisions(torch, a, b, gx, gy, xcfg):
    """The XLA compositor's decisions (`rasterize._composite_tiles_fwd_impl`)
    on ``a``'s dense binning, from two preprocessings ``a`` and ``b`` of
    the same model (float32 and float64) → (stop_a, stop_b, alpha_flip):
    per pixel (T, PX int64) the Gaussian at which each stops — its first
    live instance whose inclusive transmittance falls below T_STOP —, or
    -1 where it composites to the end; and (P,) bool the Gaussians with a
    pair that is live (α ≥ 1/255) in one precision only."""
    from omnigs_torch.ops.binning import bin_gaussians
    from omnigs_torch.ops.rasterize import T_STOP, _chunk_geometry, _chunks, _tile_pixel_coords

    dev = a.means2d.device
    binned = bin_gaussians(a, gx, gy, xcfg.max_instances, xcfg.tile_cap)
    pix = _tile_pixel_coords(gx, gy, dev)
    preps = (a, b)
    n = [torch.ones(gx * gy, pix.shape[1], dtype=p.means2d.dtype, device=dev) for p in preps]
    stop = [torch.full(n[0].shape, -1, dtype=torch.int64, device=dev) for _ in preps]
    flip = torch.zeros(P + 1, dtype=torch.bool, device=dev)
    for _, ids, msk in _chunks(binned.tile_ids, binned.tile_mask, xcfg.chunk):
        lives = []
        for k, prep in enumerate(preps):
            alpha, live, *_ = _chunk_geometry(ids, msk, prep.means2d, prep.conic,
                                              prep.opacity, pix)
            n_incl = n[k][..., None] * torch.cumprod(1.0 - alpha, dim=-1)
            fail = live & ~(n_incl >= T_STOP)
            first = fail.to(torch.int8).argmax(dim=-1)
            stop[k] = torch.where(fail.any(dim=-1) & (stop[k] < 0), ids.gather(1, first),
                                  stop[k])
            n[k] = n_incl[..., -1]
            lives.append(live)
        flip[torch.where((lives[0] != lives[1]).any(dim=1), ids, P)] = True
    return stop[0], stop[1], flip[:P]


def xla_gap(torch, fields, wide, camera, pose, xcfg, steps32, exact):
    """Which Gaussians carry the float32 steps' distance from the float64
    step. For the parameter whose float32 XLA moments lie farthest from
    the float64 step's (in units of the JAX bar, rtol 1e-3, atol
    1e-4·max): the Gaussians that miss the bar, and how many of them flip a
    decision between the precisions — `preprocess` culls them differently
    (radii or rect), a pair of theirs is live (α ≥ 1/255) in one precision
    only, or a tile of theirs has a pixel whose XLA compositor stops at
    another Gaussian (`_xla_decisions`; also how many are themselves the
    Gaussian at which such a pixel stops) —; and per float32 step the bar
    ratio over the Gaussians with no flip."""
    from omnigs_torch.model.gaussians import GaussianModel
    from omnigs_torch.ops.preprocess import preprocess, tile_grid

    vm, campos = pose
    gx, gy = tile_grid(camera)
    preps = []
    for f in (fields, wide):
        m = GaussianModel.from_numpy(f, device=vm.device)
        dt = m.xyz.dtype
        with torch.no_grad():
            preps.append(preprocess(
                m.xyz, m.get_scaling(), m.get_rotation(), m.get_opacity(),
                m.get_features(), camera, vm.to(dt), campos.to(dt), SH_DEGREE,
                active_mask=m.active, tight_culling=xcfg.tight_culling,
            ))
    a, b = preps
    cull = (a.radii != b.radii) | (a.rect != b.rect).any(dim=-1)
    s32, s64, alpha = _xla_decisions(torch, a, b, gx, gy, xcfg)
    moved = s32 != s64
    stop_tiles = moved.any(dim=1).reshape(gy, gx)
    # the Gaussians at which a moved stop lies, in either precision
    own = torch.zeros(P + 1, dtype=torch.bool, device=vm.device)
    own[torch.cat([s32[moved], s64[moved]]) % (P + 1)] = True  # -1 (none) → P
    own = own[:P]
    csum = torch.zeros(gy + 1, gx + 1, dtype=torch.int64, device=vm.device)
    csum[1:, 1:] = stop_tiles.to(torch.int64).cumsum(0).cumsum(1)

    def hits(rect):
        x0, y0, x1, y1 = rect.to(torch.int64).unbind(-1)
        return (csum[y1, x1] - csum[y0, x1] - csum[y1, x0] + csum[y0, x0]) > 0

    stop = hits(a.rect) | hits(b.rect)
    flipped = cull | alpha | stop
    rows = {k: _mu_rows(torch, s["mu"], exact["mu"], XLA_GRAD_RTOL, XLA_GRAD_ATOL)
            for k, s in steps32.items()}
    name = max(rows["xla"], key=lambda k: float(rows["xla"][k].max()))
    miss = rows["xla"][name] > 1.0
    got = steps32["xla"]["mu"][name].reshape(P, -1)
    ref = exact["mu"][name].reshape(P, -1)
    tol = XLA_GRAD_ATOL * ref.abs().max() + XLA_GRAD_RTOL * ref.abs()
    worst = ((got - ref).abs() / tol).argmax(dim=1)
    ca, cb, cc = b.conic.unbind(-1)
    kappa = (ca + cc) ** 2 / (ca * cc - cb * cb)  # the float64 conic's condition
    miss_detail = [
        [i, float(got[i, worst[i]]), float(ref[i, worst[i]]),
         float(ref[i].abs().max() / ref.abs().max()), float(rows["xla"][name][i]),
         float(kappa[i]), int(b.radii[i])]
        for i in torch.nonzero(miss).flatten()[:20].tolist()
    ]
    line = {
        "phase": "xla_gap", "param": name, "bar": [XLA_GRAD_RTOL, XLA_GRAD_ATOL],
        "xla_ratio": float(rows["xla"][name].max()),
        "misses": int(miss.sum()),
        "misses_cull_flipped": int((miss & cull).sum()),
        "misses_alpha_flipped": int((miss & alpha).sum()),
        "misses_stop_flipped": int((miss & stop).sum()),
        "misses_neither": int((miss & ~flipped).sum()),
        "misses_own_stop_moved": int((miss & own).sum()),
        "neither_ids": torch.nonzero(miss & ~flipped).flatten()[:20].tolist(),
        # each miss: id, its float32 and float64 moment where farthest over
        # the bar, its largest |float64 moment| / the parameter's max, ratio,
        # (A + C)^2 / det of its float64 conic, radius
        "miss_detail": miss_detail,
        "gaussians_cull_flipped": int(cull.sum()),
        "gaussians_alpha_flipped": int(alpha.sum()),
        "gaussians_stop_flipped": int(stop.sum()),
        "tiles_stop_flipped": int(stop_tiles.sum()),
        "pixels_stop_moved": int(moved.sum()),
        "ratio_without_flips": {
            k: float(torch.where(flipped, 0.0, r[name]).max()) for k, r in rows.items()
        },
    }
    emit(line)
    return line


def xla_phase(torch, np, model, camera, pose_list, cfg, seg_renders, steps):
    """`backend="xla"` (the dense per-tile layout and the chunked plain
    compositor, no kernel) at tile_cap 1024, chunk 32: two requests against
    the segmented renders; one float32 `train_step` and the same step in
    float64 (the XLA path is plain PyTorch, so it runs in float64 too):
    the float32 XLA and segmented steps' Adam moments are each held against
    the float64 step's at twice the JAX package's Pallas-vs-XLA bars, their
    losses within 1e-5 of each other; and the compositor's own gradients
    against the segmented compositor's at those bars. Then `xla_gap`."""
    from omnigs_torch.ops.rasterize import RasterConfig

    xcfg = RasterConfig(max_instances=cfg.max_instances, tile_cap=1024, chunk=32,
                        backend="xla", tight_culling=cfg.tight_culling)
    lines, launches = _requests(torch, model, camera, pose_list, xcfg, seg_renders, "xla", 2)
    g_x = _screen_grads(torch, model, camera, pose_list[0], xcfg)
    g_s = _screen_grads(torch, model, camera, pose_list[0], cfg)
    grad_ratio = _mu_ratio(torch, g_x, g_s, XLA_GRAD_RTOL, XLA_GRAD_ATOL)
    del g_x, g_s
    fields, gt, seg_step = steps
    st = _step(torch, fields, camera, pose_list, gt, xcfg)
    wide = {k: v.astype(np.float64) if v.dtype == np.float32 else v for k, v in fields.items()}
    exact = _step(torch, wide, camera, pose_list, gt.double(), xcfg)
    vs_float64 = {
        name: _mu_ratio(torch, got["mu"], exact["mu"], XLA_STEP_RTOL, XLA_STEP_ATOL)
        for name, got in (("xla", st), ("segmented", seg_step))
    }
    ratio = _mu_ratio(torch, st["mu"], seg_step["mu"], XLA_STEP_RTOL, XLA_STEP_ATOL)
    loss_rel = abs(st["loss"] - seg_step["loss"]) / abs(seg_step["loss"])
    emit({"phase": "xla_summary", "step_host_ms": st["host_ms"],
          "step_peak_mem_gib": st["peak_mem_gib"], "step_loss": st["loss"],
          "segmented_step_loss": seg_step["loss"], "step_loss_rel_diff": loss_rel,
          "float64_step_loss": exact["loss"], "float64_step_host_ms": exact["host_ms"],
          "float64_step_peak_mem_gib": exact["peak_mem_gib"],
          "launches": launches, "step_launches": st["launches"],
          "mu_vs_float64_tol_ratio": vs_float64,
          "mu_vs_segmented_tol_ratio": ratio,
          "compositor_grads_vs_segmented_tol_ratio": grad_ratio})
    xla_gap(torch, fields, wide, camera, pose_list[0], xcfg,
            {"xla": st, "segmented": seg_step}, exact)
    if max(x["vs_segmented_tol_ratio"] for x in lines) > 1.0:
        raise RuntimeError("xla renders off the segmented ones beyond the bar")
    if any(launches.values()) or any(st["launches"].values()) or any(
            exact["launches"].values()):
        raise RuntimeError(f"the XLA backend launched kernels: {launches}, {st['launches']}")
    if max(max(r.values()) for r in vs_float64.values()) > 1.0:
        raise RuntimeError(f"float32 steps off the float64 step: {vs_float64}")
    if max(grad_ratio.values()) > 1.0:
        raise RuntimeError(f"xla compositor gradients off the segmented ones: {grad_ratio}")
    if st["truncated"] or exact["truncated"] or loss_rel > LOSS_RTOL:
        raise RuntimeError(f"xla step: truncated {st['truncated']}, loss {loss_rel:.3g} "
                           f"relative from the segmented step")


def _script_main(torch, mod, argv=()):
    """The port's copy of a benchmark script, run through its `main` with
    the launch counters set to 0 just before and read just after → (its
    result, what it printed, launches)."""
    import contextlib
    import io

    reset_launches()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = mod.main(list(argv))
    torch.cuda.synchronize()
    return result, buf.getvalue().splitlines(), read_launches()


def reduce_phase(torch):
    """Kernel #6: the script's run, then the kernel against the float64
    sum at the script's sizes (its atomics sum in no fixed order), its
    plain version (one index_add_, also the library call), times, bound."""
    from omnigs_torch.scripts import reduce_bench as rb

    result, printed, launches = _script_main(torch, rb)
    dev = torch.device("cuda")
    p = result["p"]
    ids, rows, live = rb.make_inputs(result["r"], p, dev)
    with torch.inference_mode():
        got = rb.reduce_accum(ids[:live], rows, p)
        plain, plain_ms = _plain_ms(torch, lambda: rb.reduce_accum_plain(ids[:live], rows, p))
        exact = torch.zeros(rb.NROWS, p, dtype=torch.float64, device=dev)
        exact.index_add_(1, ids[:live].to(torch.int64), rows[:, :live].to(torch.float64))
        exact = exact.to(torch.float32)
        ratio = _reduce_close(torch, got.T, exact.T)
        plain_ratio = _reduce_close(torch, plain.T, exact.T)
        max_abs = float((got - plain).abs().max())
        kernel_ms = time_ms(torch, lambda: rb.reduce_accum(ids[:live], rows, p), reps=10)
        ids64, cols = ids[:live].to(torch.int64), rows[:, :live].contiguous()
        table = torch.zeros(rb.NROWS, p, device=dev)
        library_ms = time_ms(torch, lambda: table.index_add_(1, ids64, cols), reps=10)
    nbytes = live * (rb.NROWS * 4 + 4) + rb.NROWS * 4 * p
    bound_ms, bound_by = _bound(rb.NROWS * live, nbytes)
    res = {"phase": "reduce", "name": "reduce_accum", "script": result, "printed": printed,
           "launches": launches, "live": live, "p": p, "ops": rb.NROWS * live,
           "bytes": nbytes, "vs_float64_tol_ratio": ratio,
           "plain_vs_float64_tol_ratio": plain_ratio, "max_abs_err": max_abs,
           "kernel_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bound_ms, "bound_by": bound_by}
    emit(res)
    if launches["reduce_accum"] < 1 or ratio > 1.0 or not bool(torch.isfinite(got).all()):
        raise RuntimeError(f"reduce_accum: launches {launches['reduce_accum']}, "
                           f"{ratio:.3g} of the reduction bar")
    return res


def _zipf_ids(torch, n, p, dev):
    """n ids in [0, P) drawn with probability ∝ 1/rank^ZIPF_S over a seeded
    random ranking of the P ids: a few ids take a large share, so a warp's
    ids repeat (the contended case of an atomic reduction)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    w = torch.arange(1, p + 1, device=dev, dtype=torch.float64).pow(-ZIPF_S)
    rank = torch.multinomial(w.float(), n, replacement=True, generator=gen)
    return torch.randperm(p, generator=gen, device=dev)[rank].to(torch.int32)


def _id_spread(torch, ids, p):
    """The largest count of one id, and the mean number of distinct ids in
    a warp's 32 consecutive instances."""
    top = int(torch.bincount(ids.to(torch.int64), minlength=p).max())
    n = ids.shape[0] // 32 * 32
    w = torch.sort(ids[:n].view(-1, 32), dim=1).values
    distinct = float((1 + (w[:, 1:] != w[:, :-1]).sum(dim=1)).float().mean())
    return {"max_per_id": top, "distinct_per_warp": distinct}


def reduce_compare_phase(torch, training_inputs):
    """Kernel #6 in every build (`kernel_variants.compare_reduce`: the
    earlier sources in ``SEG_BEFORE`` when that copy exists, the present
    ones and `REDUCE_ABLATIONS`) on three inputs: the script's (uniform
    ids), the same rows with Zipf-like ids, and the live lanes of pose 0's
    tile-major slab from `tile_grad` (its ids and its backward rows); each
    build's output against the float64 sum at the reduction bar, ms in
    turns, and the deterministic `_scatter_reduce` of the same rows (nine
    of them) for the record; and the wrapper's time with no instance (its
    tables' allocation and zero fill, and the transpose)."""
    from omnigs_torch.ops import composite_tile as ct
    from omnigs_torch.scripts import reduce_bench as rb
    from omnigs_torch.utils import kernel_variants as kv

    dev = torch.device("cuda")
    ids, rows, live = rb.make_inputs(8704 * rb.CHUNK, P, dev)
    inputs = {
        "uniform": (ids[:live].contiguous(), rows),
        "zipf": (_zipf_ids(torch, live, P, dev), rows),
        "tile_slab": training_inputs,
    }
    before = SEG_BEFORE if SEG_BEFORE.is_dir() else None
    with torch.inference_mode():
        # no instance: the wrapper's two tables and the transpose alone
        empty_ms = time_ms(torch, lambda: rb.reduce_accum(ids[:0], rows, P), reps=10)
    line = {"phase": "reduce_compare",
            "before": None if before is None else str(SEG_BEFORE.relative_to(REPO)),
            "zipf_exponent": ZIPF_S, "tables_and_transpose_ms": empty_ms}
    bad = []
    for name, (ids_i, rows_i) in inputs.items():
        with torch.inference_mode():
            n = ids_i.shape[0]
            exact = torch.zeros(rb.NROWS, P, dtype=torch.float64, device=dev)
            exact.index_add_(1, ids_i.to(torch.int64), rows_i[:, :n].to(torch.float64))
            exact = exact.to(torch.float32)
            live_t = torch.tensor(n, device=dev)
            scatter_ms = time_ms(
                torch, lambda: ct._scatter_reduce(rows_i, ids_i, live_t, P), reps=3)
        res = kv.compare_reduce(before, ids_i, rows_i, P,
                                lambda out: _reduce_close(torch, out.T, exact.T))
        nbytes = n * (rb.NROWS * 4 + 4) + rb.NROWS * 4 * P
        bound_ms, bound_by = _bound(rb.NROWS * n, nbytes)
        line[name] = {"instances": n, **_id_spread(torch, ids_i, P),
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "scatter_reduce_ms": scatter_ms, **res}
        bad += [f"{name}/{v}" for v, r in res.items()
                if v != "order" and r["tol_ratio"] > 1.0]
        del exact
    emit(line)
    if bad:
        raise RuntimeError(f"reduce_accum builds off the float64 sum: {bad}")
    return line


def card_test_phase(torch):
    """The card tests (`tests/test_torch_kernels_gpu.py -m gpu`) in a child
    process with its own CUDA context; raise unless every test passed and
    none skipped."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "tests/test_torch_kernels_gpu.py", "-m", "gpu",
         "--noconftest", "-q", "-p", "no:cacheprovider", "-rs"],
        cwd=REPO, capture_output=True, text=True, timeout=CARD_TEST_TIMEOUT_S,
    )
    lines = proc.stdout.strip().splitlines()
    summary = lines[-1] if lines else ""
    counts = {k: int(v) for v, k in re.findall(r"(\d+) (passed|failed|skipped|error)", summary)}
    emit({"phase": "card_tests", "rc": proc.returncode, "summary": summary,
          "seconds": time.perf_counter() - t0, **counts})
    if proc.returncode != 0 or counts.get("skipped") or not counts.get("passed"):
        print(proc.stdout[-6000:], proc.stderr[-3000:], file=sys.stderr)
        raise RuntimeError(f"card tests: {summary} (rc {proc.returncode})")
    return counts


def emit_phase(torch):
    """Kernel #7: the script's run, then the kernel against its plain
    version bit for bit at the script's size; times, bound, and the
    library call `index_copy_`."""
    from omnigs_torch.scripts import bucket_emit_bench as be

    result, printed, launches = _script_main(torch, be)
    slots, data, _ = (torch.from_numpy(a).cuda() for a in be.make_inputs(result["rows"]))
    r = data.shape[0]
    with torch.inference_mode():
        got = be.bucket_emit(slots, data)
        plain, plain_ms = _plain_ms(torch, lambda: be.bucket_emit_plain(slots, data))
        bitwise = bool(torch.equal(got, plain))
        max_abs = float((got - plain).abs().max())
        kernel_ms = time_ms(torch, lambda: be.bucket_emit(slots, data), reps=20)
        idx, out = be.emit_index(slots), torch.empty_like(data)
        library_ms = time_ms(torch, lambda: out.index_copy_(0, idx, data), reps=20)
    nbytes = r * (be.NROWS * 4 * 2 + 4)
    bound_ms, bound_by = _bound(0, nbytes)
    res = {"phase": "emit", "name": "bucket_emit", "script": result, "printed": printed,
           "launches": launches, "rows": r, "bytes": nbytes, "bitwise": bitwise,
           "max_abs_err": max_abs, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by}
    emit(res)
    if launches["bucket_emit"] < 1 or not bitwise:
        raise RuntimeError(f"bucket_emit: launches {launches['bucket_emit']}, "
                           f"bitwise {bitwise}")
    return res


def ablate_phase(torch):
    """Kernel #8: the script's run (six modes, and full's color against
    kernel #3's), then each mode against its plain version on the script's
    slab, bit for bit (and max |Δ| ≤ 1e-4, p99.9 ≤ 1e-5, both of max(1,
    max|plain|)), a digest of its output, times, the pairs the function
    needs (α per pair below the count in a visited chunk, the mode's tail
    per live pair) and its bound beside the all-lanes count, and the warp-lane
    pairs the kernel's warps (`FWD_STRIP` rows) walk, of those the ones
    with a live pixel and the ones their strip masks drop."""
    from omnigs_torch.ops import composite_seg as cs
    from omnigs_torch.scripts import kernel_ablate as ka

    result, printed, launches = _script_main(torch, ka)
    s = ka.build_slab(torch.device("cuda"))
    slab = (s["inst_T"], s["starts"], s["counts"], s["x0"], s["y0"])
    t = s["num_tiles"]
    counts64 = s["counts"].to(torch.int64)
    modes = {}
    for mode in ka.MODES:
        with torch.inference_mode():
            got = ka.kernel_ablate(mode, *slab)
            (plain, visited, live, walked), plain_ms = _plain_ms(
                torch, lambda m=mode: ka.kernel_ablate_plain(m, *slab))
            scale = max(1.0, float(plain.abs().max()))
            diff = ((got - plain).abs() / scale).flatten()
            pairs = {}
            if mode != "dma":  # the warps' live pixels: once more, untimed
                gate = torch.zeros(s["inst_T"].shape[1], dtype=torch.int32, device=got.device)
                ka.kernel_ablate_plain(mode, *slab, warp_gate=gate)
                pairs = warp_pairs(torch, s["inst_T"], s["starts"], s["counts"], s["x0"],
                                   s["y0"], walked, gate, cs.FWD_STRIP)
                del gate
            kernel_ms = time_ms(torch, lambda m=mode: ka.kernel_ablate(m, *slab), reps=10)
        chunks = int(visited.sum())
        lanes = int(torch.minimum(counts64, visited * ka.CHUNK).sum())
        live_pairs = int(live.sum())
        rows = 3 if mode == "dma" else ka.NSTAGE
        out_bytes = 4 * 4 * t + 3 * 4 * 256 * t
        if mode == "dma":
            # its lane sums and plane adds, not per pair; all 128 lanes
            ops = ops_all_lanes = chunks * 3 * (ka.CHUNK + 256)
            nbytes = nbytes_all_lanes = rows * 4 * ka.CHUNK * chunks + out_bytes
        else:
            ops = lanes * 256 * ABLATE_ALPHA_OPS + live_pairs * ABLATE_TAIL_OPS[mode]
            ops_all_lanes = (chunks * ka.CHUNK * 256
                             * (ABLATE_ALPHA_OPS + ABLATE_TAIL_OPS[mode]))
            nbytes = rows * 4 * lanes + out_bytes
            nbytes_all_lanes = rows * 4 * ka.CHUNK * chunks + out_bytes
        bound_ms, bound_by = _bound(ops, nbytes)
        modes[mode] = {
            "max_abs_err": float(diff.max()) * scale,
            "max_rel_err": float(diff.max()),
            "p999_rel_err": float(torch.sort(diff).values[int(0.999 * (diff.numel() - 1))]),
            "bitwise": bool(torch.equal(got, plain)),
            "finite": bool(torch.isfinite(got).all()),
            "digest": _digest(got),
            "visited_chunks": chunks, "lanes_below_count": lanes,
            "pairs": lanes * 256, "live_pairs": live_pairs, **pairs,
            "ops": ops, "bytes": nbytes, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "ops_all_lanes": ops_all_lanes,
            "bound_ms_all_lanes": _bound(ops_all_lanes, nbytes_all_lanes)[0],
        }
        del plain, walked
    res = {"phase": "ablate", "name": "kernel_ablate", "script": result,
           "printed": printed, "launches": launches, "tiles": t,
           "instances": int(counts64.sum()), "modes": modes}
    emit(res)
    bad = {m: v for m, v in modes.items() if not v["finite"] or not v["bitwise"]
           or v["max_rel_err"] > MAX_ERR_BAR or v["p999_rel_err"] > P999_ERR_BAR}
    if launches["kernel_ablate"] < len(ka.MODES) or bad:
        raise RuntimeError(f"kernel_ablate: launches {launches['kernel_ablate']}, "
                           f"modes off their plain versions {sorted(bad)}")
    return res, slab


def ablate_compare_phase(torch, ares, slab):
    """Kernel #8 in every build (`kernel_variants.compare_ablate`: the
    earlier sources in ``SEG_BEFORE`` when that copy exists, the present
    ones, the walk's `no_cull` and `fwd_rows_1` and `ABLATE_ABLATIONS`) in
    each mode on the script's slab: every build's output bytes (and
    digest) equal to the production build's, ms in turns, ptxas per
    build, the mode's bound."""
    from omnigs_torch.utils import kernel_variants as kv

    before = SEG_BEFORE if SEG_BEFORE.is_dir() else None
    res = kv.compare_ablate(before, *slab)
    line = {"phase": "ablate_compare",
            "before": None if before is None else str(SEG_BEFORE.relative_to(REPO))}
    for mode, r in res.items():
        m = ares["modes"][mode]
        line[mode] = {"bound_ms": m["bound_ms"], "digest_new": m["digest"], **r}
    emit(line)
    bad = [f"{mode}/{v}" for mode, r in res.items() for v, b in r.items()
           if v != "order" and not (b["bytes_equal_new"]
                                    and b["digest"] == ares["modes"][mode]["digest"])]
    if bad:
        raise RuntimeError(f"kernel_ablate builds whose bytes differ from production: {bad}")
    return line


# the CLI phases: the pinned scene of the quality gate (seed 1234, 512×256,
# 12 train / 4 test views) and the sha256 of its points.ply and of its
# sfm_data_{train,test}.json with root_path removed (json.dumps(indent=1)),
# as the JAX script (scripts/make_synthetic_scene.py through
# scripts/cpu_run.py, on a CPU host) writes them
PINNED_SEED = 1234
PINNED_SHA256 = {
    "points.ply": "d37166be804144f7d32bbac26d585b1cf7d4ecbf4c3381279af48ca1fac99285",
    "sfm_data_train.json": "d1cd4627b79a2d4e40a64273dcff9b520509002815953aafc233b7e1981126d3",
    "sfm_data_test.json": "9cf341c2f1b9017fe59d190c61acc535bb5fc94c60b277280db69e39f6fe8869",
}
# the gate: GATE_PSNR of scripts/quality_check.sh (the JAX package's bar,
# measured on a TPU) − 0.5 dB, on the median of seeds 1 and 2 at 1,500
# iterations of cfg/lonlat/synthetic_medium.yaml
GATE_BAR = 17.07 - 0.5
GATE_ITERS = 1500
GATE_SEEDS = (1, 2)
GATE_CONFIG = REPO / "cfg" / "lonlat" / "synthetic_medium.yaml"
# cli_full: a 1920×960 scene trained 200 iterations with synthetic_fullres.yaml
# (windows, the densify at 200, the shutdown record), then the checkpoint
# round trip at 100 → 124
FULL_CONFIG = REPO / "cfg" / "lonlat" / "synthetic_fullres.yaml"
FULL_SCENE_ARGS = ("--width", "1920", "--height", "960", "--gaussians", "65536",
                   "--train-views", "6", "--test-views", "2", "--seed", "7")
FULL_ITERS = 200
CKPT_AT, CKPT_TO = 100, 124
CLI_DIR = REPO / "build" / "chip_smoke_cli"


def optional_imports():
    """Whether PIL and cv2 import and whether the native image loader
    (native/libomnigs_loader.so) loads. The CLI path's PNGs go through PIL;
    cv2 and the loader are information only (the loader's library is not
    committed, so only non-PNG datasets would need it)."""
    import ctypes
    import importlib

    out = {}
    for mod in ("PIL", "cv2"):
        try:
            importlib.import_module(mod)
            out[mod] = True
        except ImportError:
            out[mod] = False
    try:
        ctypes.CDLL(str(REPO / "native" / "libomnigs_loader.so"))
        out["native_loader"] = True
    except OSError:
        out["native_loader"] = False
    return out


def _sha256_scene(scene_dir):
    import hashlib

    out = {"points.ply": hashlib.sha256((scene_dir / "points.ply").read_bytes()).hexdigest()}
    for name in ("sfm_data_train.json", "sfm_data_test.json"):
        root = json.loads((scene_dir / name).read_text())
        root.pop("root_path")
        out[name] = hashlib.sha256(json.dumps(root, indent=1).encode()).hexdigest()
    return out


def scene_synth_phase(torch):
    """The pinned scene through the port's script on the card (its renders
    take the tile-major forward kernel); its files' hashes must be the JAX
    script's."""
    import shutil

    from omnigs_torch.scripts import make_synthetic_scene

    scene = CLI_DIR / "scene_pinned"
    shutil.rmtree(scene, ignore_errors=True)
    t0 = time.perf_counter()
    _, _, launches = _script_main(
        torch, make_synthetic_scene, [str(scene), "--seed", str(PINNED_SEED), "--device", "cuda"])
    seconds = time.perf_counter() - t0
    sha = _sha256_scene(scene)
    line = {"phase": "scene_synth", "seconds": seconds, "sha256": sha,
            "matches_jax": sha == PINNED_SHA256, "launches": launches}
    emit(line)
    if sha != PINNED_SHA256:
        raise RuntimeError(f"the pinned scene differs from the JAX script's: {sha}")
    if not launches["composite_tile_fwd"]:
        raise RuntimeError(f"scene synthesis launched {launches}")
    return scene, launches


def _cli_train(torch, argv):
    """The port's training CLI through its `main`, launch counters set to 0
    just before and read just after, the peak memory reset before."""
    from omnigs_torch.examples import train_openmvg_lonlat

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    stats, printed, launches = _script_main(torch, train_openmvg_lonlat,
                                            [*argv, "--device", "cuda"])
    stats["wall_s"] = time.perf_counter() - t0
    stats["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    stats["ms_per_iteration"] = stats["loop_s"] / stats["iterations"] * 1e3
    stats["launches"] = launches
    stats["log"] = [x for x in printed if x.startswith(("iter ", "[autosize]"))]
    return stats


def _cli_test(torch, argv):
    from omnigs_torch.examples import test_openmvg_lonlat

    means, _, launches = _script_main(torch, test_openmvg_lonlat, [*argv, "--device", "cuda"])
    return means, launches


def quality_phase(torch, scene):
    """`omnigs_torch/scripts/quality_check.sh` on the card, step for step
    through the CLIs' `main`s: seeds 1 and 2, 1,500 iterations of
    synthetic_medium.yaml each, the test CLI on each run's last PLY, then
    the port's psnr_gate at GATE_BAR. Raises when the gate fails."""
    import contextlib
    import io

    from omnigs_torch.scripts import psnr_gate

    dirs, seeds, totals = [], [], {}
    for seed in GATE_SEEDS:
        run = CLI_DIR / "quality" / f"run{seed}"
        st = _cli_train(torch, [
            str(GATE_CONFIG), str(run), str(scene / "sfm_data_train.json"),
            str(scene / "points.ply"), "--image-root", str(scene / "images"),
            "--iters", str(GATE_ITERS), "--log-every", "500", "--seed", str(seed)])
        ply = run / str(GATE_ITERS) / "ply" / "point_cloud.ply"
        means, test_launches = _cli_test(torch, [
            str(GATE_CONFIG), str(run / "test"), str(scene / "sfm_data_test.json"), str(ply)])
        line = {"phase": "quality_run", "seed": seed,
                "ms_per_iteration": st["ms_per_iteration"], "loop_s": st["loop_s"],
                "wall_s": st["wall_s"], "windows": st["windows"],
                "window_steps": st["window_steps"], "single_steps": st["single_steps"],
                "ema_loss": st["ema_loss"], "live_gaussians": st["live"],
                "truncated": st["truncated"], "launches_train": st["launches"],
                "launches_test": test_launches, "peak_mem_gib": st["peak_mem_gib"],
                "heldout_psnr": means["psnr"], "heldout_ssim": means["ssim"],
                "render_ms": means["render_time_ms"], "log": st["log"]}
        emit(line)
        seeds.append(line)
        dirs.append(str(run / "test"))
        for launches in (st["launches"], test_launches):
            for k, v in launches.items():
                totals[k] = totals.get(k, 0) + v
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = psnr_gate.main(GATE_BAR, dirs)
    psnrs = [x["heldout_psnr"] for x in seeds]
    summary = {"phase": "quality", "bar": GATE_BAR, "median_psnr": statistics.median(psnrs),
               "psnrs": psnrs, "gate": buf.getvalue().strip(), "passed": rc == 0,
               "launches": totals}
    emit(summary)
    if rc != 0:
        raise RuntimeError(f"quality gate failed: {summary['gate']}")
    bad = [x["seed"] for x in seeds if not (x["launches_train"]["composite_seg_fwd"]
                                          and x["launches_train"]["composite_seg_bwd"]
                                          and x["launches_test"]["composite_seg_fwd"])]
    if bad or any(x["truncated"] or not x["windows"] for x in seeds):
        raise RuntimeError(f"quality runs {bad}: kernels not launched, truncation or no windows")
    return totals


def _trainer_state(torch, tr):
    out = {f"model/{k}": v.detach().clone() for k, v in tr.model.params().items()}
    for k in tr.opt_state.mu:
        out[f"mu/{k}"] = tr.opt_state.mu[k].clone()
        out[f"nu/{k}"] = tr.opt_state.nu[k].clone()
    out["count"] = tr.opt_state.count.clone()
    return out


def cli_full_phase(torch):
    """A 1920×960 scene from the port's script; the training CLI with
    synthetic_fullres.yaml for 200 iterations (windows, the densify at 200,
    the shutdown record) and the test CLI on its PLY; then the checkpoint
    round trip on a full-width Trainer: save at 100, run to 124, load, run
    to 124 again, and every parameter and Adam moment `torch.equal`."""
    import shutil

    from omnigs_torch.config import load_config
    from omnigs_torch.io.openmvg import load_openmvg_scene
    from omnigs_torch.scripts import make_synthetic_scene
    from omnigs_torch.train.trainer import Trainer

    scene = CLI_DIR / "scene_full"
    shutil.rmtree(scene, ignore_errors=True)
    t0 = time.perf_counter()
    _, _, synth_launches = _script_main(torch, make_synthetic_scene,
                                        [str(scene), *FULL_SCENE_ARGS, "--device", "cuda"])
    synth_s = time.perf_counter() - t0
    run = CLI_DIR / "full"
    st = _cli_train(torch, [
        str(FULL_CONFIG), str(run), str(scene / "sfm_data_train.json"),
        str(scene / "points.ply"), "--image-root", str(scene / "images"),
        "--iters", str(FULL_ITERS), "--log-every", "50"])
    means, test_launches = _cli_test(torch, [
        str(FULL_CONFIG), str(run / "test"), str(scene / "sfm_data_test.json"),
        str(run / str(FULL_ITERS) / "ply" / "point_cloud.ply")])

    cfg = load_config(FULL_CONFIG)
    tr = Trainer(load_openmvg_scene(scene / "sfm_data_train.json", scene / "points.ply"),
                 cfg, seed=3, device="cuda")
    tr.init_from_sfm()
    tr.train(CKPT_AT)
    ckpt = run / "ckpt.pt"
    tr.save_checkpoint(ckpt)
    # the sampler's and densify's random states are not part of a checkpoint
    rng, gen = tr.sampler.rng.getstate(), tr.generator.get_state()
    charges = {f: kf.remaining_times_of_use for f, kf in tr.scene.keyframes.items()}
    t0 = time.perf_counter()
    tr.train(CKPT_TO - CKPT_AT)
    torch.cuda.synchronize()
    resume_ms = (time.perf_counter() - t0) / (CKPT_TO - CKPT_AT) * 1e3
    first = _trainer_state(torch, tr)
    tr.load_checkpoint(ckpt)
    loaded_at = tr.iteration
    tr.sampler.rng.setstate(rng)
    tr.generator.set_state(gen)
    for f, kf in tr.scene.keyframes.items():
        kf.remaining_times_of_use = charges[f]
    tr.train(CKPT_TO - CKPT_AT)
    again = _trainer_state(torch, tr)
    unequal = [k for k in first if not torch.equal(first[k], again[k])]
    line = {"phase": "cli_full", "synth_s": synth_s, "synth_launches": synth_launches,
            "ms_per_iteration": st["ms_per_iteration"], "wall_s": st["wall_s"],
            "windows": st["windows"], "window_steps": st["window_steps"],
            "single_steps": st["single_steps"], "ema_loss": st["ema_loss"],
            "live_gaussians": st["live"], "truncated": st["truncated"],
            "launches_train": st["launches"], "launches_test": test_launches,
            "peak_mem_gib": st["peak_mem_gib"], "heldout_psnr": means["psnr"],
            "render_ms": means["render_time_ms"], "log": st["log"],
            "device_peak_usage_mb": (run / "DevicePeakUsageMB.txt").read_text().splitlines(),
            "checkpoint": {"loaded_iteration": loaded_at, "iteration": tr.iteration,
                           "ms_per_iteration": resume_ms, "tensors": len(first),
                           "unequal": unequal}}
    emit(line)
    if unequal or loaded_at != CKPT_AT or tr.iteration != CKPT_TO:
        raise RuntimeError(f"checkpoint round trip: {line['checkpoint']}")
    if not (st["windows"] and st["launches"]["composite_seg_fwd"]
            and st["launches"]["composite_seg_bwd"] and test_launches["composite_seg_fwd"]):
        raise RuntimeError(f"cli_full: windows {st['windows']}, launches {st['launches']}, "
                           f"{test_launches}")
    if st["truncated"] or not math.isfinite(means["psnr"]):
        raise RuntimeError(f"cli_full: truncated {st['truncated']}, psnr {means['psnr']}")
    totals = dict(st["launches"])
    for k, v in test_launches.items():
        totals[k] += v
    return totals, synth_launches


# ---------------------------------------------------------------------------
# The remaining single-device entry points: the pinhole camera, the
# coarse-to-fine pyramid, the viewer, the live viewer, `profiling.trace`
# and the last examples.

PINHOLE_CAM_KW = dict(width=1920, height=1080, fx=1200.0, fy=1200.0, cx=960.0, cy=540.0,
                      distortion=(0.3, 0.05, 0.0, 0.0, 0.0))
PINHOLE_DIR = CLI_DIR / "pinhole_scene"
PYRAMID_ITERS = 200
PYRAMID_KEYS = {"GausPyramid.do": 1, "GausPyramid.num_sub_levels": 2,
                "GausPyramid.sub_level_times_of_use": 8}
VIEWER_W, VIEWER_H = 1920, 960
VIEWER_PSNR_BAR = 30.0
LIVE_ITERS = 210  # across the densify at 200 (from 150, every 100)
LIVE_PARAMS_AT = 100
LIVE_WIDTH = 960
TRACE_DIR = REPO / "build" / "chip_smoke_trace"


@contextlib.contextmanager
def plain_segmented_kernels():
    """`composite_seg`'s two kernel wrappers replaced by their plain
    versions (the same PyTorch code the CPU runs, here on the card's
    tensors) for the block: what a render or a backward gives without the
    kernels. Their launch counters are not touched."""
    from omnigs_torch.ops import composite_seg as cs

    fwd, bwd = cs.composite_seg_fwd, cs.composite_seg_bwd

    def plain_fwd(inst, starts8, counts, live8, num_tiles, gx, tile_lo=0):
        color, final_t, _, _ = cs.composite_seg_fwd_plain(inst, starts8, counts, num_tiles,
                                                          gx, tile_lo)
        return color, final_t

    def plain_bwd(inst, starts8, counts, live8, color_full, dcolor, num_tiles, gx, tile_lo=0):
        return cs.composite_seg_bwd_plain(inst, starts8, counts, color_full, dcolor,
                                          num_tiles, gx, tile_lo)

    cs.composite_seg_fwd, cs.composite_seg_bwd = plain_fwd, plain_bwd
    try:
        yield
    finally:
        cs.composite_seg_fwd, cs.composite_seg_bwd = fwd, bwd


def _rel_err(torch, got, ref):
    scale = float(ref.abs().max()) or 1.0
    return float((got - ref).abs().max()) / scale


def pinhole_phase(torch, np, model, pose_list, cfg):
    """The render model through the distorted 1920×1080 pinhole camera from
    the four request poses (`full_proj` from a `Keyframe`, the production
    segmented config): host ms, truncated, #1's launches, each image
    bitwise the plain versions' render. Then one L1 + SSIM backward with
    the undistort mask through #2, its gradients bitwise the plain path's;
    the time of the maps and mask and of undistorting one frame →
    (renders, the launches of the requests and the backward together)."""
    from omnigs_torch.cameras import (
        Camera,
        CameraType,
        init_undistort_map_and_mask,
        undistort_image,
    )
    from omnigs_torch.ops import loss as loss_ops
    from omnigs_torch.scene.keyframe import Keyframe
    from omnigs_torch.train.renderer import render_model

    cam = Camera(CameraType.PINHOLE, **PINHOLE_CAM_KW)
    bg = torch.zeros(3, device="cuda")
    kfs = [Keyframe(k, cam, vm[:3, :3].cpu().numpy(), vm[:3, 3].cpu().numpy())
           for k, (vm, _) in enumerate(pose_list)]
    fps = [torch.from_numpy(kf.full_proj).to("cuda") for kf in kfs]

    def render(k):
        vm, campos = pose_list[k]
        with torch.inference_mode():
            return render_model(model, cam, vm, campos, bg, SH_DEGREE, cfg, full_proj=fps[k])

    render(0)  # warm-up of the new image shape's caches
    torch.cuda.synchronize()
    reset_launches()
    renders, host_ms = [], []
    for k in range(len(pose_list)):
        t0 = time.perf_counter()
        res = render(k)
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        renders.append(res)
    fwd_launches = read_launches()
    with plain_segmented_kernels():
        plain = [render(k) for k in range(len(pose_list))]
    equal = [bool(torch.equal(r.image, p.image) and torch.equal(r.final_T, p.final_T))
             for r, p in zip(renders, plain)]

    t0 = time.perf_counter()
    m1, m2, mask_np = init_undistort_map_and_mask(cam)
    maps_ms = (time.perf_counter() - t0) * 1e3
    frame = np.ascontiguousarray(renders[1].image.permute(1, 2, 0).cpu().numpy())
    t0 = time.perf_counter()
    undistort_image(frame, m1, m2)
    undistort_ms = (time.perf_counter() - t0) * 1e3
    mask = torch.from_numpy(mask_np).to("cuda")
    gt = plain[1].image.clone()

    def grads():
        vm, campos = pose_list[0]
        params = model.params()
        res = render_model(model, cam, vm, campos, bg, SH_DEGREE, cfg, full_proj=fps[0])
        loss = loss_ops.training_loss(res.image * mask, gt)
        out = torch.autograd.grad(loss, list(params.values()))
        torch.cuda.synchronize()
        return loss.detach(), dict(zip(params, out))

    reset_launches()
    loss, g = grads()
    bwd_launches = read_launches()
    with plain_segmented_kernels():
        ploss, pg = grads()
    line = {
        "phase": "pinhole", "camera": {k: v for k, v in PINHOLE_CAM_KW.items()},
        "host_ms": host_ms, "truncated": [int(r.truncated) for r in renders],
        "launches_requests": fwd_launches, "launches_backward": bwd_launches,
        "bitwise_plain": equal,
        "image_mean": [float(r.image.mean()) for r in renders],
        "covered": [float((r.final_T < 0.5).float().mean()) for r in renders],
        "loss": float(loss), "loss_plain": float(ploss),
        "grads_bitwise_plain": {k: bool(torch.equal(g[k], pg[k])) for k in g},
        "grads_rel_err": {k: _rel_err(torch, g[k], pg[k]) for k in g},
        "grads_finite": {k: bool(torch.isfinite(v).all()) for k, v in g.items()},
        "grads_nonzero": {k: bool(v.abs().max() > 0) for k, v in g.items()},
        "maps_and_mask_ms": maps_ms, "undistort_frame_ms": undistort_ms,
        "mask_corner": float(mask_np[0, 0]),
        "mask_centre": float(mask_np[cam.height // 2, cam.width // 2]),
    }
    emit(line)
    if any(line["truncated"]) or not all(equal):
        raise RuntimeError(f"pinhole requests: truncated {line['truncated']}, bitwise {equal}")
    if not _only(fwd_launches, {"composite_seg_fwd": len(pose_list)}):
        raise RuntimeError(f"pinhole requests launched {fwd_launches}")
    if not _only(bwd_launches, {"composite_seg_fwd": 1, "composite_seg_bwd": 1}):
        raise RuntimeError(f"pinhole backward launched {bwd_launches}")
    if not (all(line["grads_bitwise_plain"].values()) and all(line["grads_finite"].values())
            and all(line["grads_nonzero"].values())):
        raise RuntimeError(f"pinhole gradients: {line}")
    return renders, {k: fwd_launches[k] + bwd_launches[k] for k in fwd_launches}


def pinhole_scene_phase(torch, np, renders, pose_list, model):
    """A four-view pinhole openMVG scene (``pinhole_radial_k3``) written
    from the pinhole renders, loaded with `load_openmvg_scene`: the mask,
    each loaded frame `torch.equal` to `undistort_image` of its PNG, and
    `Trainer.train_iteration` raising the JAX package's ValueError (neither
    package's trainer passes `full_proj`)."""
    import shutil

    from omnigs_torch.cameras import init_undistort_map_and_mask, undistort_image
    from omnigs_torch.config import load_config
    from omnigs_torch.io.native_loader import load_image
    from omnigs_torch.io.openmvg import load_openmvg_scene
    from omnigs_torch.io.ply import save_points_ply
    from omnigs_torch.scripts.make_synthetic_scene import _sfm_json
    from omnigs_torch.train.eval import save_image
    from omnigs_torch.train.trainer import Trainer

    shutil.rmtree(PINHOLE_DIR, ignore_errors=True)
    (PINHOLE_DIR / "images").mkdir(parents=True)
    views = []
    for k, (res, (vm, campos)) in enumerate(zip(renders, pose_list)):
        fname = f"pin_{k}.png"
        save_image(PINHOLE_DIR / "images" / fname, res.image.cpu().numpy())
        views.append((vm[:3, :3].cpu().numpy().astype(np.float64),
                      campos.cpu().numpy().astype(np.float64), fname))
    w, h = PINHOLE_CAM_KW["width"], PINHOLE_CAM_KW["height"]
    root = _sfm_json(views, w, h, PINHOLE_DIR / "images")
    d = PINHOLE_CAM_KW["distortion"]
    intr = root["intrinsics"][0]["value"]
    intr["polymorphic_name"] = "pinhole_radial_k3"
    intr["ptr_wrapper"]["data"] = {
        "value0": {"value0": {"width": w, "height": h},
                   "focal_length": PINHOLE_CAM_KW["fx"],
                   "principal_point": [PINHOLE_CAM_KW["cx"], PINHOLE_CAM_KW["cy"]]},
        "disto_k3": [d[0], d[1], d[4]],
    }
    (PINHOLE_DIR / "sfm_data.json").write_text(json.dumps(root, indent=1))
    idx = torch.arange(0, P, 32)
    save_points_ply(PINHOLE_DIR / "points.ply", model.xyz[idx].detach().cpu().numpy(),
                    np.full((len(idx), 3), 0.5, np.float32))

    t0 = time.perf_counter()
    scene = load_openmvg_scene(PINHOLE_DIR / "sfm_data.json", PINHOLE_DIR / "points.ply")
    load_s = time.perf_counter() - t0
    (cam,) = scene.cameras.values()
    mask = scene.undistort_mask(cam)
    m1, m2, _ = init_undistort_map_and_mask(cam)
    equal = []
    for kf in scene.keyframes.values():
        raw = load_image(PINHOLE_DIR / "images" / kf.img_filename, w, h)
        equal.append(bool(torch.equal(torch.from_numpy(kf.image),
                                      torch.from_numpy(undistort_image(raw, m1, m2)))))
    tr = Trainer(scene, load_config(FULL_CONFIG), seed=3, device="cuda")
    tr.init_from_sfm()
    try:
        tr.train_iteration()
        raised = None
    except ValueError as e:  # the JAX package's behaviour, checked below
        raised = str(e)
    line = {"phase": "pinhole_scene", "camera": [cam.camera_type.name, cam.width, cam.height,
                                                 cam.fx, cam.cx, cam.cy, list(cam.distortion)],
            "keyframes": len(scene.keyframes), "load_s": load_s,
            "mask_shape": list(mask.shape), "mask_corner": float(mask[0, 0]),
            "mask_mean": float(mask.mean()), "frames_equal_undistort": equal,
            "trainer_raised": raised}
    emit(line)
    if cam.distortion != PINHOLE_CAM_KW["distortion"] or not all(equal) or len(equal) != 4:
        raise RuntimeError(f"pinhole scene: {line}")
    if raised != "pinhole camera requires full_proj":
        raise RuntimeError(f"Trainer.train_iteration on a pinhole scene: {raised!r}")


def _yaml_with(path, keys):
    """FULL_CONFIG with ``keys`` (``Section.key: value``) replaced or
    appended, written to ``path``."""
    keys, lines = dict(keys), []
    for line in FULL_CONFIG.read_text().splitlines():
        key = line.split(":", 1)[0].strip()
        if key in keys:
            line = f"{key}: {keys.pop(key)}"
        lines.append(line)
    lines += [f"{k}: {v}" for k, v in keys.items()]
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("\n".join(lines) + "\n")
    return path


def pyramid_phase(torch):
    """cli_full's 1920×960 scene through the training CLI with the pyramid
    on (two sub-levels, 8 uses each per keyframe): 200 iterations, each
    timed with a synchronise and filed under its level by the image width;
    `train_window` must return 0 throughout."""
    from omnigs_torch.train.trainer import Trainer

    scene = CLI_DIR / "scene_full"
    yaml = _yaml_with(CLI_DIR / "pyramid.yaml", PYRAMID_KEYS)
    by_width, windows = {}, []
    orig_it, orig_win = Trainer.train_iteration, Trainer.train_window

    def timed_iteration(self):
        t0 = time.perf_counter()
        aux = orig_it(self)
        torch.cuda.synchronize()
        by_width.setdefault(int(aux["image"].shape[-1]), []).append(
            (time.perf_counter() - t0) * 1e3)
        return aux

    def recorded_window(self, k):
        took = orig_win(self, k)
        windows.append(took)
        return took

    Trainer.train_iteration, Trainer.train_window = timed_iteration, recorded_window
    try:
        st = _cli_train(torch, [
            str(yaml), str(CLI_DIR / "pyramid"), str(scene / "sfm_data_train.json"),
            str(scene / "points.ply"), "--image-root", str(scene / "images"),
            "--iters", str(PYRAMID_ITERS), "--log-every", "50"])
    finally:
        Trainer.train_iteration, Trainer.train_window = orig_it, orig_win
    levels = {w: {"iterations": len(v), "ms_mean": statistics.mean(v),
                  "ms_median": statistics.median(v), "ms_max": max(v)}
              for w, v in sorted(by_width.items())}
    line = {"phase": "pyramid", "config": PYRAMID_KEYS, "levels_by_width": levels,
            "ms_per_iteration": st["ms_per_iteration"], "windows": st["windows"],
            "single_steps": st["single_steps"], "train_window_nonzero": sum(map(bool, windows)),
            "train_window_calls": len(windows), "ema_loss": st["ema_loss"],
            "live_gaussians": st["live"], "truncated": st["truncated"],
            "launches": st["launches"], "peak_mem_gib": st["peak_mem_gib"], "log": st["log"]}
    emit(line)
    w = int(FULL_SCENE_ARGS[FULL_SCENE_ARGS.index("--width") + 1])
    if sorted(by_width) != [w // 4, w // 2, w] or st["windows"]:
        raise RuntimeError(f"pyramid levels {sorted(by_width)}, windows {st['windows']}")
    if any(windows) or st["truncated"] or not math.isfinite(st["ema_loss"]):
        raise RuntimeError(f"pyramid: {line}")
    if not (st["launches"]["composite_seg_fwd"] and st["launches"]["composite_seg_bwd"]):
        raise RuntimeError(f"pyramid launched {st['launches']}")
    return st["launches"]


def _post(port, path, obj, timeout=300):
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(obj).encode(), method="POST")
    return urllib.request.urlopen(req, timeout=timeout).read()


def viewer_phase(torch, np, model):
    """`omnigs_torch.examples.view_result` serving the render model's PLY
    on 127.0.0.1 at 1920×960 from a thread: eight POST /render (color and
    depth, scale 1.0 and 0.5, two poses), each a JPEG through kernel #3;
    then each request's render and encode timed apart, and the first color
    frame against `render_model` (JPEG error only: PSNR ≥ 30 dB)."""
    import io
    import threading

    from PIL import Image

    from omnigs_torch.cameras import Camera, CameraType
    from omnigs_torch.examples import view_result
    from omnigs_torch.io.ply import load_gaussian_ply, save_gaussian_ply
    from omnigs_torch.train.renderer import render_model
    from omnigs_torch.viewer import server

    ply = CLI_DIR / "render_model.ply"
    ply.parent.mkdir(parents=True, exist_ok=True)
    save_gaussian_ply(ply, model)
    httpd = view_result.build_server([str(ply), "--width", str(VIEWER_W), "--height",
                                      str(VIEWER_H), "--port", "0", "--host", "127.0.0.1",
                                      "--device", "cuda"])
    port = httpd.server_address[1]
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    reqs = [{"mode": m, "scale": s, "yaw": y, "pitch": 0.0, "pos": [0, 0, 0]}
            for y in (0.0, 1.3) for m in ("color", "depth") for s in (1.0, 0.5)]
    try:
        _post(port, "/render", reqs[0])  # warm-up of the caches
        reset_launches()
        frames, host_ms = [], []
        for r in reqs:
            t0 = time.perf_counter()
            frames.append(_post(port, "/render", r))
            host_ms.append((time.perf_counter() - t0) * 1e3)
        launches = read_launches()
        state = httpd.viewer_state
        split = []
        for r in reqs:
            t0 = time.perf_counter()
            img = server.render_frame(state, r)
            t1 = time.perf_counter()
            server.encode_jpeg(img)
            split.append({"render_ms": (t1 - t0) * 1e3,
                          "encode_ms": (time.perf_counter() - t1) * 1e3})
    finally:
        httpd.shutdown()
        thread.join()
    got = np.asarray(Image.open(io.BytesIO(frames[0])).convert("RGB"), np.float32) / 255.0
    loaded = load_gaussian_ply(ply, device="cuda")
    vm, campos = server._pose_to_viewmatrix(0.0, 0.0, [0, 0, 0])
    with torch.inference_mode():
        ref = render_model(loaded, Camera(CameraType.LONLAT, VIEWER_W, VIEWER_H),
                           torch.from_numpy(vm).to("cuda"), torch.from_numpy(campos).to("cuda"),
                           torch.zeros(3, device="cuda"), 3, view_result.RASTER_CONFIG)
    ref = ref.image.clamp(0, 1).permute(1, 2, 0).cpu().numpy()
    mse = float(np.mean((got - ref) ** 2))
    psnr = 10 * math.log10(1.0 / max(mse, 1e-12))
    line = {"phase": "viewer", "size": [VIEWER_W, VIEWER_H], "requests": len(reqs),
            "jpeg": [f[:2] == b"\xff\xd8" for f in frames],
            "jpeg_bytes": [len(f) for f in frames], "host_ms": host_ms, "split": split,
            "launches": launches, "psnr_vs_render_model": psnr, "psnr_bar": VIEWER_PSNR_BAR,
            "config": {"segmented": view_result.RASTER_CONFIG.segmented,
                       "want_ncontrib": view_result.RASTER_CONFIG.want_ncontrib}}
    emit(line)
    if not all(line["jpeg"]) or psnr < VIEWER_PSNR_BAR:
        raise RuntimeError(f"viewer: jpeg {line['jpeg']}, psnr {psnr}")
    if not _only(launches, {"composite_tile_fwd": len(reqs)}):
        raise RuntimeError(f"viewer requests launched {launches}")
    return launches["composite_tile_fwd"]


def _live_run(torch, attach):
    """A Trainer on cli_full's scene, LIVE_ITERS single iterations with
    lambda_dssim set to 0.3 before iteration LIVE_PARAMS_AT + 1: through
    the live viewer's POST /params while a client thread requests frames
    (``attach``), or directly."""
    import threading

    from omnigs_torch.config import load_config
    from omnigs_torch.io.openmvg import load_openmvg_scene
    from omnigs_torch.train.trainer import Trainer
    from omnigs_torch.viewer.live import start_live_viewer

    scene_dir = CLI_DIR / "scene_full"
    scene = load_openmvg_scene(scene_dir / "sfm_data_train.json", scene_dir / "points.ply",
                               image_root=scene_dir / "images")
    cfg = load_config(FULL_CONFIG)
    tr = Trainer(scene, cfg, seed=3, device="cuda")
    tr.init_from_sfm()
    frame_ms, stop, httpd, client = [], threading.Event(), None, None
    reset_launches()
    if attach:
        httpd = start_live_viewer(tr, scene, cfg, 0, width=LIVE_WIDTH, host="127.0.0.1")
        port = httpd.server_address[1]

        def frames():
            k = 0
            while not stop.is_set():
                t0 = time.perf_counter()
                jpg = _post(port, "/render", {"mode": ("color", "depth")[k % 2],
                                              "yaw": 0.05 * k})
                frame_ms.append(((time.perf_counter() - t0) * 1e3, jpg[:2] == b"\xff\xd8"))
                k += 1

        client = threading.Thread(target=frames)
        client.start()
    t0 = time.perf_counter()
    try:
        for _ in range(LIVE_ITERS):
            if tr.iteration == LIVE_PARAMS_AT:
                if attach:
                    _post(port, "/params", {"lambda_dssim": 0.3})
                else:
                    tr.set_variable_parameters({"lambda_dssim": 0.3})
            tr.train_iteration()
        torch.cuda.synchronize()
    finally:
        stop.set()
        if attach:
            client.join()
            httpd.shutdown()
    return tr, (time.perf_counter() - t0) / LIVE_ITERS * 1e3, frame_ms, read_launches()


def live_viewer_phase(torch):
    """The live viewer attached to a full-width Trainer for 210 iterations
    (across the densify at 200) while a client requests frames, ``/params``
    reaching the trainer; then the same run without the viewer: every
    parameter and Adam moment `torch.equal`."""
    tr, ms_live, frames, launches = _live_run(torch, True)
    lam = tr.get_variable_parameters()["lambda_dssim"]
    live_state = _trainer_state(torch, tr)
    live_active = int(tr.model.num_active)
    del tr
    ref, ms_ref, _, ref_launches = _live_run(torch, False)
    ref_state = _trainer_state(torch, ref)
    unequal = [k for k in live_state if not torch.equal(live_state[k], ref_state[k])]
    frame_host = [m for m, _ in frames]
    line = {"phase": "live_viewer", "iterations": LIVE_ITERS, "frames": len(frames),
            "frames_jpeg": all(ok for _, ok in frames),
            "frame_ms_mean": statistics.mean(frame_host) if frames else None,
            "frame_ms_median": statistics.median(frame_host) if frames else None,
            "frame_ms_max": max(frame_host) if frames else None,
            "frame_ms_first": frame_host[:3],
            "ms_per_iteration_with_viewer": ms_live, "ms_per_iteration_without": ms_ref,
            "lambda_dssim": lam, "live_gaussians": [live_active, int(ref.model.num_active)],
            "launches_with_viewer": launches, "launches_without": ref_launches,
            "tensors": len(live_state), "unequal": unequal}
    emit(line)
    if unequal or lam != 0.3 or not frames or not line["frames_jpeg"]:
        raise RuntimeError(f"live viewer: {line}")
    if launches["composite_seg_fwd"] != ref_launches["composite_seg_fwd"] + len(frames):
        raise RuntimeError(f"live viewer launches {launches} vs {ref_launches}")
    return ref, launches


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _device_spans(events, lo=float("-inf"), hi=float("inf")):
    """The device ops of a Chrome trace and the union of their spans
    clipped to [lo, hi] µs → (ops, merged spans)."""
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    spans = [(max(float(e["ts"]), lo), min(float(e["ts"]) + float(e["dur"]), hi)) for e in dev]
    return dev, _merge([s for s in spans if s[1] > s[0]])


def trace_phase(torch, tr):
    """One `train_window` of the 1920×960 scene under `profiling.trace`:
    from the Chrome trace, the device busy share of the window's host span
    (which ends in a synchronise), device kernels per step, the five
    longest device ops and the five longest idle gaps. Before it, one
    window untraced (its host ms a step) and one under a profiler that
    records CUDA activity only, which costs the host far less than the
    CPU ops' tracing: its device busy time over its own host span is the
    busy share nearest an untraced window's."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from omnigs_torch.utils.profiling import trace

    k_max = tr.config.tpu.fuse_steps
    tr.train_iteration()  # past the densify at 200: a window can start
    torch.cuda.synchronize()
    reset_launches()
    # the same length of window untraced, for the profiler's overhead
    t0 = time.perf_counter()
    untraced = tr.train_window(k_max)
    torch.cuda.synchronize()
    untraced_ms = (time.perf_counter() - t0) * 1e3 / max(untraced, 1)
    # CUDA activity only: every device op of the trace lies in this window,
    # which starts and ends with a synchronise
    TRACE_DIR.mkdir(parents=True, exist_ok=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cuda_only = tr.train_window(k_max)
        torch.cuda.synchronize()
        cuda_only_us = (time.perf_counter() - t0) * 1e6
    prof.export_chrome_trace(str(TRACE_DIR / "trace_cuda_only.json"))
    _, cuda_busy = _device_spans(
        json.loads((TRACE_DIR / "trace_cuda_only.json").read_text())["traceEvents"])
    cuda_busy_us = sum(b - a for a, b in cuda_busy)
    with trace(TRACE_DIR) as log_dir:
        with record_function("train_window"):
            took = tr.train_window(k_max)
            torch.cuda.synchronize()
    counted = read_launches()
    events = json.loads((Path(log_dir) / "trace.json").read_text())["traceEvents"]
    (win,) = [e for e in events if e.get("name") == "train_window" and e.get("ph") == "X"
              and e.get("cat") == "user_annotation"]
    lo, hi = float(win["ts"]), float(win["ts"]) + float(win["dur"])
    dev, busy = _device_spans(events, lo, hi)
    busy_us = sum(b - a for a, b in busy)
    gaps = [(b[0] - a[1], a[1] - lo) for a, b in zip(busy, busy[1:])]
    if busy:
        gaps += [(busy[0][0] - lo, 0.0), (hi - busy[-1][1], busy[-1][1] - lo)]
    kernels = [e for e in dev if e.get("cat") == "kernel"]
    launches = [e for e in events if e.get("cat") == "cuda_runtime"
                and "LaunchKernel" in str(e.get("name", ""))]
    by_name = {}
    for e in kernels:
        by_name.setdefault(e["name"], [0, 0.0])
        by_name[e["name"]][0] += 1
        by_name[e["name"]][1] += float(e["dur"])
    line = {"phase": "trace", "steps": took, "window_ms": (hi - lo) / 1e3,
            "ms_per_step": (hi - lo) / 1e3 / max(took, 1),
            "untraced_steps": untraced, "untraced_ms_per_step": untraced_ms,
            "device_events": len(dev), "device_busy_ms": busy_us / 1e3,
            "device_busy_ms_per_step": busy_us / 1e3 / max(took, 1),
            "device_busy_share": busy_us / (hi - lo) if hi > lo else None,
            "cuda_only": {"steps": cuda_only,
                          "ms_per_step": cuda_only_us / 1e3 / max(cuda_only, 1),
                          "device_busy_ms_per_step": cuda_busy_us / 1e3 / max(cuda_only, 1),
                          "device_busy_share": cuda_busy_us / cuda_only_us},
            "kernels_per_step": len(kernels) / max(took, 1),
            "launch_calls_per_step": len(launches) / max(took, 1),
            "launches": counted,
            "longest_device_ops": [
                {"name": e["name"][:80], "us": float(e["dur"])}
                for e in sorted(dev, key=lambda e: -float(e["dur"]))[:5]],
            "top_kernels_by_total_us": sorted(
                ({"name": n[:80], "count": c, "us": t} for n, (c, t) in by_name.items()),
                key=lambda x: -x["us"])[:5],
            "longest_idle_gaps": [{"us": g, "at_us": at} for g, at in sorted(gaps)[::-1][:5]],
            "trace_file": str(Path(log_dir) / "trace.json")}
    emit(line)
    steps = untraced + cuda_only + took
    if (min(untraced, cuda_only, took) <= 0 or not cuda_busy
            or not _only(counted, {"composite_seg_fwd": steps, "composite_seg_bwd": steps})):
        raise RuntimeError(f"trace: train_window took {untraced}, {cuda_only}, {took} steps, "
                           f"launched {counted}")
    return counted


def examples_phase(torch, np):
    """`omnigs_torch.examples.simple_cloud` at its default 2000×1000 (kernel
    #3): truncated and the image's sha256; `ImagePool` over the pinned
    scene's PNGs, every image `torch.equal` to `load_image`."""
    import hashlib

    from omnigs_torch.examples import simple_cloud
    from omnigs_torch.io.native_loader import ImagePool, load_image

    out, printed, launches = _script_main(
        torch, simple_cloud, [str(CLI_DIR / "simple_cloud"), "--device", "cuda"])
    pngs = sorted((CLI_DIR / "scene_pinned" / "images").glob("*.png"))
    pool = ImagePool(512, 256, n_threads=4)
    t0 = time.perf_counter()
    got = dict(pool.load_all(pngs))
    pool_s = time.perf_counter() - t0
    pool.close()
    equal = [bool(torch.equal(torch.from_numpy(got[i]),
                              torch.from_numpy(load_image(p, 512, 256))))
             for i, p in enumerate(pngs)]
    line = {"phase": "examples", "simple_cloud": {
                "size": list(out["image"].shape), "truncated": out["truncated"],
                "sha256": hashlib.sha256(np.ascontiguousarray(out["image"]).tobytes()).hexdigest(),
                "image_max": float(out["image"].max()), "launches": launches},
            "image_pool": {"images": len(pngs), "seconds": pool_s, "equal": all(equal)}}
    emit(line)
    if out["truncated"] or not _only(launches, {"composite_tile_fwd": 1}):
        raise RuntimeError(f"simple_cloud: {line['simple_cloud']}")
    if not pngs or not all(equal):
        raise RuntimeError(f"ImagePool: {line['image_pool']}")
    return launches["composite_tile_fwd"]

# ---- the multi-device path and the point ops ----

PAIR_MESHES = ((1, 2), (2, 1))
PAIR_ITERS = 4  # 3001-3004, across the densify at 3004
PAIR_TIMEOUT_S = 900
GRAD_RTOL, GRAD_ATOL = 2e-3, 1e-4  # ROADMAP's gradient bar (atol × max|ref|)
RENDER_BAR = 1e-5
KEYPOINTS = 2000  # a SLAM front end's features per frame
POINT_CAPACITY = 524288
POINT_NEW = 4096  # points appended by increase_pcd


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _bar_ratio(torch, got, ref):
    """max |got − ref| in units of the gradient bar (≤ 1 passes)."""
    bar = GRAD_RTOL * ref.abs() + GRAD_ATOL * float(ref.abs().max())
    return float(((got - ref).abs() / torch.clamp_min(bar, 1e-30)).max())


def parallel_phase(torch, scene, ref):
    """`ParallelTrainer` on a (1, 1) mesh of one NCCL rank, iterations
    3001-3012 of the train phase's run: the Trainer's losses (rtol 1e-5)
    and final parameters (gradient bar), host ms per iteration beside the
    Trainer's, #1/#2 launches."""
    import torch.distributed as dist

    from omnigs_torch.model import densify as densify_ops
    from omnigs_torch.ops import composite_seg as cs
    from omnigs_torch.parallel.distributed import initialize
    from omnigs_torch.train.trainer_parallel import ParallelTrainer

    initialize("nccl", init_method=f"tcp://localhost:{_free_port()}", rank=0, world_size=1)
    densified = []
    densify = densify_ops.densify_and_prune

    def counting_densify(*args, **kwargs):
        densified.append(1)
        return densify(*args, **kwargs)

    densify_ops.densify_and_prune = counting_densify
    try:
        tr = ParallelTrainer(scene, train_config(), seed=SEED, device="cuda")
        tr.init_from_sfm()
        tr.iteration = TRAIN_START
        host_ms, losses = [], []
        reset_launches()
        for _ in range(TRAIN_ITERS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            aux = tr.train_iteration()
            torch.cuda.synchronize()
            host_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(aux["loss"]))
        launches = read_launches()
        tr.drain_losses()
        params = tr.model.params()
        ratios = {k: _bar_ratio(torch, params[k].detach(), ref["model"][k]) for k in params}
        bitwise = {k: bool(torch.equal(params[k].detach(), ref["model"][k])) for k in params}
        active_equal = bool(torch.equal(tr.model.active, ref["model"]["active"]))
        truncated = tr.total_truncated
    finally:
        densify_ops.densify_and_prune = densify
        dist.destroy_process_group()
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"])]
    line = {
        "phase": "parallel", "mesh": [1, 1], "backend": "nccl", "iterations": TRAIN_ITERS,
        "host_ms": host_ms, "trainer_host_ms": ref["host_ms"],
        "mean_host_ms": statistics.mean(host_ms[1:]),
        "trainer_mean_host_ms": statistics.mean(ref["host_ms"][1:]),
        "losses_bitwise": losses == ref["losses"], "max_loss_rel": max(rel),
        "param_bar_ratio": ratios, "params_bitwise": bitwise, "active_equal": active_equal,
        "densify_calls": len(densified), "truncated": truncated,
        "launches": {k: launches[k] for k in ("composite_seg_fwd", "composite_seg_bwd")},
    }
    emit(line)
    if max(rel) > LOSS_RTOL or max(ratios.values()) > 1.0 or not active_equal:
        raise RuntimeError(f"parallel (1, 1) left the Trainer: {line}")
    if len(densified) != 3 or truncated or launches["composite_seg_bwd"] != TRAIN_ITERS:
        raise RuntimeError(f"parallel: densify {len(densified)}, truncated {truncated}, "
                           f"launches {launches}")
    return launches


class _Capture:
    """Swaps a kernel wrapper of ``module`` for a recorder of its arguments:
    the last call's are ``args`` / ``kwargs``. The launch count stays the
    wrapper's own: ``launches`` reads and writes it, so the wrapper's
    ``+= 1`` (which looks its name up in the module) lands on the real
    counter when the kernel launches."""

    def __init__(self, module, attr):
        self.module, self.attr = module, attr
        self.fn = getattr(module, attr)
        self.__name__ = self.fn.__name__
        self.args = self.kwargs = None

    @property
    def launches(self):
        return self.fn.launches

    @launches.setter
    def launches(self, n):
        self.fn.launches = n

    def __call__(self, *args, **kwargs):
        self.args, self.kwargs = args, kwargs
        return self.fn(*args, **kwargs)

    def __enter__(self):
        setattr(self.module, self.attr, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.fn)


def _pair_rank(rank, port, queue):
    """One of the two gloo ranks on cuda:0: for each mesh of PAIR_MESHES,
    the sharded render against the single-device one, rank 1's window of
    kernels #1/#2/#3 against their plain versions, one step's gathered
    gradients against the single-device mean loss's, and PAIR_ITERS
    `ParallelTrainer` iterations."""
    import traceback

    try:
        queue.put((rank, _pair_work(rank, port)))
    except BaseException:
        queue.put((rank, f"rank {rank}:\n{traceback.format_exc()}"))


def _pair_work(rank, port):
    import numpy as np
    import torch
    import torch.distributed as dist

    from omnigs_torch.cameras import Camera, CameraType
    from omnigs_torch.config import raster_config_from
    from omnigs_torch.model import optimizer as opt_ops
    from omnigs_torch.model.gaussians import FIELD_NAMES, GaussianModel
    from omnigs_torch.ops import composite_seg as cs
    from omnigs_torch.ops import composite_tile as ct
    from omnigs_torch.ops import loss as loss_ops
    from omnigs_torch.parallel.distributed import initialize
    from omnigs_torch.parallel.mesh import GAUSS_AXIS, DATA_AXIS, all_gather, axis_index, make_mesh
    from omnigs_torch.parallel.shard import sharded_render, sharded_train_step
    from omnigs_torch.train.renderer import render_model
    from omnigs_torch.train.trainer_parallel import ParallelTrainer

    torch.cuda.set_device(0)
    initialize("gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=2)
    dev = torch.device("cuda", 0)
    # which collectives the path hands gloo, on which device's tensors
    seen = set()
    for name in ("all_gather_into_tensor", "reduce_scatter_tensor", "all_reduce"):
        def recording(*args, _fn=getattr(dist, name), _name=name, **kwargs):
            seen.add(f"{_name}:{args[0].device.type}")
            return _fn(*args, **kwargs)

        setattr(dist, name, recording)
    camera = Camera(CameraType.LONLAT, WIDTH, HEIGHT)
    cfg = raster_config_from(train_config())
    tcfg = raster_config_from(tile_yaml())
    full = synthetic_model(np, dev)
    pose_list = poses(torch, dev)
    bg = torch.zeros(3, device=dev)
    scene = train_scene(torch, np, full, camera, pose_list, cfg)
    # the stepped model: the render model's means moved by N(0, INIT_NOISE)
    rng = np.random.default_rng(SEED + 2)
    moved = full.to_numpy()
    moved["xyz"] = (moved["xyz"] + rng.normal(size=moved["xyz"].shape) * INIT_NOISE).astype(np.float32)
    gts = [torch.as_tensor(kf.image, device=dev).permute(2, 0, 1).contiguous()
           for kf in list(scene.keyframes.values())[:2]]
    out = []
    try:
        for data, gauss in PAIR_MESHES:
            mesh = make_mesh(data, gauss, device_type="cuda")
            g, d = axis_index(mesh, GAUSS_AXIS), axis_index(mesh, DATA_AXIS)
            n = P // gauss

            def shard(arrays):
                return GaussianModel.from_numpy(
                    {k: arrays[k][g * n : (g + 1) * n] for k in FIELD_NAMES}, device=dev)

            res = {"mesh": [data, gauss], "rank": rank, "gauss_index": g, "data_index": d}
            vm, cp = pose_list[0]
            with torch.inference_mode():
                ref_img = render_model(full, camera, vm, cp, bg, SH_DEGREE, cfg).image
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            with _Capture(cs, "composite_seg_fwd") as fwd_cap:
                img = sharded_render(mesh, shard(full.to_numpy()), vm, cp, camera, bg,
                                     SH_DEGREE, cfg)
            torch.cuda.synchronize()
            res["render_host_ms"] = (time.perf_counter() - t0) * 1e3
            with _Capture(ct, "composite_tile_fwd") as tile_cap:
                timg = sharded_render(mesh, shard(full.to_numpy()), vm, cp, camera, bg,
                                      SH_DEGREE, tcfg)
            res["render_launches"] = read_launches()
            res["render_max_abs"] = float((img - ref_img).abs().max())
            res["tile_render_max_abs"] = float((timg - ref_img).abs().max())

            # one step: the gathered gradients (mu = 0.1·g after Adam's first
            # step) against the single-device gradient of the mean loss
            model = shard(moved)
            state = opt_ops.init_adam(model.params())
            mine = [0, 1] if data == 1 else [d]
            vms = torch.stack([pose_list[k][0] for k in mine])
            cps = torch.stack([pose_list[k][1] for k in mine])
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with _Capture(cs, "composite_seg_bwd") as bwd_cap:
                sharded_train_step(
                    mesh, model, state, vms, cps, torch.stack([gts[k] for k in mine]),
                    TRAIN_START + 1, camera=camera, sh_degree=SH_DEGREE, raster_cfg=cfg,
                    lr_cfg=opt_ops.LRConfig(), spatial_lr_scale=1.0, bg=bg,
                )
            torch.cuda.synchronize()
            res["step_host_ms"] = (time.perf_counter() - t0) * 1e3
            res["step_launches"] = read_launches()
            ref_model = GaussianModel.from_numpy(moved, device=dev)
            params = ref_model.params()
            total = 0.0
            for k in (0, 1):
                im = render_model(ref_model, camera, pose_list[k][0], pose_list[k][1], bg,
                                  SH_DEGREE, cfg).image
                total = total + 0.8 * loss_ops.l1_loss(im, gts[k]) + 0.2 * (
                    1.0 - loss_ops.ssim(im, gts[k]))
            grads = torch.autograd.grad(total / 2, list(params.values()), allow_unused=True)
            res["grad_bar_ratio"] = {}
            for (k, p_), gr in zip(params.items(), grads):
                got = all_gather(state.mu[k], mesh, GAUSS_AXIS) / 0.1
                refg = torch.zeros_like(p_) if gr is None else gr
                res["grad_bar_ratio"][k] = _bar_ratio(torch, got, refg)
            del ref_model, params, grads, total

            # rank 1's window: the kernels against their plain versions on
            # the inputs the path gave them
            if g == 1:
                a = fwd_cap.args
                kc, kt = cs.composite_seg_fwd(*a)
                pc, pt, _, _ = cs.composite_seg_fwd_plain(a[0], a[1], a[2], *a[4:])
                b = bwd_cap.args
                kb = cs.composite_seg_bwd(*b)
                pb = cs.composite_seg_bwd_plain(b[0], b[1], b[2], *b[4:])
                ta, tk = tile_cap.args, tile_cap.kwargs
                k3 = ct.composite_tile_fwd(*ta, **tk)
                p3 = ct.composite_tile_fwd_plain(*ta, **tk)[:3]
                res["window"] = {
                    "tile_lo": a[6], "tiles": a[4], "tile_lo_bwd": b[8],
                    "fwd_bitwise": bool(torch.equal(kc, pc) and torch.equal(kt, pt)),
                    "bwd_bitwise": bool(torch.equal(kb, pb)),
                    "tile_fwd_bitwise": all(bool(torch.equal(x, y)) for x, y in zip(k3, p3)),
                    "tile_y0_min": int(ta[4].min()),
                    "fwd_digest": _digest(kc, kt), "bwd_digest": _digest(kb),
                    "tile_digest": _digest(*k3),
                }

            # PAIR_ITERS iterations of the trainer on the train scene
            tcfg_ = train_config()
            tcfg_.tpu.mesh_data, tcfg_.tpu.mesh_gauss = data, gauss
            tr = ParallelTrainer(scene, tcfg_, seed=SEED, device="cuda")
            tr.init_from_sfm()
            tr.iteration = TRAIN_START
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses = [float(tr.train_iteration()["loss"]) for _ in range(PAIR_ITERS)]
            torch.cuda.synchronize()
            res["iter_host_ms"] = (time.perf_counter() - t0) * 1e3 / PAIR_ITERS
            res["train_launches"] = read_launches()
            tr.drain_losses()
            res["losses"] = losses
            res["truncated"] = tr.total_truncated
            res["finite"] = all(math.isfinite(x) for x in losses) and all(
                bool(torch.isfinite(p_).all()) for p_ in tr.model.params().values())
            res["live_gaussians"] = tr.live_gaussians()
            del tr
            res["gloo_collectives"] = sorted(seen)
            out.append(res)
    finally:
        dist.destroy_process_group()
    return out


def parallel_pair_phase(torch):
    """Two processes on cuda:0 joined over gloo (NCCL refuses two ranks on
    one card), meshes (1, 2) and (2, 1): one line per mesh with both ranks'
    results. The port stages no collective through the host; gloo moves
    CUDA tensors through host memory inside its own collectives. Two ranks
    share one card here, so these times are not scaling numbers."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    t0 = time.perf_counter()
    procs = [ctx.Process(target=_pair_rank, args=(r, port, queue)) for r in range(2)]
    for p in procs:
        p.start()
    try:
        got = dict(queue.get(timeout=PAIR_TIMEOUT_S) for _ in procs)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    for r in (0, 1):
        if isinstance(got[r], str):
            raise RuntimeError(f"parallel_pair {got[r]}")
    launches = {k: 0 for k in read_launches()}
    for i, (data, gauss) in enumerate(PAIR_MESHES):
        ranks = [got[0][i], got[1][i]]
        line = {
            "phase": "parallel_pair", "mesh": [data, gauss], "backend": "gloo",
            "ranks_on_one_card": 2, "device": "cuda:0",
            "host_staged": "none in the port (gloo copies CUDA tensors through host "
                           "memory inside its collectives)",
            "gloo_collectives": ranks[0]["gloo_collectives"],
            "seconds": time.perf_counter() - t0, "ranks": ranks,
            "lockstep_bitwise": ranks[0]["losses"] == ranks[1]["losses"],
        }
        emit(line)
        fails = []
        for r in ranks:
            if r["render_max_abs"] > RENDER_BAR or r["tile_render_max_abs"] > RENDER_BAR:
                fails.append(f"rank {r['rank']} render off the single-device one")
            if max(r["grad_bar_ratio"].values()) > 1.0:
                fails.append(f"rank {r['rank']} gradients off the bar: {r['grad_bar_ratio']}")
            if not r["finite"] or r["truncated"]:
                fails.append(f"rank {r['rank']} non-finite or truncated")
            tl = r["train_launches"]
            if tl["composite_seg_bwd"] != PAIR_ITERS or tl["composite_seg_fwd"] < PAIR_ITERS:
                fails.append(f"rank {r['rank']} trainer launches {tl}")
            if r["step_launches"]["composite_seg_bwd"] < 1 or r["render_launches"]["composite_tile_fwd"] < 1:
                fails.append(f"rank {r['rank']} path skipped a kernel")
            w = r.get("window")
            if w is not None and not (w["fwd_bitwise"] and w["bwd_bitwise"] and w["tile_fwd_bitwise"]
                                      and w["tile_lo"] > 0 and w["tile_lo_bwd"] > 0):
                fails.append(f"rank {r['rank']} window kernels: {w}")
            for part in ("render_launches", "step_launches", "train_launches"):
                for k, v in r[part].items():
                    launches[k] += v
        if any(not c.endswith(":cuda") for c in line["gloo_collectives"]):
            fails.append(f"a collective ran on host tensors: {line['gloo_collectives']}")
        if gauss == 2 and not any("window" in r for r in ranks):
            fails.append("no rank checked a window")
        if not line["lockstep_bitwise"]:
            fails.append("ranks logged different losses")
        if fails:
            raise RuntimeError(f"parallel_pair {data}x{gauss}: {fails}")
    return launches


def scaling_phase(torch):
    """`omnigs_torch.scripts.scaling_bench --meshes 1x1 --iters 10` through
    its `main` (one NCCL rank in this process): pixels/s and the shard
    tax, launches counted."""
    from omnigs_torch.scripts import scaling_bench

    reset_launches()
    t0 = time.perf_counter()
    lines = scaling_bench.main(["--meshes", "1x1", "--iters", "10"])
    launches = read_launches()
    one = next(x for x in lines if x["mesh"] == "1x1")
    emit({"phase": "scaling", "seconds": time.perf_counter() - t0, "lines": lines,
          "shard_tax": one["shard_tax"], "launches": launches})
    if launches["composite_seg_bwd"] < 8 or not math.isfinite(one["pixels_per_s"]):
        raise RuntimeError(f"scaling: {lines}, launches {launches}")
    return launches


def point_ops_phase(torch, np):
    """`model/transform` and `ops/stereo` on the card against the same calls
    on the CPU: a capacity-524,288 model with the render model's
    Gaussians, POINT_NEW points appended, a 1920×960 depth map and
    KEYPOINTS keypoints; device ms of each op."""
    from omnigs_torch.cameras import CameraType
    from omnigs_torch.model import optimizer as opt_ops
    from omnigs_torch.model import transform as T
    from omnigs_torch.model.gaussians import FIELD_NAMES, GaussianModel
    from omnigs_torch.ops import stereo

    rng = np.random.default_rng(SEED + 3)
    base = GaussianModel.empty(POINT_CAPACITY, device="cpu").to_numpy()
    src = synthetic_model(np, "cpu").to_numpy()
    for k in FIELD_NAMES:
        base[k][:P] = src[k]
    base["exist_since_iter"][:P] = rng.integers(0, 200, P)
    c, s_ = math.cos(0.3), math.sin(0.3)
    Tm = np.array([[c, -s_, 0, 0.2], [s_, c, 0, -0.1], [0, 0, 1, 0.05], [0, 0, 0, 1]], np.float32)
    new_pts = (rng.normal(size=(POINT_NEW, 3)) * 3).astype(np.float32)
    new_cols = rng.uniform(size=(POINT_NEW, 3)).astype(np.float32)
    new_d2 = rng.uniform(1e-4, 1e-2, POINT_NEW).astype(np.float32)
    depth = rng.uniform(0.5, 8.0, WIDTH * HEIGHT).astype(np.float32)
    dmask = rng.random(WIDTH * HEIGHT) < 0.7
    intr = (600.0, 600.0, WIDTH / 2, HEIGHT / 2)
    # integer pixels, as a detector's keypoints (exact squared distances)
    kp = np.stack([rng.integers(0, WIDTH, KEYPOINTS), rng.integers(0, HEIGHT, KEYPOINTS)],
                  -1).astype(np.float32)
    has3d = rng.random(KEYPOINTS) < 0.5
    kp3 = rng.uniform(-2, 2, (KEYPOINTS, 3)).astype(np.float32)
    kp3[:, 2] = rng.uniform(0.3, 6.0, KEYPOINTS)
    colors = rng.uniform(size=(WIDTH * HEIGHT, 3)).astype(np.float32)

    def run(dev):
        t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        m = GaussianModel.from_numpy(base, device=dev)
        st = opt_ops.init_adam(m.params())
        ops = {
            "apply_scaled_transformation": lambda: T.apply_scaled_transformation(m, st, 1.5, t(Tm)),
            "scaled_transform_visible_points": lambda: T.scaled_transform_visible_points(
                m, st, torch.ones(POINT_CAPACITY, dtype=torch.bool, device=dev), t(Tm),
                torch.eye(4, device=dev), 100, 50, CameraType.LONLAT)[1],
            "increase_pcd": lambda: T.increase_pcd(m, st, t(new_pts), t(new_cols), t(new_d2), 3100),
            "reproject_depth_pinhole": lambda: stereo.reproject_depth_pinhole(
                t(depth), t(dmask), intr, WIDTH),
            "inactive_geo_densify": lambda: stereo.inactive_geo_densify(
                t(kp), t(has3d), t(kp3), t(colors), 400.0, intr, WIDTH),
        }
        outs = {name: fn() for name, fn in ops.items()}
        outs["model"] = m.to_numpy()
        return outs, ops

    cpu, _ = run("cpu")
    gpu, gpu_ops = run("cuda")
    worst, exact = {}, True
    for k in FIELD_NAMES:
        a, b = gpu["model"][k], cpu["model"][k]
        if a.dtype.kind in "bi":
            exact &= bool(np.array_equal(a, b))
        else:
            worst[k] = float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))
    for name in ("reproject_depth_pinhole",):
        worst[name] = float((gpu[name].cpu() - cpu[name]).abs().max() / cpu[name].abs().max())
    gp, gc, gv = (x.cpu() for x in gpu["inactive_geo_densify"])
    cp_, cc, cv = cpu["inactive_geo_densify"]
    exact &= bool(torch.equal(gv, cv)) and bool(torch.equal(gc, cc))
    worst["inactive_geo_densify"] = float((gp - cp_).abs().max() / cp_.abs().max())
    exact &= int(gpu["increase_pcd"]) == int(cpu["increase_pcd"])
    exact &= int(gpu["scaled_transform_visible_points"]) == int(cpu["scaled_transform_visible_points"])
    ms = {name: time_ms(torch, fn, reps=5) for name, fn in gpu_ops.items()}
    line = {"phase": "point_ops", "capacity": POINT_CAPACITY, "gaussians": P,
            "new_points": POINT_NEW, "keypoints": KEYPOINTS, "depth_pixels": WIDTH * HEIGHT,
            "ms": ms, "max_rel_vs_cpu": worst, "masks_counts_equal": exact,
            "dropped": int(gpu["increase_pcd"]),
            "transformed": int(gpu["scaled_transform_visible_points"])}
    emit(line)
    # float32 on two devices: 1e-5 of each array's max
    if not exact or max(worst.values()) > 1e-5:
        raise RuntimeError(f"point_ops: the card left the CPU: {line}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (REPO / "omnigs_torch").is_dir():
        print("chip_smoke: the omnigs_torch package is not beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import numpy as np

    from omnigs_torch import cuda_build
    from omnigs_torch.cameras import Camera, CameraType
    from omnigs_torch.config import load_config, raster_config_from

    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    emit({
        "phase": "device",
        "nvidia_smi": smi,
        "name": name,
        "count": torch.cuda.device_count(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "optional_imports": optional_imports(),
    })

    sources = ["composite_seg_fwd", "composite_seg_bwd", "composite_tile_fwd",
               "composite_tile_bwd", "reduce_accum", "bucket_emit", "kernel_ablate"]
    t0 = time.perf_counter()
    cuda_build.build(sources)  # one nvcc per source, all in parallel
    report = {k: cuda_build.BUILD_REPORT.get(k, "cached") for k in sources}
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "report": report})
    # kernels #1-#4, #5 (which shares #4's source), #6's two kernels and
    # #8's six modes
    for k in ("composite_seg_fwd", "composite_seg_bwd", "composite_tile_fwd",
              "composite_tile_bwd", "reduce_accum", "kernel_ablate"):
        if report[k] != "cached" and not ptxas_clean(report[k]["ptxas"]):
            raise RuntimeError(f"{k}: ptxas reports stack or spills: {report[k]['ptxas']}")
    emit({"phase": "ptxas", **{
        name: ptxas_of(report[src]["ptxas"], name) if report[src] != "cached" else "cached"
        for src, name in (("composite_tile_bwd", "composite_tile_bwd_kernel"),
                          ("composite_tile_bwd", "composite_tile_bwd_fused_kernel"),
                          ("reduce_accum", "reduce_accum_kernel"),
                          ("reduce_accum", "reduce_transpose_kernel"),
                          ("kernel_ablate", "kernel_ablate_kernel"))}})

    cfg = raster_config_from(load_config(CONFIG))
    camera = Camera(CameraType.LONLAT, WIDTH, HEIGHT)
    model = synthetic_model(np, "cuda")
    pose_list = poses(torch, "cuda")

    kres, slab_data = kernel_phase(torch, model, camera, pose_list[0], cfg)
    gres, grad_inputs = grad_phase(torch, kres, slab_data)
    seg_compare_phase(torch, slab_data, kres, gres, grad_inputs)
    del slab_data, grad_inputs
    stage_phase(torch, model, camera, pose_list[0], cfg)
    renders, render_launches = render_phase(torch, model, camera, pose_list, cfg)
    ply_phase(torch, model, camera, pose_list[0], cfg, renders[0].image)
    scene = train_scene(torch, np, model, camera, pose_list, cfg)
    tr, train_launches, seg_loss, train_ref = train_phase(torch, scene, "cuda")
    train_stages(torch, tr)
    del tr
    # the multi-device path: one NCCL rank against the Trainer, two gloo
    # ranks sharing the card, the scaling harness, and the point ops
    par_launches = parallel_phase(torch, scene, train_ref)
    del train_ref
    pair_launches = parallel_pair_phase(torch)
    scaling_launches = scaling_phase(torch)
    point_ops_phase(torch, np)

    # the tile-major path (n_contrib on)
    tcfg = raster_config_from(tile_yaml())
    if tcfg.segmented or not tcfg.want_ncontrib:
        raise RuntimeError(f"Tpu.want_ncontrib: 1 did not select the tile-major path: {tcfg}")
    tk, tdata = tile_kernel_phase(torch, model, camera, pose_list[0], tcfg)
    tg, tile_grad_inputs = tile_grad_phase(torch, tk, tdata)
    tile_compare_phase(torch, tdata, tk, tg, tile_grad_inputs)
    reduce_inputs = tdata["reduce_inputs"]
    del tdata, tile_grad_inputs
    tile_stage_phase(torch, model, camera, pose_list[0], tcfg)
    tile_launches = tile_render_phase(torch, model, camera, pose_list, tcfg, renders)
    ttr, tile_train_launches = tile_train_phase(torch, scene, "cuda", seg_loss)
    tile_train_stages(torch, ttr)
    del ttr
    fused_launches = tile_fused_phase(torch, model, camera, pose_list, tcfg)
    tile_gather_phase(torch, model, camera, pose_list, tcfg)

    # the rest of the rasterizer: the ghost-aligned and the 2-key layouts
    # through the kernels, and the XLA backend
    steps = layout_steps(torch, model, camera, pose_list, cfg)
    ghost_launches, ghost_step = ghost_phase(torch, model, camera, pose_list, cfg, renders, steps)
    fallback_launches = fallback_phase(torch, model, camera, pose_list, renders)
    xla_phase(torch, np, model, camera, pose_list, cfg, renders, steps)
    del renders, steps
    # the benchmark scripts' kernels, each through its script's main
    red = reduce_phase(torch)
    reduce_compare_phase(torch, reduce_inputs)
    del reduce_inputs
    emi = emit_phase(torch)
    abl, ablate_slab = ablate_phase(torch)
    ablate_compare_phase(torch, abl, ablate_slab)
    del ablate_slab
    card_test_phase(torch)

    # the training CLI path: the pinned scene, the quality gate, full width
    scene, synth_launches = scene_synth_phase(torch)
    quality_launches = quality_phase(torch, scene)
    full_launches, full_synth_launches = cli_full_phase(torch)
    cli_launches = {k: quality_launches[k] + full_launches[k] for k in quality_launches}

    # the remaining single-device entry points: the pinhole camera, the
    # pyramid, the viewer and the live viewer, `profiling.trace`, the
    # last examples
    pin_renders, pinhole_launches = pinhole_phase(torch, np, model, pose_list, cfg)
    pinhole_scene_phase(torch, np, pin_renders, pose_list, model)
    del pin_renders
    pyramid_launches = pyramid_phase(torch)
    viewer_launches = viewer_phase(torch, np, model)
    live_tr, live_launches = live_viewer_phase(torch)
    trace_launches = trace_phase(torch, live_tr)
    del live_tr
    cloud_launches = examples_phase(torch, np)
    more_fwd = (pinhole_launches["composite_seg_fwd"] + pyramid_launches["composite_seg_fwd"]
                + live_launches["composite_seg_fwd"] + trace_launches["composite_seg_fwd"])
    more_bwd = (pinhole_launches["composite_seg_bwd"] + pyramid_launches["composite_seg_bwd"] + live_launches["composite_seg_bwd"]
                + trace_launches["composite_seg_bwd"])
    # the multi-device path: the (1, 1) trainer, both gloo ranks' renders,
    # steps and trainer iterations, the scaling harness
    multi = {k: par_launches[k] + pair_launches[k] + scaling_launches[k] for k in par_launches}

    emit({"kernels": [
        {
            "name": "composite_seg_fwd",
            "route": "cuda",
            "source": "omnigs_torch/csrc/composite_seg_fwd.cu",
            "replaces": "omnigs_tpu/ops/pallas_seg.py:237",
            "tpu_kernel": "omnigs_tpu/ops/pallas_seg.py::_fwd_seg_kernel",
            # render path (4 requests) + training path (12 iterations) + the
            # no-presort segmented requests (4) + the CLIs (quality gate and
            # cli_full: training steps and eval renders)
            "launches": render_launches + train_launches["composite_seg_fwd"]
            + fallback_launches["segmented"] + cli_launches["composite_seg_fwd"] + more_fwd
            + multi["composite_seg_fwd"],
            "launches_parallel": par_launches["composite_seg_fwd"],
            "launches_parallel_pair": pair_launches["composite_seg_fwd"],
            "launches_scaling": scaling_launches["composite_seg_fwd"],
            "launches_render": render_launches,
            "launches_train": train_launches["composite_seg_fwd"],
            "launches_fallback": fallback_launches["segmented"],
            "launches_cli": cli_launches["composite_seg_fwd"],
            # pinhole requests + backward, the pyramid CLI run, the live
            # viewer's training and frames, the traced window
            "launches_pinhole": pinhole_launches["composite_seg_fwd"],
            "launches_pyramid": pyramid_launches["composite_seg_fwd"],
            "launches_live_viewer": live_launches["composite_seg_fwd"],
            "launches_trace": trace_launches["composite_seg_fwd"],
            "max_abs_err": kres["max_abs_err"],
            "ms": kres["kernel_ms"],
            "plain_ms": kres["plain_ms"],
            "bound_ms": kres["bound_ms"],
            "bound_by": kres["bound_by"],
            # no single PyTorch call composites depth-sorted splats per tile
            "library_ms": None,
        },
        {
            "name": "composite_seg_bwd",
            "route": "cuda",
            "source": "omnigs_torch/csrc/composite_seg_bwd.cu",
            "replaces": "omnigs_tpu/ops/pallas_seg.py:400",
            "tpu_kernel": "omnigs_tpu/ops/pallas_seg.py::_bwd_seg_kernel",
            "launches": train_launches["composite_seg_bwd"]
            + cli_launches["composite_seg_bwd"] + more_bwd + multi["composite_seg_bwd"],
            "launches_parallel": par_launches["composite_seg_bwd"],
            "launches_parallel_pair": pair_launches["composite_seg_bwd"],
            "launches_scaling": scaling_launches["composite_seg_bwd"],
            "launches_train": train_launches["composite_seg_bwd"],
            "launches_cli": cli_launches["composite_seg_bwd"],
            "launches_pinhole": pinhole_launches["composite_seg_bwd"],
            "launches_pyramid": pyramid_launches["composite_seg_bwd"],
            "launches_live_viewer": live_launches["composite_seg_bwd"],
            "launches_trace": trace_launches["composite_seg_bwd"],
            "max_abs_err": gres["max_abs_err"],
            "max_rel_err": gres["max_rel_err"],
            "ms": gres["kernel_ms"],
            "plain_ms": gres["plain_ms"],
            "bound_ms": gres["bound_ms"],
            "bound_by": gres["bound_by"],
            # no single PyTorch call computes the splat backward per tile
            "library_ms": None,
        },
        {
            "name": "composite_tile_fwd",
            "route": "cuda",
            "source": "omnigs_torch/csrc/composite_tile_fwd.cu",
            "replaces": "omnigs_tpu/ops/pallas_raster.py:192",
            "tpu_kernel": "omnigs_tpu/ops/pallas_raster.py::_fwd_kernel",
            # tile-major render (4 requests), training (6 iterations), the
            # fused training step (1), the ghost-aligned requests and step,
            # the no-presort tile-major requests and the synthetic scenes'
            # renders (the pinned and the 1920×960 one)
            "launches": tile_launches + tile_train_launches["composite_tile_fwd"]
            + fused_launches["composite_tile_fwd"] + ghost_launches
            + fallback_launches["tile"] + synth_launches["composite_tile_fwd"]
            + full_synth_launches["composite_tile_fwd"] + viewer_launches + cloud_launches
            + multi["composite_tile_fwd"],
            # the gloo ranks' tile-major sharded renders
            "launches_parallel_pair": pair_launches["composite_tile_fwd"],
            # view_result's eight requests and simple_cloud's render
            "launches_viewer": viewer_launches,
            "launches_simple_cloud": cloud_launches,
            "launches_scene_synth": synth_launches["composite_tile_fwd"]
            + full_synth_launches["composite_tile_fwd"],
            "launches_render": tile_launches,
            "launches_train": tile_train_launches["composite_tile_fwd"],
            "launches_fused_step": fused_launches["composite_tile_fwd"],
            "launches_ghost": ghost_launches,
            "launches_fallback": fallback_launches["tile"],
            "max_abs_err": tk["max_abs_err"],
            "ms": tk["kernel_ms"],
            "plain_ms": tk["plain_ms"],
            "bound_ms": tk["bound_ms"],
            "bound_by": tk["bound_by"],
            "library_ms": None,
        },
        {
            "name": "composite_tile_bwd",
            "route": "cuda",
            "source": "omnigs_torch/csrc/composite_tile_bwd.cu",
            "replaces": "omnigs_tpu/ops/pallas_raster.py:313",
            "tpu_kernel": "omnigs_tpu/ops/pallas_raster.py::_bwd_kernel",
            # tile-major training (6 iterations) and the ghost-aligned step
            "launches": tile_train_launches["composite_tile_bwd"]
            + ghost_step["launches"]["composite_tile_bwd"],
            "max_abs_err": tg["max_abs_err"],
            "max_rel_err": tg["max_rel_err"],
            "ms": tg["kernel_ms"],
            "plain_ms": tg["plain_ms"],
            "bound_ms": tg["bound_ms"],
            "bound_by": tg["bound_by"],
            "library_ms": None,
        },
        {
            "name": "composite_tile_bwd_fused",
            "route": "cuda",
            "source": "omnigs_torch/csrc/composite_tile_bwd.cu",
            "replaces": "omnigs_tpu/ops/pallas_raster.py:573",
            "tpu_kernel": "omnigs_tpu/ops/pallas_raster.py::_bwd_kernel_fused",
            # the opt-in route (fused_reduce=True, P ≤ 163,840): one step
            "launches": fused_launches["composite_tile_bwd_fused"],
            "max_abs_err": tg["fused"]["max_abs_err"],
            "tol_ratio": tg["fused"]["vs_plain_tol_ratio"],
            "ms": tg["fused"]["kernel_ms"],
            "plain_ms": tg["fused"]["plain_ms"],
            "bound_ms": tg["fused"]["bound_ms"],
            "bound_by": tg["fused"]["bound_by"],
            # index_add_ would do the reduction, but no single call does the
            # splat backward with it
            "library_ms": None,
        },
        {
            "name": "reduce_accum",
            "route": "cuda",
            "source": "omnigs_torch/csrc/reduce_accum.cu",
            "replaces": "scripts/reduce_bench.py:36",
            "tpu_kernel": "scripts/reduce_bench.py::_reduce_kernel",
            # the script's main (python -m omnigs_torch.scripts.reduce_bench)
            "launches": red["launches"]["reduce_accum"],
            "max_abs_err": red["max_abs_err"],
            "tol_ratio": red["vs_float64_tol_ratio"],
            "ms": red["kernel_ms"],
            "plain_ms": red["plain_ms"],
            "bound_ms": red["bound_ms"],
            "bound_by": red["bound_by"],
            "library_ms": red["library_ms"],  # index_add_
        },
        {
            "name": "bucket_emit",
            "route": "cuda",
            "source": "omnigs_torch/csrc/bucket_emit.cu",
            "replaces": "scripts/bucket_emit_bench.py:48",
            "tpu_kernel": "scripts/bucket_emit_bench.py::_emit_kernel",
            "launches": emi["launches"]["bucket_emit"],
            "max_abs_err": emi["max_abs_err"],
            "ms": emi["kernel_ms"],
            "plain_ms": emi["plain_ms"],
            "bound_ms": emi["bound_ms"],
            "bound_by": emi["bound_by"],
            "library_ms": emi["library_ms"],  # index_copy_
        },
        {
            "name": "kernel_ablate",
            "route": "cuda",
            "source": "omnigs_torch/csrc/kernel_ablate.cu",
            "replaces": "scripts/kernel_ablate.py:58",
            "tpu_kernel": "scripts/kernel_ablate.py::make_kernel",
            "launches": abl["launches"]["kernel_ablate"],
            # the six modes: the worst error, the full mode's time and bound
            # (the others per mode in the ablate line)
            "max_abs_err": max(v["max_abs_err"] for v in abl["modes"].values()),
            "ms": abl["modes"]["full"]["kernel_ms"],
            "plain_ms": abl["modes"]["full"]["plain_ms"],
            "bound_ms": abl["modes"]["full"]["bound_ms"],
            "bound_by": abl["modes"]["full"]["bound_by"],
            "ms_by_mode": {m: v["kernel_ms"] for m, v in abl["modes"].items()},
            "bound_ms_by_mode": {m: v["bound_ms"] for m, v in abl["modes"].items()},
            # no single PyTorch call composites splats per tile
            "library_ms": None,
        },
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
