"""Densification (clone/split), pruning, and opacity reset on static capacity.

Counterpart of `omnigs_tpu/model/densify.py`: candidates are written into
free capacity slots chosen by a prefix-sum allocator, split parents are
deactivated, and the Adam moments of the written slots are zeroed. Order:
clone first, then split (both masks from the same pre-densify gradients),
then prune by opacity / screen size / world size; the statistics of every
slot reset afterwards. If free slots run out, the excess candidates are
dropped deterministically (clones before children, ascending slot order)
and counted.

Every function updates the model's fields and the optimizer state in
place (the JAX functions return new ones). The split noise comes from an
explicit `torch.Generator` on the model's device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from omnigs_torch.model.gaussians import PARAM_NAMES, GaussianModel, inverse_sigmoid
from omnigs_torch.model.optimizer import AdamState, zero_moments
from omnigs_torch.ops.covariance import quat_to_rotmat
from omnigs_torch.utils import profiling

SPLIT_N = 2  # children per split


class DensifyStats(NamedTuple):
    num_cloned: torch.Tensor
    num_split: torch.Tensor
    num_pruned: torch.Tensor
    num_dropped: torch.Tensor  # candidates lost to capacity exhaustion


def _split_noise(generator: torch.Generator, p: int) -> torch.Tensor:
    """(SPLIT_N, P, 3) standard normal samples for the split children."""
    return torch.randn(
        (SPLIT_N, p, 3), generator=generator, device=generator.device
    )


def _scatter_new_items(model: GaussianModel, items: dict, valid: torch.Tensor):
    """Write the ``valid`` items into free slots, in place. Returns
    (slot_written mask, dropped count)."""
    P = model.capacity
    dev = model.active.device
    free = ~model.active
    n_free = torch.sum(free)
    # free slots in ascending index order
    free_slots = torch.sort((~free).to(torch.uint8), stable=True).indices
    rank = torch.cumsum(valid.to(torch.int64), dim=0) - 1
    placed = valid & (rank < n_free)
    target = torch.where(
        placed, free_slots[torch.clamp(rank, 0, P - 1)], torch.full_like(rank, P)
    )

    def write(field: torch.Tensor, values: torch.Tensor):
        # one extra row takes every dropped candidate, then is cut off
        padded = torch.cat([field, torch.zeros_like(field[:1])])
        padded[target] = values.to(field.dtype)
        field.copy_(padded[:P])

    for name in PARAM_NAMES:
        write(getattr(model, name), items[name])
    write(model.active, torch.ones_like(valid))
    write(model.exist_since_iter, items["exist_since_iter"])
    slot_written = torch.zeros(P + 1, dtype=torch.bool, device=dev)
    # the scalar's host → device copy waits for the stream
    with profiling.host_wait("densify"):
        slot_written[target] = True
    dropped = torch.sum(valid & ~placed)
    return slot_written[:P], dropped


@torch.no_grad()
def densify_and_prune(
    model: GaussianModel,
    opt_state: AdamState,
    generator: torch.Generator,
    *,
    max_grad: float,
    min_opacity: float,
    extent: float,
    max_screen_size: int,
    percent_dense: float,
    prune_by_extent: bool,
    iteration: int,
) -> DensifyStats:
    """Clone, split and prune on static capacity, in place."""
    P = model.capacity
    # float32 like the JAX function's traced extent: the thresholds below
    # round as its f32 products do
    extent = torch.full((), extent, dtype=torch.float32, device=model.active.device)
    grads = model.xyz_gradient_accum / torch.clamp_min(model.denom, 1e-12)
    grads = torch.where(model.denom > 0, grads, torch.zeros_like(grads))

    scale_act = model.get_scaling()
    max_scale = torch.amax(scale_act, dim=-1)
    hot = model.active & (grads >= max_grad)
    small = max_scale <= percent_dense * extent
    clone_mask = hot & small
    split_mask = hot & ~small

    # candidates [clones | child0 | child1], P entries each; split children
    # sample xyz ~ N(0, diag(scale)) rotated into the world
    R = quat_to_rotmat(model.get_rotation())  # (P, 3, 3)
    noise = _split_noise(generator, P) * scale_act[None]
    child_xyz = torch.einsum("pij,npj->npi", R, noise) + model.xyz[None]
    child_scaling = torch.log(scale_act / (0.8 * SPLIT_N))

    items = {}
    for name in PARAM_NAMES:
        p = getattr(model, name)
        if name == "xyz":
            items[name] = torch.cat([p, child_xyz[0], child_xyz[1]])
        elif name == "scaling":
            items[name] = torch.cat([p, child_scaling, child_scaling])
        else:
            items[name] = torch.cat([p, p, p])
    items["exist_since_iter"] = torch.full(
        (3 * P,), iteration, dtype=torch.int32, device=model.active.device
    )
    valid = torch.cat([clone_mask, split_mask, split_mask])

    slot_written, dropped = _scatter_new_items(model, items, valid)
    # zero the Adam moments of freshly written slots
    zero_moments(opt_state, slot_written)
    # deactivate split parents
    model.active &= ~split_mask

    # prune; newly placed slots read the zeroed max_radii2d of a free slot
    prune = model.get_opacity() < min_opacity
    if max_screen_size:
        big_vs = model.max_radii2d > max_screen_size
        if prune_by_extent:
            big_ws = torch.amax(model.get_scaling(), dim=-1) > 0.1 * extent
        else:
            big_ws = torch.zeros_like(big_vs)
        prune = prune | big_vs | big_ws
    num_pruned = torch.sum(model.active & prune)
    model.active &= ~prune

    # statistics reset for every slot
    model.xyz_gradient_accum.zero_()
    model.denom.zero_()
    model.max_radii2d.zero_()
    return DensifyStats(
        num_cloned=torch.sum(clone_mask),
        num_split=torch.sum(split_mask),
        num_pruned=num_pruned,
        num_dropped=dropped,
    )


@torch.no_grad()
def reset_opacity(model: GaussianModel, opt_state: AdamState) -> None:
    """Clamp the activated opacity of live slots to ≤ 0.01 and re-logit;
    zero the opacity group's Adam moments. In place."""
    new_op = inverse_sigmoid(torch.clamp_max(model.get_opacity(), 0.01))[:, None]
    model.opacity.copy_(torch.where(model.active[:, None], new_op, model.opacity))
    zero_moments(
        opt_state,
        torch.ones(model.capacity, dtype=torch.bool, device=model.active.device),
        names=("opacity",),
    )


@torch.no_grad()
def add_densification_stats(
    model: GaussianModel, ndc_grads: torch.Tensor, radii: torch.Tensor
) -> None:
    """Accumulate the screen-space gradient norm and the max screen radius
    of the visible slots, in place."""
    visible = radii > 0
    gnorm = torch.linalg.vector_norm(ndc_grads[:, :2], dim=-1)
    model.xyz_gradient_accum += torch.where(visible, gnorm, torch.zeros_like(gnorm))
    model.denom += visible.to(model.denom.dtype)
    model.max_radii2d.copy_(
        torch.where(
            visible, torch.maximum(model.max_radii2d, radii), model.max_radii2d
        )
    )
