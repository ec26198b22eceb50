"""Sub-stage timing of the aligned binning on one card.

The port's copy of `scripts/bin_bench.py`: each internal phase of
`bin_instances_aligned` timed standalone, so that binning's time can be
attributed: slot ownership, the row gather, the expansion math, the
tile-cull math, `tile_cover_counts`, the ghost construction, and three
sorts (the 2-key (tile, depth) sort over the instances and ghosts, the
same order by one packed int64 key, and the 2-key sort of the first 2^20
entries). The lines and the sizes are the JAX script's (lonlat 1920×960,
P = 2^17 of the example model from the identity pose, R = 2^21 slots);
`run` takes smaller sizes for a run on the CPU.

PyTorch sorts by one key: the 2-key stable ``lax.sort`` is two stable
sorts, depth first, then tile (`binning._sort_tile_depth`). Each time is
`utils.profiling.stage_ms` over 20 calls after 2, and each line ends with
what it measures (``device``, ``launch`` or ``host``, as in `kernel_bench`).

Two slips of the JAX script are not carried over: it first builds a jitted
preprocess of the wrong arguments (``exp(scaling)`` as the means) and never
calls it; and its comment on the last sort says 1.4M where the slice is
2^20. Without 64-bit mode JAX also truncates the packed key's int64 to
int32, which shifts the tile out of it: on the TPU that sort ordered by
the depth bits alone. Here the key is what the JAX expression spells out.

    python -m omnigs_torch.scripts.bin_bench [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

from omnigs_torch.cameras import Camera, CameraType
from omnigs_torch.ops.binning import (
    _min_quad_over_box,
    _owner_of_slot,
    _sort_tile_depth,
    tile_cover_counts,
)
from omnigs_torch.ops.composite_seg import CHUNK
from omnigs_torch.ops.preprocess import TILE, tile_grid
from omnigs_torch.scripts.example import example_model, preprocess_model
from omnigs_torch.utils.profiling import stage_ms

_I32 = torch.int32
_I64 = torch.int64
# entries of the last sort (the JAX script's ``m``)
SORT_SLICE = 1 << 20
# the JAX script's printed lines, each up to its first formatted field
STAGE_LINES = (
    "owner_of_slot R=2M    ",
    "row gather (R,11)     ",
    "expansion math        ",
    "tile-cull math        ",
    "tile_cover_counts     ",
    "ghost construction    ",
    "sort ",
    "sort packed int64 1k+1p",
    "sort 1.0M 2k+1p       ",
)


def row_table(prep) -> torch.Tensor:
    """(P, 11) f32 rows: rect (4), depth, means2d (2), conic (3), opacity."""
    return torch.cat([prep.rect.to(torch.float32), prep.depths[:, None], prep.means2d,
                      prep.conic, prep.opacity[:, None]], dim=-1)


def expand(rows, g, offsets, gx):
    """Each slot's raw tile id from its owner's rect row and its index
    within the owner's emission (rect-row-major)."""
    j = torch.arange(rows.shape[0], dtype=_I32, device=rows.device)
    x0 = rows[:, 0].to(_I32)
    width = torch.clamp_min(rows[:, 2].to(_I32) - x0, 1)
    local = j - offsets[g.to(_I64)]
    tx = x0 + local % width
    ty = rows[:, 1].to(_I32) + local // width
    return ty * gx + tx


def cull(rows, tile_id, gx):
    """(R,) bool: the slot's max α over its tile reaches 1/255."""
    tx = tile_id % gx
    ty = tile_id // gx
    mx, my = rows[:, 5], rows[:, 6]
    cA, cB, cC = rows[:, 7], rows[:, 8], rows[:, 9]
    op = rows[:, 10]
    px0 = (tx * TILE).to(torch.float32)
    py0 = (ty * TILE).to(torch.float32)
    qmin = _min_quad_over_box(cA, cB, cC, px0 - mx, px0 + (TILE - 1) - mx,
                              py0 - my, py0 + (TILE - 1) - my)
    return op * torch.exp(-0.5 * qmin) >= 1.0 / 255.0


def ghosts(padded, counts, num_tiles, chunk=CHUNK):
    """Each ghost slot's tile: ghost_counts = padded − counts per tile."""
    n_ghost = num_tiles * chunk
    gc = padded - counts
    go = torch.cumsum(gc, dim=0, dtype=_I32) - gc
    return torch.clamp(_owner_of_slot(go, n_ghost), 0, num_tiles - 1)


def sort2(tile, depth, g):
    """The stable 2-key (tile, depth) sort with payload ``g`` → the three
    sorted arrays."""
    order = _sort_tile_depth(tile, depth)
    return tile[order], depth[order], g[order]


def packed_key(tile, depth):
    """int64 ``tile << 32 | depth bits`` (the float's bits as uint32): for
    depths ≥ 0, +inf included, the order of (tile, depth)."""
    return (tile.to(_I64) << 32) | (depth.view(_I32).to(_I64) & 0xFFFFFFFF)


def sort_packed(tile, depth, g):
    """The stable sort by `packed_key` with payload ``g`` → (keys, g)."""
    key, order = torch.sort(packed_key(tile, depth), stable=True)
    return key, g[order]


def inputs(prep, gx, gy, max_instances):
    """Every sub-stage's inputs from one preprocess, as the JAX script
    chains them: offsets, owners, rows, tile ids, per-tile counts, ghosts,
    and the instance + ghost arrays of the sorts."""
    p = prep.depths.shape[0]
    num_tiles = gx * gy
    tiles = prep.tiles_touched.to(_I32)
    offsets = torch.cumsum(tiles, dim=0, dtype=_I32) - tiles
    g = torch.clamp(_owner_of_slot(offsets, max_instances), 0, p - 1)
    table = row_table(prep)
    rows = table[g.to(_I64)]
    tile_id = torch.clamp(expand(rows, g, offsets, gx), 0, num_tiles)
    counts = tile_cover_counts(prep.rect, tiles > 0, gx, gy)
    padded = ((counts + CHUNK - 1) // CHUNK) * CHUNK
    gtile = ghosts(padded, counts, num_tiles)
    n_ghost = num_tiles * CHUNK
    live_ghosts = torch.arange(n_ghost, device=g.device) < torch.sum(padded - counts)
    all_tile = torch.cat([tile_id, torch.where(live_ghosts, gtile, num_tiles)])
    all_depth = torch.cat([rows[:, 4], rows.new_full((n_ghost,), torch.inf)])
    all_g = torch.cat([g, g.new_zeros(n_ghost)])
    return dict(tiles=tiles, offsets=offsets, g=g, table=table, rows=rows,
                tile_id=tile_id, counts=counts, padded=padded, gtile=gtile,
                all_tile=all_tile, all_depth=all_depth, all_g=all_g)


def run(device, width=1920, height=960, gaussians=1 << 17, max_instances=1 << 21) -> dict:
    """Time the sub-stages at these sizes on ``device`` and print one line
    each → {"ms": {stage: ms}, "measures": {stage: "device" | "launch" |
    "host"}, "busy_ms": {stage: the card's busy ms a call} for the
    ``launch`` stages, "lines": [...], "device": name}."""
    dev = torch.device(device)
    camera = Camera(CameraType.LONLAT, width, height)
    gx, gy = tile_grid(camera)
    num_tiles = gx * gy
    R = max_instances
    out = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev),
           "ms": {}, "measures": {}, "busy_ms": {}, "lines": []}

    def stage(key, label, fn):
        ms, kind, busy = stage_ms(fn, dev)
        out["ms"][key], out["measures"][key] = ms, kind
        line = f"{label}{ms:8.2f} ms  {kind}"
        if busy is not None:
            out["busy_ms"][key] = busy
            line += f" (busy {busy:.2f} ms)"
        print(line, flush=True)
        out["lines"].append(line)

    with torch.no_grad():
        prep = preprocess_model(example_model(gaussians, dev), camera)
        x = inputs(prep, gx, gy, R)
        stage("owner_of_slot", "owner_of_slot R=2M    ",
              lambda: _owner_of_slot(x["offsets"], R))
        stage("row_gather", "row gather (R,11)     ", lambda: x["table"][x["g"].to(_I64)])
        stage("expansion", "expansion math        ",
              lambda: expand(x["rows"], x["g"], x["offsets"], gx))
        stage("tile_cull", "tile-cull math        ", lambda: cull(x["rows"], x["tile_id"], gx))
        stage("tile_cover_counts", "tile_cover_counts     ",
              lambda: tile_cover_counts(prep.rect, x["tiles"] > 0, gx, gy))
        stage("ghosts", "ghost construction    ",
              lambda: ghosts(x["padded"], x["counts"], num_tiles))
        sort_in = (x["all_tile"], x["all_depth"], x["all_g"])
        stage("sort_2key", f"sort {sort_in[0].shape[0] / 1e6:.1f}M 2k+1p   ",
              lambda: sort2(*sort_in))
        stage("sort_packed", "sort packed int64 1k+1p", lambda: sort_packed(*sort_in))
        m = SORT_SLICE
        stage("sort_2key_slice", "sort 1.0M 2k+1p       ",
              lambda: sort2(*(a[:m] for a in sort_in)))
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    return run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
