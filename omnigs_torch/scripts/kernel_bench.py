"""Per-stage timing of the rasterization pipeline on one card.

The port's copy of `scripts/kernel_bench.py`: each stage of the production
path timed standalone (preprocess, the compact / packed / ghost-aligned
binnings, the slab builds, the tile-major forward (#3), backward (#4) and
fused backward (#5) kernels, the segmented relay, slab and kernels (#1,
#2), and five instance → Gaussian gradient reductions) at the workload of
`bench.py`, so that kernel work can be attributed and a change measured in
isolation. Every stage and printed line of the JAX script is here, under
the same names (`STAGE_LINES`), with the same ``--stages`` and size flags,
plus ``--device``.

The model is the JAX scripts' example model (`example.example_model`, P =
``--gaussians``) from the identity pose at lonlat ``--width`` ×
``--height``. The compact binnings are trimmed to ``--cap`` slab lanes as
the JAX script trims them (tiles whose segment would cross the cap lose
their count, starts clipped, the slab cut); the relay takes the untrimmed
compact binning and trims at the cap itself; the fused backward runs only
where P ≤ `composite_tile.FUSED_REDUCE_MAX_P`, as the JAX routing has it.

Each time is `utils.profiling.stage_ms` over the JAX script's 20 calls
after 2, and each line ends with what it measures: ``device`` when the
host had enqueued every timed call before the card reached them (the CUDA
events read the card's time alone), ``launch`` when the card reached them
earlier (the events may hold the host's launch gaps; the line adds the
card's busy time a call, `utils.profiling.device_busy_ms`), ``host`` when
a call makes the host wait for the card (the events hold the host's gaps)
and on the CPU (the host clock).

    python -m omnigs_torch.scripts.kernel_bench [--stages fwd bwd red]
    python -m omnigs_torch.scripts.kernel_bench --device cpu --width 128 \\
        --height 64 --gaussians 300 --max-instances 8192 --cap 4096
"""

from __future__ import annotations

import argparse

import torch

from omnigs_torch.cameras import Camera, CameraType
from omnigs_torch.ops import composite_seg as cs
from omnigs_torch.ops import composite_tile as ct
from omnigs_torch.ops.binning import (
    bin_instances,
    bin_instances_aligned,
    bin_instances_packed,
    segment_relay,
)
from omnigs_torch.ops.preprocess import tile_grid
from omnigs_torch.scripts.example import example_model, preprocess_model
from omnigs_torch.utils.profiling import stage_ms

# the JAX script's printed lines, each up to its first formatted field
STAGE_LINES = (
    "workload: P=",
    "preprocess            ",
    "instances: emitted=",
    "binning (",
    "binning (packed+cull) ",
    "binning (packed+emit) ",
    "build slab            ",
    "build slab (live)     ",
    "fwd kernel            ",
    "bwd kernel            ",
    "fwd kernel (no nctr)  ",
    "bwd fused (kern+red)  ",
    "seg relay             ",
    "  live8=",
    "build slab8           ",
    "seg fwd kernel        ",
    "seg bwd kernel        ",
    "red: scatter-add (R,9)",
    "red: scatter-add(R,16)",
    "red: scatter (live)   ",
    "binning w/ emission   ",
    "red: gather+segdiff   ",
    "red: sort+segsum      ",
)
CHUNK = cs.CHUNK


def _trim(inst, cap):
    """The JAX script's compact trim: tiles whose segment crosses ``cap``
    lose their count, starts are clipped into the slab, the slab is cut."""
    fits = inst.starts + inst.counts <= cap
    return inst._replace(
        counts=torch.where(fits, inst.counts, 0),
        starts=torch.clamp(inst.starts, 0, cap - 1),
        sorted_g=inst.sorted_g[:cap],
    )


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--stages", nargs="*", default=None)
    ap.add_argument("--gaussians", type=int, default=1 << 17)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=960)
    ap.add_argument("--max-instances", type=int, default=26 << 16)
    ap.add_argument("--layout", choices=("compact", "ghost"), default="compact")
    ap.add_argument("--cap", type=int, default=8704 * 128)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    with torch.no_grad():
        return run(args)


def run(args) -> dict:
    """The stages ``args.stages`` (all by default) at the sizes of
    ``args`` → {"ms", "measures": per stage, "busy_ms": per ``launch``
    stage, "lines": printed, "device",
    "instances": emitted / composited / truncated, "seg": the relay's
    live8 / pad / chunks / truncated, "fwd_image" and "seg_image": (color,
    final_T) of #3 and #1, "kernels": each kernel wrapper's first output
    beside a callable of its plain version on the same inputs,
    "reductions": the five reductions as callables, "reduced_rows": (the
    rows, their ids)}."""
    dev = torch.device(args.device)
    W, H, P, R, cap = args.width, args.height, args.gaussians, args.max_instances, args.cap
    camera = Camera(CameraType.LONLAT, W, H)
    gx, gy = tile_grid(camera)
    num_tiles = gx * gy
    model = example_model(P, dev)
    out = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev),
           "ms": {}, "measures": {}, "busy_ms": {}, "lines": [], "kernels": {}}

    def want(stage):
        return args.stages is None or stage in args.stages

    def say(text):
        print(text, flush=True)
        out["lines"].append(text)

    def stage(key, label, fn):
        ms, kind, busy = stage_ms(fn, dev)
        out["ms"][key], out["measures"][key] = ms, kind
        if busy is not None:
            out["busy_ms"][key] = busy
        say(f"{label}{ms:8.2f} ms  {kind}"
            + (f" (busy {busy:.2f} ms)" if busy is not None else ""))

    prep = preprocess_model(model, camera)
    say(f"workload: P={P} {W}x{H} tiles={num_tiles} R={R}")
    if want("prep"):
        stage("prep", "preprocess            ", lambda: preprocess_model(model, camera))

    if args.layout == "ghost":
        def bin_fn(p):
            return bin_instances_aligned(p, gx, gy, R, CHUNK, tile_cull=True)
    else:
        def bin_fn(p):
            return _trim(bin_instances(p, gx, gy, R, tile_cull=True), cap)

    inst = bin_fn(prep)
    n_inst = int(inst.num_instances)
    n_comp = int(torch.sum(inst.counts))
    out["instances"] = {"emitted": n_inst, "composited": n_comp,
                        "truncated": int(inst.truncated)}
    say(f"instances: emitted={n_inst} composited={n_comp} "
        f"avg/tile={n_comp / num_tiles:.0f} truncated={int(inst.truncated)}")
    if want("bin"):
        stage("bin", f"binning ({args.layout}+cull)", lambda: bin_fn(prep))

    if want("bin_packed") and args.layout == "compact":
        # the depth-presorted packed-key binning, with the same trim
        def binp_fn(emission):
            return _trim(bin_instances_packed(prep, gx, gy, R, tile_cull=True,
                                              with_emission=emission), cap)

        stage("bin_packed", "binning (packed+cull) ", lambda: binp_fn(False))
        stage("bin_packed_emit", "binning (packed+emit) ", lambda: binp_fn(True))

    def build(live):
        return ct._build_inst(prep.means2d, prep.conic, prep.rgb, prep.opacity,
                              inst.sorted_g, live, None)

    inst_T = build(inst.sorted_g.shape[0])  # every lane gathered
    if want("build"):
        stage("build", "build slab            ", lambda: build(inst.sorted_g.shape[0]))
        stage("build_live", "build slab (live)     ",
              lambda: build(torch.amax(inst.starts + inst.counts)))

    x0, y0 = ct.tile_origins(gx, gy, dev)
    slab = (inst_T, inst.starts, inst.counts, x0, y0)
    fwd = ct.composite_tile_fwd(*slab, num_tiles)
    color, final_t, _ = fwd
    out["fwd_image"] = (color, final_t)
    out["kernels"]["composite_tile_fwd"] = (
        fwd, lambda: ct.composite_tile_fwd_plain(*slab, num_tiles)[:3])
    if want("fwd"):
        stage("fwd", "fwd kernel            ", lambda: ct.composite_tile_fwd(*slab, num_tiles))

    bg = torch.zeros(3, device=dev)
    color_full = color + final_t[:, None, :] * bg[None, :, None]
    dcolor = torch.ones_like(color_full) / (W * H)
    dinst = ct.composite_tile_bwd(*slab, color_full, dcolor, num_tiles)
    out["kernels"]["composite_tile_bwd"] = (
        dinst, lambda: ct.composite_tile_bwd_plain(*slab, color_full, dcolor, num_tiles))
    if want("bwd"):
        stage("bwd", "bwd kernel            ",
              lambda: ct.composite_tile_bwd(*slab, color_full, dcolor, num_tiles))

    if want("fwd_nc"):
        stage("fwd_nc", "fwd kernel (no nctr)  ",
              lambda: ct.composite_tile_fwd(*slab, num_tiles, want_ncontrib=False))

    if want("bwd_fused") and P <= ct.FUSED_REDUCE_MAX_P:
        fargs = (inst_T, inst.sorted_g, inst.starts, inst.counts, x0, y0, color_full, dcolor,
                 num_tiles, P)
        out["kernels"]["composite_tile_bwd_fused"] = (
            ct.composite_tile_bwd_fused(*fargs), lambda: ct.composite_tile_bwd_fused_plain(*fargs))
        stage("bwd_fused", "bwd fused (kern+red)  ", lambda: ct.composite_tile_bwd_fused(*fargs))

    if want("seg"):
        # the segmented pipeline: relay + the walk kernels #1 / #2; the
        # relay takes the UNTRIMMED compact binning (it trims at r8 itself)
        r8 = cap
        inst_u = bin_instances(prep, gx, gy, R, tile_cull=True)

        def relay():
            return segment_relay(inst_u.sorted_g, inst_u.starts, inst_u.counts, r8, P)

        seg = relay()
        stage("seg_relay", "seg relay             ", relay)
        live8 = int(seg.live8)
        out["seg"] = {"live8": live8, "pad": live8 - n_comp, "chunks": live8 // CHUNK,
                      "truncated": int(seg.truncated)}
        say(f"  live8={live8} (+{live8 - n_comp} pad) "
            f"chunks={live8 // CHUNK} trunc={int(seg.truncated)}")

        def build8():
            return cs._build_inst_seg(prep.means2d, prep.conic, prep.rgb, prep.opacity,
                                      seg.sorted_g8, None, seg.ride_d, seg.ride_t)

        inst_T8 = build8()
        stage("build8", "build slab8           ", build8)
        seg_args = (inst_T8, seg.starts8, seg.counts, seg.live8)
        scolor, sfinal_t = cs.composite_seg_fwd(*seg_args, num_tiles, gx)
        out["seg_image"] = (scolor, sfinal_t)
        plain_args = (inst_T8, seg.starts8, seg.counts)
        out["kernels"]["composite_seg_fwd"] = (
            (scolor, sfinal_t),
            lambda: cs.composite_seg_fwd_plain(*plain_args, num_tiles, gx)[:2])
        stage("seg_fwd", "seg fwd kernel        ",
              lambda: cs.composite_seg_fwd(*seg_args, num_tiles, gx))
        scolor_full = scolor + sfinal_t[:, None, :] * bg[None, :, None]
        sdcolor = torch.ones_like(scolor_full) / (W * H)
        out["kernels"]["composite_seg_bwd"] = (
            cs.composite_seg_bwd(*seg_args, scolor_full, sdcolor, num_tiles, gx),
            lambda: cs.composite_seg_bwd_plain(*plain_args, scolor_full, sdcolor, num_tiles, gx))
        stage("seg_bwd", "seg bwd kernel        ",
              lambda: cs.composite_seg_bwd(*seg_args, scolor_full, sdcolor, num_tiles, gx))

    if want("red"):
        out["reductions"] = reduce_stages(dev, stage, prep, inst, dinst, gx, gy, R, P, cap,
                                          args.layout)
        out["reduced_rows"] = (dinst[: cs.NGRAD, : inst.sorted_g.shape[0]], inst.sorted_g)
    return out


def reduce_stages(dev, stage, prep, inst, dinst, gx, gy, R, P, cap, layout):
    """Time the five instance → Gaussian reductions of the backward's rows
    ``dinst`` (NROWS, ≥ R') by the binning ``inst``'s ids, and the binning
    with the gather reduction's survivor-rank payload → the five
    reductions by stage key, each a callable → (P, ≥ 9) rows."""
    r = inst.sorted_g.shape[0]
    sg = inst.sorted_g
    rows = dinst[: cs.NGRAD, :r]

    def scatter(width):
        return torch.zeros(P, width, device=dev).index_add_(
            0, sg.to(torch.int64), dinst[:width, :r].T)

    if layout == "ghost":
        def bin_e():
            return bin_instances_aligned(prep, gx, gy, R, CHUNK, with_emission=True,
                                         tile_cull=True)
    else:
        def bin_e():
            return _trim(bin_instances(prep, gx, gy, R, tile_cull=True,
                                       with_emission=True), cap)

    inst_e = bin_e()

    def sortsum():
        sid, order = torch.sort(sg)  # unstable, as the JAX sort
        # the prefix sums run along the rows of the (9, R) block: PyTorch's
        # CUDA scan along dim 0 of an (R, 9) array walks each column
        # serially (~290 ms at R = 1,114,112)
        cs_ = torch.cumsum(rows[:, order], dim=1)
        idx = torch.searchsorted(sid, torch.arange(P + 1, dtype=sid.dtype, device=dev))
        csz = torch.cat([cs_.new_zeros(cs.NGRAD, 1), cs_], dim=1)
        return (csz[:, idx[1:]] - csz[:, idx[:-1]]).T

    variants = {
        "red_scatter9": lambda: scatter(9),
        "red_scatter16": lambda: scatter(16),
        # the production live-bound scatter (the JAX script's chunked loop)
        "red_scatter_live": lambda: ct._scatter_reduce(
            dinst, sg, torch.amax(inst.starts + inst.counts), P),
        "red_gather": lambda: ct.gather_reduce_rows(
            rows.T, inst_e.sorted_e, inst_e.seg_lo, inst_e.seg_hi),
        "red_sortsum": sortsum,
    }
    stage("red_scatter9", "red: scatter-add (R,9)", variants["red_scatter9"])
    stage("red_scatter16", "red: scatter-add(R,16)", variants["red_scatter16"])
    stage("red_scatter_live", "red: scatter (live)   ", variants["red_scatter_live"])
    stage("bin_emission", "binning w/ emission   ", bin_e)
    stage("red_gather", "red: gather+segdiff   ", variants["red_gather"])
    stage("red_sortsum", "red: sort+segsum      ", sortsum)
    return variants


if __name__ == "__main__":
    main()
