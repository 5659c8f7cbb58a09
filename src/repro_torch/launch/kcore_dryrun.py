"""Dry-run of the DISTRIBUTED K-CORE sweep at the paper's true scales on an
H100 fleet: the port of ``repro.launch.kcore_dryrun``.

The paper's graphs (com-friendster 1.8B, WX-15B, WX-136B edges) cannot be
materialized here, but the sweep can be run on shapes alone. Bucket shapes
come from the same power-law degree model, calibrated to (n, m), laid over
the same 512-rank production mesh. Each case gets:

* the analytic memory model (the device's share of the tiles plus the
  replicated state) against the H100's 80 GB, and the modeled collective
  schedule of a run;
* the program's own numbers: one full sweep of the distributed engine's
  :func:`~repro_torch.core.distributed.make_sweep_fn` with the counts
  kernel (the path the card runs), on meta tensors, as rank 0 of a fake
  512-rank process group, under :class:`~repro_torch.roofline.tally.Tally`:
  its peak live bytes, bytes moved, int32 ops and collectives, priced
  against the H100 and its links (:mod:`repro_torch.roofline.analysis`).

Nothing here touches a GPU or the network. A case whose node ids reach
2^31, or whose modeled layout exceeds the card, is recorded without the
trace, as in the reference.

Usage (no GPU needed):
    python -m repro_torch.launch.kcore_dryrun [--wire int16] [--cand 2048]
        [--case NAME] [--split3] [--mono-only] [--slices N] [--tag T]

Records go to ``artifacts/kcore_torch/`` under the repository root.
"""
import argparse
import dataclasses
import json
import math
import os
import time

import numpy as np
import torch

ARTIFACT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))),
    "artifacts", "kcore_torch",
)
WORLD_SIZE = 512  # the multi-pod production mesh

# (name, n_nodes, n_edges, divide_threshold, k_max from the paper)
WORKLOADS = {
    "com-friendster": (65_608_366, 1_806_067_135, 80, 304),
    "WX-15B": (646_408_482, 15_179_911_593, 100, 401),
    "WX-136B": (2_226_845_928, 136_588_315_957, 250, 1_179),
}


def powerlaw_bucket_rows(n: int, m: int, max_width: int = 1 << 20):
    """Rows per power-of-two degree bucket for a power-law degree model
    calibrated so the mean degree matches 2m/n. Hub nodes above max_width
    are assumed degree-split (standard virtual-node trick; documented)."""
    mu = 2 * m / n
    # discrete P(d) ~ d^-alpha on [1, max_width]; solve alpha for mean mu.
    ds = np.arange(1, max_width + 1, dtype=np.float64)

    def mean_for(alpha):
        w = ds ** (-alpha)
        return float((ds * w).sum() / w.sum())

    lo, hi = 1.05, 3.5
    for _ in range(60):
        mid = (lo + hi) / 2
        if mean_for(mid) > mu:
            lo = mid
        else:
            hi = mid
    alpha = (lo + hi) / 2
    w = ds ** (-alpha)
    p = w / w.sum()
    buckets = []
    width = 8
    lo_d = 1
    while lo_d <= max_width:
        hi_d = min(width, max_width)
        frac = p[lo_d - 1 : hi_d].sum()
        rows = int(n * frac)
        if rows > 0:
            buckets.append((width, rows))
        lo_d = width + 1
        width *= 2
    return alpha, buckets


def degseq_hindex(buckets) -> int:
    """h-index of the modeled degree sequence (candidate window bound)."""
    best = 0
    for h in [8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768]:
        cnt = sum(rows for width, rows in buckets if width >= h)
        if cnt >= h:
            best = h
    return best


def build_specs_for(n: int, buckets, plan, wire_dtype, id_dtype):
    """Meta stand-ins of rank 0's sweep inputs: the replicated ``c`` (wire
    dtype), ``ext_pad`` (int32) and node -> bucket map (int16, 2 bytes a
    node), and each bucket's row and slot block, padded as the reference
    pads its global shapes (rows to the node shards, at least one row each;
    slots to the slot shards, at least 8 each)."""
    from repro_torch.core.distributed import ShardedBucket

    ns, ms = plan.n_node_shards, plan.n_slot_shards
    meta = torch.device("meta")
    specs = []
    for width, rows in buckets:
        rows_p = max(ns, int(math.ceil(rows / ns)) * ns)
        width_p = max(ms * 8, int(math.ceil(width / ms)) * ms)
        specs.append(ShardedBucket(
            ids=torch.empty(rows_p // ns, dtype=torch.int32, device=meta),
            neigh=torch.empty(rows_p // ns, width_p // ms, dtype=id_dtype, device=meta),
            rows=rows_p, width=width_p,
        ))
    c = torch.empty(n + 1, dtype=wire_dtype, device=meta)
    ext_pad = torch.empty(n + 1, dtype=torch.int32, device=meta)
    node_tile = torch.empty(n + 1, dtype=torch.int16, device=meta)
    return c, ext_pad, node_tile, specs


def traced_sweep(plan, cand: int, c, ext_pad, node_tile, buckets):
    """One full sweep (every bucket active) of the distributed engine with
    the counts kernel, under a :class:`~repro_torch.roofline.tally.Tally`.
    Returns ``(tally, seconds)``."""
    from repro_torch.core.distributed import make_sweep_fn
    from repro_torch.roofline.tally import Tally

    sweep = make_sweep_fn(plan, cand, use_kernel=True)
    active = np.ones(len(buckets), dtype=bool)
    t0 = time.perf_counter()
    with Tally() as tally:
        sweep(c, ext_pad, active, node_tile, buckets)
    return tally, time.perf_counter() - t0


def run_case(name, n, m, cand, wire, multi_pod=True, tag="", n_iters=30):
    """One case's record. Needs an initialized process group of the
    production mesh's size (``main`` opens a fake one)."""
    from repro_torch.core.distributed import planned_collective_schedule
    from repro_torch.launch.mesh import make_production_plan
    from repro_torch.roofline import hw
    from repro_torch.roofline.analysis import roofline_terms

    plan = make_production_plan(multi_pod=multi_pod)
    alpha, buckets = powerlaw_bucket_rows(n, m)
    wire_dtype = torch.int16 if wire == "int16" else torch.int32
    id_dtype = torch.int32 if n < 2**31 else torch.int64

    # Feasibility: replicated state + sharded tiles per device.
    id_bytes = 4 if id_dtype == torch.int32 else 8
    wire_bytes = 2 if wire == "int16" else 4
    slots = sum(r * max(8, w) for w, r in buckets)
    tiles_dev = slots * id_bytes / plan.size
    # coreness (wire) + ext (int16) + frontier node->bucket map (int16)
    state_dev = (n + 1) * (wire_bytes + 2 + 2)
    total_dev = tiles_dev + state_dev + 512 * 2**20
    fits = total_dev < hw.HBM_BYTES
    rec = {
        "case": f"{name}{tag}",
        "n": n,
        "m": m,
        "alpha": round(alpha, 3),
        "mesh": "2x16x16" if multi_pod else "16x16",
        "cand": cand,
        "wire": wire,
        "id_dtype": str(id_dtype).removeprefix("torch."),
        "memory_model": {
            "tiles_dev": tiles_dev,
            "state_dev": state_dev,
            "total_dev": total_dev,
        },
        "fits_80gb": bool(fits),
    }
    # Modeled collective traffic of a whole run, from the planned frontier
    # schedule over the modeled bucket shapes (the live engine's per-bucket
    # ring formula); reported even for infeasible layouts.
    sched = planned_collective_schedule(
        [r for _w, r in buckets], plan, cand,
        wire_bytes=wire_bytes, n_iters=n_iters,
    )
    rec["modeled_collectives"] = {
        "n_iters": n_iters,
        "first_sweep_bytes": sched[0],
        "total_bytes": sum(sched),
        "per_iter_bytes": sched,
    }
    if n + 1 >= 2**31:
        # int64 ids double the tile bytes, and the sweep's int32 id
        # arithmetic overflows: the monolithic 2.2B-node layout is
        # infeasible outright; the divide is what brings a part under 2^31.
        rec["fits_80gb"] = False
        rec["skipped_compile"] = "node ids exceed int32 (monolithic 2.2B-node layout)"
        _dump(rec)
        return rec
    if not fits:
        rec["skipped_compile"] = "exceeds per-device HBM — infeasible layout"
        _dump(rec)
        return rec

    c, ext_pad, node_tile, specs = build_specs_for(n, buckets, plan, wire_dtype, id_dtype)
    tally, seconds = traced_sweep(plan, cand, c, ext_pad, node_tile, specs)
    colls = tally.collectives
    rec["trace_s"] = round(seconds, 1)
    rec["peak_temp_bytes"] = tally.peak_bytes
    rec["hbm_bytes"] = tally.hbm_bytes
    rec["int_ops"] = tally.int_ops
    rec["collectives"] = {"wire_bytes": colls.wire_bytes, "count": colls.count,
                          "link_wire_bytes": colls.link_wire_bytes}
    rec["roofline"] = roofline_terms(tally.int_ops, tally.hbm_bytes, colls).as_dict()
    _dump(rec)
    return rec


def _dump(rec):
    os.makedirs(ARTIFACT_DIR, exist_ok=True)
    path = os.path.join(ARTIFACT_DIR, f"{rec['case']}__{rec['mesh']}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    rl = rec.get("roofline")
    extra = (
        f"peak={rec['peak_temp_bytes']/2**30:.1f}GiB "
        f"compute={rl['compute_s']:.4g}s memory={rl['memory_s']:.4g}s "
        f"collective={rl['collective_s']:.4g}s [{rl['bottleneck']}]"
        if rl
        else rec.get("skipped_compile", "")
    )
    mc = rec.get("modeled_collectives")
    coll = (
        f"coll/iter0={mc['first_sweep_bytes']/2**30:.3f}GiB "
        f"coll_total={mc['total_bytes']/2**30:.2f}GiB "
        if mc else ""
    )
    print(
        f"{rec['case']:34s} mesh={rec['mesh']} fits80g={rec['fits_80gb']} "
        f"dev_mem={rec['memory_model']['total_dev']/2**30:.1f}GiB {coll}{extra}",
        flush=True,
    )


def run_split3(name, n, m, t, kmax, wire, tag=""):
    """Recursive Rough-Divide into 3 parts (paper §5.6). Part sizes are
    modeled from the degree buckets (in-part adjacency is conservatively
    the full bucket width)."""
    _alpha, buckets = powerlaw_bucket_rows(n, m)
    top = [(w, r) for w, r in buckets if w >= 2 * t]
    mid = [(w, r) for w, r in buckets if 8 < w < 2 * t]
    bot = [(w, r) for w, r in buckets if w <= 8]
    for label, part, cand in [
        (f"top(t={t})", top, min(2 * kmax, 4096)),
        (f"mid(8<d<{t})", mid, t),
        ("bottom(d<=8)", bot, 8),
    ]:
        pn = sum(r for _w, r in part)
        pm = sum(r * w for w, r in part) // 2
        run_case(f"{name}-3p-{label}", max(pn, 1 << 20), max(pm, 1 << 22), cand,
                 wire, multi_pod=True, tag=tag)


def run_slices(name, n, m, t, kmax, wire, n_slices, tag=""):
    """Part-parallel schedule table: price the 3-part split's parts with
    the production scheduler (``part_cost`` + ``assign_parts``) on the
    single-pod 16x16 mesh divided into ``n_slices`` slices along "data".
    Pure planning-layer math: no device is touched, so this prints the
    same placement the live part-parallel engine would compute."""
    from repro_torch.core.partsched import SliceSpec, assign_parts, part_cost

    node_shards, slot_shards = 16, 16
    if node_shards % n_slices != 0:
        raise SystemExit(f"--slices must divide the {node_shards}-way node axis")
    specs = [
        SliceSpec(index=i, n_node_shards=node_shards // n_slices,
                  n_slot_shards=slot_shards)
        for i in range(n_slices)
    ]
    wire_bytes = 2 if wire == "int16" else 4
    _alpha, buckets = powerlaw_bucket_rows(n, m)
    splits = [
        (f"top(t={t})", [(w, r) for w, r in buckets if w >= 2 * t],
         min(2 * kmax, 4096)),
        (f"mid(8<d<{t})", [(w, r) for w, r in buckets if 8 < w < 2 * t], t),
        ("bottom(d<=8)", [(w, r) for w, r in buckets if w <= 8], 8),
    ]
    costs, labels = [], {}
    for cursor, (label, part, cand) in enumerate(splits):
        shapes = [(r, w) for w, r in part]
        pn = max(sum(r for _w, r in part), 1)
        c = part_cost(shapes, cand, pn, specs[0], wire_bytes=wire_bytes)
        costs.append(dataclasses.replace(c, cursor=cursor))
        labels[cursor] = label
    sched = assign_parts(costs, specs)
    loads = sched.slice_loads()
    peak = max(loads) or 1
    print(f"\n{name}{tag}: 3-part split on 16x16 / {n_slices} slices "
          f"({specs[0].n_node_shards}x{specs[0].n_slot_shards} each, wire={wire})")
    for a in sched.assignments:
        c = a.cost
        print(f"  part {a.cursor} {labels[a.cursor]:16s} -> slice {a.slice_index}  "
              f"coll={c.collective_bytes/2**30:8.2f}GiB  "
              f"hbm/dev={c.hbm_bytes/2**30:8.2f}GiB  "
              f"resident/dev={c.part_bytes/2**30:6.2f}GiB")
    for i, load in enumerate(loads):
        bar = "#" * int(40 * load / peak)
        print(f"  slice {i}: modeled {load/2**30:10.2f}GiB  "
              f"util={load/peak:5.1%}  {bar}")
    rec = {
        "case": f"{name}{tag}-slices{n_slices}",
        "mesh": "16x16",
        "n_slices": n_slices,
        "wire": wire,
        "decisions": [{**d, "label": labels[d["cursor"]]}
                      for d in sched.decisions()],
        "slice_loads": loads,
        "slice_utilization": [load / peak for load in loads],
    }
    os.makedirs(ARTIFACT_DIR, exist_ok=True)
    with open(os.path.join(ARTIFACT_DIR, f"{rec['case']}__16x16.json"), "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None):
    from repro_torch.launch.mesh import fake_process_group

    ap = argparse.ArgumentParser()
    ap.add_argument("--wire", choices=["int32", "int16"], default="int32")
    ap.add_argument("--cand", type=int, default=None, help="candidate window")
    ap.add_argument("--tag", default="")
    ap.add_argument("--case", default=None)
    ap.add_argument("--split3", action="store_true")
    ap.add_argument("--mono-only", action="store_true")
    ap.add_argument("--slices", type=int, default=None,
                    help="print the part-parallel schedule table for the "
                         "3-part split across N mesh slices (planning only)")
    args = ap.parse_args(argv)

    with fake_process_group(WORLD_SIZE):
        for name, (n, m, t, kmax) in WORKLOADS.items():
            if args.case and args.case != name:
                continue
            if args.slices:
                run_slices(name, n, m, t, kmax, args.wire, args.slices, tag=args.tag)
                continue
            if args.split3:
                run_split3(name, n, m, t, kmax, args.wire, tag=args.tag)
                continue
            _alpha, buckets = powerlaw_bucket_rows(n, m)
            cand = args.cand or degseq_hindex(buckets)
            # Monolithic (PSGraph baseline).
            run_case(name, n, m, cand, args.wire, multi_pod=True, tag=args.tag + "-mono")
            if args.mono_only:
                continue
            # Rough-Divide at the paper's threshold: top part (deg >= t) and
            # the rest (modeled sizes: nodes with modeled degree >= t go to
            # the top).
            top_n = sum(r for w, r in buckets if w >= t)
            top_m = sum(r * min(w, 4 * t) for w, r in buckets if w >= t) // 2
            rest_n, rest_m = n - top_n, m - top_m
            run_case(f"{name}-top(t={t})", max(top_n, 1 << 20), max(top_m, 1 << 22),
                     min(cand, kmax * 2), args.wire, multi_pod=True, tag=args.tag)
            run_case(f"{name}-rest(t={t})", rest_n, rest_m, min(cand, t),
                     args.wire, multi_pod=True, tag=args.tag)


if __name__ == "__main__":
    main()
