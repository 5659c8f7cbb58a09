"""DC-kCore launcher of the PyTorch port -- the paper's workload as a CLI.

  python -m repro_torch.launch.kcore --graph rmat:18:16 --thresholds 16,64 --engine fused
  python -m repro_torch.launch.kcore --graph rmat:14:12 --reorder rcm --check
  python -m repro_torch.launch.kcore --graph er:2000:8 --device cpu --check
  python -m repro_torch.launch.kcore --graph rmat:12:8 --thresholds 16,4 \
      --checkpoint-dir ck --sweep-checkpoint-every 1 --resume --check
  python -m repro_torch.launch.kcore --graph file:/data/com-friendster.txt \
      --budget-gb 2 --strategy rough --edge-chunk 1048576 --overlap --check
  python -m repro_torch.launch.kcore --graph rmat:20:16 --thresholds 64,16 \
      --engine fused --part-parallel 2 --check
  torchrun --nproc-per-node 4 -m repro_torch.launch.kcore --graph rmat:16:16 \
      --thresholds 64,16 --part-parallel 2 --devices 4 --check

Graphs: ``rmat:<scale>:<edge_factor>``, ``ba:<n>:<m>``, ``er:<n>:<deg>``,
``file:<path>`` (SNAP edge list), ``npz:<path>`` (``graph.io.save_npz``;
either package's files load in the other).

``--edge-chunk N`` routes ingest through the streaming path: ``file:``
graphs are read in N-edge chunks and built via the spill-to-disk external
dedup (synthetic and ``npz:`` graphs are re-streamed through the same
builder), and the CLI reports the tracked peak transient host bytes next to
the in-memory loader's baseline. ``--overlap`` turns on the staged
pipeline: the next part's divide and bucketize run on a worker thread
(numpy only) and checkpoint saves go async while the current part sweeps;
coreness is byte-identical either way, and the summary reports the
device-idle fraction the flag exists to shrink and the prefetch hits and
misses. ``--part-parallel S`` conquers up to S parts at once per wave
(speculative shrink chain, validated in plan order; byte-identical
coreness): without ``--devices`` the slices are worker threads sharing
``--engine``, each on its own CUDA stream on the card. Slices are priced
against the memory budget: slice capacity defaults to ``--budget-gb``
(override with ``--slice-capacity-gb``), and a part that no slice admits
triggers a re-divide with smaller parts instead of aborting.
``--slice-timeout`` / ``--max-retries`` arm the wave watchdog: a crashed
part retries on its slice with backoff, and a slice that hangs past the
timeout (or runs out of retries) is blacklisted with its parts re-planned
over the survivors. ``--devices N`` runs the distributed engine (with the
counts kernel) over rank slices of a ``(N/mp, mp)`` data x model plan of
the process group (``mp = 2`` when ``N`` is divisible by ``2 S``), with the
E(v) boundary exchange over the ranks; start N ranks with ``torchrun``
(the group is initialized from ``env://`` over gloo unless the caller
initialized one; its world size must be N). ``--fault
site:kind[:at[:count[:delay]]]`` injects failures for chaos testing (sites:
slice_conquer, boundary_fold, checkpoint_save, prefetch; kinds: crash,
hang, slow); ``--fault-log FILE`` writes the run's fault event trail as
JSON.

``--device`` picks where the sweep runs (default ``cuda``; ``cpu`` runs the
kernels' plain PyTorch versions). ``--engine {sorted,count,kernel,fused}``
selects the conquer sweep engine -- ``fused`` is the single-kernel CUDA
sweep (gather + h-index + dirty push per bucket), ``kernel`` the CUDA
h-index over a gathered matrix -- and ``--int16`` opts the fused engine
into the halved-width estimate mode (falls back to int32 automatically when
any starting estimate reaches 2^15; coreness is bit-identical in every
case). ``--reorder {identity,bfs,rcm}`` applies a locality-aware node
ordering to each part before tiling (``--reorder-sample N`` computes it
from an N-slot edge sample); ``--max-bucket-rows`` overrides the tile
autotuner with a uniform row cap (``auto`` = degree-profile autotuner,
``none`` = one tile per degree class). ``--divide-chunk N`` sizes the
chunked divide passes. ``--checkpoint-dir`` saves the pipeline state after
every part (``--sweep-checkpoint-every K`` also snapshots the conquer
state every K sweeps), ``--resume`` re-enters at the first unfinished part
(or mid-part, at the last snapshot) and ``--ckpt-retain N`` keeps the N
newest steps; the format is the JAX package's, so either CLI resumes the
other's directory. ``--check`` compares with the BZ peeling oracle and
exits 1 on a mismatch. The summary ends with each kernel's launch count.
"""
from __future__ import annotations

import argparse
import json
import os
import time

from repro_torch.core.dckcore import dc_kcore
from repro_torch.core.divide import plan_thresholds
from repro_torch.core.partsched import SliceCapacityError
from repro_torch.graph import barabasi_albert, erdos_renyi, rmat
from repro_torch.graph.io import (
    csr_from_edge_chunks,
    graph_edge_chunks,
    load_edgelist,
    load_npz,
    stream_edgelist,
)
from repro_torch.graph.oracle import peel_coreness
from repro_torch.kernels.counts import partial_counts_op
from repro_torch.kernels.fused import fused_sweep_op
from repro_torch.kernels.hindex import hindex_op


def load_graph(spec: str, seed: int, edge_chunk: int | None = None):
    """Build the graph for ``spec`` (synthetic specs are numpy and seeded:
    the same graph as the JAX package builds from the same spec and seed).
    Returns ``(graph, ingest_stats)``; with ``edge_chunk`` set, ingest runs
    through the streaming builder and ``ingest_stats`` is its
    :class:`~repro_torch.graph.io.IngestStats`, else ``None``."""
    kind, _, rest = spec.partition(":")
    if kind == "file":
        if edge_chunk is not None:
            return stream_edgelist(rest, chunk_edges=edge_chunk)
        return load_edgelist(rest), None
    if kind == "rmat":
        scale, ef = (rest.split(":") + ["16"])[:2]
        g = rmat(int(scale), int(ef), seed=seed)
    elif kind == "ba":
        n, m = rest.split(":")
        g = barabasi_albert(int(n), int(m), seed=seed)
    elif kind == "er":
        n, d = rest.split(":")
        g = erdos_renyi(int(n), float(d), seed=seed)
    elif kind == "npz":
        g = load_npz(rest)
    else:
        raise ValueError(f"unknown graph spec {spec}")
    if edge_chunk is not None:
        # Re-stream the in-memory graph through the chunked builder so the
        # streaming path (and its resident-bytes accounting) is exercised
        # for synthetic specs too.
        return csr_from_edge_chunks(
            graph_edge_chunks(g, edge_chunk), n_nodes=g.n_nodes,
            chunk_edges=edge_chunk,
        )
    return g, None


def run_with_capacity_replan(
    g,
    thresholds,
    *,
    replan_budget_bytes=None,
    max_replans=3,
    dc=dc_kcore,
    **dc_kwargs,
):
    """Run ``dc_kcore``; on :class:`SliceCapacityError`, re-divide and retry.

    The wave scheduler refuses a part whose modeled resident bytes exceed
    every slice's capacity. Then the thresholds are re-planned for a smaller
    per-part budget (halved each attempt, with a proportionally larger part
    allowance), so the oversized part is split, and the run starts over.
    The shrink starts from the smaller of ``replan_budget_bytes`` and the
    wave's ``slice_capacity_bytes`` (the constraint that tripped).
    ``resume`` is forced off on retries: the aborted attempt's checkpoints
    describe another partition. Re-raises after ``max_replans`` re-divides,
    or at once when no ``replan_budget_bytes`` is known.

    Returns ``(core, report, thresholds, n_replans)`` with the thresholds
    that completed.
    """
    attempt = 0
    while True:
        try:
            core, report = dc(g, thresholds=thresholds, **dc_kwargs)
            return core, report, thresholds, attempt
        except SliceCapacityError as exc:
            attempt += 1
            if replan_budget_bytes is None or attempt > max_replans:
                raise
            base = int(replan_budget_bytes)
            cap = dc_kwargs.get("slice_capacity_bytes")
            if cap is not None:
                base = min(base, int(cap))
            shrunk = max(1, base >> attempt)
            thresholds = plan_thresholds(
                g.degrees, shrunk, max_parts=8 * (1 << attempt)
            )
            print(f"slice capacity exceeded ({exc}); re-divided for "
                  f"{shrunk / 2**30:.3f} GB/part -> thresholds {thresholds} "
                  f"(retry {attempt}/{max_replans})")
            dc_kwargs["resume"] = False


def rank_mesh_plan(n_devices: int, n_slices: int, device: str):
    """The ``--devices`` plan: a ``(N/mp, mp)`` data x model plan over the
    process group (``mp = 2`` when ``N`` is divisible by ``2 S``, so the
    data axis still splits into ``S`` slices), initialized from ``env://``
    over gloo unless the caller initialized it already."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh_plan

    if not dist.is_initialized():
        dist.init_process_group("gloo", init_method="env://")
    if dist.get_world_size() != n_devices:
        raise ValueError(f"--devices {n_devices} needs a process group of "
                         f"{n_devices} ranks (torchrun --nproc-per-node "
                         f"{n_devices}), got {dist.get_world_size()}")
    if torch.device(device).type == "cuda" and torch.cuda.is_available():
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", dist.get_rank()))
                              % torch.cuda.device_count())
    mp = 2 if n_devices % (2 * n_slices) == 0 else 1
    return make_mesh_plan((n_devices // mp, mp), ("data", "model"))


def parse_max_bucket_rows(v: str):
    """argparse type for --max-bucket-rows: "auto" | "none" -> None | int."""
    if v == "auto":
        return "auto"
    if v == "none":
        return None
    try:
        return int(v)
    except ValueError:
        raise argparse.ArgumentTypeError(f"expected 'auto', 'none' or an int, got {v!r}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--graph", default="rmat:14:16")
    ap.add_argument("--thresholds", default="", help="comma list; empty = monolithic")
    ap.add_argument("--budget-gb", type=float, default=None,
                    help="auto-plan thresholds for this per-part budget")
    ap.add_argument("--strategy", choices=["rough", "exact"], default="rough")
    ap.add_argument("--reorder", choices=["identity", "bfs", "rcm"], default="identity",
                    help="locality-aware node ordering applied per part")
    ap.add_argument("--reorder-sample", type=int, default=None, metavar="SLOTS",
                    help="compute the ordering from an edge sample of this "
                         "many slots instead of the full CSR traversal")
    ap.add_argument("--engine", choices=["sorted", "count", "kernel", "fused"],
                    default="sorted",
                    help="conquer sweep engine (fused = single-kernel CUDA "
                         "sweep; kernel = CUDA h-index)")
    ap.add_argument("--int16", action="store_true",
                    help="fused engine only: int16 estimate vector "
                         "(overflow-guarded int32 fallback; bit-identical "
                         "coreness)")
    ap.add_argument("--max-bucket-rows", type=parse_max_bucket_rows, default="auto",
                    help='tile row cap: "auto" (degree-profile autotuner), '
                         '"none" (one tile per degree class) or an int')
    ap.add_argument("--edge-chunk", type=int, default=None, metavar="EDGES",
                    help="stream ingest in chunks of this many edges "
                         "(bounded-transient spill-to-disk CSR build)")
    ap.add_argument("--divide-chunk", type=int, default=None, metavar="SLOTS",
                    help="chunk budget (adjacency slots) of the divide "
                         "passes; default = the built-in bounded budget")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="save pipeline state here after every part")
    ap.add_argument("--sweep-checkpoint-every", type=int, default=None,
                    metavar="K",
                    help="also snapshot the conquer state every K sweeps "
                         "(mid-part resume; requires --checkpoint-dir)")
    ap.add_argument("--resume", action="store_true",
                    help="resume from --checkpoint-dir at the first "
                         "unfinished part (or mid-part, at the last "
                         "completed sweep snapshot)")
    ap.add_argument("--overlap", action=argparse.BooleanOptionalAction,
                    default=False,
                    help="pipeline the stages: prefetch the next part's "
                         "divide on a worker thread and make checkpoint "
                         "saves async while the current part sweeps "
                         "(byte-identical coreness either way)")
    ap.add_argument("--part-parallel", type=int, default=None, metavar="S",
                    help="conquer up to S parts concurrently per wave "
                         "(speculative shrink chain, validated in plan "
                         "order; byte-identical coreness). Without "
                         "--devices the slices are worker threads sharing "
                         "--engine, each on its own CUDA stream")
    ap.add_argument("--slice-capacity-gb", type=float, default=None,
                    metavar="GB",
                    help="cap each part-parallel slice's modeled resident "
                         "bytes (default: the --budget-gb value; requires "
                         "--part-parallel)")
    ap.add_argument("--slice-timeout", type=float, default=None, metavar="S",
                    help="declare a part-parallel slice dead when its "
                         "sweep heartbeat stalls this many seconds "
                         "(blacklist + re-plan over the survivors; "
                         "requires --part-parallel)")
    ap.add_argument("--max-retries", type=int, default=None, metavar="N",
                    help="retry a crashed part on its slice up to N times "
                         "with exponential backoff before blacklisting "
                         "the slice (requires --part-parallel)")
    ap.add_argument("--devices", type=int, default=None, metavar="N",
                    help="run the distributed engine (counts kernel) over "
                         "N ranks (torchrun) split into --part-parallel "
                         "rank slices, with the E(v) boundary exchange over "
                         "the ranks (requires --part-parallel; N must be "
                         "divisible by S)")
    ap.add_argument("--ckpt-retain", type=int, default=2, metavar="N",
                    help="keep the N newest boundary/sweep checkpoint "
                         "steps (default 2: a corrupted latest step falls "
                         "back to its predecessor on --resume)")
    ap.add_argument("--fault", action="append", default=[], metavar="SPEC",
                    help="inject a failure: site:kind[:at[:count[:delay]]] "
                         "(repeatable; chaos testing)")
    ap.add_argument("--fault-log", default=None, metavar="FILE",
                    help="write the fault event trail as JSON")
    ap.add_argument("--device", default="cuda",
                    help="where the sweep runs: cuda (default) or cpu")
    ap.add_argument("--check", action="store_true", help="verify vs BZ peeling")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.resume and args.checkpoint_dir is None:
        ap.error("--resume requires --checkpoint-dir")
    if args.sweep_checkpoint_every is not None and args.checkpoint_dir is None:
        ap.error("--sweep-checkpoint-every requires --checkpoint-dir")
    if args.int16 and args.engine != "fused":
        ap.error("--int16 requires --engine fused")
    if args.devices is not None and args.part_parallel is None:
        ap.error("--devices requires --part-parallel")
    if args.part_parallel is not None and args.overlap:
        ap.error("--part-parallel subsumes --overlap (the wave IS the "
                 "speculation) — pass one or the other")
    if args.devices is not None and args.engine != "sorted":
        ap.error("--devices selects the distributed engine; drop --engine")
    if args.slice_capacity_gb is not None and args.part_parallel is None:
        ap.error("--slice-capacity-gb requires --part-parallel")
    if (args.slice_timeout is not None or args.max_retries is not None) \
            and args.part_parallel is None:
        ap.error("--slice-timeout/--max-retries configure the part-parallel "
                 "watchdog; they require --part-parallel")
    if args.ckpt_retain < 1:
        ap.error("--ckpt-retain must be >= 1")

    fault_plan = None
    if args.fault:
        from repro_torch.runtime import FaultPlan

        try:
            fault_plan = FaultPlan.parse(args.fault)
        except ValueError as e:
            ap.error(str(e))

    part_parallel_plan = None
    if args.devices is not None:
        part_parallel_plan = rank_mesh_plan(args.devices, args.part_parallel, args.device)

    t0 = time.perf_counter()
    g, ingest = load_graph(args.graph, args.seed, edge_chunk=args.edge_chunk)
    ingest_s = time.perf_counter() - t0
    print(f"graph: n={g.n_nodes:,} m={g.n_edges:,} max_deg={int(g.degrees.max())}")
    if ingest is not None:
        print(f"ingest (streamed, {ingest_s:.2f}s): chunk={ingest.chunk_edges:,} edges, "
              f"{ingest.n_chunks} chunks, {ingest.n_bins} dedup bins, "
              f"spill={ingest.spill_bytes/2**20:.1f} MiB; "
              f"peak transient {ingest.peak_transient_bytes/2**20:.2f} MiB "
              f"vs in-memory baseline {ingest.baseline_transient_bytes/2**20:.2f} MiB "
              f"(output CSR {ingest.output_bytes/2**20:.2f} MiB)")
    budget_bytes = (
        int(args.budget_gb * 2**30) if args.budget_gb is not None else None
    )
    if budget_bytes is not None:
        thresholds = plan_thresholds(g.degrees, budget_bytes)
        print(f"planned thresholds for {args.budget_gb} GB/part: {thresholds}")
    else:
        thresholds = [int(t) for t in args.thresholds.split(",") if t]

    # Price the part-parallel slices against the real budget: an oversized
    # part then fails the assignment at planning time (SliceCapacityError,
    # a re-divide below) instead of running out of memory mid-wave.
    slice_capacity_bytes = None
    if args.part_parallel is not None:
        if args.slice_capacity_gb is not None:
            slice_capacity_bytes = int(args.slice_capacity_gb * 2**30)
        elif budget_bytes is not None:
            slice_capacity_bytes = budget_bytes

    counters = (fused_sweep_op, hindex_op, partial_counts_op)
    launches0 = [op.launches for op in counters]
    core, report, thresholds, n_replans = run_with_capacity_replan(
        g, thresholds,
        replan_budget_bytes=budget_bytes,
        strategy=args.strategy,
        reorder=args.reorder,
        reorder_sample_edges=args.reorder_sample,
        max_bucket_rows=args.max_bucket_rows,
        divide_chunk=args.divide_chunk,
        engine=args.engine, int16=args.int16, device=args.device,
        checkpoint_dir=args.checkpoint_dir,
        resume=args.resume,
        sweep_checkpoint_every=args.sweep_checkpoint_every,
        ckpt_retain=args.ckpt_retain,
        overlap=args.overlap,
        part_parallel=args.part_parallel,
        part_parallel_plan=part_parallel_plan,
        slice_capacity_bytes=slice_capacity_bytes,
        slice_timeout_s=args.slice_timeout,
        max_retries=args.max_retries,
        fault_plan=fault_plan,
    )
    if n_replans:
        print(f"capacity re-divides: {n_replans} (final thresholds "
              f"{thresholds})")
    print(f"\nDC-kCore done in {report.total_time_s:.2f}s "
          f"(preprocess {report.preprocess_time_s:.2f}s, engine={args.engine}"
          f"{'+int16' if args.int16 else ''}, reorder={args.reorder}, "
          f"overlap={'on' if report.overlap else 'off'}, device={args.device})")
    print(f"device idle fraction: {report.idle_fraction:.3f} "
          f"(sweeping {report.total_decompose_time_s:.2f}s of "
          f"{report.total_time_s:.2f}s wall)")
    if report.overlap:
        print(f"prefetch: {report.prefetch_hits} hit(s), "
              f"{report.prefetch_misses} miss(es) recomputed")
    if report.part_parallel:
        util = "/".join(f"{u:.2f}" for u in report.slice_utilization)
        print(f"part-parallel: {report.part_parallel} slice(s), wave wall "
              f"{report.conquer_wall_s:.2f}s, slice utilization [{util}], "
              f"{report.prefetch_hits} speculation hit(s), "
              f"{report.prefetch_misses} miss(es), "
              f"{report.speculation_discards} conquer(s) discarded, "
              f"boundary-exchange bytes = {report.boundary_exchange_bytes:,}")
    if (report.retries or report.blacklisted_slices or report.degraded_waves
            or report.quarantined_steps):
        bl = ",".join(str(s) for s in report.blacklisted_slices) or "-"
        print(f"fault tolerance: {report.retries} part retr"
              f"{'y' if report.retries == 1 else 'ies'}, "
              f"blacklisted slices [{bl}], "
              f"{report.degraded_waves} degraded wave(s), "
              f"{report.quarantined_steps} quarantined checkpoint step(s)")
    if args.fault_log:
        events = list(report.fault_events)
        if fault_plan is not None:
            events += [e for e in fault_plan.events if e not in events]
        with open(args.fault_log, "w") as f:
            json.dump({"events": events}, f, indent=2, default=str)
        print(f"fault-event log: {len(events)} event(s) -> {args.fault_log}")
    if report.resumed_parts:
        print(f"resumed: {report.resumed_parts} part(s) restored from "
              f"{args.checkpoint_dir}, not re-run")
    for p in report.parts:
        if p.resumed_at_sweep:
            print(f"resumed mid-part: {p.name} warm-restarted at sweep "
                  f"{p.resumed_at_sweep} from a sweep snapshot")
    print(f"k_max = {int(core.max())}, total comm = {report.total_comm:,} updates, "
          f"peak part bytes = {report.peak_bytes/2**20:.1f} MiB")
    print(f"sweep work (frontier): {report.total_gathered_rows:,} gathered rows "
          f"vs {report.total_full_sweep_rows:,} full-sweep rows; "
          f"measured collective bytes = {report.total_collective_bytes:,}")
    if args.checkpoint_dir:
        print(f"checkpoint saves: blocked {report.total_save_time_s:.3f}s, "
              f"completed writes {report.total_save_wall_s:.3f}s "
              f"({args.checkpoint_dir})")
    for p in report.parts:
        print(f"  part {p.name:>10}: n={p.n_nodes:>9,} m={p.n_edges:>11,} "
              f"iters={p.iterations:>3} comm={p.comm_amount:>10,} "
              f"work={p.gathered_rows:>10,}/{p.full_sweep_rows:<10,} "
              f"adj_density={p.bitmap_density:.3f} "
              f"divide_peak={p.divide_transient_bytes/2**20:.2f}MiB "
              f"save_s={p.save_time_s:.3f} save_wall_s={p.save_wall_s:.3f} "
              f"finalized={p.finalized:,}"
              + (f" slice={p.slice_index} wave={p.wave} "
                 f"modeled={p.modeled_cost_bytes:,}B"
                 if p.slice_index >= 0 else "")
              + (" [prefetched]" if p.prefetched else ""))
    launched = [op.launches - n0 for op, n0 in zip(counters, launches0)]
    print(f"kernel launches: fused_sweep={launched[0]:,} hindex={launched[1]:,} "
          f"partial_counts={launched[2]:,}")
    if args.check:
        t0 = time.perf_counter()
        oracle = peel_coreness(g)
        ok = bool((core == oracle).all())
        print(f"oracle check ({time.perf_counter()-t0:.1f}s): {'CONSISTENT' if ok else 'MISMATCH'}")
        if not ok:
            raise SystemExit(1)


if __name__ == "__main__":
    main()
