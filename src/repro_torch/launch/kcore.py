"""DC-kCore launcher of the PyTorch port -- the paper's workload as a CLI.

  python -m repro_torch.launch.kcore --graph rmat:18:16 --thresholds 16,64 --engine fused
  python -m repro_torch.launch.kcore --graph rmat:14:12 --reorder rcm --check
  python -m repro_torch.launch.kcore --graph er:2000:8 --device cpu --check
  python -m repro_torch.launch.kcore --graph rmat:12:8 --thresholds 16,4 \
      --checkpoint-dir ck --sweep-checkpoint-every 1 --resume --check
  python -m repro_torch.launch.kcore --graph file:/data/com-friendster.txt \
      --budget-gb 2 --strategy rough --edge-chunk 1048576 --overlap --check

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
misses. ``--fault site:kind[:at[:count[:delay]]]`` injects failures for
chaos testing (sites: boundary_fold, checkpoint_save, prefetch; kinds:
crash, hang, slow); ``--fault-log FILE`` writes the run's fault event
trail as JSON. The part-parallel flags of the JAX CLI are not ported yet
(``ROADMAP.md``, queue 1, item 7).

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
import time

from repro_torch.core.dckcore import dc_kcore
from repro_torch.core.divide import plan_thresholds
from repro_torch.graph import barabasi_albert, erdos_renyi, rmat
from repro_torch.graph.io import (
    csr_from_edge_chunks,
    graph_edge_chunks,
    load_edgelist,
    load_npz,
    stream_edgelist,
)
from repro_torch.graph.oracle import peel_coreness
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
    if args.ckpt_retain < 1:
        ap.error("--ckpt-retain must be >= 1")

    fault_plan = None
    if args.fault:
        from repro_torch.runtime import FaultPlan

        try:
            fault_plan = FaultPlan.parse(args.fault)
        except ValueError as e:
            ap.error(str(e))

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
    if args.budget_gb is not None:
        thresholds = plan_thresholds(g.degrees, int(args.budget_gb * 2**30))
        print(f"planned thresholds for {args.budget_gb} GB/part: {thresholds}")
    else:
        thresholds = [int(t) for t in args.thresholds.split(",") if t]

    launches0 = (fused_sweep_op.launches, hindex_op.launches)
    core, report = dc_kcore(
        g, thresholds,
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
        fault_plan=fault_plan,
    )
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
    if report.quarantined_steps:
        print(f"checkpoint integrity: {report.quarantined_steps} quarantined "
              f"checkpoint step(s)")
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
              + (" [prefetched]" if p.prefetched else ""))
    print(f"kernel launches: fused_sweep={fused_sweep_op.launches - launches0[0]:,} "
          f"hindex={hindex_op.launches - launches0[1]:,}")
    if args.check:
        t0 = time.perf_counter()
        oracle = peel_coreness(g)
        ok = bool((core == oracle).all())
        print(f"oracle check ({time.perf_counter()-t0:.1f}s): {'CONSISTENT' if ok else 'MISMATCH'}")
        if not ok:
            raise SystemExit(1)


if __name__ == "__main__":
    main()
