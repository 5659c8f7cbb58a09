#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. It needs one CUDA device and ``nvcc``,
and fails (non-zero exit, no result line) without them. Phases:

1. The card's name and power limit (``nvidia-smi``), then the build of
   every CUDA kernel from ``src/repro_torch/kernels/csrc`` (one ``nvcc``
   per source, all started together).
2. Each kernel against its plain PyTorch version, on the card, at every
   tile shape of the main path -- the 57 tiles ``bucketize`` cuts from
   ``rmat(20, 16, seed=0)`` (widths 8 ... 65,536), candidate window 1389 --
   on two states: the start state ``deg + ext`` and the state after three
   sweeps. The fused kernel runs with int32 and int16 estimates (the int16
   states saturate at 2^15 - 1, a valid upper bound the engine could
   resume from) and with the dirty push on and off. Tolerance: exact
   equality (all values are integers). The fused and h-index kernels (one
   launch plan) run each tile by its own plan and, for tiles wider than
   1,024, also by one block per row and by the exact search, so every path
   and the cluster split are compared. Then each kernel's device time for
   one full sweep (one launch per tile, one memset of the dirty buffer),
   its plain version's time and the least time the card could take for
   the same work; the fused kernel's full sweep with the push on and off
   at both states; its per-width table (each tile alone: push on and off,
   and the h-index kernel on the same rows gathered beforehand); the wide
   tiles' planned launch against one block per row and the exact search,
   for both kernels.
3. The main path: ``dc_kcore`` on ``rmat(20, 16, seed=0)`` with the rough
   thresholds (64, 16) and monolithic, through the fused engine in int32
   and int16 and through the h-index kernel engine, plus one run of the
   fused compaction dispatch. Every run's coreness must equal the
   Batagelj-Zaversnik peeling oracle. The kernels' launch counters are
   zeroed just before and read just after, and each engine's kernel must
   have launched.
4. The partial-counts kernel of the distributed engine against its plain
   version at the same 57 tile shapes and two states, with each tile's
   neighbour slots whole (one slot shard) and split in two halves (two
   slot shards, whose counts must also add up to the whole's), by each
   shard's own launch plan and every other path that covers it (step,
   warp, one block a row, the cluster split); exact equality. Then its
   device time for one full sweep, per width class, its plain version's
   time and its bound.
5. The distributed main path on one rank: ``dc_kcore`` through
   ``make_distributed_decompose`` on a 1x1 plan with the counts kernel, at
   ``rmat(20, 16, seed=0)`` with the thresholds (64, 16) and monolithic.
   Every run must equal the oracle; the counts
   kernel's launch counter is zeroed just before and read just after, and
   must be above 0. Then the monolithic run through
   ``decompose_distributed`` with the engine's dirty push, the flat
   max-scatter over every slot and the boolean-mask index, in turns: the
   same trajectory, and each form's wall.
6. Four ranks on the one card: four processes (this script with
   ``--fleet-rank``), gloo over a ``file://`` store, CUDA tensors, a
   (2, 2) data x model plan, on ``rmat(16, 16, seed=0)`` written by this
   process, after its one-rank run with the counts kernel and one without
   it, which must take the same per-sweep trajectories (this check ran at
   ``rmat(20, 16)`` until the serve phase needed the time).
   ``dc_kcore`` with the thresholds and the counts kernel must
   equal the oracle and the one-rank run's trajectories; a
   ``frontier=False`` run's collective bytes must equal the planned
   schedule. Then the same ranks run part-parallel rank slices: the plan
   split into two slices of two ranks, ``part_parallel=2`` (Exact-Divide),
   the counts kernel, with the E(v) boundary exchange over all four ranks;
   every rank must equal the one-rank run and the oracle, both slices must
   conquer parts, the exchange must move bytes, and the counts kernel must
   launch on every rank (its counter zeroed just before the run). Any
   rank's failure fails the smoke. gloo moves the collectives through host
   memory: these are not NCCL or NVLink times.
7. Crash and resume on ``rmat(16, 16)``, one rank, counts kernel: snapshots
   every sweep, a crash raised at the second snapshot save, a resume that
   must restart mid-part and reach the uninterrupted run's coreness.
8. Out-of-core ingest of ``rmat(20, 16, seed=0)``: the graph re-streamed
   through ``graph_edge_chunks`` -> ``csr_from_edge_chunks`` (2^20-edge
   chunks, a spill directory) must give the in-memory CSR bit for bit, with
   ``IngestStats``' transient and resident bytes printed; ``save_npz`` /
   ``load_npz`` round trip; the SNAP text path ``save_edgelist`` ->
   ``stream_edgelist``, bit-identical too, at ``rmat(16, 16)`` (it parses
   one line at a time in Python: 68 s at ``rmat(20, 16)`` on the card's
   host).
9. The overlapped pipeline: ``dc_kcore`` on ``rmat(20, 16)`` with the
   thresholds (64, 16) and the fused engine, Rough- and Exact-Divide, with
   ``overlap`` off and on; coreness byte-identical between the two and
   equal to the oracle, no prefetch miss under Exact-Divide, and one
   overlapped run with a checkpoint directory (async saves) whose latest
   checkpoint restores to the same coreness. Wall and sweeping time, the
   device-idle fraction and the prefetch hits and misses are printed.
10. Incremental serving on ``rmat(20, 16)``: an edit log of 8 sealed batches
    of 2,048 uniform inserts and 2,048 deletes of existing edges, one batch
    of 1 insert and one batch of 4,096 + 4,096 (past the dirty budget),
    written batch by batch while this process replays it through
    ``apply_updates`` with the fused engine; side by side, a second thread
    replays it with the h-index engine and the serve CLI (``python -m
    repro_torch.launch.kcore_serve --device cuda``) tails it in a
    subprocess. Each batch must equal a from-scratch fused decompose, the
    final graph the oracle; both update modes must occur and the kernels'
    launch counters move on the update path (the CLI reports its own).
    The replays share the host's cores and the card, so their per-batch
    times are taken under that load. One incremental re-sweep's starting
    state is captured, and the fused and h-index kernels are held against
    their plain versions on every tile at that state. Per batch: mode,
    dirty fraction and the split into splice, region BFS, bucketize and
    re-sweep; the CLI's updates/s, query p50/p99 and staleness.
11. Part-parallel conquer. Stream slices on ``rmat(20, 16)`` with the
    thresholds (64, 16): ``dc_kcore(engine="fused", part_parallel=S)``,
    Rough and Exact, S = 2 and 3, and ``engine="kernel"`` at S = 2; each
    coreness byte-identical to phase 3's sequential run and equal to the
    oracle, no speculation miss under Exact, each slice's parts on that
    slice's own CUDA stream (recorded inside the worker) and each slice's
    launches counted (the counters zeroed just before each run and read
    just after); wall against phase 9's sequential runs, the wave wall,
    per-slice busy seconds and utilization, the speculation counters. Then
    on ``rmat(16, 16)``: one injected ``slice_conquer`` crash (retried once),
    one injected hang (the watchdog blacklists its slice), both
    byte-identical to the sequential run, and a crash at the second sweep
    snapshot whose resume warm-restarts mid-part. Rank slices ran in phase
    6's fleet: the (2, 2) plan split into two slices of two ranks,
    ``part_parallel=2``, the counts kernel. Last, the CLI with
    ``--part-parallel 2 --check`` on phase 8's npz of ``rmat(20, 16)``.
12. The dry-run. (a) ``python -m repro_torch.launch.kcore_dryrun`` with
    ``--wire int16``, ``--split3 --wire int16`` and ``--slices 4``, each a
    child process with its own fake 512-rank process group: the paper-scale
    records (memory model, the traced sweep's peak bytes, bytes, int32 ops,
    collectives and roofline on meta tensors), printed line by line; every
    case record must carry its memory model. (b) The tally against the
    card: one full sweep of the distributed engine (one rank, counts
    kernel) at ``rmat(20, 16)`` traced on meta tensors, and the same sweep
    on the card, whose ``max_memory_allocated`` above the baseline must lie
    within 20% of the traced peak; the tally's bytes and roofline beside
    the card's sweep time (CUDA events). The counts kernel's counter is
    zeroed just before the card's sweep and read just after. (c) The three
    k-core examples (``examples/torch/*.py --device cuda``) as child
    processes, each to its oracle line. The dry-run children run beside
    (b) and (c); they touch no GPU.
13. The LM serving path (``repro_torch.models``, ``runtime/serve_loop.py``,
    ``launch/serve.py``), with the k-core kernels' counters zeroed just
    before and read just after (they must stay 0: the path's products and
    attention are torch matmuls, with no Pallas counterpart). (a) qwen3-8b
    at its published widths and depth (8.19 B parameters, f32, drawn on the
    card from seed 0), bf16 activations: a 4 x 512-token prompt and 64
    greedy tokens after a 4-token warm-up call; every logit finite, every
    token in the vocab; the prefill time, the median decode time a token,
    tokens/s and ``max_memory_allocated`` beside their bounds, and one
    decode step and one prefill under ``torch.profiler`` (device busy time,
    kernel count, idle share, costliest kernels). (b) The same parameters
    with f32 activations and TF32 off: 16 teacher-forced decode steps after
    a 32-token prefill against one forward over the same tokens, within the
    reference's decode tolerance (atol 2e-3, rtol 1e-3). (c) mamba2-130m at
    its published widths (in f32) and every architecture's smoke config:
    the card against the CPU on the same parameters (every cross gate 0.5),
    logits within atol 1e-4 and rtol 1e-4, or the CPU's own movement under
    a one-ulp change of the parameters where larger, and 8 greedy tokens
    equal wherever the CPU's top-two margin exceeds 1e-3. (d) ``python -m
    repro_torch.launch.serve --arch qwen3-8b`` as a child process.
14. The LM training path (``repro_torch.optim``, ``repro_torch.data``,
    remat, ``runtime/train_loop.py``, ``launch/steps.py``,
    ``launch/train.py``), with the k-core kernels' counters zeroed just
    before and read just after (they must stay 0: no Pallas counterpart).
    (a) granite-3-2b at its published widths and depth (2.53 B f32
    parameters drawn on the card from seed 0), bf16 activations, AdamW with
    warmup-cosine, clip 1.0 and full remat through ``step_fn_for("train")``,
    ``SyntheticTokens`` at batch 4 x 1,024, 6 steps: each step's time, loss
    and grad norm (all finite), the median of steps 3-6, tokens/s,
    ``max_memory_allocated`` and the bound (8 N tokens at 989 TFLOP/s plus
    AdamW's bytes at 3.35 TB/s); four more steps with deterministic mode
    off, on, on, off; one step under ``torch.profiler`` (kernels and host
    ops); the same batch's gradients twice with deterministic mode off and
    on (on: bit-identical); a forward alone and the optimizer alone. (b)
    The card against the CPU from the same parameters, with the CPU tests'
    schedule and data, 5 steps: granite-3-2b's smoke config with AdamW and
    grok-1-314b's with Adafactor (bf16 parameters); losses within rtol 1e-4
    and parameters by ``models/parity.py::train_param_agreement``. (c) On
    the card, granite smoke: a crash at step 8 after a step-5 checkpoint,
    resumed to step 12, bit-identical to an uninterrupted run. (d) ``python
    -m repro_torch.launch.train --arch mamba2-130m --steps 20 --batch 4
    --seq 512`` (published widths) and ``examples/torch/train_lm.py``
    (which must print that the loss decreased) as child processes.
15. The kernel table as one JSON line, then the result line (printed
    last, after phase 16).
16. The LM dry-run against the card (``launch/dryrun.py``'s tally, one
    rank, no mesh): phase 14(a)'s granite-3-2b train step and phase 13(a)'s
    qwen3-8b prefill and decode step traced on meta tensors; for each, the
    traced peak bytes against the card's ``max_memory_allocated``, the
    traced FLOPs against ``flops_model.cost(..., n_chips=1)`` (within rel
    0.15, asserted) and the FLOP roofline's time against the card's time;
    the traced peak must hold the resident parameters (train: with
    gradients and AdamW state).

Nothing here imports JAX or the JAX package (``src/repro``).
"""
from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

SCALE, EDGE_FACTOR, SEED = 20, 16, 0
THRESHOLDS = (64, 16)
SMALL_SCALE = 16  # rmat(16, 16, seed=0): the four-rank and crash-resume phases
FLEET_SHAPE, FLEET_AXES = (2, 2), ("data", "model")
FLEET_TIMEOUT_S = 600
# Phase 10's edit batches (inserts, deletes). At rmat(20,16) a 2,048 +
# 2,048 batch already floods a dirty region of 0.62 of the nodes (past the
# 0.5 budget: a full re-sweep), so the last batch, twice that, is sure to;
# the single insert takes the incremental path.
SERVE_BATCHES = [(2048, 2048)] * 8 + [(1, 0), (4096, 4096)]
SLEEP_CYCLES = 20_000_000  # ~10 ms at 1.98 GHz: the host enqueues a whole sweep meanwhile


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def device_time_ms(torch, fn, reps: int) -> float:
    """Median milliseconds of ``fn()`` between two CUDA events. A sleep
    kernel holds the stream while the host enqueues ``fn``'s launches, so
    for a run of kernels the events bracket device work, not launch
    overhead; work paced by the host (the plain versions) is timed as it
    runs."""
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run it from the "
              f"root of a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.core.dckcore import dc_kcore
    from repro_torch.core.decompose import decompose
    from repro_torch.core.hindex import hindex_of_sequence
    from repro_torch.graph.build import bucketize
    from repro_torch.graph.generators import rmat
    from repro_torch.graph.oracle import peel_coreness
    from repro_torch.core.distributed import MeshPlan, make_distributed_decompose
    from repro_torch.kernels import build
    from repro_torch.kernels.counts import (counts_launch_plan, partial_counts_op,
                                            partial_counts_plain)
    from repro_torch.kernels.counts.ops import COUNTS_PATHS
    from repro_torch.kernels.fused import fused_launch_plan, fused_sweep_op, fused_sweep_plain
    from repro_torch.kernels.fused.ops import PATHS
    from repro_torch.kernels.hindex import hindex_op, hindex_plain
    from repro_torch.roofline import hw
    from repro_torch.roofline.kcore_model import roofline_time_s, sweep_cost

    dev = torch.device("cuda")
    t_all = time.perf_counter()

    # ---------------- phase 1: device, build ---------------- #
    card = nvidia_smi("name,power.limit")
    log(card)
    max_clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    int32_rate = hw.int32_ops_per_s(sms, max_clock_mhz * 1e6)
    log(f"device: {torch.cuda.get_device_name(0)}, {sms} SMs, max SM clock "
        f"{max_clock_mhz:.0f} MHz -> INT32 rate {int32_rate / 1e12:.2f} Tops/s; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    build_s = build.build()
    log(f"kernel build: {time.perf_counter() - t0:.1f}s wall "
        + ", ".join(f"{k}.cu {v:.1f}s" for k, v in build_s.items()))
    for name in build.SOURCES:
        spills = [l.strip() for l in build.ptxas_report(name).splitlines()
                  if "spill" in l and " 0 bytes spill stores" not in l]
        log(f"ptxas {name}.cu: {'spills: ' + '; '.join(spills) if spills else 'no spills'}")

    # ---------------- phase 2: kernels vs plain at main-path shapes ------- #
    t0 = time.perf_counter()
    g = rmat(SCALE, EDGE_FACTOR, seed=SEED)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    bg = bucketize(g)
    log(f"graph rmat({SCALE},{EDGE_FACTOR},seed={SEED}): n={g.n_nodes:,} "
        f"m={g.n_edges:,} max_deg={int(g.degrees.max()):,}; generated in "
        f"{gen_s:.1f}s, bucketized in {time.perf_counter() - t0:.1f}s into "
        f"{len(bg.buckets)} tiles, widths {sorted(set(bg.widths))}")
    n = bg.n_nodes
    cand = max(1, hindex_of_sequence(bg.degrees.astype("int64") + bg.ext))
    log(f"candidate window cand={cand}")
    tiles = [(torch.as_tensor(b.node_ids).to(dev), torch.as_tensor(b.neigh).to(dev))
             for b in bg.buckets]
    ext_pad = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    deg = torch.as_tensor(bg.degrees, dtype=torch.int32).to(dev)
    snaps = {}
    decompose(bg, op="fused", max_iter=3, device="cuda",
              on_sweep=lambda it, view: snaps.update({it: view}))
    states = {"start": deg, "sweep3": snaps[3]}

    def padded(state, dtype):
        s = state if dtype == torch.int32 else state.clamp(max=(1 << 15) - 1)
        return torch.cat([s, torch.full((1,), -1, dtype=torch.int32, device=dev)]).to(dtype)

    def fused_plans(rows, width):
        """The tile's own launch plan and, for a tile wider than a warp's
        path, also one block per row and the exact search: every path and
        cluster of the fused (and the h-index) kernel runs at the main
        path's shapes."""
        plans = [fused_launch_plan(rows, width, cand)]
        if width > 1024:
            plans += [fused_launch_plan(rows, width, cand, path="hist", cluster=1),
                      fused_launch_plan(rows, width, cand, path="search")]
        return list(dict.fromkeys(plans))

    def plan_label(plan):
        """(path, lanes a row) on the group path, else (path, cluster)."""
        return plan.path, plan.group if plan.path == "group" else plan.cluster

    max_err = {"fused": 0, "hindex": 0}
    checks = {"fused": 0, "hindex": 0}
    plans_hit = set()
    hindex_plans_hit = set()
    t0 = time.perf_counter()
    for sname, state in states.items():
        for dtype in (torch.int32, torch.int16):
            c = padded(state, dtype)
            for ids, neigh in tiles:
                for track in (True, False):
                    want = fused_sweep_plain(c, ext_pad, ids, neigh, cand=cand, track_dirty=track)
                    for plan in fused_plans(*neigh.shape):
                        got = fused_sweep_op(c, ext_pad, ids, neigh, cand=cand,
                                             track_dirty=track, plan=plan)
                        err = max(int((a.long() - b.long()).abs().max())
                                  for a, b in zip(got, want))
                        max_err["fused"] = max(max_err["fused"], err)
                        checks["fused"] += 1
                        plans_hit.add(plan_label(plan))
                        if err:
                            raise AssertionError(
                                f"fused kernel != plain: state {sname} {dtype} width "
                                f"{neigh.shape[1]} rows {neigh.shape[0]} track_dirty {track} "
                                f"plan {plan} max abs err {err}")
        # The h-index kernel launches by the fused kernel's plan: the same
        # plans, every path and the cluster split.
        c = padded(state, torch.int32)
        for ids, neigh in tiles:
            x = c[neigh]
            want = hindex_plain(x, ext_pad[ids], cand=cand)
            for plan in fused_plans(*neigh.shape):
                got = hindex_op(x, ext_pad[ids], cand=cand, plan=plan)
                err = int((got.long() - want.long()).abs().max())
                max_err["hindex"] = max(max_err["hindex"], err)
                checks["hindex"] += 1
                hindex_plans_hit.add(plan_label(plan))
                if err:
                    raise AssertionError(f"hindex kernel != plain: state {sname} width "
                                         f"{neigh.shape[1]} plan {plan} max abs err {err}")
    for name, hit in (("fused", plans_hit), ("hindex", hindex_plans_hit)):
        if ({path for path, _ in hit} != set(PATHS)
                or not any(path == "hist" and k > 1 for path, k in hit)):
            raise AssertionError(f"the {name} comparisons missed a path or the cluster "
                                 f"split: {sorted(hit)}")
    torch.cuda.synchronize()
    log(f"kernels vs plain versions: {checks['fused']} fused and {checks['hindex']} "
        f"hindex comparisons at all {len(tiles)} tile shapes (plans as (path, group or "
        f"cluster): fused {sorted(plans_hit)}, hindex {sorted(hindex_plans_hit)}), states "
        f"{list(states)}: max abs err fused={max_err['fused']} "
        f"hindex={max_err['hindex']} (tolerance 0) in {time.perf_counter() - t0:.1f}s")

    # Timing of one full sweep at the start state (int32, dirty push on). A
    # real sweep zeroes `dirty` once and then pushes every tile into it
    # (core/decompose.py), so every timed repetition zeroes it too: pushes
    # into bytes already 1 from an earlier repetition would time another
    # kernel.
    c = padded(states["start"], torch.int32)
    dirty = torch.zeros(n + 1, dtype=torch.int8, device=dev)
    gathered = [c[neigh] for _ids, neigh in tiles]
    ext_rows = [ext_pad[ids] for ids, _neigh in tiles]

    def fused_sweep_kernel(state_c=c, track=True):
        dirty.zero_()
        for ids, neigh in tiles:
            fused_sweep_op(state_c, ext_pad, ids, neigh, cand=cand, track_dirty=track,
                           dirty=dirty)

    def fused_sweep_plain_all():
        d = torch.zeros(n + 1, dtype=torch.int8, device=dev)
        for ids, neigh in tiles:
            fused_sweep_plain(c, ext_pad, ids, neigh, cand=cand, dirty=d)

    def hindex_kernel_all():
        for x, e in zip(gathered, ext_rows):
            hindex_op(x, e, cand=cand)

    def hindex_plain_all():
        for x, e in zip(gathered, ext_rows):
            hindex_plain(x, e, cand=cand)

    fused_sweep_kernel()  # warm-up
    hindex_kernel_all()
    fused_ms = device_time_ms(torch, fused_sweep_kernel, reps=7)
    hindex_ms = device_time_ms(torch, hindex_kernel_all, reps=7)
    fused_plain_ms = device_time_ms(torch, fused_sweep_plain_all, reps=3)
    hindex_plain_ms = device_time_ms(torch, hindex_plain_all, reps=3)

    # Least time for the same work: each input read once, each output
    # written once, over the HBM rate; one int32 compare per neighbour slot
    # (an h-index must look at every slot) over the INT32 rate.
    rows = sum(int(ids.numel()) for ids, _ in tiles)
    slots = sum(int(neigh.numel()) for _, neigh in tiles)
    dirty.zero_()
    fused_sweep_kernel()
    pushed = int((dirty > 0).sum())
    touched = int(torch.unique(torch.cat([nb.reshape(-1) for _, nb in tiles])).numel())
    fused_bytes = (slots * 4 + rows * 4 * 2 + touched * 4  # neigh, ids, ext; c entries read
                   + rows * 4 * 2 + pushed)                 # est, changed; dirty bytes set
    hindex_bytes = slots * 4 + rows * 4 + rows * 4
    fused_bound_ms = max(fused_bytes / hw.HBM_BW, slots / int32_rate) * 1e3
    hindex_bound_ms = max(hindex_bytes / hw.HBM_BW, slots / int32_rate) * 1e3
    fused_by = "bytes" if fused_bytes / hw.HBM_BW >= slots / int32_rate else "operations"
    hindex_by = "bytes" if hindex_bytes / hw.HBM_BW >= slots / int32_rate else "operations"
    shapes = [(b.n_rows, b.width) for b in bg.buckets]
    mb, mf = sweep_cost(shapes, cand, wire_bytes=4, fused=True, track_dirty=True)
    ub, uf = sweep_cost(shapes, cand, wire_bytes=4, fused=False, track_dirty=False)
    # kcore_model prices the TPU form's dense rows x width x cand compare at
    # the INT32 rate. The CUDA kernels search instead (about width x 11
    # compares a row), so this is the TPU form's work, not a bound on them.
    fused_model_ms = roofline_time_s(mb, mf, peak_ops=int32_rate) * 1e3
    hindex_model_ms = roofline_time_s(ub, uf, peak_ops=int32_rate) * 1e3
    # The same full sweep with the push off, and both at the sweep3 state:
    # their difference is what the push costs in a sweep, where later tiles
    # find bytes that earlier tiles already set.
    full_ms = {("start", True): fused_ms}
    for sname, state in states.items():
        c_s = padded(state, torch.int32)
        for track in (True, False):
            if (sname, track) not in full_ms:
                full_ms[sname, track] = device_time_ms(
                    torch, lambda: fused_sweep_kernel(c_s, track), reps=7)
    log("fused kernel, one full sweep with one memset of dirty (ms): " + ", ".join(
        f"{sname} push {'on' if track else 'off'} {t:.4f}"
        for (sname, track), t in full_ms.items()))
    log(f"one full sweep at the start state ({len(tiles)} launches, {rows:,} rows, "
        f"{slots:,} slots): fused kernel {fused_ms:.4f} ms (plain {fused_plain_ms:.2f} ms, "
        f"bound {fused_bound_ms:.4f} ms by {fused_by}); hindex kernel {hindex_ms:.4f} ms "
        f"(plain {hindex_plain_ms:.2f} ms, bound {hindex_bound_ms:.4f} ms by {hindex_by}); "
        f"no single PyTorch call computes an h-index, so there is no library time; "
        f"the TPU form's dense compare (kcore_model.sweep_cost) at the INT32 rate "
        f"would take fused {fused_model_ms:.4f} ms, hindex {hindex_model_ms:.4f} ms")

    # Per width class, at both states: the fused kernel with the dirty push
    # on and off, and the h-index kernel on the same rows gathered
    # beforehand. Each tile's launch is timed alone, with the memset of
    # `dirty` in the window as in a sweep; push = on - off, gather = off -
    # (memset + hindex in one window: the random reads of c that the h-index
    # kernel is spared). A window's fixed cost (a few us) is most of a
    # narrow tile's time alone, so the h-index kernel is also timed with the
    # class's tiles back to back, as in a sweep.
    memset_ms = device_time_ms(torch, dirty.zero_, reps=7)
    for sname, state in states.items():
        cs = padded(state, torch.int32)
        per_width = {}
        full = {True: 0.0, False: 0.0}
        for ids, neigh in tiles:
            w = int(neigh.shape[1])
            x, e = cs[neigh], ext_pad[ids]
            t = {}
            for track in (True, False):
                t[track] = device_time_ms(torch, lambda: (dirty.zero_(), fused_sweep_op(
                    cs, ext_pad, ids, neigh, cand=cand, track_dirty=track, dirty=dirty)),
                    reps=5)
                full[track] += t[track]
            hk = device_time_ms(torch, lambda: hindex_op(x, e, cand=cand), reps=5)
            hkm = device_time_ms(torch, lambda: (dirty.zero_(), hindex_op(x, e, cand=cand)),
                                 reps=5)
            acc = per_width.setdefault(w, [0, 0, 0.0, 0.0, 0.0, 0.0, []])
            acc[0] += 1
            acc[1] += int(neigh.shape[0])
            acc[2] += t[True]
            acc[3] += t[False]
            acc[4] += hk
            acc[5] += hkm
            acc[6].append((x, e))
        log(f"fused kernel per width class, state {sname} (int32; each tile's launch "
            f"timed alone with a {memset_ms:.4f} ms memset of dirty in the window; "
            f"push = on - off, gather = off - (memset + hindex)): sum over tiles push on "
            f"{full[True]:.4f} ms, push off {full[False]:.4f} ms")
        for w, (nt, nr, on, off, hk, hkm, xs) in sorted(per_width.items()):
            row = device_time_ms(torch, lambda: [hindex_op(x, e, cand=cand) for x, e in xs],
                                 reps=5)
            log(f"  fused {sname:>6} width {w:>6}: {nt:>2} tile(s) {nr:>8,} rows: push on "
                f"{on:.4f} ms, push off {off:.4f} ms, hindex {hk:.4f} ms alone, {row:.4f} ms "
                f"in a row; push {on - off:.4f} ms, gather {off - hkm:.4f} ms")

    # The wide tiles at the start state (int32, push on, memset in the
    # window): the planned launch against one block per row (the plan splits
    # a row over a cluster only where that is faster) and the exact search
    # (the earlier one-block binary search, with this kernel's push); the
    # same three for the h-index kernel on the rows gathered beforehand.
    for (ids, neigh), x, e in zip(tiles, gathered, ext_rows):
        rows_t, w = (int(v) for v in neigh.shape)
        if w <= 1024:
            continue
        wide_plans = [fused_launch_plan(rows_t, w, cand),
                      fused_launch_plan(rows_t, w, cand, path="hist", cluster=1),
                      fused_launch_plan(rows_t, w, cand, path="search")]
        times = [device_time_ms(torch, lambda: (dirty.zero_(), fused_sweep_op(
            c, ext_pad, ids, neigh, cand=cand, dirty=dirty, plan=plan)), reps=5)
            for plan in wide_plans]
        htimes = [device_time_ms(torch, lambda: hindex_op(x, e, cand=cand, plan=plan), reps=5)
                  for plan in wide_plans]
        log(f"  fused wide tile width {w:>6} rows {rows_t:>5}: planned "
            f"({plan_label(wide_plans[0])}) {times[0]:.4f} ms, one "
            f"block per row {times[1]:.4f} ms, exact search {times[2]:.4f} ms")
        log(f"  hindex wide tile width {w:>6} rows {rows_t:>5}: planned "
            f"({plan_label(wide_plans[0])}) {htimes[0]:.4f} ms, one "
            f"block per row {htimes[1]:.4f} ms, exact search {htimes[2]:.4f} ms")

    # ---------------- phase 3: the main path ---------------- #
    t0 = time.perf_counter()
    oracle = peel_coreness(g)
    log(f"peel_coreness oracle: k_max={int(oracle.max())} in {time.perf_counter() - t0:.1f}s")

    def engine(op, **kw):
        """The engine ``dc_kcore`` builds for ``engine=op``, recording the
        estimate dtype each part ran with (int16 falls back to int32 for a
        part whose start estimates reach 2^15)."""
        dtypes = []

        def fn(bg):
            res = decompose(bg, op=op, device="cuda", **kw)
            dtypes.append(res.est_dtype)
            return res
        return fn, dtypes

    runs = [
        ("fused int32", THRESHOLDS, engine("fused")),
        ("fused int32", (), engine("fused")),
        ("fused int16", THRESHOLDS, engine("fused", int16=True)),
        ("fused int16", (), engine("fused", int16=True)),
        ("kernel", THRESHOLDS, engine("kernel")),
        ("kernel", (), engine("kernel")),
        ("fused compaction", (), engine("fused", fused_compaction_min_tiles=1)),
    ]
    int16_parts = []
    seq = {}  # phase 3's sequential fused int32 run at THRESHOLDS: (wall, coreness)
    fused_sweep_op.launches = 0
    hindex_op.launches = 0
    for name, thresholds, (fn, dtypes) in runs:
        before = (fused_sweep_op.launches, hindex_op.launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        core, rep = dc_kcore(g, thresholds, decompose_fn=fn)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ok = bool((core == oracle).all())
        d_fused = fused_sweep_op.launches - before[0]
        d_hindex = hindex_op.launches - before[1]
        parts = [f"{p.name}:{dt}" for p, dt in zip(rep.parts, dtypes)]
        if name == "fused int16":
            int16_parts += [p for p in parts if p.endswith(":int16")]
        log(f"main path {name:>16} thresholds={list(thresholds)}: wall {wall:.2f}s "
            f"(sweeping {rep.total_decompose_time_s:.2f}s), sweeps "
            f"{rep.total_iterations}, total comm {rep.total_comm:,}, gathered rows "
            f"{rep.total_gathered_rows:,}, launches fused={d_fused:,} "
            f"hindex={d_hindex:,}, parts:estimate dtype {parts}: "
            f"{'CONSISTENT' if ok else 'MISMATCH'}")
        if not ok:
            raise AssertionError(f"main path {name} {thresholds}: coreness != oracle")
        if name == "fused int32" and thresholds == THRESHOLDS:
            seq["wall"], seq["core"] = wall, core
        if (d_hindex if name == "kernel" else d_fused) <= 0:
            raise AssertionError(f"main path {name}: its kernel was never launched")
        if len(dtypes) != len(rep.parts):
            raise AssertionError(f"main path {name}: {len(rep.parts)} parts but "
                                 f"{len(dtypes)} decompose calls")
    if not int16_parts:
        raise AssertionError("no part of the int16 runs ran with int16 estimates: "
                             "every part fell back to int32")
    launches = {"fused": fused_sweep_op.launches, "hindex": hindex_op.launches}
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")

    # ---------------- phase 4: the counts kernel vs plain ---------------- #
    def slot_shards(x, k):
        """The [rows, width / k] blocks of k slot shards (widths are powers
        of two, at least 8)."""
        w = x.shape[1] // k
        return [x[:, j * w:(j + 1) * w].contiguous() for j in range(k)]

    def counts_plans(rows, w):
        """The shard's own launch plan and every other path that covers it:
        the step and warp paths, and the histogram with one block a row and
        with its planned cluster."""
        plans = [counts_launch_plan(rows, w, cand)]
        for path, cluster in (("step", None), ("warp", None), ("hist", 1), ("hist", None)):
            try:
                plans.append(counts_launch_plan(rows, w, cand, path=path, cluster=cluster))
            except ValueError:
                pass
        return list(dict.fromkeys(plans))

    max_err["counts"] = 0
    checks["counts"] = 0
    counts_plans_hit = set()
    t0 = time.perf_counter()
    for sname, state in states.items():
        c = padded(state, torch.int32)
        for ids, neigh in tiles:
            x, e = c[neigh], ext_pad[ids]
            whole = None
            for k in (1, 2):
                total = None
                for xs in slot_shards(x, k):
                    want = partial_counts_plain(xs, e, cand=cand)
                    planned = None
                    for plan in counts_plans(*xs.shape):
                        got = partial_counts_op(xs, e, cand=cand, plan=plan)
                        planned = got if planned is None else planned
                        err = int((got.long() - want.long()).abs().max())
                        max_err["counts"] = max(max_err["counts"], err)
                        checks["counts"] += 1
                        counts_plans_hit.add((plan.path, plan.cluster))
                        if err:
                            raise AssertionError(
                                f"counts kernel != plain: state {sname} width "
                                f"{neigh.shape[1]} slot shards {k} plan {plan} max abs "
                                f"err {err}")
                    total = planned if total is None else total + planned
                if whole is None:
                    whole = total
                elif not torch.equal(total, whole):
                    raise AssertionError(f"two slot shards' counts do not add up to the "
                                         f"whole row's: state {sname} width {neigh.shape[1]}")
    if ({path for path, _ in counts_plans_hit} != set(COUNTS_PATHS)
            or not any(path == "hist" and k > 1 for path, k in counts_plans_hit)):
        raise AssertionError(f"the counts comparisons missed a path or the cluster split: "
                             f"{sorted(counts_plans_hit)}")
    torch.cuda.synchronize()
    log(f"counts kernel vs plain version: {checks['counts']} comparisons at all "
        f"{len(tiles)} tile shapes, one and two slot shards, states {list(states)}, "
        f"cand={cand}, plans as (path, cluster) {sorted(counts_plans_hit)}: max abs err "
        f"{max_err['counts']} (tolerance 0) in {time.perf_counter() - t0:.1f}s")

    halves = [slot_shards(x, 2) for x in gathered]

    def counts_kernel_all():
        for x, e in zip(gathered, ext_rows):
            partial_counts_op(x, e, cand=cand)

    def counts_kernel_halves():
        for hs, e in zip(halves, ext_rows):
            for h in hs:
                partial_counts_op(h, e, cand=cand)

    def counts_plain_all():
        for x, e in zip(gathered, ext_rows):
            partial_counts_plain(x, e, cand=cand)

    counts_kernel_all()  # warm-up
    counts_ms = device_time_ms(torch, counts_kernel_all, reps=7)
    counts_half_ms = device_time_ms(torch, counts_kernel_halves, reps=7)
    counts_plain_ms = device_time_ms(torch, counts_plain_all, reps=3)
    # Least time: each slot and ext read once, the [rows, cand] int32 counts
    # written once, over the HBM rate; one histogram update per slot over
    # the INT32 rate.
    counts_bytes = slots * 4 + rows * 4 + rows * cand * 4
    counts_half_bytes = counts_bytes + rows * 4 + rows * cand * 4  # ext read, counts written twice
    counts_bound_ms = max(counts_bytes / hw.HBM_BW, slots / int32_rate) * 1e3
    counts_half_bound_ms = max(counts_half_bytes / hw.HBM_BW, slots / int32_rate) * 1e3
    counts_by = "bytes" if counts_bytes / hw.HBM_BW >= slots / int32_rate else "operations"
    log(f"counts, one full sweep at the start state ({len(tiles)} launches, "
        f"{rows * cand * 4 / 1e9:.3f} GB of counts): kernel {counts_ms:.4f} ms (plain "
        f"{counts_plain_ms:.2f} ms, bound {counts_bound_ms:.4f} ms by {counts_by}); two slot "
        f"shards ({2 * len(tiles)} launches): {counts_half_ms:.4f} ms (bound "
        f"{counts_half_bound_ms:.4f} ms); no single PyTorch call computes suffix counts, "
        f"so there is no library time")
    per_width_counts = {}  # as the h-index kernel's: each tile alone, then the class in a row
    for (ids, neigh), x, e, hs in zip(tiles, gathered, ext_rows, halves):
        w = int(neigh.shape[1])
        k1 = device_time_ms(torch, lambda: partial_counts_op(x, e, cand=cand), reps=5)
        k2 = device_time_ms(torch, lambda: [partial_counts_op(h, e, cand=cand) for h in hs],
                            reps=5)
        acc = per_width_counts.setdefault(w, [0, 0, 0.0, 0.0, 0.0, set(), []])
        acc[5].update((p.path, p.cluster) for p in (counts_launch_plan(*h.shape, cand)
                                                    for h in [x] + hs))
        acc[0] += 1
        acc[1] += int(neigh.shape[0])
        acc[2] += k1
        acc[3] += k2
        acc[4] += (x.numel() * 4 + x.shape[0] * 4 + x.shape[0] * cand * 4) / hw.HBM_BW * 1e3
        acc[6].append((x, e))
    for w, (nt, nr, k1, k2, b, labels, xs) in sorted(per_width_counts.items()):
        row = device_time_ms(torch, lambda: [partial_counts_op(x, e, cand=cand) for x, e in xs],
                             reps=5)
        log(f"  counts width {w:>6}: {nt:>2} tile(s) {nr:>8,} rows: one shard {k1:.4f} ms "
            f"alone, {row:.4f} ms in a row, two shards {k2:.4f} ms alone, bound {b:.4f} ms "
            f"(plans as (path, cluster) {sorted(labels)})")
    del halves

    # ---------------- phase 5: the distributed main path, one rank -------- #
    def recording(fn):
        """``fn`` (a DecomposeFn) that also keeps each part's result."""
        results = []

        def rec(bg, **kw):
            res = fn(bg, **kw)
            results.append(res)
            return res
        return rec, results

    plan1 = MeshPlan()
    partial_counts_op.launches = 0
    for thresholds in (THRESHOLDS, ()):
        before = partial_counts_op.launches
        fn = make_distributed_decompose(plan1, use_kernel=True, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        core, rep = dc_kcore(g, thresholds, decompose_fn=fn)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ok = bool((core == oracle).all())
        d_counts = partial_counts_op.launches - before
        log(f"distributed 1x1 counts kernel thresholds={list(thresholds)}: wall {wall:.2f}s "
            f"(sweeping {rep.total_decompose_time_s:.2f}s), sweeps {rep.total_iterations}, "
            f"total comm {rep.total_comm:,}, gathered rows {rep.total_gathered_rows:,}, "
            f"peak part bytes {rep.peak_bytes:,}, launches counts={d_counts:,}: "
            f"{'CONSISTENT' if ok else 'MISMATCH'}")
        if not ok:
            raise AssertionError(f"distributed {thresholds}: coreness != oracle")
        if d_counts <= 0:
            raise AssertionError(f"distributed {thresholds}: {d_counts} counts launches")
    launches["counts"] = partial_counts_op.launches
    if launches["counts"] <= 0:
        raise AssertionError("the counts kernel never launched on the distributed main path")
    dirty_push_forms(bg)

    # ---------------- phase 6: four ranks on the one card ---------------- #
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        small = rmat(SMALL_SCALE, EDGE_FACTOR, seed=SEED)
        np.savez(work / "graph.npz", indptr=small.indptr, indices=small.indices,
                 n_nodes=small.n_nodes)
        small_oracle = peel_coreness(small)
        fn1, res1 = recording(make_distributed_decompose(plan1, use_kernel=True, device="cuda"))
        core1, rep1 = dc_kcore(small, THRESHOLDS, decompose_fn=fn1)
        if not (core1 == small_oracle).all():
            raise AssertionError("distributed 1x1 on the small graph: coreness != oracle")
        traj1 = [[r.comm_per_iter, r.active_rows_per_iter] for r in res1]
        # The same run without the counts kernel (the engine's own torch
        # counts, `_partial_counts`, on the card) must take the same
        # per-sweep trajectories.
        fnp, resp = recording(make_distributed_decompose(plan1, use_kernel=False,
                                                         device="cuda"))
        t0 = time.perf_counter()
        corep, _ = dc_kcore(small, THRESHOLDS, decompose_fn=fnp)
        plain_s = time.perf_counter() - t0
        if not (corep == small_oracle).all() or traj1 != [
                [r.comm_per_iter, r.active_rows_per_iter] for r in resp]:
            raise AssertionError("distributed 1x1 without the counts kernel: coreness or "
                                 "per-sweep trajectories differ from the kernel's run")
        log(f"graph rmat({SMALL_SCALE},{EDGE_FACTOR},seed={SEED}): n={small.n_nodes:,} "
            f"m={small.n_edges:,}; one-rank reference {rep1.total_iterations} sweeps in "
            f"{len(rep1.parts)} parts: CONSISTENT; without the counts kernel "
            f"({plain_s:.2f}s) the same trajectories: CONSISTENT")

        t0 = time.perf_counter()
        procs = []
        for r in range(4):
            out = open(work / f"rank{r}.log", "w")
            procs.append((subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--fleet-rank", str(r),
                 str(work)], stdout=out, stderr=subprocess.STDOUT), out))
        deadline = time.monotonic() + FLEET_TIMEOUT_S
        try:
            for p, _out in procs:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
        finally:
            for p, out in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
                out.close()
        failed = [r for r, (p, _o) in enumerate(procs) if p.returncode != 0]
        if failed:
            for r in failed:
                log(f"--- rank {r} (exit {procs[r][0].returncode}) ---")
                log((work / f"rank{r}.log").read_text()[-4000:])
            raise AssertionError(f"four-rank phase: ranks {failed} failed")
        fleet = [json.loads((work / f"rank{r}.json").read_text()) for r in range(4)]
        for r, res in enumerate(fleet):
            core_r = np.load(work / f"core{r}.npy")
            if not (core_r == small_oracle).all():
                raise AssertionError(f"four-rank phase: rank {r} coreness != oracle")
            if res["trajectories"] != traj1:
                raise AssertionError(f"four-rank phase: rank {r} comm_per_iter / "
                                     f"active_rows_per_iter differ from the one-rank run's")
            if res["full_sweep_bytes"] != res["planned_bytes"]:
                raise AssertionError(f"four-rank phase: rank {r} frontier=False collective "
                                     f"bytes {res['full_sweep_bytes']} != planned schedule "
                                     f"{res['planned_bytes']}")
            if res["launches"] <= 0:
                raise AssertionError(f"four-rank phase: rank {r} never launched the counts kernel")
        blocks = sorted(tuple(res["blocks"]) for res in fleet)
        if blocks != [(0, 0), (0, 1), (1, 0), (1, 1)]:
            raise AssertionError(f"four-rank phase: row/slot blocks {blocks}")
        for r, res in enumerate(fleet):
            pp = res["part_parallel"]
            core_r = np.load(work / f"core_pp{r}.npy")
            if core_r.tobytes() != core1.tobytes() or not (core_r == small_oracle).all():
                raise AssertionError(f"rank slices: rank {r} coreness != the one-rank run "
                                     f"or the oracle")
            if (sorted(set(pp["slice_index"])) != [0, 1] or min(pp["slice_busy_s"]) <= 0
                    or pp["boundary_exchange_bytes"] <= 0 or pp["launches"] <= 0
                    or pp["own_slice"] != r // 2):
                raise AssertionError(f"rank slices: rank {r} {pp}")
        pp = fleet[0]["part_parallel"]
        log(f"part-parallel rank slices, {FLEET_SHAPE} plan split into two slices of two "
            f"ranks, Exact-Divide, counts kernel: every rank CONSISTENT and byte-identical to "
            f"the one-rank run; rank 0: dc_kcore wall {pp['wall']:.2f}s, wave wall "
            f"{pp['conquer_wall_s']:.2f}s, slice busy {[round(b, 3) for b in pp['slice_busy_s']]}"
            f" s, utilization {[round(u, 3) for u in pp['slice_utilization']]}, parts' slices "
            f"{pp['slice_index']}, boundary-exchange bytes {pp['boundary_exchange_bytes']:,}, "
            f"counts launches per rank {[res['part_parallel']['launches'] for res in fleet]}")
        log(f"four ranks, {FLEET_SHAPE} {FLEET_AXES} plan over gloo on one card: every rank "
            f"CONSISTENT, trajectories equal to the one-rank run's, frontier=False collective "
            f"bytes equal to the planned schedule; rank 0: dc_kcore wall "
            f"{fleet[0]['wall']:.2f}s (sweeping {fleet[0]['sweeping']:.2f}s), "
            f"{fleet[0]['sweeps']} sweeps, {sum(fleet[0]['collective_bytes']):,} collective "
            f"bytes per rank, counts launches per rank "
            f"{[res['launches'] for res in fleet]}; phase {time.perf_counter() - t0:.1f}s "
            f"(gloo through host memory: not NCCL or NVLink times)")

        # ---------------- phase 7: crash and mid-part resume ------------- #
        class Crash(Exception):
            pass

        saves = []

        def killer(cursor, sweep, _save_s):
            saves.append((cursor, sweep))
            if len(saves) == 2:
                raise Crash

        ck = str(work / "ck")
        fnr = make_distributed_decompose(plan1, use_kernel=True, device="cuda")
        try:
            dc_kcore(small, THRESHOLDS, decompose_fn=fnr, checkpoint_dir=ck,
                     sweep_checkpoint_every=1, on_sweep_saved=killer)
            raise AssertionError("crash-resume phase: the injected crash never fired")
        except Crash:
            pass
        core_r, rep_r = dc_kcore(small, THRESHOLDS, decompose_fn=fnr, checkpoint_dir=ck,
                                 resume=True, sweep_checkpoint_every=1)
        resumed = [(p.name, p.resumed_at_sweep) for p in rep_r.parts]
        if not (core_r == core1).all():
            raise AssertionError("crash-resume phase: resumed coreness != uninterrupted run")
        if not any(sweep > 0 for _name, sweep in resumed):
            raise AssertionError(f"crash-resume phase: no part resumed mid-part {resumed}")
        log(f"crash and resume: crashed at snapshot saves {saves}, resumed parts "
            f"(name, sweep) {resumed}: coreness equal to the uninterrupted run")

        # ---------------- phases 8-11: ingest, overlap, serve, waves ------- #
        npz_path = phase_ingest(g, small, work)
        seq_walls = phase_overlap(g, oracle, work)
        phase_serve(g, npz_path, work)
        phase_part_parallel(g, oracle, seq, seq_walls, small, small_oracle, npz_path, work)
        phase_dryrun(bg)
        serve_measured = phase_lm()
        train_measured = phase_train(work)
        phase_lm_dryrun(serve_measured, train_measured)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    bad = sorted(m for m in sys.modules
                 if m in ("jax", "repro") or m.startswith(("jax.", "repro.")))
    if bad:
        raise AssertionError(f"JAX or the JAX package was imported: {bad}")

    # ---------------- phase 15: result lines ---------------- #
    kernels = [
        {"name": "fused_sweep", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/fused.cu",
         "replaces": "src/repro/kernels/fused/fused.py:98",
         "launches": launches["fused"], "max_abs_err": max_err["fused"],
         "ms": fused_ms, "plain_ms": fused_plain_ms, "bound_ms": fused_bound_ms,
         "bound_by": fused_by, "library_ms": None},
        {"name": "hindex", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/hindex.cu",
         "replaces": "src/repro/kernels/hindex/hindex.py:68",
         "launches": launches["hindex"], "max_abs_err": max_err["hindex"],
         "ms": hindex_ms, "plain_ms": hindex_plain_ms, "bound_ms": hindex_bound_ms,
         "bound_by": hindex_by, "library_ms": None},
        {"name": "partial_counts", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/counts.cu",
         "replaces": "src/repro/kernels/counts/counts.py:42",
         "launches": launches["counts"], "max_abs_err": max_err["counts"],
         "ms": counts_ms, "plain_ms": counts_plain_ms, "bound_ms": counts_bound_ms,
         "bound_by": counts_by, "library_ms": None},
    ]
    log(f"chip_smoke total {time.perf_counter() - t_all:.1f}s")
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def dirty_push_forms(bg) -> None:
    """The distributed engine's dirty push (``distributed._push_dirty``, a
    max-scatter staged per row) against the flat max-scatter over every slot
    (the reference's expression) and the boolean-mask index it replaced, on
    the one-rank monolithic run at rmat(20, 16), in turns; the same
    trajectory each time."""
    import torch

    from repro_torch.core import distributed as dist_mod

    def flat(tile_dirty, node_tile, neigh, row_changed):
        return tile_dirty.scatter_reduce_(
            0, node_tile[neigh].long().flatten(),
            row_changed[:, None].expand_as(neigh).to(torch.int32).flatten(), reduce="amax")

    def mask(tile_dirty, node_tile, neigh, row_changed):  # a sync per bucket
        tile_dirty[node_tile[neigh[row_changed]].long()] = 1
        return tile_dirty

    engine = dist_mod._push_dirty
    forms = {"row-staged": engine, "flat": flat, "mask": mask}
    walls = {name: [] for name in forms}
    first = None
    try:
        for name in ["row-staged", "flat", "mask", "mask", "flat", "row-staged"]:
            dist_mod._push_dirty = forms[name]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = dist_mod.decompose_distributed(bg, dist_mod.MeshPlan(), use_kernel=True,
                                                 device="cuda")
            torch.cuda.synchronize()
            walls[name].append(time.perf_counter() - t0)
            traj = (res.coreness.tobytes(), res.comm_per_iter, res.active_rows_per_iter)
            first = first or traj
            if traj != first:
                raise AssertionError(f"dirty push {name}: another trajectory")
    finally:
        dist_mod._push_dirty = engine
    log(f"dirty push forms, one-rank monolithic decompose_distributed at rmat(20,16), "
        f"{res.iterations} sweeps, same trajectory: " + ", ".join(
            f"{name} {' / '.join(f'{w:.3f}' for w in ws)} s" for name, ws in walls.items()))


def same_csr(a, b) -> bool:
    """Bit-identical CSR graphs: node count, indptr and indices (dtypes
    included)."""
    import numpy as np

    return (a.n_nodes == b.n_nodes and a.indptr.dtype == b.indptr.dtype
            and a.indices.dtype == b.indices.dtype
            and np.array_equal(a.indptr, b.indptr) and np.array_equal(a.indices, b.indices))


def phase_ingest(g, small, work: Path) -> Path:
    """Phase 8: stream ``g`` through the spill-to-disk builder and the npz
    round trip, and ``small`` through the SNAP text path; every CSR
    bit-identical. Returns the npz of ``g``."""
    from repro_torch.graph.io import (csr_from_edge_chunks, graph_edge_chunks, load_npz,
                                      save_edgelist, save_npz, stream_edgelist)

    chunk = 1 << 20
    t0 = time.perf_counter()
    streamed, st = csr_from_edge_chunks(graph_edge_chunks(g, chunk), n_nodes=g.n_nodes,
                                        chunk_edges=chunk, workdir=str(work / "spill"))
    stream_s = time.perf_counter() - t0
    if not same_csr(streamed, g):
        raise AssertionError("ingest: the streamed CSR differs from the in-memory one")
    del streamed
    log(f"ingest, re-streamed rmat({SCALE},{EDGE_FACTOR}) in {chunk:,}-edge chunks: "
        f"{stream_s:.1f}s, {st.n_chunks} chunks, {st.n_bins} dedup bins, spill "
        f"{st.spill_bytes:,} bytes; peak transient host bytes {st.peak_transient_bytes:,} "
        f"against the in-memory loader's {st.baseline_transient_bytes:,}; resident output "
        f"CSR {st.output_bytes:,} bytes: bit-identical")
    if st.peak_transient_bytes >= st.baseline_transient_bytes:
        raise AssertionError("ingest: the streamed build held more transient bytes than "
                             "the in-memory loader")
    npz_path = work / f"rmat{SCALE}.npz"
    t0 = time.perf_counter()
    save_npz(str(npz_path), g)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    if not same_csr(load_npz(str(npz_path)), g):
        raise AssertionError("ingest: the npz round trip changed the graph")
    log(f"ingest, npz: save_npz {save_s:.1f}s ({npz_path.stat().st_size:,} bytes), "
        f"load_npz {time.perf_counter() - t0:.1f}s: bit-identical")
    # The text path parses one line at a time in Python: 68 s at rmat(20,16)
    # on the card's host, so it runs at rmat(16,16), which exercises the
    # same code (several chunks, several dedup bins) in a few seconds.
    txt = work / f"rmat{SMALL_SCALE}.txt"
    t0 = time.perf_counter()
    save_edgelist(str(txt), small)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    from_text, tst = stream_edgelist(str(txt), n_nodes=small.n_nodes, chunk_edges=1 << 18,
                                     workdir=str(work / "spill_text"))
    if not same_csr(from_text, small) or tst.n_chunks < 2 or tst.n_bins < 2:
        raise AssertionError("ingest: the edge list streamed back differs from the graph")
    log(f"ingest, SNAP text path at rmat({SMALL_SCALE},{EDGE_FACTOR}): save_edgelist "
        f"{save_s:.1f}s ({txt.stat().st_size:,} bytes), stream_edgelist "
        f"{time.perf_counter() - t0:.1f}s in {tst.n_chunks} chunks of {1 << 18:,} edges, "
        f"{tst.n_bins} dedup bins (peak transient {tst.peak_transient_bytes:,} bytes): "
        f"bit-identical")
    txt.unlink()
    return npz_path


def phase_overlap(g, oracle, work: Path) -> dict:
    """Phase 9: the overlapped pipeline against the sequential one on the
    card, and an overlapped run whose async checkpoints restore. Returns
    the sequential runs' walls by strategy."""
    import threading

    import torch
    from repro_torch.core.dckcore import PipelineState, dc_kcore
    from repro_torch.kernels.fused import fused_sweep_op

    cores = {}
    walls = {}
    fused_sweep_op.launches = 0
    for strategy in ("rough", "exact"):
        for overlap in (False, True):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            core, rep = dc_kcore(g, THRESHOLDS, strategy=strategy, engine="fused",
                                 device="cuda", overlap=overlap)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            ok = bool((core == oracle).all())
            cores[strategy, overlap] = core
            walls[strategy, overlap] = wall
            log(f"overlap {'on ' if overlap else 'off'} {strategy:>5} thresholds="
                f"{list(THRESHOLDS)}: wall {wall:.2f}s (sweeping "
                f"{rep.total_decompose_time_s:.2f}s), idle fraction {rep.idle_fraction:.3f}, "
                f"prefetch hits {rep.prefetch_hits} misses {rep.prefetch_misses}, prefetched "
                f"parts {[p.name for p in rep.parts if p.prefetched]}, sweeps "
                f"{rep.total_iterations}: {'CONSISTENT' if ok else 'MISMATCH'}")
            if not ok:
                raise AssertionError(f"overlap {overlap} {strategy}: coreness != oracle")
            if overlap and strategy == "exact" and (rep.prefetch_misses or not rep.prefetch_hits):
                raise AssertionError(f"overlap exact: {rep.prefetch_hits} prefetch hits, "
                                     f"{rep.prefetch_misses} misses (Exact-Divide must hit)")
        if cores[strategy, True].tobytes() != cores[strategy, False].tobytes():
            raise AssertionError(f"overlap {strategy}: coreness not byte-identical to the "
                                 f"sequential run's")
    ck = work / "ck_overlap"
    core, rep = dc_kcore(g, THRESHOLDS, strategy="rough", engine="fused", device="cuda",
                         overlap=True, checkpoint_dir=str(ck))
    launches = fused_sweep_op.launches
    state = PipelineState.restore(str(ck), g.n_nodes)
    if state is None or not state.complete or state.coreness.tobytes() != core.tobytes():
        raise AssertionError("overlap with checkpoints: the latest checkpoint does not "
                             "restore to the run's coreness")
    if core.tobytes() != cores["rough", False].tobytes():
        raise AssertionError("overlap with checkpoints: coreness differs")
    alive = [t.name for t in threading.enumerate()
             if t.name.startswith(("dckcore-prefetch", "ckpt-save"))]
    if alive or launches <= 0:
        raise AssertionError(f"overlap: threads left {alive}, fused launches {launches}")
    log(f"overlap on with async checkpoints: wall {rep.total_time_s:.2f}s, blocked on saves "
        f"{rep.total_save_time_s:.3f}s, completed writes {rep.total_save_wall_s:.3f}s, idle "
        f"fraction {rep.idle_fraction:.3f}; the latest checkpoint (step of "
        f"{state.parts_done} parts, complete) restores to the same coreness; fused launches "
        f"on the overlap path {launches:,}")
    return {strategy: walls[strategy, False] for strategy in ("rough", "exact")}


def phase_part_parallel(g, oracle, seq, seq_walls, small, small_oracle, npz_path: Path,
                        work: Path) -> None:
    """Phase 11: part-parallel conquer on the card. Stream slices through
    ``dc_kcore``'s own engines (the fused and h-index kernels), the watchdog
    (an injected crash and hang) and a mid-part crash and resume, then the
    CLI. The engine's ``decompose`` is wrapped to record, inside each slice
    worker, the thread and its current CUDA stream."""
    import threading

    import numpy as np
    import torch
    import repro_torch.core.dckcore as dckcore
    from repro_torch.kernels.fused import fused_sweep_op
    from repro_torch.kernels.hindex import hindex_op
    from repro_torch.runtime import FaultPlan, FaultSpec

    t_phase = time.perf_counter()
    real_decompose = dckcore.decompose
    seen = []

    def recording(bg, **kw):
        seen.append((threading.current_thread().name, torch.cuda.current_stream().cuda_stream))
        return real_decompose(bg, **kw)

    default_stream = torch.cuda.default_stream().cuda_stream

    def checked_streams(name, slices):
        """Every part ran on a slice worker, on that slice's one stream,
        and no two slices shared a stream or used the default one."""
        by_thread = {}
        for thread, stream in seen:
            if not thread.startswith("dckcore-conquer-"):
                raise AssertionError(f"{name}: a part ran on thread {thread}")
            by_thread.setdefault(thread, set()).add(stream)
        streams = [next(iter(v)) for v in by_thread.values()]
        if (any(len(v) != 1 for v in by_thread.values()) or len(set(streams)) != len(streams)
                or default_stream in streams or len(by_thread) > slices):
            raise AssertionError(f"{name}: streams by slice thread {by_thread}")
        return {t: hex(next(iter(v))) for t, v in sorted(by_thread.items())}

    dckcore.decompose = recording
    try:
        runs = [("fused", "rough", 2), ("fused", "rough", 3), ("fused", "exact", 2),
                ("fused", "exact", 3), ("kernel", "exact", 2)]
        for engine, strategy, slices in runs:
            counter = fused_sweep_op if engine == "fused" else hindex_op
            seen.clear()
            counter.launches = 0
            counter.launches_by_thread.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            core, rep = dckcore.dc_kcore(g, THRESHOLDS, strategy=strategy, engine=engine,
                                         device="cuda", part_parallel=slices)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            per_slice = dict(sorted(counter.launches_by_thread.items()))
            streams = checked_streams(f"stream slices {engine} {strategy} S={slices}", slices)
            if core.tobytes() != seq["core"].tobytes() or not (core == oracle).all():
                raise AssertionError(f"stream slices {engine} {strategy} S={slices}: coreness "
                                     f"differs from the sequential run or the oracle")
            if strategy == "exact" and (rep.prefetch_misses or rep.speculation_discards):
                raise AssertionError(f"stream slices {engine} exact S={slices}: "
                                     f"{rep.prefetch_misses} misses, "
                                     f"{rep.speculation_discards} discards")
            if (counter.launches <= 0 or sum(per_slice.values()) != counter.launches
                    or set(per_slice) != set(streams)):
                raise AssertionError(f"stream slices {engine} {strategy} S={slices}: launches "
                                     f"{counter.launches}, by thread {per_slice}")
            log(f"stream slices {engine:>6} {strategy:>5} S={slices}: wall {wall:.2f}s against "
                f"the sequential fused run's {seq_walls[strategy]:.2f}s (phase 9), wave wall "
                f"{rep.conquer_wall_s:.2f}s, sweeping {rep.total_decompose_time_s:.2f}s, slice "
                f"busy {[round(b, 3) for b in rep.slice_busy_s]} s, utilization "
                f"{[round(u, 3) for u in rep.slice_utilization]}, speculation hits "
                f"{rep.prefetch_hits} misses {rep.prefetch_misses} discards "
                f"{rep.speculation_discards}, parts (name, slice, wave) "
                f"{[(p.name, p.slice_index, p.wave) for p in rep.parts]}, {engine} launches "
                f"by slice {per_slice}, streams {streams}: CONSISTENT, byte-identical")

        # The watchdog and a mid-part crash, on rmat(16, 16).
        small_seq, _ = dckcore.dc_kcore(small, THRESHOLDS, engine="fused", device="cuda")
        if not (small_seq == small_oracle).all():
            raise AssertionError("watchdog: the sequential small run != the oracle")
        crash = FaultPlan([FaultSpec("slice_conquer", "crash", at=0)])
        seen.clear()
        core, rep = dckcore.dc_kcore(small, THRESHOLDS, engine="fused", device="cuda",
                                     part_parallel=2, max_retries=2, fault_plan=crash)
        checked_streams("watchdog crash", 2)
        if core.tobytes() != small_seq.tobytes() or rep.retries != 1 or len(crash.events) != 1:
            raise AssertionError(f"watchdog crash: retries {rep.retries}, events "
                                 f"{crash.events}, coreness equal "
                                 f"{core.tobytes() == small_seq.tobytes()}")
        hang = FaultPlan([FaultSpec("slice_conquer", "hang", at=0, delay_s=60.0)])
        t0 = time.perf_counter()
        core, rep_h = dckcore.dc_kcore(small, THRESHOLDS, engine="fused", device="cuda",
                                       part_parallel=2, slice_timeout_s=2.0, max_retries=0,
                                       fault_plan=hang)
        hang_s = time.perf_counter() - t0
        if (core.tobytes() != small_seq.tobytes() or len(rep_h.blacklisted_slices) != 1
                or rep_h.degraded_waves < 1):
            raise AssertionError(f"watchdog hang: blacklisted {rep_h.blacklisted_slices}, "
                                 f"degraded waves {rep_h.degraded_waves}")
        log(f"watchdog on stream slices, rmat({SMALL_SCALE},{EDGE_FACTOR}): one slice_conquer "
            f"crash -> {rep.retries} retry, fault events "
            f"{[e['event'] for e in rep.fault_events]}; one hang with a 2 s timeout -> "
            f"blacklisted slices {rep_h.blacklisted_slices}, {rep_h.degraded_waves} degraded "
            f"wave(s), wall {hang_s:.2f}s; both byte-identical to the sequential run")

        class Crash(Exception):
            pass

        saves = []

        def killer(cursor, sweep, _save_s):
            saves.append((cursor, sweep, threading.current_thread().name))
            if len(saves) == 2:
                raise Crash

        ck = str(work / "ck_waves")
        try:
            dckcore.dc_kcore(small, THRESHOLDS, engine="fused", device="cuda", part_parallel=2,
                             checkpoint_dir=ck, sweep_checkpoint_every=1,
                             on_sweep_saved=killer)
            raise AssertionError("stream slices crash: the injected crash never fired")
        except Crash:
            pass
        core, rep = dckcore.dc_kcore(small, THRESHOLDS, engine="fused", device="cuda",
                                     part_parallel=2, checkpoint_dir=ck, resume=True,
                                     sweep_checkpoint_every=1)
        resumed = [(p.name, p.resumed_at_sweep) for p in rep.parts]
        if core.tobytes() != small_seq.tobytes() or not any(s > 0 for _n, s in resumed):
            raise AssertionError(f"stream slices crash and resume: resumed {resumed}")
        log(f"stream slices crash and resume: crashed at snapshot saves "
            f"(cursor, sweep, thread) {saves}, resumed parts (name, sweep) {resumed}: "
            f"coreness equal to the uninterrupted run")
    finally:
        dckcore.decompose = real_decompose
    alive = [t.name for t in threading.enumerate() if t.name.startswith("dckcore-conquer")]
    if alive:
        raise AssertionError(f"part-parallel: conquer threads left {alive}")

    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.kcore", "--graph", f"npz:{npz_path}",
         "--thresholds", ",".join(map(str, THRESHOLDS)), "--engine", "fused",
         "--part-parallel", "2", "--check"],
        capture_output=True, text=True, env=env, cwd=str(ROOT), timeout=FLEET_TIMEOUT_S)
    lines = [l for l in cli.stdout.splitlines() if l.startswith(("part-parallel:", "DC-kCore",
                                                                  "kernel launches", "oracle"))]
    if cli.returncode != 0 or "CONSISTENT" not in cli.stdout or len(lines) != 4:
        log(cli.stdout[-4000:] + cli.stderr[-4000:])
        raise AssertionError(f"part-parallel CLI exited {cli.returncode}")
    log(f"part-parallel CLI (--part-parallel 2 --engine fused --check on the npz, "
        f"{time.perf_counter() - t0:.1f}s): " + " | ".join(lines))
    log(f"part-parallel phase (stream slices, watchdog, crash and resume, CLI): "
        f"{time.perf_counter() - t_phase:.1f}s")


def phase_dryrun(bg) -> None:
    """Phase 12: the paper-scale dry-run, the tally against the card, and
    the examples."""
    import numpy as np
    import torch

    from repro_torch.core.distributed import (MeshPlan, make_sweep_fn, node_tile_map,
                                              shard_buckets)
    from repro_torch.core.hindex import hindex_of_sequence
    from repro_torch.kernels.counts import partial_counts_op
    from repro_torch.launch.kcore_dryrun import ARTIFACT_DIR, traced_sweep
    from repro_torch.roofline.analysis import roofline_terms

    t_phase = time.perf_counter()
    started = time.time()
    env = dict(os.environ, PYTHONPATH=str(SRC))
    runs = [["--wire", "int16"], ["--split3", "--wire", "int16"], ["--slices", "4"]]
    children = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.kcore_dryrun", *args], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for args in runs]
    try:
        # (b) One full sweep, traced on meta tensors and run on the card.
        plan = MeshPlan()
        cand = max(1, hindex_of_sequence(bg.degrees.astype(np.int64) + bg.ext))
        start = np.concatenate([bg.degrees.astype(np.int32) + bg.ext.astype(np.int32), [-1]])
        state = {
            "c": torch.from_numpy(start.astype(np.int32)),
            "ext_pad": torch.from_numpy(np.concatenate([bg.ext, [0]]).astype(np.int32)),
            "node_tile": torch.from_numpy(node_tile_map(bg)),
        }
        meta = {k: v.to("meta") for k, v in state.items()}
        tally, trace_s = traced_sweep(plan, cand, meta["c"], meta["ext_pad"],
                                      meta["node_tile"], shard_buckets(bg, plan, "meta"))
        cuda = {k: v.to("cuda") for k, v in state.items()}
        buckets = shard_buckets(bg, plan, "cuda")
        sweep = make_sweep_fn(plan, cand, use_kernel=True)
        active = np.ones(len(buckets), dtype=bool)
        c_run = cuda["c"].clone()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        partial_counts_op.launches = 0
        sweep(c_run, cuda["ext_pad"], active, cuda["node_tile"], buckets)
        torch.cuda.synchronize()
        launches = partial_counts_op.launches
        card_peak = torch.cuda.max_memory_allocated() - base
        del c_run
        runs_c = [cuda["c"].clone() for _ in range(7)]
        t0 = time.perf_counter()  # the host's enqueue of one sweep, unsynchronized
        sweep(runs_c.pop(), cuda["ext_pad"], active, cuda["node_tile"], buckets)
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        sweep_ms = device_time_ms(
            torch, lambda: sweep(runs_c.pop(), cuda["ext_pad"], active, cuda["node_tile"],
                                 buckets), reps=5)
        rl = roofline_terms(tally.int_ops, tally.hbm_bytes, tally.collectives)
        top = sorted(tally.bytes_by_op.items(), key=lambda kv: -kv[1])[:5]
        bound_s = max(rl.compute_s, rl.memory_s, rl.collective_s)
        ratio = tally.peak_bytes / card_peak
        log(f"dry-run calibration, one full sweep of the distributed engine (1x1, counts "
            f"kernel) at {len(buckets)} buckets, cand={cand}: traced peak "
            f"{tally.peak_bytes:,} B, card max_memory_allocated above baseline {card_peak:,} B "
            f"(traced / card {ratio:.4f}); traced {tally.hbm_bytes:,} B moved, "
            f"{tally.int_ops:,} int32 ops, roofline {bound_s * 1e3:.4f} ms [{rl.bottleneck}]; "
            f"card sweep {sweep_ms:.4f} ms (CUDA events, median of 5; the host enqueues it "
            f"in {enqueue_ms:.2f} ms, so above {SLEEP_CYCLES / 1.98e6:.0f} ms the events time "
            f"the host); counts launches "
            f"{launches}; trace {trace_s:.2f}s")
        log("  traced bytes by op: " + ", ".join(
            f"{name} {b:,} ({b / tally.hbm_bytes:.1%})" for name, b in top))
        if abs(ratio - 1) > 0.2:
            raise AssertionError(f"dry-run calibration: traced peak {tally.peak_bytes} B is "
                                 f"not within 20% of the card's {card_peak} B")
        if launches != len(buckets):
            raise AssertionError(f"dry-run calibration: {launches} counts launches for "
                                 f"{len(buckets)} buckets")

        # (c) The examples on the card.
        for name, oracle_line in (("quickstart", "all three methods consistent"),
                                  ("multipart_divide", "more parts -> less communication"),
                                  ("kcore_end_to_end", "CONSISTENT")):
            t0 = time.perf_counter()
            ex = subprocess.run(
                [sys.executable, str(ROOT / "examples" / "torch" / f"{name}.py"),
                 "--device", "cuda"], cwd=ROOT, env=env, capture_output=True, text=True,
                timeout=600)
            for line in ex.stdout.splitlines():
                log(f"  example {name}: {line}")
            if ex.returncode != 0 or oracle_line not in ex.stdout:
                log(ex.stderr[-4000:])
                raise AssertionError(f"example {name}: exit {ex.returncode}, oracle line "
                                     f"{'found' if oracle_line in ex.stdout else 'missing'}")
            log(f"example {name} --device cuda: exit 0 in {time.perf_counter() - t0:.1f}s")

        # (a) The paper-scale records.
        for args, child in zip(runs, children):
            out, _ = child.communicate(timeout=600)
            for line in out.splitlines():
                log(f"  kcore_dryrun {' '.join(args)}: {line}")
            if child.returncode != 0:
                raise AssertionError(f"kcore_dryrun {args}: exit {child.returncode}")
    finally:
        for child in children:
            if child.poll() is None:
                child.kill()
                child.communicate()
    records = [json.loads(p.read_text()) for p in Path(ARTIFACT_DIR).glob("*__2x16x16.json")
               if p.stat().st_mtime >= started]
    if len(records) != 18 or any("memory_model" not in r for r in records):
        raise AssertionError(f"kcore_dryrun: {len(records)} case records, want 18, each "
                             f"with its memory model")
    log(f"dry-run phase (records, calibration, examples): "
        f"{time.perf_counter() - t_phase:.1f}s")


LM_BATCH, LM_PROMPT, LM_NEW = 4, 512, 64  # phase 13(a): qwen3-8b serving
LM_PARITY_PROMPT, LM_PARITY_STEPS = 32, 16  # phase 13(b): decode against forward


def _max_excess(got, want, atol, rtol):
    """Largest ``|got - want| - (atol + rtol * |want|)``: <= 0 where they
    agree within the tolerance (numpy's ``assert_allclose`` rule)."""
    got, want = got.double().cpu(), want.double().cpu()
    return float(((got - want).abs() - (atol + rtol * want.abs())).max())


def _profile(torch, fn, n: int = 5, ops: int = 0) -> str:
    """``fn()`` under ``torch.profiler``: its wall time, the device's busy
    time (the sum of its kernels' times), their count, the idle share, and
    the ``n`` costliest kernels; with ``ops``, also the ``ops`` host ops
    (``aten::*``) whose own kernels took longest. (A CUDA-event bracket with the stream held
    by a sleep kernel, as the k-core phases time, does not work here: a
    step's few thousand launches overflow the launch queue, and the host
    blocks behind the held stream.)"""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0),
                  reverse=True)  # the kernels, not the host ops above them
    if not rows:
        return f"wall {wall_ms:.3f} ms under the profiler, which saw no device time"
    busy_ms = sum(r[0] for r in rows) / 1e3
    out = (f"wall {wall_ms:.3f} ms under the profiler, device busy {busy_ms:.3f} ms over "
           f"{sum(r[1] for r in rows):,} kernels (idle {1 - busy_ms / wall_ms:.1%}); costliest: "
           + "; ".join(f"{key[:56]} x{cnt} {t / 1e3:.3f} ms" for t, cnt, key in rows[:n]))
    if ops:
        host = sorted(((e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
                       if not str(e.device_type).endswith("CUDA")
                       and e.self_device_time_total > 0), reverse=True)
        out += "; by host op: " + "; ".join(f"{key} x{cnt} {t / 1e3:.3f} ms"
                                            for t, cnt, key in host[:ops])
    return out


def phase_lm() -> dict:
    """Phase 13: the LM serving path (``repro_torch.models``,
    ``runtime/serve_loop.py``, ``launch/serve.py``). Returns phase 13(a)'s
    measurements for phase 16: the prefill and median decode ms and the
    peak allocated bytes of the generate call."""
    import dataclasses

    import torch

    from repro_torch.configs import ARCHS, get_config, get_smoke_config
    from repro_torch.kernels.counts import partial_counts_op
    from repro_torch.kernels.fused import fused_sweep_op
    from repro_torch.kernels.hindex import hindex_op
    from repro_torch.launch.serve import card_name, generate, random_inputs
    from repro_torch.models.model import CausalLM
    from repro_torch.models.module import count_params, init_params
    from repro_torch.models.parity import DECODE_TOL, f32_tolerance, greedy_agreement, \
        ulp_perturbed
    from repro_torch.runtime import greedy_generate

    t_phase = time.perf_counter()
    dev, cpu = torch.device("cuda"), torch.device("cpu")
    card = card_name(dev)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    counters = (fused_sweep_op, hindex_op, partial_counts_op)
    for op in counters:
        op.launches = 0

    # (a) qwen3-8b at its published widths and depth, bf16 activations.
    cfg = get_config("qwen3-8b")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = init_params(CausalLM(cfg, device=dev), 0)
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    n_params = count_params(model)
    param_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    prompt, _ = random_inputs(cfg, LM_BATCH, LM_PROMPT, 0, dev)
    generate(model, prompt, 4)  # warm-up: cuBLAS handles and kernel choices
    res = generate(model, prompt, LM_NEW)
    tokens = res["tokens"]
    if not res["all_finite"]:
        raise AssertionError("qwen3-8b: non-finite logits")
    if tokens.shape != (LM_BATCH, LM_NEW) or int(tokens.min()) < 0 or \
            int(tokens.max()) >= cfg.vocab_size:
        raise AssertionError(f"qwen3-8b: tokens {tuple(tokens.shape)} outside [0, "
                             f"{cfg.vocab_size})")
    dec_ms = res["decode_ms_median"]
    measured = {"prefill_ms": res["prefill_ms"], "decode_ms": dec_ms,
                "peak_bytes": res["peak_bytes"]}
    # Least times, from the card's published peaks (3.35 TB/s, 989 TFLOP/s
    # bf16). A decode step reads every f32 weight but the embedding table
    # (gathered, 4 rows), writes its bf16 cast and reads that cast again.
    emb_bytes = model.embed.tokens.numel() * 4
    cast_bytes = (param_bytes - emb_bytes) * 2  # f32 read + bf16 write + bf16 read
    dec_bound_ms = cast_bytes / 3.35e12 * 1e3
    dec_bf16_ms = (param_bytes - emb_bytes) / 2 / 3.35e12 * 1e3
    flops = 2 * LM_BATCH * LM_PROMPT * (n_params - model.embed.tokens.numel()) + \
        4 * LM_BATCH * cfg.n_heads * LM_PROMPT ** 2 * cfg.head_dim * cfg.n_layers
    pre_bound_ms = max(flops / 989e12, cast_bytes / 3.35e12) * 1e3
    log(f"LM serve qwen3-8b (published widths, {cfg.n_layers} layers, {n_params:,} params, "
        f"{param_bytes:,} B f32; drawn on the card from seed 0 in {init_s:.2f}s): batch "
        f"{LM_BATCH} x prompt {LM_PROMPT}, {LM_NEW} greedy tokens, bf16 activations; "
        f"{card}")
    log(f"  prefill {res['prefill_ms']:.3f} ms (bound {pre_bound_ms:.3f} ms: "
        f"{flops / 1e12:.2f} TFLOP at 989 TFLOP/s, {cast_bytes / 1e9:.2f} GB at 3.35 TB/s); "
        f"decode median {dec_ms:.3f} ms/token over {len(res['decode_ms'])} steps (min "
        f"{min(res['decode_ms']):.3f}, max {max(res['decode_ms']):.3f}; bound with per-use "
        f"casts {dec_bound_ms:.3f} ms, with bf16 weights kept {dec_bf16_ms:.3f} ms); "
        f"{LM_BATCH / dec_ms * 1e3:.1f} decode tokens/s, {LM_BATCH * LM_NEW / res['wall_s']:.1f}"
        f" tokens/s over the whole call ({res['wall_s']:.3f}s); peak "
        f"{res['peak_bytes']:,} B allocated; every logit finite, tokens in [0, vocab)")

    # Where the time goes: the profiler's kernel times against the wall.
    with torch.inference_mode():
        caches = model.prefill(prompt, max_len=LM_PROMPT + LM_NEW)[1]
        tok, pos = tokens[:, :1], torch.full((LM_BATCH,), LM_PROMPT, device=dev)
        log(f"  one decode step: {_profile(torch, lambda: model.decode_step(caches, tok, pos))}")
        log(f"  one prefill: "
            f"{_profile(torch, lambda: model.prefill(prompt, max_len=LM_PROMPT + 1))}")
    del caches

    # (b) the same parameters, f32 activations, TF32 off: 16 teacher-forced
    # decode steps against one full forward over the same tokens.
    model.cfg = dataclasses.replace(cfg, dtype=torch.float32)
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        gen = torch.Generator(device=dev).manual_seed(0)
        seq = torch.randint(0, cfg.vocab_size, (2, LM_PARITY_PROMPT + LM_PARITY_STEPS),
                            generator=gen, device=dev)
        with torch.inference_mode():
            full = model(seq)[0]
            _, caches = model.prefill(seq[:, :LM_PARITY_PROMPT], max_len=seq.shape[1])
            worst, worst_excess = 0.0, float("-inf")
            for t in range(LM_PARITY_STEPS):
                p = LM_PARITY_PROMPT + t
                lg, caches = model.decode_step(caches, seq[:, p:p + 1],
                                               torch.full((2,), p, device=dev))
                worst = max(worst, float((lg[:, 0] - full[:, p]).abs().max()))
                worst_excess = max(worst_excess, _max_excess(lg[:, 0], full[:, p],
                                                             **DECODE_TOL))
        if worst_excess > 0:
            raise AssertionError(f"qwen3-8b f32 decode vs forward: max abs diff {worst:.3e} "
                                 f"outside atol 2e-3 rtol 1e-3")
        log(f"  f32 parity (TF32 off): {LM_PARITY_STEPS} decode steps after a "
            f"{LM_PARITY_PROMPT}-token prefill against one forward over the same tokens: max "
            f"abs diff {worst:.3e} (max |logit| {float(full.abs().max()):.3f}), within atol "
            f"2e-3 rtol 1e-3")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    del model, full, caches
    torch.cuda.empty_cache()

    # (c) mamba2-130m at its published widths and every smoke config: the
    # card against the CPU on the same parameters, in f32.
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cases = [("mamba2-130m (published)",
                  dataclasses.replace(get_config("mamba2-130m"), dtype=torch.float32))]
        cases += [(f"{arch} (smoke)", get_smoke_config(arch)) for arch in ARCHS]
        for label, c in cases:
            t0 = time.perf_counter()
            ref = init_params(CausalLM(c, device=cpu), 0)
            with torch.no_grad():
                for name, prm in ref.named_parameters():
                    if name.endswith("cross_gate"):
                        prm.fill_(0.5)  # nonzero: the cross-attention path counts
            onc = CausalLM(c, device=dev)
            onc.load_state_dict(ref.state_dict())
            # The CPU's own movement under one ulp of every parameter, for
            # the tolerance (models/parity.py).
            moved = CausalLM(c, device=cpu)
            moved.load_state_dict(ulp_perturbed(ref.state_dict()))
            prompt, extras = random_inputs(c, 2, 16, 0, cpu)
            ex_dev = None if extras is None else {k: v.to(dev) for k, v in extras.items()}
            with torch.inference_mode():
                want = ref(prompt, extras)[0]
                got = onc(prompt.to(dev), ex_dev)[0]
                tol = f32_tolerance(want, moved(prompt, extras)[0])
                if _max_excess(got, want, **tol) > 0:
                    raise AssertionError(
                        f"{label}: card logits differ from the CPU's by "
                        f"{float((got.cpu() - want).abs().max()):.3e}, outside atol "
                        f"{tol['atol']:.3g} rtol {tol['rtol']:.3g}")
                g_cpu = greedy_generate(ref, prompt, 8, extras=extras)
                g_dev = greedy_generate(onc, prompt.to(dev), 8, extras=ex_dev)

                def logits_at(row, t):
                    seq = torch.cat([prompt[row], g_cpu[row, :t]])[None]
                    row_ex = (None if extras is None
                              else {k: v[row:row + 1] for k, v in extras.items()})
                    return ref(seq, row_ex)[0][0, -1]

                agree = greedy_agreement(g_dev, g_cpu, logits_at, c.vocab_size)
            log(f"  card vs cpu, {label}, f32: logits max abs diff "
                f"{float((got.cpu() - want).abs().max()):.3e} (tolerance atol {tol['atol']:.3g}, "
                f"rtol {tol['rtol']:.3g}; max |logit| {float(want.abs().max()):.3f}); greedy 8 "
                f"tokens {agree}; {time.perf_counter() - t0:.2f}s")
            del ref, onc, moved
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.cuda.empty_cache()

    # The launcher as a user runs it, on the card at full width.
    t0 = time.perf_counter()
    cli = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--arch", "qwen3-8b"],
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=str(SRC)))
    for line in cli.stdout.splitlines():
        log(f"  launch.serve: {line}")
    if cli.returncode != 0:
        log(cli.stderr[-4000:])
        raise AssertionError(f"python -m repro_torch.launch.serve: exit {cli.returncode}")
    log(f"  launch.serve --arch qwen3-8b: {time.perf_counter() - t0:.1f}s in its own process")
    launched = {op.__name__: op.launches for op in counters}
    if any(launched.values()):
        raise AssertionError(f"the LM path launched a k-core kernel: {launched}")
    log(f"LM phase: {time.perf_counter() - t_phase:.1f}s; k-core kernel launches on the LM "
        f"path {launched} (its products and attention are torch matmuls: no Pallas "
        f"counterpart)")
    return measured


TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 1024, 6  # phase 14(a): granite-3-2b training
TRAIN_LR = 3e-4
# Phase 14(b)-(c): the CPU tests' schedule and data (tests/test_torch_train_loop.py).
SMOKE_SCHED = dict(lr=1e-3, warmup=2, total=5)
SMOKE_SEQ, SMOKE_BATCH, SMOKE_STEPS = 16, 2, 5


def _timed_ms(torch, fn) -> float:
    """Host milliseconds of ``fn()`` between two synchronizes."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def phase_train(work: Path) -> dict:
    """Phase 14: the LM training path (``optim/``, ``data/``, remat in
    ``models/blocks.py``, ``runtime/train_loop.py``, ``launch/steps.py``,
    ``launch/train.py``, ``examples/torch/train_lm.py``). Returns phase
    14(a)'s measurements for phase 16: the median step ms and the peak
    allocated bytes of its steps."""
    import dataclasses
    import math

    import torch

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.kernels.counts import partial_counts_op
    from repro_torch.kernels.fused import fused_sweep_op
    from repro_torch.kernels.hindex import hindex_op
    from repro_torch.launch.serve import card_name
    from repro_torch.launch.steps import step_fn_for
    from repro_torch.models.model import CausalLM, loss_fn
    from repro_torch.models.module import count_params, init_params
    from repro_torch.models.parity import TRAIN_LOSS_RTOL, train_param_agreement
    from repro_torch.optim import Optimizer, apply_updates, clip_by_global_norm, \
        get_optimizer, warmup_cosine
    from repro_torch.runtime import FailureInjector, InjectedFailure, TrainLoop, make_train_step
    from repro_torch.runtime.train_loop import device_batch

    t_phase = time.perf_counter()
    dev, cpu = torch.device("cuda"), torch.device("cpu")
    card = card_name(dev)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    counters = (fused_sweep_op, hindex_op, partial_counts_op)
    for op in counters:
        op.launches = 0

    # (a) granite-3-2b at its published widths and depth: AdamW with
    # warmup-cosine, clip 1.0, full remat, through step_fn_for("train").
    cfg = get_config("granite-3-2b")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = init_params(CausalLM(cfg, device=dev), 0)
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    n_params = count_params(model)
    train_fn, _ = step_fn_for(cfg, "train", lr=TRAIN_LR)
    train_cfg = dataclasses.replace(cfg, remat="full")
    optimizer = get_optimizer(train_cfg, lr=TRAIN_LR)
    opt_state = optimizer.init(dict(model.named_parameters()))
    data = SyntheticTokens(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    step_t = torch.zeros((), dtype=torch.long, device=dev)
    state = {"opt": opt_state}

    def run_step(fn, i):
        batch = device_batch(data.batch_at(i), dev)
        out = {}

        def go():
            _, state["opt"], out["m"] = fn(model, state["opt"], step_t, batch)

        ms = _timed_ms(torch, go)
        step_t.add_(1)
        return ms, float(out["m"]["loss"]), float(out["m"]["grad_norm"])

    runs = [run_step(train_fn, i) for i in range(TRAIN_STEPS)]
    peak = torch.cuda.max_memory_allocated(dev)
    times, losses, norms = zip(*runs)
    if not all(math.isfinite(x) for x in losses + norms):
        raise AssertionError(f"granite-3-2b training: non-finite loss or grad norm {runs}")
    med_ms = statistics.median(times[2:])
    measured = {"step_ms": med_ms, "peak_bytes": peak}
    tokens = TRAIN_BATCH * TRAIN_SEQ
    state_bytes = sum(p.numel() * 4 for p in model.parameters()) * 4  # params, grads, m, v
    flop_ms = 8 * n_params * tokens / 989e12 * 1e3
    opt_ms = 7 * 4 * n_params / 3.35e12 * 1e3  # AdamW reads p, g, m, v, writes p, m, v (f32)
    log(f"LM train granite-3-2b (published widths, {cfg.n_layers} layers, {n_params:,} params, "
        f"drawn on the card from seed 0 in {init_s:.2f}s; f32 params, grads and AdamW state "
        f"{state_bytes:,} B): batch {TRAIN_BATCH} x seq {TRAIN_SEQ}, bf16 activations, full "
        f"remat, AdamW lr {TRAIN_LR} warmup-cosine, clip 1.0, deterministic; {card}")
    log(f"  steps 1-{TRAIN_STEPS} ms " + ", ".join(f"{t:.1f}" for t in times)
        + f"; loss " + ", ".join(f"{x:.4f}" for x in losses)
        + f"; grad norm " + ", ".join(f"{x:.4f}" for x in norms))
    log(f"  median of steps 3-{TRAIN_STEPS} {med_ms:.3f} ms, {tokens / med_ms * 1e3:,.0f} "
        f"tokens/s; bound {flop_ms + opt_ms:.3f} ms (8 N tokens = "
        f"{8 * n_params * tokens / 1e12:.1f} TFLOP at 989 TFLOP/s {flop_ms:.3f} ms + AdamW "
        f"{7 * 4 * n_params / 1e9:.1f} GB at 3.35 TB/s {opt_ms:.3f} ms); peak {peak:,} B "
        f"allocated; every loss and grad norm finite")

    # What deterministic mode costs: steps with it off and on, in turns.
    free_fn = make_train_step(train_cfg, optimizer, deterministic=False)
    turns = {"off": [], "on": []}
    for i, mode in enumerate(("off", "on", "on", "off")):
        turns[mode].append(run_step(free_fn if mode == "off" else train_fn,
                                    TRAIN_STEPS + i)[0])
    log(f"  deterministic mode off/on/on/off: {turns['off'][0]:.1f}, {turns['on'][0]:.1f}, "
        f"{turns['on'][1]:.1f}, {turns['off'][1]:.1f} ms: it costs "
        f"{statistics.mean(turns['on']) - statistics.mean(turns['off']):+.1f} ms a step")

    # Where the time goes: one profiled step, a forward alone (what full remat
    # computes again in backward), and the optimizer alone on fake gradients.
    log(f"  one train step: "
        f"{_profile(torch, lambda: run_step(train_fn, TRAIN_STEPS + 4), n=6, ops=12)}")

    # Trap 2 at full width: the same batch's gradients twice, with
    # deterministic mode off and on (an optimizer that keeps the first
    # gradients, compares the second with them and applies nothing).
    def grad_repeat(deterministic):
        kept, diff = {}, []

        def update(grads, st, params, step):
            if not kept:
                kept.update({k: g.clone() for k, g in grads.items()})
            else:
                diff.append(max(float((g - kept[k]).abs().max()) for k, g in grads.items()))
            return {k: g.zero_() for k, g in grads.items()}, st

        probe = make_train_step(train_cfg, Optimizer(init=lambda p: {}, update=update),
                                max_grad_norm=float("inf"), deterministic=deterministic)
        batch = device_batch(data.batch_at(0), dev)
        for _ in range(2):
            probe(model, {}, step_t, batch)
        del kept
        return diff[0]

    repeat = {mode: grad_repeat(mode == "on") for mode in ("off", "on")}
    if repeat["on"] != 0.0:
        raise AssertionError(f"granite-3-2b: deterministic gradients differ by {repeat['on']}")
    log(f"  the same batch's gradients twice at full width: max abs diff {repeat['off']:.3e} "
        f"with deterministic mode off, {repeat['on']:.3e} with it on")
    batch = device_batch(data.batch_at(0), dev)
    with torch.no_grad():
        fwd_ms = min(_timed_ms(torch, lambda: loss_fn(model, batch)) for _ in range(3))
    with torch.no_grad():
        params = {k: p.detach() for k, p in model.named_parameters()}
        grads = {k: torch.randn_like(p).mul_(1e-3) for k, p in params.items()}

        def opt_pass():
            g, _ = clip_by_global_norm(grads, 1.0)
            upd, state["opt"] = optimizer.update(g, state["opt"], params, step_t)
            apply_updates(params, upd)

        opt_pass_ms = _timed_ms(torch, opt_pass)
    del grads, params
    log(f"  forward alone (no grad) {fwd_ms:.3f} ms, computed twice a step under full remat; "
        f"clip + AdamW + apply alone {opt_pass_ms:.3f} ms (bound {opt_ms:.3f} ms); the rest of "
        f"the step (backward) {med_ms - 2 * fwd_ms - opt_pass_ms:.3f} ms")
    del model, state, optimizer, opt_state, batch
    torch.cuda.empty_cache()

    # (b) card against CPU: the same carried parameters, schedule and data as
    # the CPU tests, five steps each; granite with AdamW, grok-1 with
    # Adafactor on its stacked leaves (bf16 parameters).
    lr_fn = warmup_cosine(SMOKE_SCHED["lr"], SMOKE_SCHED["warmup"], SMOKE_SCHED["total"])

    def smoke_loop(c, base, device, **kw):
        m = CausalLM(c, device=device)
        m.load_state_dict(base.state_dict())
        return TrainLoop(cfg=c, model=m, optimizer=get_optimizer(c, **SMOKE_SCHED),
                         data=SyntheticTokens(c.vocab_size, SMOKE_SEQ, SMOKE_BATCH, seed=1), **kw)

    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for arch in ("granite-3-2b", "grok-1-314b"):
            c = get_smoke_config(arch)
            base = init_params(CausalLM(c, device=cpu), 0)
            res = []
            for device in (cpu, dev):
                loop = smoke_loop(c, base, device)
                hist = loop.run(SMOKE_STEPS, log_every=1)
                res.append((hist["loss"], {k: v.cpu() for k, v in loop.model.state_dict().items()}))
            (l_cpu, p_cpu), (l_dev, p_dev) = res
            rel = max(abs(a - b) / abs(b) for a, b in zip(l_dev, l_cpu))
            if rel > TRAIN_LOSS_RTOL:
                raise AssertionError(f"{arch} training: card losses {l_dev} against the CPU's "
                                     f"{l_cpu}: rel diff {rel:.3e} > {TRAIN_LOSS_RTOL}")
            note = train_param_agreement(p_dev, p_cpu, lr_fn, SMOKE_STEPS)
            log(f"  card vs cpu, {arch} (smoke) with {c.optimizer}, {SMOKE_STEPS} steps, f32 "
                f"activations: loss max rel diff {rel:.3e} (rtol {TRAIN_LOSS_RTOL}); parameters "
                f"{note}")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32

    # (c) resume on the card, granite smoke: a crash at step 8 after the
    # step-5 checkpoint, resumed to step 12, against an uninterrupted run.
    c = get_smoke_config("granite-3-2b")
    base = init_params(CausalLM(c, device=cpu), 0)
    whole = smoke_loop(c, base, dev, ckpt_dir=str(work / "train_a"), ckpt_every=5,
                       ckpt_blocking=True)
    whole.run(12, log_every=1)
    crashed = smoke_loop(c, base, dev, ckpt_dir=str(work / "train_b"), ckpt_every=5,
                         ckpt_blocking=True, failure_injector=FailureInjector(fail_at={8}))
    try:
        crashed.run(12, log_every=1)
        raise AssertionError("train resume: the injected failure never fired")
    except InjectedFailure:
        pass
    resumed = smoke_loop(c, init_params(CausalLM(c, device=cpu), 1), dev,
                         ckpt_dir=str(work / "train_b"), ckpt_every=5, ckpt_blocking=True)
    if not resumed.try_resume() or resumed.step != 5:
        raise AssertionError(f"train resume: resumed at step {resumed.step}, not 5")
    resumed.run(12 - resumed.step, log_every=1)
    differ = [k for k, v in whole.model.state_dict().items()
              if not torch.equal(v, resumed.model.state_dict()[k])]
    differ += [f"opt {part} {k}" for part in ("m", "v") for k in whole.opt_state[part]
               if not torch.equal(whole.opt_state[part][k], resumed.opt_state[part][k])]
    if differ:
        raise AssertionError(f"train resume on the card is not bit-identical: {differ[:8]}")
    log(f"  resume on the card (granite smoke): crashed at step 8, resumed from the step-5 "
        f"checkpoint to step 12: parameters and AdamW state bit-identical to an uninterrupted "
        f"run")

    # (d) the launcher and the example, as a user runs them, on the card.
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    cmds = {"launch.train": [sys.executable, "-m", "repro_torch.launch.train", "--arch",
                             "mamba2-130m", "--steps", "20", "--batch", "4", "--seq", "512"],
            "train_lm.py": [sys.executable, str(ROOT / "examples" / "torch" / "train_lm.py")]}
    procs = {name: subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                    text=True, env=env) for name, cmd in cmds.items()}
    outs = {}
    try:
        for name, proc in procs.items():
            outs[name] = proc.communicate(timeout=600)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for name, (out, err) in outs.items():
        for line in out.splitlines():
            log(f"  {name}: {line}")
        if procs[name].returncode != 0:
            log(err[-4000:])
            raise AssertionError(f"{name}: exit {procs[name].returncode}")
    if "loss decreased" not in outs["train_lm.py"][0]:
        raise AssertionError("examples/torch/train_lm.py: the loss did not decrease")
    log(f"  launch.train --arch mamba2-130m (published widths) and the example beside it: "
        f"{time.perf_counter() - t0:.1f}s in their own processes")
    launched = {op.__name__: op.launches for op in counters}
    if any(launched.values()):
        raise AssertionError(f"the LM training path launched a k-core kernel: {launched}")
    log(f"LM training phase: {time.perf_counter() - t_phase:.1f}s; k-core kernel launches on "
        f"the training path {launched} (its products, attention and losses are torch "
        f"matmuls and autograd: no Pallas counterpart)")
    return measured


# Phase 16: the traced FLOPs of a step within this of the analytic model's,
# the reference's tolerance (tests/test_roofline.py).
LM_DRYRUN_FLOPS_RTOL = 0.15


def phase_lm_dryrun(serve: dict, train: dict) -> None:
    """Phase 16: the LM dry-run against the card. The three steps phases 13
    and 14 ran on the card, traced once more on meta tensors (one rank, no
    mesh) under the dry-run's tally: granite-3-2b's train step at 4 x 1,024
    with full remat and AdamW, qwen3-8b's prefill at 4 x 512 (cache room
    for 64 more tokens) and one decode step at batch 4 on its caches. For
    each, the traced peak (arguments plus the call's own storages) against
    the card's ``max_memory_allocated``, the traced FLOPs against
    ``flops_model.cost(..., n_chips=1)`` (asserted within
    ``LM_DRYRUN_FLOPS_RTOL``), and the FLOP roofline's time against the
    card's time. The traced peak must hold at least the resident
    parameters (and for the train step their gradients and AdamW state);
    the ratio to the card's peak is printed, not asserted."""
    import dataclasses

    import torch

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch.serve import card_name
    from repro_torch.launch.steps import step_fn_for
    from repro_torch.models.model import CausalLM
    from repro_torch.models.module import count_params
    from repro_torch.optim import get_optimizer
    from repro_torch.roofline import flops_model
    from repro_torch.roofline.analysis import CollectiveStats, flop_roofline_terms
    from repro_torch.roofline.tally import Tally

    t_phase = time.perf_counter()
    # The trace needs no card: without one (a check of the phase alone on a
    # CPU host, with measurements passed in) the card line says so.
    card = card_name(torch.device("cuda")) if torch.cuda.is_available() else "no card"
    meta = torch.device("meta")

    def nbytes(tensors):
        return sum(t.numel() * t.element_size() for t in tensors)

    def report(label, cfg, shape, n_params, tally, arg_bytes, resident, measured_peak,
               measured_ms):
        want = flops_model.cost(cfg, shape, n_params, 1, remat=shape.kind == "train").flops_total
        rel = abs(tally.flops - want) / want
        rl = flop_roofline_terms(tally.flops, tally.hbm_bytes, CollectiveStats(), 1)
        peak = arg_bytes + tally.peak_bytes
        log(f"  {label}: traced peak {peak:,} B (arguments {arg_bytes:,} + the call's own "
            f"{tally.peak_bytes:,}) against the card's max_memory_allocated {measured_peak:,} B "
            f"(ratio {peak / measured_peak:.3f}); traced FLOPs {tally.flops:,} against the "
            f"analytic {want:,.0f} (rel {rel:.4f}); roofline {max(rl.compute_s, rl.memory_s) * 1e3:.3f}"
            f" ms ({rl.bottleneck}: compute {rl.compute_s * 1e3:.3f} ms, memory "
            f"{rl.memory_s * 1e3:.3f} ms of {tally.hbm_bytes:,} B) against the card's "
            f"{measured_ms:.3f} ms")
        if rel > LM_DRYRUN_FLOPS_RTOL:
            raise AssertionError(f"{label}: traced FLOPs {tally.flops:,} not within "
                                 f"{LM_DRYRUN_FLOPS_RTOL} of the analytic {want:,.0f}")
        if peak < resident:
            raise AssertionError(f"{label}: traced peak {peak:,} B below the resident "
                                 f"{resident:,} B")

    log(f"LM dry-run against the card (one rank, meta tensors, the dry-run's tally); {card}")

    # granite-3-2b's train step, as phase 14(a) ran it.
    cfg = get_config("granite-3-2b")
    model = CausalLM(cfg, device=meta)
    n_params = count_params(model)
    fn, _ = step_fn_for(cfg, "train", lr=TRAIN_LR)
    params = dict(model.named_parameters())
    opt_state = get_optimizer(dataclasses.replace(cfg, remat="full"), lr=TRAIN_LR).init(params)
    batch = {k: torch.empty(TRAIN_BATCH, TRAIN_SEQ, dtype=torch.int32, device=meta)
             for k in ("tokens", "labels")}
    step_t = torch.zeros((), dtype=torch.long, device=meta)
    args = list(params.values()) + [opt_state["m"][k] for k in params] + \
        [opt_state["v"][k] for k in params] + list(batch.values())
    with Tally() as tally:
        fn(model, opt_state, step_t, batch)
    p_bytes = nbytes(params.values())
    report(f"granite-3-2b train step {TRAIN_BATCH} x {TRAIN_SEQ}", cfg,
           ShapeConfig("smoke", "train", TRAIN_SEQ, TRAIN_BATCH), n_params, tally, nbytes(args),
           p_bytes * 4, train["peak_bytes"], train["step_ms"])  # params, grads, m, v (f32)

    # qwen3-8b's prefill and one decode step, as phase 13(a) ran them.
    cfg = get_config("qwen3-8b")
    model = CausalLM(cfg, device=meta)
    n_params = count_params(model)
    p_bytes = nbytes(model.parameters())
    prompt = torch.empty(LM_BATCH, LM_PROMPT, dtype=torch.long, device=meta)
    with torch.inference_mode(), Tally() as tally:
        _logits, caches = model.prefill(prompt, max_len=LM_PROMPT + LM_NEW)
    report(f"qwen3-8b prefill {LM_BATCH} x {LM_PROMPT}", cfg,
           ShapeConfig("smoke", "prefill", LM_PROMPT, LM_BATCH), n_params, tally,
           p_bytes + nbytes([prompt]), p_bytes, serve["peak_bytes"], serve["prefill_ms"])
    cache_bytes = nbytes(t for c in caches for d in c.values() for t in d.values())
    token = torch.empty(LM_BATCH, 1, dtype=torch.long, device=meta)
    position = torch.empty(LM_BATCH, dtype=torch.long, device=meta)
    with torch.inference_mode(), Tally() as tally:
        model.decode_step(caches, token, position)
    report(f"qwen3-8b decode step, batch {LM_BATCH}, {LM_PROMPT + LM_NEW} cache slots", cfg,
           ShapeConfig("smoke", "decode", LM_PROMPT + LM_NEW, LM_BATCH), n_params, tally,
           p_bytes + cache_bytes, p_bytes + cache_bytes, serve["peak_bytes"], serve["decode_ms"])
    log(f"LM dry-run phase: {time.perf_counter() - t_phase:.1f}s")


def _serve_batches(g0, seed):
    """The edit batches of phase 10, drawn from ``np.random.default_rng(seed)``
    as ``tests/test_incremental.py::_random_batch`` draws them: uniform node
    pairs to insert, and existing edges to delete (a uniform node of nonzero
    degree, then a uniform neighbour) of the graph as it stands before the
    batch. A generator: send it each batch's resulting graph."""
    import numpy as np

    rng = np.random.default_rng(seed)
    g = g0
    for n_ins, n_del in SERVE_BATCHES:
        n = g.n_nodes
        iu, iv = rng.integers(0, n, n_ins), rng.integers(0, n, n_ins)
        nz = np.nonzero(np.diff(g.indptr) > 0)[0]
        rows = nz[rng.integers(0, nz.size, n_del)] if n_del else np.zeros(0, np.int64)
        du, dv = [], []
        for r in rows.tolist():
            du.append(r)
            dv.append(int(g.indices[rng.integers(g.indptr[r], g.indptr[r + 1])]))
        g = yield iu, iv, np.asarray(du, np.int64), np.asarray(dv, np.int64)


def phase_serve(g, npz_path: Path, work: Path) -> None:
    """Phase 10: the serve path on the card. This thread writes the edit log
    batch by batch while it replays it through the fused engine (each batch
    checked against a from-scratch fused decompose); a second thread replays
    it through the h-index engine and the serve CLI tails it in a
    subprocess, both as the batches are sealed."""
    import threading

    import numpy as np
    import torch
    import repro_torch.core.incremental as incremental
    from repro_torch.core.decompose import decompose
    from repro_torch.core.hindex import hindex_of_sequence
    from repro_torch.graph.build import bucketize
    from repro_torch.graph.editlog import EditLog, EditLogReader
    from repro_torch.graph.oracle import peel_coreness
    from repro_torch.kernels.fused import fused_sweep_op, fused_sweep_plain
    from repro_torch.kernels.hindex import hindex_op, hindex_plain

    n_batches = len(SERVE_BATCHES)
    log_dir = work / "editlog"
    boot = decompose(bucketize(g), op="fused", device="cuda").coreness
    # The starting state of the first incremental re-sweep: the real
    # decompose runs, its arguments are kept.
    captured = []
    real_decompose = incremental.decompose

    def capturing(bg, **kw):
        if kw.get("seed_nodes") is not None and not captured:
            captured.append((bg, np.array(kw["init_coreness"]), np.asarray(kw["seed_nodes"])))
        return real_decompose(bg, **kw)

    fresh = [None] * n_batches  # the from-scratch fused coreness after each batch
    fresh_ready = [threading.Event() for _ in range(n_batches)]
    abort = threading.Event()
    deadline = time.monotonic() + FLEET_TIMEOUT_S

    def replay(op, writer=None):
        """Fold the log's batches through apply_updates on the card, each
        checked against the from-scratch result. With ``writer`` (the fused
        run) draw each batch, write it to the log, and compute that result.
        Returns (final graph, final coreness, modes, update-path launches);
        a kernel's launches are counted around apply_updates only, and each
        counter is moved by one thread only."""
        graph, core, modes, launched = g, boot, [], 0
        counter = fused_sweep_op if op == "fused" else hindex_op
        reader = EditLogReader(str(log_dir))
        batches = _serve_batches(g, SEED) if writer is not None else None
        edits = next(batches) if batches is not None else None
        for b in range(n_batches):
            if writer is not None:
                writer.append(edits[0], edits[1])
                writer.append(edits[2], edits[3], delete=True)
                writer.seal_batch()
            while reader.poll() == 0:
                if abort.is_set() or time.monotonic() > deadline:
                    raise AssertionError(f"serve {op}: batch {b} was never sealed")
                time.sleep(0.05)
            batch = reader.read_batch()
            before = counter.launches
            res = incremental.apply_updates(graph, core, batch, op=op, device="cuda")
            launched += counter.launches - before
            graph, core = res.graph, res.coreness
            modes.append(res.mode)
            split = " ".join(f"{k} {v:.3f}s" for k, v in res.stage_s.items())
            sweeps = res.decompose_result.iterations if res.decompose_result else 0
            log(f"serve {op:>6} batch {b}: {batch.n_raw:,} raw edits ({res.n_inserted:,} "
                f"inserted, {res.n_deleted:,} deleted), mode {res.mode}, dirty fraction "
                f"{res.dirty_frac:.4f} ({res.dirty_count:,} nodes), {sweeps} sweeps, wall "
                f"{res.wall_time_s:.3f}s = {split}")
            if writer is not None:
                fresh[b] = decompose(bucketize(graph), op="fused", device="cuda").coreness
                fresh_ready[b].set()
                if b + 1 < n_batches:
                    edits = batches.send(graph)
            elif not fresh_ready[b].wait(timeout=max(1.0, deadline - time.monotonic())):
                raise AssertionError(f"serve {op}: no from-scratch result for batch {b}")
            if not np.array_equal(core, fresh[b]):
                raise AssertionError(f"serve {op} batch {b}: coreness != a from-scratch fused "
                                     f"decompose")
        if launched <= 0:
            raise AssertionError(f"serve {op}: the kernel never launched on the update path")
        if not {"incremental", "full"} <= set(modes):
            raise AssertionError(f"serve {op}: update modes {modes} (both must occur)")
        return graph, core, modes, launched

    kernel_run = {}

    def kernel_replay():
        try:
            kernel_run["result"] = replay("kernel")
        except BaseException as exc:  # re-raised by the main thread
            kernel_run["error"] = exc

    env = dict(os.environ, PYTHONPATH=str(SRC))
    cli_out = open(work / "serve_cli.log", "w+")
    t_serve = time.perf_counter()
    incremental.decompose = capturing
    with EditLog(str(log_dir)) as writer:
        cli = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.kcore_serve", "--graph",
             f"npz:{npz_path}", "--device", "cuda", "--engine", "fused", "--edit-log",
             str(log_dir), "--max-batches", str(n_batches), "--idle-timeout-s",
             str(FLEET_TIMEOUT_S), "--json"],
            stdout=cli_out, stderr=subprocess.STDOUT, env=env, cwd=str(ROOT))
        worker = threading.Thread(target=kernel_replay, name="smoke-serve-kernel")
        worker.start()
        try:
            fused = replay("fused", writer)
            worker.join(timeout=max(1.0, deadline - time.monotonic()))
            cli.wait(timeout=max(1.0, deadline - time.monotonic()))
        finally:
            abort.set()
            worker.join(timeout=60)
            incremental.decompose = real_decompose
            if cli.poll() is None:
                cli.kill()
                cli.wait()
            cli_out.seek(0)
            cli_text = cli_out.read()
            cli_out.close()
    serve_s = time.perf_counter() - t_serve
    if "error" in kernel_run:
        raise kernel_run["error"]
    kernel = kernel_run["result"]
    final_graph, final_core = fused[0], fused[1]
    if not same_csr(final_graph, kernel[0]):
        raise AssertionError("serve: the two engines' final graphs differ")
    t0 = time.perf_counter()
    if not np.array_equal(final_core, peel_coreness(final_graph)):
        raise AssertionError("serve: the final graph's coreness != the oracle")
    log(f"serve in process ({serve_s:.1f}s for both replays beside the CLI): every batch "
        f"equal to a from-scratch fused decompose, the final graph (n={final_graph.n_nodes:,} "
        f"m={final_graph.n_edges:,}) equal to the oracle ({time.perf_counter() - t0:.1f}s); "
        f"modes {fused[2]}; update-path launches fused_sweep={fused[3]:,} (fused engine), "
        f"hindex={kernel[3]:,} (h-index engine)")
    if cli.returncode != 0:
        log(cli_text[-6000:])
        raise AssertionError(f"serve CLI exited {cli.returncode}")
    m = json.loads(cli_text.strip().splitlines()[-1])
    if (m["batches_drained"] != n_batches or m["final_n_nodes"] != final_graph.n_nodes
            or m["final_k_max"] != int(final_core.max())
            or m["update_modes"] != {mode: fused[2].count(mode) for mode in set(fused[2])}
            or m["kernel_launches"]["fused_sweep"] <= 0 or m["device"] != "cuda"):
        raise AssertionError(f"serve CLI: unexpected metrics {m}")
    log(f"serve CLI (--device cuda --engine fused, tailing the log as it was written): "
        f"{m['batches_drained']} batches, modes {m['update_modes']}, updates/s "
        f"{m['updates_per_s']:.1f}, publishes/s {m['publishes_per_s']:.3f}, "
        f"{m['n_queries']:,} queries, query p50 {m['query_p50_ms']:.4f} ms p99 "
        f"{m['query_p99_ms']:.4f} ms, staleness mean {m['staleness_mean_edits']:.1f} / max "
        f"{m['staleness_max_edits']:.0f} pending edits, max snapshot age "
        f"{m['staleness_max_age_s']:.2f}s, fused launches on its update path "
        f"{m['kernel_launches']['fused_sweep']:,}")

    # The kernels at an incremental re-sweep's starting state.
    if not captured:
        raise AssertionError("serve: no incremental re-sweep was captured")
    bg, init, seeds = captured[0]
    dev = torch.device("cuda")
    n = bg.n_nodes
    c = torch.cat([torch.from_numpy(init.astype(np.int32)),
                   torch.full((1,), -1, dtype=torch.int32)]).to(dev)
    ext_pad = torch.cat([torch.as_tensor(np.asarray(bg.ext), dtype=torch.int32),
                         torch.zeros(1, dtype=torch.int32)]).to(dev)
    cand = max(1, hindex_of_sequence(bg.degrees.astype(np.int64) + bg.ext))
    seed_ids = np.nonzero(seeds)[0] if seeds.dtype == bool else seeds
    owner = bg.node_bucket_map()[:-1][seed_ids]
    active = sorted(set(int(o) for o in owner if o >= 0))
    err = {"fused": 0, "hindex": 0}
    for b in bg.buckets:
        ids = torch.as_tensor(b.node_ids).to(dev)
        neigh = torch.as_tensor(b.neigh).to(dev)
        for track in (True, False):
            want = fused_sweep_plain(c, ext_pad, ids, neigh, cand=cand, track_dirty=track)
            got = fused_sweep_op(c, ext_pad, ids, neigh, cand=cand, track_dirty=track)
            err["fused"] = max(err["fused"], max(int((x.long() - y.long()).abs().max())
                                                 for x, y in zip(got, want)))
        x, e = c[neigh], ext_pad[ids]
        err["hindex"] = max(err["hindex"], int((hindex_op(x, e, cand=cand).long()
                                                - hindex_plain(x, e, cand=cand).long())
                                               .abs().max()))
    log(f"kernels at an incremental re-sweep's starting state ({len(bg.buckets)} tiles, "
        f"{seed_ids.size:,} seeded nodes in {len(active)} active tiles, n={n:,}, "
        f"cand={cand}): fused (push on and off) and hindex against their plain versions on "
        f"every tile, max abs err fused={err['fused']} hindex={err['hindex']} (tolerance 0)")
    if err["fused"] or err["hindex"]:
        raise AssertionError(f"kernels at the re-sweep state != plain versions: {err}")


def fleet_rank(rank: int, work: str) -> int:
    """One rank of phase 6: join the gloo group, run the (2, 2) plan on the
    graph the parent wrote to ``work``, then the plan's two rank slices
    part-parallel, and write this rank's results there."""
    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(SRC))
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{work}/store",
                            rank=rank, world_size=4)
    from repro_torch.core.dckcore import dc_kcore
    from repro_torch.core.distributed import (decompose_distributed,
                                              make_distributed_decompose,
                                              planned_collective_schedule)
    from repro_torch.core.hindex import hindex_of_sequence
    from repro_torch.core.partsched import slice_mesh_plans
    from repro_torch.graph.build import bucketize
    from repro_torch.graph.structs import Graph
    from repro_torch.kernels.counts import partial_counts_op
    from repro_torch.launch.mesh import make_mesh_plan

    data = np.load(Path(work) / "graph.npz")
    g = Graph(indptr=data["indptr"], indices=data["indices"], n_nodes=int(data["n_nodes"]))
    plan = make_mesh_plan(FLEET_SHAPE, FLEET_AXES)
    fn = make_distributed_decompose(plan, use_kernel=True, device="cuda")
    results = []

    def rec(bg, **kw):
        res = fn(bg, **kw)
        results.append(res)
        return res

    partial_counts_op.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    core, rep = dc_kcore(g, THRESHOLDS, decompose_fn=rec)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = partial_counts_op.launches
    bg = bucketize(g)
    cand = max(1, hindex_of_sequence(bg.degrees.astype(np.int64) + bg.ext))
    full = decompose_distributed(bg, plan, use_kernel=True, frontier=False, device="cuda")
    planned = planned_collective_schedule(
        [b.n_rows for b in bg.buckets], plan, cand, n_iters=full.iterations,
        full_sweeps=full.iterations, frontier=False)
    np.save(Path(work) / f"core{rank}.npy", core)

    # Part-parallel rank slices: the plan split into two slices of two ranks
    # along "data"; each rank conquers its slice's parts and receives the
    # other slice's results.
    partial_counts_op.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    core_pp, rep_pp = dc_kcore(g, THRESHOLDS, strategy="exact", part_parallel=2,
                               part_parallel_plan=plan, device="cuda")
    torch.cuda.synchronize()
    pp = {
        "wall": time.perf_counter() - t0, "launches": partial_counts_op.launches,
        "conquer_wall_s": rep_pp.conquer_wall_s, "slice_busy_s": rep_pp.slice_busy_s,
        "slice_utilization": rep_pp.slice_utilization,
        "slice_index": [p.slice_index for p in rep_pp.parts],
        "boundary_exchange_bytes": rep_pp.boundary_exchange_bytes,
        "own_slice": next(i for i, p in enumerate(slice_mesh_plans(plan, 2)) if p.rank >= 0),
    }
    np.save(Path(work) / f"core_pp{rank}.npy", core_pp)
    (Path(work) / f"rank{rank}.json").write_text(json.dumps({
        "trajectories": [[r.comm_per_iter, r.active_rows_per_iter] for r in results],
        "collective_bytes": [b for r in results for b in r.collective_bytes_per_iter],
        "full_sweep_bytes": full.collective_bytes_per_iter, "planned_bytes": planned,
        "blocks": [plan.node_index, plan.slot_index], "launches": launches,
        "wall": wall, "sweeping": rep.total_decompose_time_s, "sweeps": rep.total_iterations,
        "part_parallel": pp,
    }))
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--fleet-rank":
        sys.exit(fleet_rank(int(sys.argv[2]), sys.argv[3]))
    sys.exit(main())
