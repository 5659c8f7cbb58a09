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
   equality (all values are integers). Then each kernel's device time for
   one full sweep (one launch per tile), its plain version's time and the
   least time the card could take for the same work.
3. The main path: ``dc_kcore`` on ``rmat(20, 16, seed=0)`` with the rough
   thresholds (64, 16) and monolithic, through the fused engine in int32
   and int16 and through the h-index kernel engine, plus one run of the
   fused compaction dispatch. Every run's coreness must equal the
   Batagelj-Zaversnik peeling oracle. The kernels' launch counters are
   zeroed just before and read just after, and each engine's kernel must
   have launched.
4. The kernel table as one JSON line, then the result line.

Nothing here imports JAX or the JAX package (``src/repro``).
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

SCALE, EDGE_FACTOR, SEED = 20, 16, 0
THRESHOLDS = (64, 16)
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
    from repro_torch.kernels import build
    from repro_torch.kernels.fused import fused_sweep_op, fused_sweep_plain
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

    max_err = {"fused": 0, "hindex": 0}
    checks = {"fused": 0, "hindex": 0}
    t0 = time.perf_counter()
    for sname, state in states.items():
        for dtype in (torch.int32, torch.int16):
            c = padded(state, dtype)
            for ids, neigh in tiles:
                for track in (True, False):
                    got = fused_sweep_op(c, ext_pad, ids, neigh, cand=cand, track_dirty=track)
                    want = fused_sweep_plain(c, ext_pad, ids, neigh, cand=cand, track_dirty=track)
                    err = max(int((a.long() - b.long()).abs().max()) for a, b in zip(got, want))
                    max_err["fused"] = max(max_err["fused"], err)
                    checks["fused"] += 1
                    if err:
                        raise AssertionError(
                            f"fused kernel != plain: state {sname} {dtype} width "
                            f"{neigh.shape[1]} rows {neigh.shape[0]} track_dirty {track} "
                            f"max abs err {err}")
        c = padded(state, torch.int32)
        for ids, neigh in tiles:
            x = c[neigh]
            got = hindex_op(x, ext_pad[ids], cand=cand)
            want = hindex_plain(x, ext_pad[ids], cand=cand)
            err = int((got.long() - want.long()).abs().max())
            max_err["hindex"] = max(max_err["hindex"], err)
            checks["hindex"] += 1
            if err:
                raise AssertionError(f"hindex kernel != plain: state {sname} width "
                                     f"{neigh.shape[1]} max abs err {err}")
    torch.cuda.synchronize()
    log(f"kernels vs plain versions: {checks['fused']} fused and {checks['hindex']} "
        f"hindex comparisons at all {len(tiles)} tile shapes, states "
        f"{list(states)}: max abs err fused={max_err['fused']} "
        f"hindex={max_err['hindex']} (tolerance 0) in {time.perf_counter() - t0:.1f}s")

    # Timing of one full sweep at the start state (int32, dirty push on).
    c = padded(states["start"], torch.int32)
    dirty = torch.zeros(n + 1, dtype=torch.int8, device=dev)
    gathered = [c[neigh] for _ids, neigh in tiles]
    ext_rows = [ext_pad[ids] for ids, _neigh in tiles]

    def fused_sweep_kernel():
        for ids, neigh in tiles:
            fused_sweep_op(c, ext_pad, ids, neigh, cand=cand, dirty=dirty)

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
    log(f"one full sweep at the start state ({len(tiles)} launches, {rows:,} rows, "
        f"{slots:,} slots): fused kernel {fused_ms:.4f} ms (plain {fused_plain_ms:.2f} ms, "
        f"bound {fused_bound_ms:.4f} ms by {fused_by}); hindex kernel {hindex_ms:.4f} ms "
        f"(plain {hindex_plain_ms:.2f} ms, bound {hindex_bound_ms:.4f} ms by {hindex_by}); "
        f"no single PyTorch call computes an h-index, so there is no library time; "
        f"the TPU form's dense compare (kcore_model.sweep_cost) at the INT32 rate "
        f"would take fused {fused_model_ms:.4f} ms, hindex {hindex_model_ms:.4f} ms")

    per_width = {}
    for (ids, neigh), x, e in zip(tiles, gathered, ext_rows):
        w = int(neigh.shape[1])
        fk = device_time_ms(torch, lambda: fused_sweep_op(
            c, ext_pad, ids, neigh, cand=cand, dirty=dirty), reps=5)
        hk = device_time_ms(torch, lambda: hindex_op(x, e, cand=cand), reps=5)
        acc = per_width.setdefault(w, [0, 0, 0.0, 0.0])
        acc[0] += 1
        acc[1] += int(neigh.shape[0])
        acc[2] += fk
        acc[3] += hk
    for w, (nt, nr, fk, hk) in sorted(per_width.items()):
        log(f"  width {w:>6}: {nt:>2} tile(s) {nr:>8,} rows: fused {fk:.4f} ms, "
            f"hindex {hk:.4f} ms (one launch per tile, each timed alone)")

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

    bad = sorted(m for m in sys.modules
                 if m in ("jax", "repro") or m.startswith(("jax.", "repro.")))
    if bad:
        raise AssertionError(f"JAX or the JAX package was imported: {bad}")

    # ---------------- phase 4: result lines ---------------- #
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
    ]
    log(f"chip_smoke total {time.perf_counter() - t_all:.1f}s")
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
