"""Coreness serving front end of the PyTorch port -- incremental maintenance
under query load.

  python -m repro_torch.launch.kcore_serve --graph rmat:12:8 --edit-log /tmp/log
  python -m repro_torch.launch.kcore_serve --graph npz:/data/g.npz --edit-log /tmp/log \
      --engine fused --query-batch 256 --max-batches 50
  python -m repro_torch.launch.kcore_serve --graph ba:2000:5 --edit-log /tmp/log \
      --engine count --device cpu

Boots the graph, runs one full decompose, publishes the snapshot through
:class:`~repro_torch.core.snapshot_pub.SnapshotPublisher`, then splits into
two roles: an update worker thread (named ``kcore-serve-update``) tails the
``--edit-log`` directory (:class:`~repro_torch.graph.editlog.EditLogReader`,
EdgeStore chunk format; a log written by either package replays here),
folds each sealed batch through
:func:`~repro_torch.core.incremental.apply_updates`, and republishes; the
main thread plays query traffic (batched coreness lookups, k-core
membership, top-core) against whatever snapshot is currently published.
The run drains every sealed batch (stopping after ``--max-batches`` if set,
or once the log has been idle for ``--idle-timeout-s``) and prints the
publisher's metrics: updates/sec, publishes/sec, query p50/p99 latency,
and staleness (edits pending at query time, plus the maximum snapshot age
observed by a query).

``--device`` is where the boot decompose and every re-sweep run (default
``cuda``, through the fused or h-index CUDA kernel with ``--engine
fused|kernel``; without a GPU that raises, ``cpu`` runs the kernels' plain
versions). The update thread is the only one that launches kernels; the
main thread reads numpy snapshots. A transient ``apply_updates``/publish
failure is retried in place with exponential backoff (``--update-retries``
/ ``--update-backoff-s``) before it takes the worker down -- the batch is
already drained from the log and ``apply_updates`` is pure over its
inputs, so a retry is idempotent. A CUDA error is not retried: it ends the
worker at once and the CLI re-raises it. ``--stale-warn-s`` prints a
warning the first time a query sees a snapshot older than that; ``--fault
serve_update:crash...`` injects failures into the update path for chaos
testing (see :class:`repro_torch.runtime.FaultPlan`).
"""
from __future__ import annotations

import argparse
import json
import threading
import time

import numpy as np
import torch

from repro_torch.core.decompose import decompose
from repro_torch.core.incremental import apply_updates
from repro_torch.core.snapshot_pub import SnapshotPublisher
from repro_torch.graph.build import bucketize
from repro_torch.graph.editlog import EditLogReader
from repro_torch.kernels.fused import fused_sweep_op
from repro_torch.kernels.hindex import hindex_op
from repro_torch.launch.kcore import load_graph

UPDATE_THREAD_NAME = "kcore-serve-update"


def _is_device_error(exc: BaseException) -> bool:
    """A CUDA failure (a launch error, an out-of-memory, an error the CUDA
    runtime reports): retrying the batch cannot cure it."""
    return isinstance(exc, torch.OutOfMemoryError) or (
        isinstance(exc, RuntimeError) and "CUDA" in str(exc))


def _update_loop(
    pub: SnapshotPublisher,
    reader: EditLogReader,
    state: dict,
    *,
    op: str,
    dirty_budget_frac: float,
    max_batches: int | None,
    idle_timeout_s: float,
    poll_interval_s: float,
    stop: threading.Event,
    retries: int = 3,
    backoff_s: float = 0.05,
    fault_plan=None,
    device="cuda",
) -> None:
    def fold_and_publish(edits):
        # One retry unit: the edits are already drained from the log and
        # apply_updates is pure over (graph, coreness, edits), so rerunning
        # after a transient failure is idempotent. State is only committed
        # after publish succeeds.
        if fault_plan is not None:
            fault_plan.visit("serve_update", batch=state["n_batches"])
        res = apply_updates(
            state["graph"], state["coreness"], edits,
            op=op, dirty_budget_frac=dirty_budget_frac, device=device,
        )
        pub.publish(res.graph, res.coreness, n_edits=edits.n_raw)
        state["graph"], state["coreness"] = res.graph, res.coreness
        state["modes"][res.mode] = state["modes"].get(res.mode, 0) + 1
        state["n_batches"] += 1

    idle_since = time.perf_counter()
    try:
        while not stop.is_set():
            if reader.poll() == 0:
                if time.perf_counter() - idle_since > idle_timeout_s:
                    return
                time.sleep(poll_interval_s)
                continue
            edits = reader.read_batch()
            idle_since = time.perf_counter()
            pub.note_pending(edits.n_raw)
            attempt = 0
            while True:
                try:
                    fold_and_publish(edits)
                    break
                except Exception as exc:
                    attempt += 1
                    if attempt > retries or stop.is_set() or _is_device_error(exc):
                        raise
                    state["update_retries"] += 1
                    print(f"update batch failed ({exc!r}); "
                          f"retry {attempt}/{retries}")
                    time.sleep(backoff_s * (2 ** (attempt - 1)))
            if max_batches is not None and state["n_batches"] >= max_batches:
                return
    except Exception as exc:  # surfaced as the CLI's exit error
        state["error"] = exc


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--graph", default="rmat:12:8")
    ap.add_argument("--edit-log", required=True,
                    help="EditLog directory to tail (EdgeStore slot format)")
    ap.add_argument("--engine", choices=["sorted", "count", "kernel", "fused"],
                    default="count", help="sweep engine for re-sweeps")
    ap.add_argument("--dirty-budget-frac", type=float, default=0.5,
                    help="dirty-region fraction beyond which an update "
                         "falls back to a full re-sweep")
    ap.add_argument("--query-batch", type=int, default=128,
                    help="node ids per batched coreness query")
    ap.add_argument("--max-batches", type=int, default=None,
                    help="stop after draining this many sealed batches")
    ap.add_argument("--idle-timeout-s", type=float, default=1.0,
                    help="exit once the log has been idle this long")
    ap.add_argument("--poll-interval-s", type=float, default=0.01)
    ap.add_argument("--update-retries", type=int, default=3,
                    help="retry a failed update batch this many times with "
                         "exponential backoff before exiting")
    ap.add_argument("--update-backoff-s", type=float, default=0.05,
                    help="base backoff between update retries (doubles "
                         "per attempt)")
    ap.add_argument("--stale-warn-s", type=float, default=None,
                    help="warn when a query observes a snapshot older "
                         "than this many seconds")
    ap.add_argument("--fault", action="append", default=[], metavar="SPEC",
                    help="inject a failure: site:kind[:at[:count[:delay]]] "
                         "(chaos testing; the update worker visits the "
                         "serve_update site per batch)")
    ap.add_argument("--device", default="cuda",
                    help="where the boot decompose and the re-sweeps run: "
                         "cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", action="store_true",
                    help="emit the final metrics as one JSON line")
    args = ap.parse_args(argv)

    g, _ = load_graph(args.graph, args.seed)
    t0 = time.perf_counter()
    boot = decompose(bucketize(g), op=args.engine, device=args.device)
    pub = SnapshotPublisher()
    pub.publish(g, boot.coreness)
    print(f"boot: n={g.n_nodes:,} m={g.n_edges:,} "
          f"k_max={int(boot.coreness.max(initial=0))} "
          f"decompose {time.perf_counter() - t0:.2f}s on {args.device}; serving")

    fault_plan = None
    if args.fault:
        from repro_torch.runtime import FaultPlan

        fault_plan = FaultPlan.parse(args.fault)

    state = {"graph": g, "coreness": boot.coreness, "modes": {},
             "n_batches": 0, "error": None, "update_retries": 0}
    stop = threading.Event()
    worker = threading.Thread(
        target=_update_loop,
        args=(pub, EditLogReader(args.edit_log), state),
        kwargs=dict(op=args.engine,
                    dirty_budget_frac=args.dirty_budget_frac,
                    max_batches=args.max_batches,
                    idle_timeout_s=args.idle_timeout_s,
                    poll_interval_s=args.poll_interval_s,
                    stop=stop,
                    retries=args.update_retries,
                    backoff_s=args.update_backoff_s,
                    fault_plan=fault_plan,
                    device=args.device),
        name=UPDATE_THREAD_NAME, daemon=True,
    )
    launches0 = (fused_sweep_op.launches, hindex_op.launches)
    worker.start()

    rng = np.random.default_rng(args.seed)
    max_age_s = 0.0
    stale_warned = False
    try:
        while worker.is_alive():
            snap = pub.snapshot
            age_s = time.perf_counter() - snap.published_at
            max_age_s = max(max_age_s, age_s)
            if (args.stale_warn_s is not None and not stale_warned
                    and age_s > args.stale_warn_s):
                stale_warned = True
                print(f"WARNING: serving a snapshot {age_s:.2f}s old "
                      f"(v{snap.version}; threshold {args.stale_warn_s}s)")
            ids = rng.integers(0, max(1, snap.n_nodes), args.query_batch)
            pub.query_coreness(ids)
            pub.query_in_kcore(ids[: max(1, args.query_batch // 4)],
                               max(1, snap.max_core // 2))
            pub.query_top_kcore()
            if not snap.verify():  # pragma: no cover - the torn-state alarm
                raise RuntimeError(f"torn snapshot v{snap.version}")
            worker.join(timeout=0.002)
    finally:
        stop.set()
        if fault_plan is not None:
            fault_plan.release()  # wake any injected hang so join returns
        worker.join()
    if state["error"] is not None:
        raise state["error"]

    m = pub.metrics()
    m["batches_drained"] = state["n_batches"]
    m["update_modes"] = state["modes"]
    m["update_retries"] = state["update_retries"]
    m["staleness_max_age_s"] = max_age_s
    m["final_n_nodes"] = int(state["graph"].n_nodes)
    m["final_k_max"] = int(state["coreness"].max(initial=0))
    m["device"] = args.device
    # Read after the worker joined: the update path's kernel launches.
    m["kernel_launches"] = {"fused_sweep": fused_sweep_op.launches - launches0[0],
                            "hindex": hindex_op.launches - launches0[1]}
    if args.json:
        print(json.dumps(m, sort_keys=True))
    else:
        print(f"drained {state['n_batches']} batch(es), modes={state['modes']}")
        print(f"updates/s = {m['updates_per_s']:.1f}  "
              f"publishes/s = {m['publishes_per_s']:.1f}  "
              f"queries = {m['n_queries']:,}")
        print(f"query latency p50 = {m['query_p50_ms']:.3f} ms  "
              f"p99 = {m['query_p99_ms']:.3f} ms")
        print(f"staleness: mean {m['staleness_mean_edits']:.1f} / "
              f"max {m['staleness_max_edits']:.0f} pending edits at query "
              f"time; {m['pending_edits']} still pending at exit; "
              f"max snapshot age {m['staleness_max_age_s']:.2f}s")
        print(f"kernel launches on the update path: "
              f"fused_sweep={m['kernel_launches']['fused_sweep']:,} "
              f"hindex={m['kernel_launches']['hindex']:,}")
        if m["update_retries"]:
            print(f"update worker: {m['update_retries']} transient "
                  f"failure(s) retried")
    return m


if __name__ == "__main__":
    main()
