"""End-to-end run (the paper's workload): resource-budgeted DC-kCore on a
multi-million-edge graph with checkpoint/restart (the PyTorch port of
``examples/kcore_end_to_end.py``).

Demonstrates the full production path:
  1. budget-driven threshold planning (the paper's "limited resources" knob),
  2. sequential conquer with per-sweep coreness snapshots,
  3. a simulated mid-run failure + restart from the snapshot,
  4. correctness check against the BZ peeling oracle.

The snapshots go to a fresh temporary directory, removed at the end, so
two runs never resume each other.

    PYTHONPATH=src python examples/torch/kcore_end_to_end.py [--device cpu]
"""
import argparse
import shutil
import tempfile
import time

import numpy as np

from repro_torch.ckpt import latest_step, restore_pytree, save_pytree
from repro_torch.core import dc_kcore, decompose, plan_thresholds
from repro_torch.device import resolve_device
from repro_torch.graph import peel_coreness, rmat


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="where to sweep (default cuda)")
    device = resolve_device(ap.parse_args(argv).device)

    g = rmat(scale=16, edge_factor=16, seed=7)  # ~65k nodes, ~1M edges
    print(f"graph: {g.n_nodes:,} nodes, {g.n_edges:,} edges, "
          f"{g.memory_bytes()/2**20:.0f} MiB CSR")

    budget = g.memory_bytes() // 2  # force a division: half the monolithic bytes
    thresholds = plan_thresholds(g, budget) or [24]
    print(f"budget {budget/2**20:.0f} MiB/part -> thresholds {thresholds}")

    ckpt_dir = tempfile.mkdtemp(prefix="dckcore_ckpt_")
    fail_once = {"armed": True}

    def decompose_with_snapshots(bg):
        """Conquer engine with per-sweep snapshots + one injected failure."""
        resume = None
        if latest_step(ckpt_dir) is not None:
            state, it, _ = restore_pytree(ckpt_dir, {"c": np.zeros(bg.n_nodes, np.int32)})
            if state["c"].shape == (bg.n_nodes,):
                resume = state["c"]
                print(f"    resumed part from snapshot at sweep {it}")

        def on_sweep(it, c):
            save_pytree(ckpt_dir, {"c": c.cpu().numpy()}, step=it)
            if fail_once["armed"] and it == 2 and bg.n_nodes > 1000:
                fail_once["armed"] = False
                raise RuntimeError("simulated worker failure at sweep 2")

        return decompose(bg, init_coreness=resume, on_sweep=on_sweep, device=device)

    try:
        t0 = time.time()
        try:
            core, report = dc_kcore(g, thresholds=thresholds,
                                    decompose_fn=decompose_with_snapshots)
        except RuntimeError as e:
            print(f"  !! {e} — restarting from snapshot")
            core, report = dc_kcore(g, thresholds=thresholds,
                                    decompose_fn=decompose_with_snapshots)
        print(f"\ndone in {time.time()-t0:.1f}s  k_max={int(core.max())} "
              f"comm={report.total_comm:,} peak={report.peak_bytes/2**20:.1f} MiB")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)

    print("verifying against BZ peeling oracle...")
    oracle = peel_coreness(g)
    if not (core == oracle).all():
        raise SystemExit("MISMATCH")
    print("CONSISTENT — coreness exact despite division, budget cap and restart")


if __name__ == "__main__":
    main()
