"""Quickstart: DC-kCore on a small power-law graph, verified vs peeling
(the PyTorch port of ``examples/quickstart.py``).

    PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]
"""
import argparse

from repro_torch.core import dc_kcore
from repro_torch.device import resolve_device
from repro_torch.graph import peel_coreness, rmat


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="where to sweep (default cuda)")
    device = resolve_device(ap.parse_args(argv).device)

    g = rmat(scale=12, edge_factor=12, seed=0)
    print(f"graph: {g.n_nodes:,} nodes, {g.n_edges:,} edges")

    # Monolithic (the PSGraph baseline of the paper).
    core_mono, rep_mono = dc_kcore(g, thresholds=(), device=device)

    # Divide-and-conquer: split at coreness 16 (Rough-Divide), conquer each part.
    core_dc, rep_dc = dc_kcore(g, thresholds=(16,), strategy="rough", device=device)

    oracle = peel_coreness(g)
    if not ((core_mono == oracle).all() and (core_dc == oracle).all()):
        raise SystemExit("MISMATCH against the peeling oracle")
    print(f"k_max = {int(oracle.max())} — all three methods consistent")
    print(f"monolithic: comm={rep_mono.total_comm:,} peak={rep_mono.peak_bytes/2**20:.1f} MiB")
    print(f"dc-kcore:   comm={rep_dc.total_comm:,} peak={rep_dc.peak_bytes/2**20:.1f} MiB "
          f"({rep_dc.peak_bytes/rep_mono.peak_bytes:.0%} of monolithic)")
    for p in rep_dc.parts:
        print(f"  part {p.name:>9}: n={p.n_nodes:,} iters={p.iterations} comm={p.comm_amount:,}")


if __name__ == "__main__":
    main()
