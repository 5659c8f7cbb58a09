"""Paper §5.6: the communication-vs-preprocessing tradeoff of 2-4 parts
(the PyTorch port of ``examples/multipart_divide.py``).

    PYTHONPATH=src python examples/torch/multipart_divide.py [--device cpu]
"""
import argparse

from repro_torch.core import dc_kcore
from repro_torch.device import resolve_device
from repro_torch.graph import peel_coreness, rmat


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="where to sweep (default cuda)")
    device = resolve_device(ap.parse_args(argv).device)

    g = rmat(scale=14, edge_factor=12, seed=2)
    oracle = peel_coreness(g)
    print(f"graph: {g.n_nodes:,} nodes {g.n_edges:,} edges k_max={oracle.max()}")

    _, mono = dc_kcore(g, thresholds=(), device=device)
    print(f"\n{'parts':>6} {'comm':>10} {'preprocess_s':>13} {'peak MiB':>9}")
    print(f"{1:>6} {mono.total_comm:>10,} {mono.preprocess_time_s:>13.2f} "
          f"{mono.peak_bytes/2**20:>9.1f}")
    for thresholds in [(16,), (8, 32), (8, 16, 48)]:
        core, rep = dc_kcore(g, thresholds=thresholds, strategy="rough", device=device)
        if not (core == oracle).all():
            raise SystemExit(f"MISMATCH against the peeling oracle at {thresholds}")
        print(f"{len(thresholds)+1:>6} {rep.total_comm:>10,} {rep.preprocess_time_s:>13.2f} "
              f"{rep.peak_bytes/2**20:>9.1f}")
    print("\nmore parts -> less communication & smaller peak, more preprocessing "
          "(paper Figs 10-11)")


if __name__ == "__main__":
    main()
