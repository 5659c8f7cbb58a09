"""Graph substrate: containers, generators, oracles, reordering and IO.

Numpy copies of the JAX package's ``repro.graph`` modules (that package's
``core`` imports JAX, so the port keeps its own copies); they build
byte-identical CSR graphs and bucketed tiles. Host-side graphs are numpy
CSR (``Graph``); ``BucketedGraph`` holds the degree-bucketed padded tiles
the sweep kernels read.
"""
from repro_torch.graph.structs import Graph, BucketedGraph, Bucket, from_reference_arrays
from repro_torch.graph.build import autotune_tile_caps, bucketize, induced_subgraph, external_info
from repro_torch.graph.generators import erdos_renyi, barabasi_albert, rmat
from repro_torch.graph.io import (
    EdgeStore,
    IngestStats,
    csr_from_edge_chunks,
    graph_edge_chunks,
    iter_edgelist_chunks,
    stream_edgelist,
)
from repro_torch.graph.oracle import peel_coreness
from repro_torch.graph.reorder import (
    REORDER_METHODS,
    bfs_order,
    bitmap_density,
    rcm_order,
    reorder_graph,
    sample_edge_skeleton,
    sampled_order,
)

__all__ = [
    "Graph",
    "BucketedGraph",
    "Bucket",
    "from_reference_arrays",
    "autotune_tile_caps",
    "bucketize",
    "induced_subgraph",
    "external_info",
    "erdos_renyi",
    "barabasi_albert",
    "rmat",
    "EdgeStore",
    "IngestStats",
    "csr_from_edge_chunks",
    "graph_edge_chunks",
    "iter_edgelist_chunks",
    "stream_edgelist",
    "peel_coreness",
    "REORDER_METHODS",
    "bfs_order",
    "bitmap_density",
    "rcm_order",
    "reorder_graph",
    "sample_edge_skeleton",
    "sampled_order",
]
