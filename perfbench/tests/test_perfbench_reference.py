"""The plain reference against the definition of coreness on small graphs."""
import itertools

import numpy as np
import pytest
import torch

from perfbench import graph, reference


def brute_coreness(n, edges):
    """Coreness by the definition: the largest k whose k-core (what is
    left after repeatedly deleting nodes of degree below k) holds v."""
    adj = {v: set() for v in range(n)}
    for u, v in edges:
        if u != v:
            adj[u].add(v)
            adj[v].add(u)
    core = [0] * n
    for k in itertools.count(1):
        alive = set(range(n))
        changed = True
        while changed:
            changed = False
            for v in list(alive):
                if len(adj[v] & alive) < k:
                    alive.discard(v)
                    changed = True
        if not alive:
            return core
        for v in alive:
            core[v] = k


def csr_of(n, edges):
    src = torch.tensor([u for u, _ in edges], dtype=torch.int64)
    dst = torch.tensor([v for _, v in edges], dtype=torch.int64)
    return graph.simple_csr(src, dst, n)


CASES = {
    "path": (4, [(0, 1), (1, 2), (2, 3)]),
    "triangle_and_tail": (5, [(0, 1), (1, 2), (2, 0), (2, 3)]),
    "clique5_isolated": (6, [(u, v) for u in range(5) for v in range(u + 1, 5)]),
    "star": (6, [(0, v) for v in range(1, 6)]),
    "two_cliques_bridge": (8, [(u, v) for u in range(4) for v in range(u + 1, 4)]
                           + [(u, v) for u in range(4, 8) for v in range(u + 1, 8)]
                           + [(3, 4)]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_reference_matches_definition(name):
    n, edges = CASES[name]
    csr = csr_of(n, edges)
    got = reference.coreness(csr.indptr, csr.indices).tolist()
    assert got == brute_coreness(n, edges)


@pytest.mark.parametrize("seed", range(6))
def test_reference_matches_definition_on_random_graphs(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(5, 40))
    m = int(rng.integers(0, 4 * n))
    edges = [tuple(int(x) for x in rng.integers(0, n, 2)) for _ in range(m)]
    csr = csr_of(n, edges) if edges else graph.DeviceCSR(
        torch.zeros(n + 1, dtype=torch.int64), torch.zeros(0, dtype=torch.int32), n)
    got = reference.coreness(csr.indptr, csr.indices).tolist()
    assert got == brute_coreness(n, edges)


def test_reference_is_plain():
    """The reference imports nothing but torch: no module of the program."""
    import ast
    import inspect

    imported = set()
    for node in ast.walk(ast.parse(inspect.getsource(reference))):
        if isinstance(node, ast.Import):
            imported.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            imported.add((node.module or "").split(".")[0])
    assert imported <= {"__future__", "torch"}
