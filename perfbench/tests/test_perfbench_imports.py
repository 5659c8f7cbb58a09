"""Nothing the benchmark loads is JAX or the JAX package ``repro``."""
import subprocess
import sys

from perfbench import spec

PROBE = r"""
import sys
sys.path[0:0] = [{root!r}, {src!r}]
from perfbench import control, graph, harness, profiling, reference, roofline, spec
import perfbench.run
from repro_torch.core import decompose
from repro_torch.graph import Graph, bucketize
bench = spec.load_benchmark()
for cell in bench["workloads"]:
    for kind in ("end_to_end", "per_layer"):
        spec.load_readers(spec.cell_metrics(bench, cell, kind))
    spec.load_runner(spec.load_traffic(cell["traffic"])["runner"])
    spec.load_generator(spec.load_config(cell["config"])["generator"])
print(" ".join(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""


def test_no_jax_and_no_reference_package_loaded():
    code = PROBE.format(root=str(spec.ROOT), src=str(spec.ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    top = set(out.stdout.split())
    assert "repro_torch" in top and "torch" in top
    assert not top & set(spec.FORBIDDEN_MODULES), top & set(spec.FORBIDDEN_MODULES)


def test_top_level_names_are_compared_whole():
    loaded = ["repro_torch", "repro_torch.core", "jaxtyping", "reprolib",
              "repro", "repro.core.decompose", "jax.numpy", "jaxlib", "flax.linen"]
    assert spec.forbidden_loaded(loaded) == [
        "flax.linen", "jax.numpy", "jaxlib", "repro", "repro.core.decompose"]
