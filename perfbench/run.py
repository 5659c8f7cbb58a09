"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` also ``breakdown``, and last ``checks``: each number
compared with its limit); the same checks are the last lines of standard
error. Any failure (an unknown name, no GPU or fewer than the cell asks
for, a program that cannot be imported, JAX or the JAX package loaded)
exits with a code other than 0, a reason on standard error and no result.
"""
import time

_SETUP_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# The harness is the ``perfbench`` package and the program lives under
# ``src``; the script's own folder comes off the path so that no module
# here can shadow one of the standard library's.
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))


def _fail(code: int, reason: str) -> int:
    print(f"perfbench: {reason}", file=sys.stderr)
    return code


def _parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = _parse(argv)
    from perfbench import spec

    try:
        bench = spec.load_benchmark()
        cell = spec.find_cell(bench, args.workload)
        config = spec.load_config(cell["config"])
        traffic = spec.load_traffic(cell["traffic"])
        kind = "per_layer" if args.trace else "end_to_end"
        metrics = spec.cell_metrics(bench, cell, kind)
        readers = spec.load_readers(metrics)
    except spec.SpecError as e:
        return _fail(2, str(e))

    import torch

    if not torch.cuda.is_available():
        return _fail(3, "torch.cuda.is_available() is False: the benchmark "
                        "measures the GPU and never falls back to the CPU")
    if torch.cuda.device_count() < int(cell["chips"]):
        return _fail(3, f"workload {cell['name']!r} needs {cell['chips']} GPU(s), "
                        f"torch.cuda.device_count() is {torch.cuda.device_count()}")
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        return _fail(4, f"cannot import the program (repro_torch under "
                        f"{ROOT / 'src'}): {e}")

    from perfbench import harness

    result = harness.run(config, traffic, seed=args.seed, seconds=args.seconds,
                         trace=bool(args.trace), metrics=metrics, readers=readers,
                         device="cuda:0", chips=int(cell["chips"]),
                         setup_start=_SETUP_START)
    loaded = spec.forbidden_loaded(sys.modules)
    if loaded:
        return _fail(5, f"JAX or the JAX package was loaded: {', '.join(loaded)}")
    print(f"perfbench: {cell['name']} seed {args.seed} on "
          f"{torch.cuda.get_device_name(0)} (GPUs: {torch.cuda.device_count()})",
          file=sys.stderr)
    for name, check in result["checks"].items():
        print(f"check {name}: {check['value']} (limit {check['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
