"""The control of ``correct``: the program one changing sweep short.

    python3 perfbench/control.py --workload kron-s24-conquer --seconds 5 --seeds 11 12 13

runs the cell once a seed through ``harness.run``, as ``run.py`` does, with
the call's entry replaced by :func:`stopped_short`: each call makes the
sound decomposition, then the same call again stopped two sweeps short of
it (the last sweep of a sound run changes nothing), the program's own path
to an answer that is not exact. The window's answers are the stopped
ones, held to the same checks and limits as a benchmark run's. Prints one
JSON line a seed (``correct`` and the checks); it exits 1 where a seed
reads ``correct`` true. Runs on the GPU only; the benchmark's own runs
never run it.
"""
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))


def stopped_short(entry):
    """``entry`` (the port's ``decompose``) stopped two sweeps short of the
    sweeps its sound call takes from the same start."""

    def call(bg, **kwargs):
        if "max_iter" in kwargs:  # the roofline's one sweep: left as it is
            return entry(bg, **kwargs)
        sound = entry(bg, **kwargs)
        return entry(bg, **kwargs, max_iter=max(sound.iterations - 2, 0))

    return call


def main(argv=None) -> int:
    import argparse

    import torch

    from perfbench import harness, spec

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    try:
        bench = spec.load_benchmark()
        cell = spec.find_cell(bench, args.workload)
        config = spec.load_config(cell["config"])
        traffic = spec.load_traffic(cell["traffic"])
        metrics = spec.cell_metrics(bench, cell, "end_to_end")
        readers = spec.load_readers(metrics)
    except spec.SpecError as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("perfbench: torch.cuda.is_available() is False", file=sys.stderr)
        return 3
    runner = spec.load_runner(traffic["runner"])
    any_correct = False
    for seed in args.seeds:
        result = harness.run(config, traffic, seed=seed, seconds=args.seconds,
                             trace=False, metrics=metrics, readers=readers,
                             device="cuda:0",
                             entry=stopped_short(runner.port_entry()))
        any_correct |= result["correct"]
        print(json.dumps({"workload": cell["name"], "seed": seed,
                          "correct": result["correct"],
                          "attempted": result["attempted"],
                          "checks": result["checks"]}), flush=True)
    return 1 if any_correct else 0


if __name__ == "__main__":
    sys.exit(main())
