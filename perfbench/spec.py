"""Find a cell's configuration, traffic, runner, generator and metric
readers by name.

Every lookup raises :class:`SpecError` with a message that says which
name could not be found and which names exist, so that ``run.py`` can
exit with a reason instead of a traceback.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Dict, Iterable, List

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent

# The names BENCHMARK.json may use; checked before a name becomes a path.
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")

# Top-level module names that must never be loaded by a benchmark run:
# JAX and the JAX package that the port was made from.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


class SpecError(Exception):
    """A name in ``BENCHMARK.json`` or on the command line that resolves
    to no file, or a file that does not hold what the harness needs."""


def _checked_name(kind: str, name: str) -> str:
    if not isinstance(name, str) or not _NAME.match(name):
        raise SpecError(f"{kind} name {name!r} is not a valid name")
    return name


def _names_in(folder: Path, suffix: str) -> List[str]:
    return sorted(p.name[: -len(suffix)] for p in folder.glob(f"*{suffix}")
                  if not p.name.startswith("_"))


def load_benchmark(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    try:
        return json.loads(path.read_text())
    except FileNotFoundError:
        raise SpecError(f"no BENCHMARK.json at {root}") from None
    except json.JSONDecodeError as e:
        raise SpecError(f"BENCHMARK.json is not valid JSON: {e}") from None


def find_cell(bench: dict, workload: str) -> dict:
    _checked_name("workload", workload)
    for cell in bench.get("workloads", []):
        if cell["name"] == workload:
            return cell
    known = ", ".join(c["name"] for c in bench.get("workloads", []))
    raise SpecError(f"no workload named {workload!r} in BENCHMARK.json "
                    f"(known: {known})")


def _load_json(kind: str, folder: str, name: str) -> dict:
    _checked_name(kind, name)
    path = BENCH_DIR / folder / f"{name}.json"
    if not path.is_file():
        known = ", ".join(_names_in(BENCH_DIR / folder, ".json"))
        raise SpecError(f"no {kind} named {name!r}: {path.relative_to(ROOT)} "
                        f"does not exist (known: {known})")
    try:
        return json.loads(path.read_text())
    except json.JSONDecodeError as e:
        raise SpecError(f"{kind} file {path.relative_to(ROOT)} is not valid "
                        f"JSON: {e}") from None


def load_config(name: str) -> dict:
    """``configs/<name>.json``: the deployment a cell runs."""
    config = _load_json("configuration", "configs", name)
    for key in ("generator", "scale", "edge_factor", "engine", "layout"):
        if key not in config:
            raise SpecError(f"configuration {name!r} has no {key!r}")
    return config


def load_traffic(name: str) -> dict:
    """``traffic/<name>.json``: the runner of the window and its parameters
    (start state, edits, arrivals), checked by that runner."""
    traffic = _load_json("traffic mix", "traffic", name)
    if not isinstance(traffic.get("runner"), str):
        raise SpecError(f"traffic mix {name!r} names no runner")
    runner = load_runner(traffic["runner"])
    rate = traffic.get("arrivals_per_s")
    if rate is not None and not (isinstance(rate, (int, float)) and rate > 0):
        raise SpecError(f"traffic mix {name!r}: arrivals_per_s {rate!r} is not "
                        f"a positive number")
    try:
        runner.validate(traffic)
    except ValueError as e:
        raise SpecError(f"traffic mix {name!r}: {e}") from None
    return traffic


def _load_module(kind: str, folder: str, name: str, attr: str) -> ModuleType:
    _checked_name(kind, name)
    path = BENCH_DIR / folder / f"{name}.py"
    if not path.is_file():
        known = ", ".join(_names_in(BENCH_DIR / folder, ".py"))
        raise SpecError(f"no {kind} named {name!r}: {path.relative_to(ROOT)} "
                        f"does not exist (known: {known})")
    mod_name = f"perfbench_{folder}_" + re.sub(r"[^A-Za-z0-9_]", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    if not callable(getattr(module, attr, None)):
        raise SpecError(f"{kind} file {path.relative_to(ROOT)} defines no "
                        f"{attr}()")
    return module


def load_generator(name: str) -> ModuleType:
    """``graphs/<name>.py``, which defines ``edges(...)``."""
    return _load_module("graph generator", "graphs", name, "edges")


def load_runner(name: str) -> ModuleType:
    """``runners/<name>.py``, which defines ``Part``, ``reference_answer``
    and ``validate``."""
    module = _load_module("runner", "runners", name, "Part")
    for attr in ("reference_answer", "validate"):
        if not callable(getattr(module, attr, None)):
            raise SpecError(f"runner {name!r} defines no {attr}()")
    return module


def load_metric(name: str) -> ModuleType:
    """``metrics/<name>.py``, which defines ``read(ctx)`` (end to end or
    per layer)."""
    return _load_module("metric", "metrics", name, "read")


def cell_metrics(bench: dict, cell: dict, kind: str) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` entries that apply to ``cell``:
    those with no ``workloads`` key, and those that list it."""
    return [m for m in bench.get(kind, [])
            if "workloads" not in m or cell["name"] in m["workloads"]]


def load_readers(entries: Iterable[dict]) -> Dict[str, ModuleType]:
    return {m["name"]: load_metric(m["name"]) for m in entries}


def forbidden_loaded(modules: Iterable[str]) -> List[str]:
    """The loaded modules whose top-level name (the part before the first
    dot, compared whole) is JAX's or the JAX package's: ``repro_torch`` is
    not ``repro``."""
    return sorted(m for m in modules if m.split(".", 1)[0] in FORBIDDEN_MODULES)
