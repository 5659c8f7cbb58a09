"""Multi-pod dry-run of the LM harness on an H100 fleet: the port of
``repro.launch.dryrun``.

For every (architecture x input shape) cell, on the single-pod 16x16 mesh
and the 2x16x16 multi-pod mesh:

    specs = input_specs(arch, shape, mesh)     # meta DTensors, policy placements
    with on_mesh(mesh, rules), Tally() as tally:
        step(**specs)                          # launch/steps.py's step, once

The mesh is a ``DeviceMesh`` over rank 0 of a fake process group
(:func:`repro_torch.launch.mesh.fake_process_group`): every tensor is a meta
tensor, so nothing is allocated and no device or network is touched.
DTensor plays the part of XLA's SPMD partitioner: each op runs on rank 0's
shard and the collectives that redistribute its inputs are issued (and
moved nowhere). :class:`repro_torch.roofline.tally.Tally` counts what
rank 0 would do: its FLOPs, bytes, peak live bytes and collectives, priced
on the H100 and its links (:mod:`repro_torch.roofline.analysis`), beside
the analytic model of :mod:`repro_torch.roofline.flops_model`.

The record keeps the reference's keys, except: ``fits_16gb`` is
``fits_80gb`` (the memory model against ``hw.HBM_BYTES``); ``compile_s`` is
``trace_s`` (``lower_s`` the seconds to build the inputs);
``memory_analysis`` holds the argument and output bytes and the tally's
``peak_temp_bytes``; the loop-blind HLO counts are the traced ``flops`` and
``hbm_bytes`` (the port runs one block per layer, so they are loop-exact);
``replicated_fallbacks`` also lists the sites where an activation is
replicated for an op DTensor has no sharding rule for. One JSON record per
cell lands in ``artifacts/dryrun_torch/``.

Usage (no GPU needed):
    python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k
    python -m repro_torch.launch.dryrun --all                  # single-pod pass
    python -m repro_torch.launch.dryrun --all --both-meshes    # and 512 chips
    python -m repro_torch.launch.dryrun --compare REF_DIR      # against the reference's
                                                               # records (its --artifact-dir)
"""
import argparse
import contextlib
import json
import logging
import os
import threading
import time
import traceback

import torch

from repro_torch.configs import SHAPES, cells
from repro_torch.launch.mesh import fake_process_group, make_production_mesh
from repro_torch.launch.specs import input_specs, rules_for
from repro_torch.launch.steps import step_fn_for
from repro_torch.models.module import count_params
from repro_torch.roofline import flops_model, hw
from repro_torch.roofline.analysis import active_params, flop_roofline_terms, model_flops
from repro_torch.roofline.tally import Tally, repeated, top_holders
from repro_torch.sharding.policy import active_mesh, dp_size

MICRO_PER_DEVICE = 2  # target per-device microbatch rows for train cells
BIG_MODEL_PARAMS = 50e9  # above this, microbatch 1 row/device (stash budget)
WORLD_SIZE = 512  # the multi-pod production mesh

ARTIFACT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))),
    "artifacts", "dryrun_torch",
)


def _local_tensors(tree, out):
    """Rank 0's tensors of a tree of dicts, lists, tuples and modules (a
    DTensor's local shard, a plain tensor as it is)."""
    if isinstance(tree, torch.nn.Module):
        tree = list(tree.parameters())
    if isinstance(tree, torch.Tensor):
        out.append(tree.to_local() if hasattr(tree, "to_local") else tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            _local_tensors(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _local_tensors(v, out)
    return out


def _bytes(tensors, skip=frozenset()) -> int:
    """Bytes of the distinct storages of ``tensors`` not in ``skip``."""
    seen = {}
    for t in tensors:
        key = t.untyped_storage()._cdata
        if key not in skip:
            seen[key] = t.untyped_storage().nbytes()
    return sum(seen.values())


# A candidate layout whose redistribution needs DTensor's graph search is
# priced at this (the cost unit is the seconds DTensor's model gives a
# collective; a real one costs well under 1).
_GRAPH_PLAN_PENALTY = 1e6
_on_mesh = threading.local()  # .depth: on_mesh blocks open on this thread
_installed = threading.Lock()


def _inside() -> bool:
    return getattr(_on_mesh, "depth", 0) > 0


def _install_dtensor_hooks() -> None:
    """Wrap two of DTensor's functions, once per process. The wrappers act
    only on a thread inside :func:`on_mesh`, and are DTensor's own
    elsewhere:

    * DTensor picks each op's layout by pricing the redistribution of every
      candidate; a candidate with strided or reordered shards is planned by
      a graph search over the placements of every mesh dim, which does not
      end in minutes on the 3-D mesh. Such candidates cost
      :data:`_GRAPH_PLAN_PENALTY` (the choice goes to plain shardings); the
      redistributions that do run are planned as DTensor plans them.
    * DTensor's all-to-all on meta shards runs as its own ``_dtensor`` op
      whatever the mesh's device type; on a ``"cpu"`` mesh DTensor would
      fall back to an all-gather, which is not what a GPU fleet runs (the
      tally prices the all-to-all)."""
    import torch.distributed._functional_collectives as funcol
    import torch.distributed.tensor._ops.utils as op_utils
    import torch.distributed.tensor.placement_types as pt
    from torch.distributed.tensor._dtensor_spec import DTensorSpec
    from torch.distributed.tensor.placement_types import _StridedShard

    with _installed:
        if getattr(op_utils.redistribute_cost, "_dry_run", False):
            return
        cost_of, alltoall = op_utils.redistribute_cost, pt.shard_dim_alltoall

        def needs_graph(spec) -> bool:
            return (any(isinstance(p, _StridedShard) for p in spec.placements)
                    or spec.shard_order is None
                    or not DTensorSpec.is_default_device_order(spec.shard_order))

        def redistribute_cost(current, target):
            if _inside() and (needs_graph(current) or needs_graph(target)):
                return 0.0 if current == target else _GRAPH_PLAN_PENALTY
            return cost_of(current, target)

        def shard_dim_alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
            if not (_inside() and input.device.type == "meta"):
                return alltoall(input, gather_dim, shard_dim, mesh, mesh_dim)
            group = funcol._resolve_group((mesh, mesh_dim))
            return torch.ops._dtensor.shard_dim_alltoall(
                input, gather_dim, shard_dim, funcol._group_or_group_name(group))

        redistribute_cost._dry_run = True
        op_utils.redistribute_cost = redistribute_cost
        pt.shard_dim_alltoall = shard_dim_alltoall


@contextlib.contextmanager
def on_mesh(mesh, rules, log=None):
    """Run a step on ``mesh`` as the dry-run runs it: activation constraints
    resolved by ``rules``, op fallbacks noted in ``log``, plain tensors made
    inside the step taken as replicated, and DTensor's layout choices and
    all-to-all as :func:`_install_dtensor_hooks` sets them. On meta tensors
    it traces; on real ones (a process group of real ranks) it computes."""
    from torch.distributed.tensor.experimental import implicit_replication

    _install_dtensor_hooks()
    _on_mesh.depth = getattr(_on_mesh, "depth", 0) + 1
    try:
        with active_mesh(mesh, rules, log), implicit_replication():
            yield
    finally:
        _on_mesh.depth -= 1


def trace_step(fn, kwargs, mesh, rules, log, holders: bool = False):
    """Run ``fn(**kwargs)`` once :func:`on_mesh` under a :class:`Tally`
    (keeping its ``peak_holders`` if ``holders``). Returns ``(tally, output)``."""
    with on_mesh(mesh, rules, log), Tally(holders=holders) as tally:
        out = fn(**kwargs)
    return tally, out


def _group(n_ranks: int):
    """A fake process group of ``n_ranks`` unless one is initialized."""
    import torch.distributed as dist

    return contextlib.nullcontext() if dist.is_initialized() else fake_process_group(n_ranks)


def run_cell(arch: str, shape_name: str, multi_pod: bool, rules=None,
             artifact_dir: str = ARTIFACT_DIR, tag: str = "",
             accum_override: int = None, grad_constrain: bool = False,
             accum_dtype=None, holders: int = 0) -> dict:
    """One cell's record. ``grad_constrain`` is the reference's flag, taken
    and not needed: the port's train step always lays each gradient out like
    its parameter (``runtime/train_loop.py::_grad``). ``holders``: print the
    that many largest groups of storages live at the traced peak."""
    with _group(WORLD_SIZE if multi_pod else WORLD_SIZE // 2):
        return _run_cell(arch, shape_name, multi_pod, rules, artifact_dir, tag,
                         accum_override, grad_constrain, accum_dtype, holders)


def _run_cell(arch, shape_name, multi_pod, rules, artifact_dir, tag, accum_override,
              grad_constrain, accum_dtype, holders) -> dict:
    mesh = make_production_mesh(multi_pod=multi_pod)
    n_chips = mesh.size()
    shape = SHAPES[shape_name]
    t0 = time.perf_counter()
    specs, cfg, log = input_specs(arch, shape_name, mesh, rules=rules)
    the_rules = rules or rules_for(cfg, shape_name)
    n_params = count_params(specs["model"])
    accum = 1
    if shape.kind == "train":
        per_dev = max(1, shape.global_batch // dp_size(mesh, the_rules))
        micro = 1 if n_params > BIG_MODEL_PARAMS else MICRO_PER_DEVICE
        accum = max(1, per_dev // micro)
        if accum_override:
            accum = accum_override
    fn, order = step_fn_for(cfg, shape.kind, accum_steps=accum, accum_dtype=accum_dtype,
                            microbatch_repeat=repeated)
    kwargs = {k: specs[k] for k in order}
    args = _local_tensors(kwargs, [])
    arg_storages = frozenset(t.untyped_storage()._cdata for t in args)
    t_lower = time.perf_counter() - t0

    tally, out = trace_step(fn, kwargs, mesh, the_rules, log, holders=holders > 0)
    t_trace = time.perf_counter() - t0 - t_lower
    for nbytes, count, op, shape_, dtype in top_holders(tally.peak_holders, holders):
        print(f"  at the peak: {nbytes:,} B in {count} x {op} {list(shape_)} {dtype}")

    colls = tally.collectives
    n_active = active_params(cfg)
    mflops = model_flops(cfg, shape, n_params, n_active)
    analytic = flops_model.cost(
        cfg, shape, n_params, n_chips, remat=(shape.kind == "train")
    )
    flops_dev = analytic.flops_total / n_chips
    bytes_dev = analytic.hbm_bytes_per_device
    rl = flop_roofline_terms(flops_dev, bytes_dev, colls, n_chips, mflops)
    arg_bytes = _bytes(args)
    out_bytes = _bytes(_local_tensors(out, []), skip=arg_storages)
    mem_model = flops_model.device_memory_model(
        cfg, shape, n_params, n_chips, dp_size(mesh, the_rules), accum
    )
    record = {
        "arch": arch,
        "shape": shape_name,
        "kind": shape.kind,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "n_chips": n_chips,
        "params": n_params,
        "active_params": n_active,
        "accum_steps": accum,
        "lower_s": round(t_lower, 2),
        "trace_s": round(t_trace, 2),
        "flops_per_device": flops_dev,
        "bytes_per_device": bytes_dev,
        "flops": tally.flops,
        "hbm_bytes": tally.hbm_bytes,
        "analytic_detail": analytic.detail,
        "memory_analysis": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "peak_temp_bytes": tally.peak_bytes,
            "peak_bytes": arg_bytes + tally.peak_bytes,
        },
        "memory_model": mem_model,
        "fits_80gb": bool(mem_model["total"] < hw.HBM_BYTES),
        "collectives": {
            "count": colls.count,
            "raw_bytes": colls.op_bytes,
            "wire_bytes": colls.wire_bytes,
            "total_wire_bytes": colls.total_wire,
            "link_wire_bytes": colls.link_wire_bytes,
        },
        "roofline": rl.as_dict(),
        "replicated_fallbacks": [
            {"axes": list(map(str, a)), "dim": d, "size": s, "axis_size": m}
            for (a, d, s, m) in log.replicated
        ] + [{"op": op, "site": site} for (op, site) in log.ops],
    }
    os.makedirs(artifact_dir, exist_ok=True)
    fname = f"{arch}__{shape_name}__{record['mesh']}{tag}.json"
    with open(os.path.join(artifact_dir, fname), "w") as f:
        json.dump(record, f, indent=1)
    return record


# The record fields computed by the analytic models, which equal the
# reference's record for record; and how far the traced peak and wire bytes
# may stray from the reference's compiled ones (a ratio, either way up).
ANALYTIC_FIELDS = ("params", "active_params", "accum_steps", "flops_per_device",
                   "bytes_per_device", "analytic_detail", "memory_model")
REFERENCE_BAND = 3.0


def reference_ratios(record: dict, reference: dict) -> dict:
    """A traced record against the reference dry-run's compiled record of
    the same cell: ``peak``, the traced ``peak_bytes`` over the reference's
    argument, output and temp bytes (its own peak); ``wire``, the total wire
    bytes over the reference's; ``analytic``, whether the
    :data:`ANALYTIC_FIELDS` are equal."""
    mem = reference["memory_analysis"]
    ref_peak = mem["argument_bytes"] + mem["output_bytes"] + mem["temp_bytes"]
    return {
        "peak": record["memory_analysis"]["peak_bytes"] / ref_peak,
        "wire": (record["collectives"]["total_wire_bytes"]
                 / max(reference["collectives"]["total_wire_bytes"], 1)),
        "analytic": all(record[k] == reference[k] for k in ANALYTIC_FIELDS),
    }


def compare(artifact_dir: str, reference_dir: str) -> int:
    """Print each record of ``artifact_dir`` that ``reference_dir`` holds
    too (the reference CLI's ``--artifact-dir``) with its
    :func:`reference_ratios`; returns the number of cells out of band
    (a ratio above :data:`REFERENCE_BAND`, or analytic fields that differ)."""
    out = 0
    for fname in sorted(os.listdir(artifact_dir)):
        ref_path = os.path.join(reference_dir, fname)
        if not fname.endswith(".json") or not os.path.exists(ref_path):
            continue
        with open(os.path.join(artifact_dir, fname)) as f, open(ref_path) as g:
            r = reference_ratios(json.load(f), json.load(g))
        bad = max(r["peak"], r["wire"]) > REFERENCE_BAND or not r["analytic"]
        out += bad
        print(f"{fname[:-5]:48s} peak {r['peak']:.3f} wire {r['wire']:.3f} "
              f"analytic {'equal' if r['analytic'] else 'DIFFER'}{'  OUT OF BAND' if bad else ''}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--artifact-dir", default=ARTIFACT_DIR)
    ap.add_argument("--tag", default="", help="artifact filename suffix (perf variants)")
    ap.add_argument("--accum", type=int, default=None)
    ap.add_argument("--grad-constrain", action="store_true")
    ap.add_argument("--accum-dtype", choices=["f32", "bf16"], default=None)
    ap.add_argument("--rules", choices=["default", "serve"], default="default")
    ap.add_argument("--peak-holders", type=int, default=0, metavar="N",
                    help="print the N largest groups of storages live at the traced peak")
    ap.add_argument("--compare", metavar="REFERENCE_DIR",
                    help="trace nothing: hold the records in --artifact-dir against the "
                         "reference dry-run's records in REFERENCE_DIR (exit 1 out of band)")
    args = ap.parse_args(argv)
    if args.compare:
        bad = compare(args.artifact_dir, args.compare)
        print(f"\n{bad} cell(s) out of band ({REFERENCE_BAND}x)")
        raise SystemExit(1 if bad else 0)

    # DTensor warns, once per redistribution pattern, that it splits a
    # multi-axis collective into one per mesh dim; the tally prices each.
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    accum_dtype = {None: None, "f32": torch.float32, "bf16": torch.bfloat16}[args.accum_dtype]
    rules_override = None
    if args.rules == "serve":
        from repro_torch.sharding.policy import SERVE_RULES
        rules_override = dict(SERVE_RULES)

    if args.all:
        todo = cells()
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all)")
        todo = [(args.arch, args.shape)]
    meshes = [args.multi_pod] if not args.both_meshes else [False, True]

    failures = []
    with fake_process_group(WORLD_SIZE):
        for arch, shape_name in todo:
            for mp in meshes:
                label = f"{arch} x {shape_name} x {'2x16x16' if mp else '16x16'}"
                print(f"=== {label} ===", flush=True)
                try:
                    rec = run_cell(
                        arch, shape_name, mp, rules=rules_override,
                        artifact_dir=args.artifact_dir, tag=args.tag,
                        accum_override=args.accum,
                        grad_constrain=args.grad_constrain,
                        accum_dtype=accum_dtype, holders=args.peak_holders,
                    )
                    rl = rec["roofline"]
                    print(
                        f"  ok: compute={rl['compute_s']:.4g}s memory={rl['memory_s']:.4g}s "
                        f"collective={rl['collective_s']:.4g}s bottleneck={rl['bottleneck']} "
                        f"fits_80gb={rec['fits_80gb']} "
                        f"peak={rec['memory_analysis']['peak_bytes'] / 2**30:.1f}GiB "
                        f"(lower {rec['lower_s']}s, trace {rec['trace_s']}s)",
                        flush=True,
                    )
                except Exception as e:  # noqa: BLE001 - reported, and the run exits 1
                    failures.append((label, repr(e)))
                    traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for label, err in failures:
            print(" ", label, err)
        raise SystemExit(1)
    print("\nall dry-run cells traced OK")


if __name__ == "__main__":
    main()
