"""The port's LM dry-run records held against the reference's compiled
records, cell by cell, at full size on the 16x16 mesh.

The reference side is ``repro.launch.dryrun.run_cell`` in one child
interpreter for all the cells (the reference's dry-run sets ``XLA_FLAGS``
on import), on the CPU, writing its records to a temporary directory. The
port's ``repro_torch.launch.dryrun.run_cell`` traces the same cells in a
second child beside it, as rank 0 of a fake 512-rank process group.

Per cell: the analytic fields are equal, and the traced peak and wire bytes
are within ``BAND`` (3x) above the reference's compiled peak
(argument + output + temp bytes) and wire bytes. There is no lower bound:
DTensor's layouts are not GSPMD's, and the reference's CPU temp bytes
over-count (``src/repro/launch/dryrun.py``'s own note). The cells are the
three whose records once left the band (long-context decode, where the
weights were gathered for one row, and grok-1's training step, where the
optimizer formed the whole expert preconditioner on every rank) and three
decode cells whose embedding lookup and weight gathers changed with them.
"""
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BAND = 3.0  # every cell outside the three repaired ones met it before (highest 2.84x)
ANALYTIC = ("params", "active_params", "accum_steps", "flops_per_device", "bytes_per_device",
            "analytic_detail", "memory_model")
CELLS = [
    ("mamba2-130m", "long_500k"),
    ("jamba-1.5-large-398b", "long_500k"),
    ("grok-1-314b", "train_4k"),
    ("mamba2-130m", "decode_32k"),
    ("whisper-small", "decode_32k"),
    ("granite-3-2b", "decode_32k"),
]

_REF_CHILD = r"""
import sys
from repro.launch.dryrun import run_cell

for arch, shape in CELLS:
    run_cell(arch, shape, False, artifact_dir=sys.argv[1])
"""

# The port's traces run in a child of their own too: DTensor keeps caches
# for the life of a process that can outlive a test module's process group.
_PORT_CHILD = r"""
import logging, sys
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_process_group

logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
with fake_process_group(dryrun.WORLD_SIZE):
    for arch, shape in CELLS:
        dryrun.run_cell(arch, shape, False, artifact_dir=sys.argv[1])
"""


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """``(arch, shape) -> (the port's record, the reference's record)``.
    Both children start with the module and run side by side; the first
    call waits for them."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(REPO, "src") + os.pathsep + os.environ.get("PYTHONPATH", ""))
    children = {}
    for side, code in (("port", _PORT_CHILD), ("reference", _REF_CHILD)):
        out = tmp_path_factory.mktemp(side)
        with open(out / "stdout.txt", "w") as so, open(out / "stderr.txt", "w") as se:
            proc = subprocess.Popen(
                [sys.executable, "-c", code.replace("CELLS", repr(CELLS)), str(out)],
                stdout=so, stderr=se, env=env, cwd=REPO)
        children[side] = (proc, out)

    def get(arch, shape):
        recs = []
        for side, (proc, out) in children.items():
            if proc.returncode is None:
                proc.wait(timeout=900)
            assert proc.returncode == 0, (side, (out / "stderr.txt").read_text()[-4000:])
            with open(out / f"{arch}__{shape}__16x16.json") as f:
                recs.append(json.load(f))
        return tuple(recs)

    yield get
    for proc, _out in children.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.mark.parametrize("arch,shape", CELLS)
def test_record_within_band_of_reference(arch, shape, records):
    rec, ref = records(arch, shape)
    for key in ANALYTIC:
        assert rec[key] == ref[key], key
    mem = ref["memory_analysis"]
    peak = rec["memory_analysis"]["peak_bytes"] / (
        mem["argument_bytes"] + mem["output_bytes"] + mem["temp_bytes"])
    wire = rec["collectives"]["total_wire_bytes"] / ref["collectives"]["total_wire_bytes"]
    assert peak <= BAND and wire <= BAND, (peak, wire)
    if (arch, shape) == ("mamba2-130m", "long_500k"):
        # One row a step: no rank gathers a weight or moves the token table.
        assert "all-to-all" not in rec["collectives"]["count"], rec["collectives"]
