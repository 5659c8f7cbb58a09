"""The port's checkpoints against the JAX package's.

* The on-disk format: a tree saved by either package restores in the other,
  with the same leaf files and manifest; a CRC mismatch or an unreadable
  manifest raises ``CheckpointCorruptError``; a corrupt step is quarantined
  and restore falls back to the previous one; the manager keeps ``retain``
  steps and drains its async saves.
* A crash at a sweep-snapshot save and a mid-part resume through the port's
  distributed engine (one rank, CPU), byte-identical to the uninterrupted run.
* Across packages: a checkpoint directory holding a part boundary and a
  sweep snapshot, written by one package's ``dc_kcore``, resumes in both to
  identical coreness and per-part reports -- both ways round.
* The CLI's checkpoint and resume flags on the CPU.
"""
import dataclasses
import functools
import json
import os
import shutil

import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as ref_ckpt
from repro.core.dckcore import dc_kcore as ref_dc_kcore
from repro.graph.generators import rmat
from repro.graph.oracle import peel_coreness
from repro_torch import ckpt
from repro_torch.core.dckcore import dc_kcore
from repro_torch.core.distributed import MeshPlan, make_distributed_decompose
from repro_torch.graph.structs import from_reference_arrays
from repro_torch.launch import kcore as port_cli

torch.set_num_threads(1)

TIMERS = {"extract_time_s", "decompose_time_s", "save_time_s", "save_wall_s"}
THRESHOLDS = (4, 10)


@functools.lru_cache(maxsize=None)
def _graph():
    return rmat(10, 8, seed=11)


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "coreness": rng.integers(-1, 50, 64).astype(np.int32),
        "finalized": rng.random(64) < 0.5,
        "nested": [rng.random(3), (np.arange(4, dtype=np.int64),)],
        "scalar": np.float32(2.5),
    }


def _assert_tree_equal(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_tree_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_tree_equal(x, y)
    else:
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------- #
# Format
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_format_round_trip_across_packages(tmp_path, writer):
    tree, extra = _tree(), {"format": 1, "reports": [{"a": 1}]}
    save = ckpt.save_pytree if writer == "port" else ref_ckpt.save_pytree
    save(str(tmp_path / writer), tree, 7, extra=extra)
    for restore in (ckpt.restore_pytree, ref_ckpt.restore_pytree):
        got, step, got_extra = restore(str(tmp_path / writer), _tree(1))
        assert step == 7 and got_extra == extra
        _assert_tree_equal(got, tree)
    # Both packages write the same leaf files and manifest for one tree.
    other = "jax" if writer == "port" else "port"
    (ref_ckpt.save_pytree if writer == "port" else ckpt.save_pytree)(
        str(tmp_path / other), tree, 7, extra=extra)
    manifests = [json.load(open(tmp_path / w / "step_00000007" / "manifest.json"))
                 for w in (writer, other)]
    assert manifests[0] == manifests[1]
    assert sorted(os.listdir(tmp_path / writer / "step_00000007")) == sorted(
        os.listdir(tmp_path / other / "step_00000007"))


def test_latest_step_ignores_tmp_and_corrupt(tmp_path):
    d = str(tmp_path)
    assert ckpt.latest_step(d) is None
    for s in (1, 3):
        ckpt.save_pytree(d, _tree(s), s)
    os.makedirs(tmp_path / "step_00000009.tmp")
    os.makedirs(tmp_path / "step_00000008.corrupt")
    assert ckpt.latest_step(d) == ref_ckpt.latest_step(d) == 3
    with pytest.raises(FileNotFoundError):
        ckpt.restore_pytree(str(tmp_path / "missing"), _tree())
    with pytest.raises(ValueError, match="structure"):
        ckpt.restore_pytree(d, {"other": np.zeros(1)})


def _flip_a_data_byte(path):
    with open(path, "r+b") as f:
        f.seek(-1, os.SEEK_END)
        b = f.read(1)
        f.seek(-1, os.SEEK_END)
        f.write(bytes([b[0] ^ 0xFF]))


def test_crc_mismatch_and_bad_manifest_raise(tmp_path):
    d = str(tmp_path)
    ckpt.save_pytree(d, _tree(), 1)
    _flip_a_data_byte(tmp_path / "step_00000001" / "coreness__0.npy")
    with pytest.raises(ckpt.CheckpointCorruptError, match="CRC"):
        ckpt.restore_pytree(d, _tree())
    with pytest.raises(ref_ckpt.CheckpointCorruptError, match="CRC"):
        ref_ckpt.restore_pytree(d, _tree())
    ckpt.save_pytree(d, _tree(), 2)
    (tmp_path / "step_00000002" / "manifest.json").write_text("{not json")
    with pytest.raises(ckpt.CheckpointCorruptError, match="manifest"):
        ckpt.restore_pytree(d, _tree(), step=2)


def test_quarantine_and_fallback_to_previous_step(tmp_path):
    d = str(tmp_path)
    ckpt.save_pytree(d, _tree(1), 1)
    ckpt.save_pytree(d, _tree(2), 2)
    _flip_a_data_byte(tmp_path / "step_00000002" / "finalized__0.npy")
    seen = []
    got, step, _ = ckpt.restore_pytree_with_fallback(
        d, _tree(), on_corrupt=lambda s, e: seen.append(s))
    assert step == 1 and seen == [2]
    _assert_tree_equal(got, _tree(1))
    assert sorted(os.listdir(d)) == ["step_00000001", "step_00000002.corrupt"]
    _flip_a_data_byte(tmp_path / "step_00000001" / "finalized__0.npy")
    with pytest.raises(FileNotFoundError):
        ckpt.restore_pytree_with_fallback(d, _tree())


def test_manager_retention_async_saves_and_purge(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path), retain=2)
    tree = _tree()
    done = []
    for step in range(1, 5):
        mgr.save(tree, step, blocking=(step % 2 == 0),
                 on_done=lambda s, secs: done.append(s))
        tree["coreness"][:] = -7  # a by-value snapshot: later edits don't leak
    mgr.wait()
    assert done == [1, 2, 3, 4]
    assert sorted(os.listdir(tmp_path)) == ["step_00000003", "step_00000004"]
    got, _, _ = ckpt.restore_pytree(str(tmp_path), _tree())
    assert (got["coreness"] == -7).all()
    mgr.save({"x": np.zeros(2)}, 5)  # in flight during the purge
    os.makedirs(tmp_path / "step_00000009.tmp")
    mgr.clear_steps()
    assert os.listdir(tmp_path) == []
    bad = ckpt.CheckpointManager(str(tmp_path / "bad"))
    bad.save({"x": np.zeros(1)}, 1, on_done=lambda s, secs: 1 / 0)
    with pytest.raises(ZeroDivisionError):
        bad.wait()


# --------------------------------------------------------------------- #
# Crash and resume
# --------------------------------------------------------------------- #
class Crash(Exception):
    pass


def _killer(at_cursor, at_call):
    calls = []

    def hook(cursor, sweep, save_s):
        calls.append((cursor, sweep))
        if cursor == at_cursor and sum(c == at_cursor for c, _ in calls) == at_call:
            raise Crash
    return hook, calls


def test_midsweep_resume_through_distributed_engine(tmp_path):
    g = from_reference_arrays(_graph())
    fn = make_distributed_decompose(MeshPlan(), use_kernel=True, device="cpu")
    base, base_rep = dc_kcore(g, thresholds=THRESHOLDS, decompose_fn=fn)
    ck = str(tmp_path / "ck")
    hook, calls = _killer(0, 2)
    with pytest.raises(Crash):
        dc_kcore(g, thresholds=THRESHOLDS, decompose_fn=fn, checkpoint_dir=ck,
                 sweep_checkpoint_every=1, on_sweep_saved=hook)
    assert calls == [(0, 1), (0, 2)]
    core, rep = dc_kcore(g, thresholds=THRESHOLDS, decompose_fn=fn,
                         checkpoint_dir=ck, resume=True, sweep_checkpoint_every=1)
    np.testing.assert_array_equal(core, base)
    np.testing.assert_array_equal(core, peel_coreness(_graph()))
    assert [p.resumed_at_sweep for p in rep.parts] == [2, 0, 0]
    assert rep.parts[0].iterations == base_rep.parts[0].iterations - 2
    # Disk stays bounded: the finished run holds the two newest boundaries
    # and no snapshot.
    assert sorted(os.listdir(ck)) == ["step_00000002", "step_00000003", "sweeps"]
    assert os.listdir(os.path.join(ck, "sweeps")) == []
    # A complete checkpoint resumes to the stored result without a sweep.
    again, rep2 = dc_kcore(g, thresholds=THRESHOLDS, decompose_fn=fn,
                           checkpoint_dir=ck, resume=True)
    np.testing.assert_array_equal(again, base)
    assert rep2.resumed_parts == 3


def _write_crashed_dir(writer, path):
    """Run ``writer``'s dc_kcore until it crashes at the second sweep save of
    part 1, leaving the part-0 boundary and part 1's snapshots on disk."""
    hook, _ = _killer(1, 2)
    kw = dict(thresholds=THRESHOLDS, checkpoint_dir=path, sweep_checkpoint_every=1,
              on_sweep_saved=hook)
    with pytest.raises(Crash):
        if writer == "jax":
            ref_dc_kcore(_graph(), **kw)
        else:
            dc_kcore(from_reference_arrays(_graph()), device="cpu", **kw)
    assert sorted(os.listdir(path)) == ["step_00000001", "sweeps"]
    assert len(os.listdir(os.path.join(path, "sweeps"))) == 2


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_resume_across_packages(tmp_path, writer):
    src = str(tmp_path / "written")
    _write_crashed_dir(writer, src)
    for reader in ("jax", "port"):
        shutil.copytree(src, str(tmp_path / reader))
    kw = dict(thresholds=THRESHOLDS, resume=True, sweep_checkpoint_every=1)
    ref_core, ref_rep = ref_dc_kcore(_graph(), checkpoint_dir=str(tmp_path / "jax"), **kw)
    core, rep = dc_kcore(from_reference_arrays(_graph()), device="cpu",
                         checkpoint_dir=str(tmp_path / "port"), **kw)
    np.testing.assert_array_equal(core, ref_core)
    np.testing.assert_array_equal(core, peel_coreness(_graph()))
    assert rep.resumed_parts == ref_rep.resumed_parts == 1
    assert [p.resumed_at_sweep for p in rep.parts] == [0, 2, 0]
    assert len(rep.parts) == len(ref_rep.parts)
    for a, b in zip(ref_rep.parts, rep.parts):
        for f in dataclasses.fields(a):
            if f.name not in TIMERS:
                assert getattr(a, f.name) == getattr(b, f.name), f.name
    # Each package's finished directory holds the same boundary state.
    for step in ("step_00000002", "step_00000003"):
        a = json.load(open(tmp_path / "jax" / step / "manifest.json"))
        b = json.load(open(tmp_path / "port" / step / "manifest.json"))
        assert a["files"] == b["files"] and a["crc32"] == b["crc32"]


def test_dc_kcore_checkpoint_option_checks(tmp_path):
    g = from_reference_arrays(rmat(8, 4, seed=0))
    with pytest.raises(ValueError, match="checkpoint_dir"):
        dc_kcore(g, device="cpu", resume=True)
    with pytest.raises(ValueError, match="checkpoint_dir"):
        dc_kcore(g, device="cpu", sweep_checkpoint_every=1)
    with pytest.raises(ValueError, match="ckpt_retain"):
        dc_kcore(g, device="cpu", checkpoint_dir=str(tmp_path), ckpt_retain=0)
    dc_kcore(g, thresholds=(4,), device="cpu", checkpoint_dir=str(tmp_path))
    with pytest.raises(ValueError, match="thresholds"):
        dc_kcore(g, thresholds=(3,), device="cpu", checkpoint_dir=str(tmp_path), resume=True)
    with pytest.raises(ValueError, match="different graph"):
        dc_kcore(from_reference_arrays(rmat(8, 5, seed=0)), thresholds=(4,), device="cpu",
                 checkpoint_dir=str(tmp_path), resume=True)


def test_cli_checkpoint_and_resume_flags(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    argv = ["--graph", "rmat:10:8", "--thresholds", "10,4", "--device", "cpu",
            "--checkpoint-dir", ck, "--sweep-checkpoint-every", "1",
            "--ckpt-retain", "1", "--check"]
    port_cli.main(argv)
    out = capsys.readouterr().out
    assert "CONSISTENT" in out and "checkpoint saves:" in out
    assert sorted(os.listdir(ck)) == ["step_00000003", "sweeps"]
    port_cli.main(argv + ["--resume"])
    out = capsys.readouterr().out
    assert "resumed: 3 part(s) restored" in out and "CONSISTENT" in out
    for bad in (["--resume"], ["--sweep-checkpoint-every", "2"],
                ["--checkpoint-dir", ck, "--ckpt-retain", "0"]):
        with pytest.raises(SystemExit):
            port_cli.main(["--graph", "rmat:8:4", "--device", "cpu"] + bad)
