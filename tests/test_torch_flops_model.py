"""Differential tests of the port's analytic FLOP and memory model
(``repro_torch.roofline.flops_model``) and the "useful work" yardstick of
``repro_torch.roofline.analysis`` (``active_params``, ``model_flops``, the
FLOP-priced roofline) against the JAX package's ``repro.roofline``.

Every dry-run cell, the skipped long-context ones too, at 256 and 512 chips:
the numbers are the same arithmetic in the same order, so they are held
exactly equal (no tolerance).
"""
import dataclasses

import pytest

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import cells as ref_cells
from repro.configs import get_config as ref_get_config
from repro.models.model import build_specs
from repro.models.module import count_params as ref_count_params
from repro.roofline import analysis as ref_analysis
from repro.roofline import flops_model as ref_fm
from repro_torch.configs import SHAPES, cells, get_config
from repro_torch.models.model import CausalLM
from repro_torch.models.module import count_params
from repro_torch.roofline import analysis, flops_model, hw

CELLS = ref_cells(include_skipped=True)
N_CHIPS = (256, 512)


def test_cells_equal():
    assert cells(include_skipped=True) == CELLS
    assert cells() == ref_cells()


@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_cost_and_memory_model_exact(arch, shape_name):
    ref_cfg, cfg = ref_get_config(arch), get_config(arch)
    ref_shape, shape = REF_SHAPES[shape_name], SHAPES[shape_name]
    n_params = ref_count_params(build_specs(ref_cfg))
    assert count_params(CausalLM(cfg, device="meta")) == n_params
    assert flops_model._kv_cache_bytes(cfg, shape.global_batch, shape.seq_len) == \
        ref_fm._kv_cache_bytes(ref_cfg, ref_shape.global_batch, ref_shape.seq_len)
    assert flops_model.forward_flops_per_token(cfg, shape.seq_len / 2) == \
        ref_fm.forward_flops_per_token(ref_cfg, ref_shape.seq_len / 2)
    for n_chips in N_CHIPS:
        for remat in (True, False):
            want = ref_fm.cost(ref_cfg, ref_shape, n_params, n_chips, remat=remat)
            got = flops_model.cost(cfg, shape, n_params, n_chips, remat=remat)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
        for dp, accum in ((n_chips // 16, 1), (n_chips // 16, 4), (1, 1)):
            assert flops_model.device_memory_model(cfg, shape, n_params, n_chips, dp, accum) \
                == ref_fm.device_memory_model(ref_cfg, ref_shape, n_params, n_chips, dp, accum)


@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_active_params_and_model_flops_exact(arch, shape_name):
    ref_cfg, cfg = ref_get_config(arch), get_config(arch)
    n_params = ref_count_params(build_specs(ref_cfg))
    n_active = ref_analysis.active_params(ref_cfg)
    assert analysis.active_params(cfg) == n_active
    assert analysis.model_flops(cfg, SHAPES[shape_name], n_params, n_active) == \
        ref_analysis.model_flops(ref_cfg, REF_SHAPES[shape_name], n_params, n_active)


@pytest.mark.parametrize("n_chips", N_CHIPS)
def test_flop_roofline_terms(n_chips):
    """The FLOP roofline prices compute at the H100's dense bf16 rate and
    memory at its HBM rate (the reference's formulas, the card's constants),
    the collectives by link; useful fraction as the reference's."""
    colls = analysis.CollectiveStats()
    colls.add("all-gather", 1 << 30, list(range(8)))  # one NVLink node
    colls.add("all-reduce", 1 << 20, list(range(0, 256, 16)))  # across nodes
    rl = analysis.flop_roofline_terms(2e12, 3e9, colls, n_chips, model_flops=1e15)
    assert rl.compute_s == 2e12 / hw.PEAK_FLOPS_BF16
    assert rl.memory_s == 3e9 / hw.HBM_BW
    assert rl.collective_s == colls.seconds()
    assert rl.wire_bytes_per_device == colls.total_wire
    assert rl.bottleneck == max(("compute", rl.compute_s), ("memory", rl.memory_s),
                                ("collective", rl.collective_s), key=lambda kv: kv[1])[0]
    assert rl.useful_fraction == 1e15 / (2e12 * n_chips)
    assert set(rl.as_dict()) == {f.name for f in dataclasses.fields(ref_analysis.Roofline)}
