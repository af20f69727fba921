"""The port's roofline (``roofline/analysis.py``) against the JAX
package's, on the CPU: ``lm_param_counts`` and ``model_flops_for`` equal
the reference's for every (arch x cell); ``from_record``'s terms and
dominant term with one H100's constants (the pattern of
``tests/test_roofline.py``'s); the collective counter that stands where
the reference parses HLO.  Every comparison is exact: the same integer
and float arithmetic in the same order."""
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.roofline import analysis as janalysis
from repro_torch.configs import registry
from repro_torch.core import distributed as tdist
from repro_torch.launch import cells
from repro_torch.roofline import analysis

ALL = [(a, c.name) for a in jregistry.all_arch_ids()
       for c in jregistry.get(a).cells]


@pytest.mark.parametrize("arch,shape", ALL,
                         ids=[f"{a}-{s}" for a, s in ALL])
def test_model_flops_and_param_counts_are_the_references(arch, shape):
    spec = jregistry.get(arch)
    jcell = jregistry.cell_by_name(spec, shape)
    family = registry.family(arch)
    cfg = cells.configs_of(arch).CONFIG
    cell = registry.cell_by_name(shape, family)
    assert analysis.model_flops_for(family, cfg, cell, {}) == \
        janalysis.model_flops_for(spec.family, spec.config, jcell, {})
    if family == "lm":
        assert analysis.lm_param_counts(cfg) == \
            janalysis.lm_param_counts(spec.config)


def test_h100_constants():
    assert analysis.PEAK_FLOPS == {"bfloat16": 989e12, "float16": 989e12,
                                   "float32": 67e12}
    assert (analysis.HBM_BW, analysis.NVLINK_BW) == (3.35e12, 450e9)


def test_roofline_terms_and_dominance():
    rec = {"n_devices": 1,
           "cost": {"flops": 989e12 * 2.0 + 67e12 * 0.5,
                    "flops_bfloat16": 989e12 * 2.0,
                    "flops_float32": 67e12 * 0.5,
                    "bytes accessed": 3.35e12 * 0.5},
           "collectives": {"total": 450e9 * 0.1}}
    r = analysis.from_record(rec, model_flops=rec["cost"]["flops"] * 0.5)
    assert abs(r.compute_s - 2.5) < 1e-9
    assert abs(r.memory_s - 0.5) < 1e-9
    assert abs(r.collective_s - 0.1) < 1e-9
    assert r.dominant == "compute" and r.bound_time_s == r.compute_s
    assert abs(r.useful_flops_ratio - 0.5) < 1e-9
    assert 0 < r.roofline_fraction <= 1.0
    rec["cost"]["bytes accessed"] = 3.35e12 * 4.0
    assert analysis.from_record(rec).dominant == "memory"


def test_collective_counter_bytes_and_ops():
    """Under a dry tally ``all_to_all`` and ``all_reduce_sum`` are counted
    (bytes of their result on this rank) and not run: no process group
    is needed, and each returns an empty tensor of its result's shape."""
    x = torch.arange(12, dtype=torch.int32).reshape(4, 3)
    y = torch.ones(5, dtype=torch.float32)
    z = torch.ones(2, 8, dtype=torch.bfloat16)
    with analysis.Tally(dry=True) as t:
        a = tdist.all_to_all(x, None)
        b = tdist.all_reduce_sum(y, None)
        c = tdist.all_reduce_sum(z, None)
    assert a.shape == x.shape and a.dtype == x.dtype
    assert b.shape == y.shape and c.dtype == torch.bfloat16
    assert analysis.collective_bytes(t) == {
        "all-to-all": 48, "all-reduce": 20 + 32, "total": 100,
        "all-to-all_ops": 1, "all-reduce_ops": 2}
    # the tally's shape is the reference's
    assert set(analysis.collective_bytes(analysis.Tally())) == {"total"}


def test_kernel_work_reaches_a_dry_tally_only():
    with analysis.Tally() as wet, analysis.Tally(dry=True) as dry:
        analysis.note_kernel("fused_fm", 10, 20)
        analysis.note_kernel("fused_fm", 1, 2)
    assert wet.kernels == {}
    assert dry.kernels == {"fused_fm": {"calls": 2, "flops": 11,
                                        "bytes": 22, "dtype": "float32"}}
    assert dry.kernel_flops() == {"float32": 11} and dry.kernel_bytes() == 22


def test_meta_routes_report_their_bound_work():
    """A kernel wrapper on meta tensors returns its output's shape and
    reports the bytes and operations of its bound (PERF.md's formulas)."""
    from repro_torch.kernels import embedding_bag, fused_fm, segment_sum
    b, f, d = 16, 5, 8
    emb = torch.empty(b, f, d, device="meta")
    table = torch.empty(100, d, device="meta")
    ids = torch.empty(b, 7, dtype=torch.int32, device="meta")
    x = torch.empty(50, d, device="meta")
    indptr = torch.empty(51, dtype=torch.int64, device="meta")
    idx = torch.empty(300, dtype=torch.int32, device="meta")
    before = {**fused_fm.launches, **embedding_bag.launches,
              **segment_sum.launches}
    with analysis.Tally(dry=True) as t:
        assert fused_fm.fused_fm(emb).shape == (b,)
        assert fused_fm.fused_fm_backward(
            emb, torch.empty(b, device="meta")).shape == emb.shape
        assert embedding_bag.embedding_bag(table, ids).shape == (b, d)
        assert embedding_bag.embedding_bag_backward(
            torch.empty(b, d, device="meta"), ids, None, "sum",
            100).shape == (100, d)
        assert segment_sum.csr_sum(x, indptr, idx).shape == (50, d)
    k = t.kernels
    assert k["fused_fm"]["flops"] == 3 * b * f * d + 3 * b * d
    assert k["fused_fm"]["bytes"] == b * f * d * 4 + b * 4
    assert k["fused_fm_backward"]["bytes"] == 2 * b * f * d * 4 + b * 4
    assert k["embedding_bag"]["bytes"] == b * 7 * d * 4 + b * 7 * 4 \
        + b * d * 4
    assert k["embedding_bag_backward"]["bytes"] == b * 7 * 4 + b * d * 4 \
        + 100 * d * 4
    assert k["csr_sum"]["flops"] == 300 * d
    assert k["csr_sum"]["bytes"] == 300 * d * 4 + 300 * 4 + 51 * 8 \
        + 50 * d * 4
    assert {**fused_fm.launches, **embedding_bag.launches,
            **segment_sum.launches} == before        # nothing launched


def test_memory_dict_keeps_the_reference_names():
    got = analysis.memory_dict({"argument_size_in_bytes": 3.0,
                                "temp_size_in_bytes": 4, "other": 1,
                                "alias_size_in_bytes": None})
    assert got == {"argument_size_in_bytes": 3, "temp_size_in_bytes": 4}
    assert np.isclose(analysis.compute_s({"flops": 1, "flops_int8": 67e12}),
                      1.0)
