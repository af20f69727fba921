"""The port's dry-run (``launch/dryrun.py``) and its report
(``roofline/report.py``), on the CPU: every cell's record at SMOKE; the
arguments' bytes against XLA's ``memory_analysis()`` of the JAX bundle at
one host device; the layer fit, kept as a check, against the full count
at published width; one dense layer's counted FLOPs against its matrix
parameters and chunked attention; qwen3-14b's ``decode_32k`` cache at
published width; the CLI's refusals.  Counts are integers and compared
exactly."""
import dataclasses
import json

import jax
import pytest

from repro.core import compat
from repro.launch import cells as jcells
from repro.launch import mesh as jmesh_mod
from repro_torch.configs import qwen3_14b, registry
from repro_torch.launch import cells, dryrun
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import lm
from repro_torch.roofline import analysis, report

ALL = cells.all_cells()


@pytest.fixture(scope="module")
def mesh():
    return mesh_mod.make_local_mesh()


@pytest.mark.parametrize("arch,shape", ALL,
                         ids=[f"{a}-{s}" for a, s in ALL])
def test_every_smoke_cell_is_counted(mesh, arch, shape):
    rec = dryrun.run_cell(arch, shape, smoke=True, write=False, mesh=mesh)
    assert rec["ok"], rec.get("traceback")
    assert rec["flops_convention"] == dryrun.FLOPS_CONVENTION
    assert rec["n_devices"] == 1 and rec["fits_hbm"]
    assert rec["cost"]["flops"] == sum(
        v for k, v in rec["cost"].items() if k.startswith("flops_"))
    m = rec["memory"]
    assert m["peak_size_in_bytes"] >= m["argument_size_in_bytes"] > 0
    assert m["temp_size_in_bytes"] == m["peak_size_in_bytes"] \
        - m["argument_size_in_bytes"]
    assert rec["collectives"] == {"total": 0}


@pytest.mark.parametrize("arch,shape", [
    ("deepfm", "serve_p99"), ("graphsage-reddit", "molecule"),
    ("qwen3-14b", "decode_32k"), ("two-tower-retrieval", "train_batch")])
def test_argument_bytes_are_xlas(mesh, arch, shape):
    """One cell of each family (and a train cell): the record's
    arguments are the bytes XLA's ``memory_analysis()`` gives the JAX
    bundle compiled at one host device."""
    jmesh = jmesh_mod.make_local_mesh()
    with compat.set_mesh(jmesh):
        jb = jcells.build_cell(arch, shape, jmesh, smoke=True)
        compiled = jax.jit(jb.fn).lower(*jb.args).compile()
    want = compiled.memory_analysis().argument_size_in_bytes
    rec = dryrun.run_cell(arch, shape, smoke=True, write=False, mesh=mesh)
    assert rec["memory"]["argument_size_in_bytes"] == want


@pytest.fixture(scope="module")
def qwen_decode(mesh):
    return dryrun.run_cell("qwen3-14b", "decode_32k", write=False,
                           mesh=mesh)


def test_layer_fit_reproduces_the_full_count(mesh, qwen_decode):
    """At published width, a dense model (base 1) and a mixed one
    (deepseek-v3: its dense prefix held, base 4)."""
    mixed = dryrun.run_cell("deepseek-v3-671b", "decode_32k", write=False,
                            mesh=mesh)
    for rec, base in ((qwen_decode, 1), (mixed, 4)):
        lf = rec["layer_fit"]
        assert rec["ok"] and lf["matches_count"]
        assert lf["fit_base_layers"] == base
        assert lf["flops"] == rec["cost"]["flops"]
        assert lf["bytes accessed"] == rec["cost"]["bytes accessed"]
        assert lf["flops_per_layer"] > 0
        assert report.effective_record(rec)["cost"] == {
            **rec["cost"], "flops": lf["flops"],
            "bytes accessed": lf["bytes accessed"]}


def test_decode_32k_cache_at_published_width(qwen_decode):
    """qwen3-14b's decode_32k at its cell's batch 128: the arguments are
    the weights, the cache (``lm.cache_bytes``) and the tokens and
    positions; the record says it does not fit one card."""
    cfg = qwen3_14b.CONFIG
    m = qwen_decode["memory"]
    assert m["argument_size_in_bytes"] == lm.param_bytes(cfg) \
        + lm.cache_bytes(cfg, 128, 32768) + 2 * 128 * 4
    assert not qwen_decode["fits_hbm"]
    assert m["peak_size_in_bytes"] > analysis.HBM_BYTES
    # the decode step writes its caches in place and returns them
    assert m["alias_size_in_bytes"] == lm.cache_bytes(cfg, 128, 32768)


def test_one_dense_layer_counts_its_products(mesh):
    """qwen3-14b SMOKE prefill at 2 x 32: one layer (two layers' count
    less one's) counts 2 x tokens x its matrix parameters, plus the
    chunked attention's score and value products (each query chunk of 16
    against the keys up to its end)."""
    cfg = qwen3_14b.SMOKE
    cell = registry.reduce_cell(registry.cell_by_name("prefill_32k", "lm"))
    b, s = cell.dims["batch"], cell.dims["seq"]
    counted = [dryrun.measure(cells._lm_cell(
        "qwen3-14b", dataclasses.replace(cfg, n_layers=n), cell,
        mesh))["cost"]["flops"] for n in (1, 2)]
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    matrices = 2 * d * h * dh + 2 * d * kv * dh + 3 * d * cfg.d_ff
    attention = sum(2 * 2 * b * h * min(cfg.q_chunk, s - q0) * dh
                    * min(s, q0 + cfg.q_chunk)
                    for q0 in range(0, s, cfg.q_chunk))
    assert counted[1] - counted[0] == 2 * b * s * matrices + attention


def test_cli_help_and_refusals(capsys):
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--help"])
    assert e.value.code == 0
    assert "--multi-pod" in capsys.readouterr().out
    refusal = ("FSDP / tensor-parallel placement, the bundles' "
               "in_shardings / out_shardings and the dry-run at that mesh, "
               "which wait for ROADMAP queue 1, item 15.4")
    for flag in ("--multi-pod", "--both-meshes"):
        with pytest.raises(SystemExit, match=refusal):
            dryrun.main(["--all", flag])
    with pytest.raises(SystemExit, match=refusal):
        dryrun.run_cell("deepfm", "serve_p99", write=False,
                        mesh=mesh_mod.make_production_mesh())
    prod = mesh_mod.make_production_mesh(multi_pod=True)
    assert (prod.axis_names, prod.shape) == (("pod", "data", "model"),
                                             (2, 16, 16))


def test_records_and_report(tmp_path, capsys, mesh):
    """The CLI writes a record a cell (and reads it back unless
    ``--force``); the report renders it with the H100's constants and
    compares two directories."""
    out = str(tmp_path / "recs")
    assert dryrun.main(["--arch", "deepfm", "--shape", "serve_p99",
                        "--out", out]) == 0
    path = dryrun.record_path(out, "deepfm", "serve_p99")
    with open(path) as f:
        rec = json.load(f)
    assert rec["ok"] and rec["mesh"] == "local" and rec["layer_fit"] is None
    assert dryrun.run_cell("deepfm", "serve_p99", out) == rec
    capsys.readouterr()
    report.main(["--dir", out, "--card", "NVIDIA H100 80GB HBM3, 700.00 W"])
    text = capsys.readouterr().out
    assert "H100 SXM (989e12 bf16" in text and "v5e" not in text
    assert "| deepfm | serve_p99 | OK |" in text
    assert "counted on the host of NVIDIA H100 80GB HBM3, 700.00 W" in text
    report.main(["--dir", out, "--compare-baseline", out])
    assert "×1.00" in capsys.readouterr().out
