"""The port's cell builder (``launch/cells.py``) and ``materialize_bundle``
against the JAX package's, on the CPU: every (arch x cell) of the
registry at SMOKE draws the same arguments and names the same ``meta``;
every cell runs as ``test_arch_smoke.py::test_smoke_cell`` runs the JAX
bundles; one cell of each kind, ``sparse_emb`` and ``accum2``, answer as
the JAX bundle's ``fn`` does; two-tower's ``a2a`` and ``psum16`` bundles
run in a gloo world.

Tolerances, each with its reason:

* ``materialize_bundle``'s arguments: bitwise, leaf for leaf in
  ``jax.tree_util``'s order (the same numpy draws, the same casts).
* model outputs (probabilities, user vectors, logits, caches, top-k
  values): 1e-5, rtol and atol (fp32 sums taken in other orders).  The LM
  cells run their SMOKE configs in float32 on both sides, so no bf16
  tolerance is needed; an MoE config is held to JAX's kept-only dispatch
  (``tests/test_torch_lm.py``'s ``_kept_only_moe_apply``: the reference
  clobbers a kept slot when an expert overflows).  Top-k indices: equal.
* train steps: ``tests/test_torch_lm_train.py``'s: loss and ``grad_norm``
  1e-5 relative; parameters 1e-5 but where JAX's state says Adam's step
  is a sign (there within lr); fp32 state 1e-5.
* the ``a2a`` / ``psum16`` worlds: 1e-5 of the JAX bundle's vectors (at
  the local mesh, whose ``model`` axis is 1, both lookups take the local
  path, in the reference and in the port).
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.core import compat
from repro.launch import cells as jcells
from repro.launch import mesh as jmesh_mod
from repro.launch.materialize import materialize_bundle as jmaterialize
from repro.models import common as jcm
from repro_torch.configs import registry
from repro_torch.core import convert
from repro_torch.launch import cells
from repro_torch.launch import materialize as mat
from repro_torch.launch import mesh as mesh_mod

from conftest import subprocess_env

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_lm import JAX_CONFIGS  # noqa: E402
from test_torch_lm_train import (_assert_params_close,  # noqa: E402
                                 _assert_state_close, _dispatch)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
ALL = [(a, c.name) for a in jregistry.all_arch_ids()
       for c in jregistry.get(a).cells]
WORLD, WORLD_TIMEOUT_S = 2, 240
MOE_ARCHS = ("deepseek-v3-671b", "qwen3-moe-235b-a22b")


@pytest.fixture(scope="module")
def jmesh():
    return jmesh_mod.make_local_mesh()


@pytest.fixture(scope="module")
def mesh():
    return mesh_mod.make_local_mesh()


def _bits(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _jbits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16) if str(a.dtype) == "bfloat16" else a


def port_leaves(tree) -> list:
    """A tree's tensors in ``materialize``'s (``jax.tree_util``'s) order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree, key=mat._key_order)
                for x in port_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in port_leaves(v)]
    raise TypeError(type(tree))


def _jbundle(jmesh, arch, shape, variant="baseline"):
    with compat.set_mesh(jmesh):
        return jcells.build_cell(arch, shape, jmesh, smoke=True,
                                 variant=variant)


# ---------------------------------------------------------------------------
# the arguments and meta, every cell
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,shape", ALL,
                         ids=[f"{a}-{s}" for a, s in ALL])
def test_materialize_bundle_is_the_jax_packages(jmesh, mesh, arch, shape):
    jb = _jbundle(jmesh, arch, shape)
    pb = cells.build_cell(arch, shape, mesh, smoke=True)
    assert pb.meta == jb.meta
    assert pb.cell.kind == jb.cell.kind and pb.cell.dims == jb.cell.dims
    want = jax.tree_util.tree_leaves(jmaterialize(jb, seed=0))
    got = port_leaves(mat.materialize_bundle(pb, seed=0))
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, (i, g.shape, w.shape)
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype), i
        np.testing.assert_array_equal(_bits(g), _jbits(w), err_msg=str(i))


def test_leaf_order_numbers_list_indices():
    """A path-keyed dict draws as the reference's nested tree: ``mlp/10``
    after ``mlp/9``."""
    keys = ["mlp/10/w", "mlp/9/w", "mlp/1/b", "bias", "mlp_x"]
    assert sorted(keys, key=mat._key_order) == [
        "bias", "mlp/1/b", "mlp/9/w", "mlp/10/w", "mlp_x"]


GNN = [c.name for c in registry.GNN_CELLS]


@pytest.mark.parametrize("shape", GNN)
def test_gnn_serve_requests_are_the_jax_launchers(jmesh, mesh, shape):
    """The GNN serve launcher's request i (its optimizer state, step and
    batch) is the JAX launcher's ``materialize(bundle.args[1:], seed=i +
    1, int_high=...)``, bitwise, and a request runs to a finite loss."""
    from repro.launch.materialize import materialize as jmat
    from repro_torch.launch import serve as launch_serve
    jb = _jbundle(jmesh, "graphsage-reddit", shape)
    pb = cells.build_cell("graphsage-reddit", shape, mesh, smoke=True)
    for i in range(2):
        want = jax.tree_util.tree_leaves(jmat(
            jb.args[1:], seed=i + 1, int_high=jb.meta.get("int_high")))
        req = launch_serve.gnn_request(pb, i, "cpu")
        got = port_leaves(req)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_bits(g), _jbits(w))
    base = mat.materialize_bundle(pb, seed=0)
    out = pb.fn(base[0], *req)
    assert bool(torch.isfinite(out[3]["loss"]))


# ---------------------------------------------------------------------------
# test_arch_smoke's checks, every cell
# ---------------------------------------------------------------------------
def _out_leaves(out) -> list:
    return [x for x in torch.utils._pytree.tree_flatten(out)[0]
            if isinstance(x, torch.Tensor)]


@pytest.mark.parametrize("arch,shape", ALL,
                         ids=[f"{a}-{s}" for a, s in ALL])
def test_smoke_cell(mesh, arch, shape):
    bundle = cells.build_cell(arch, shape, mesh, smoke=True)
    args = mat.materialize_bundle(bundle, seed=0)
    shapes = {k: tuple(v.shape) for k, v in args[0].items()}
    out = bundle.fn(*args)
    assert all(bool(torch.isfinite(t).all()) for t in _out_leaves(out)
               if t.is_floating_point()), f"{arch}/{shape} not finite"
    if bundle.meta.get("has_opt"):
        assert {k: tuple(v.shape) for k, v in out[0].items()} == shapes
        assert int(out[2]) == 1
    if bundle.cell.kind == "rec_serve":
        assert _out_leaves(out)[0].shape[0] == bundle.cell.dims["batch"]


def test_build_cell_refuses_an_unknown_variant(mesh):
    with pytest.raises(ValueError, match="unknown variant"):
        cells.build_cell("deepfm", "serve_p99", mesh, smoke=True,
                         variant="ring")


# ---------------------------------------------------------------------------
# outputs against the JAX bundles' fn
# ---------------------------------------------------------------------------
def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32)
                        if np.asarray(a).dtype.kind == "f" or
                        str(np.asarray(a).dtype) == "bfloat16"
                        else np.asarray(a), tree)


def _close(got, want):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=TOL,
                               atol=TOL)


def _lm_bundles(jmesh, mesh, arch, shape, variant):
    """Both bundles of an LM cell at SMOKE in float32."""
    jcfg = dataclasses.replace(JAX_CONFIGS[arch].SMOKE, dtype="float32")
    cfg = dataclasses.replace(registry.LM_ARCHS[arch].SMOKE,
                              dtype="float32")
    jcell = jcells._reduce_cell("lm", jregistry.cell_by_name(
        jregistry.get(arch), shape))
    cell = registry.reduce_cell(registry.cell_by_name(shape, "lm"))
    with compat.set_mesh(jmesh):
        jb = jcells._lm_cell(arch, jcfg, jcell, jmesh,
                             jcm.MeshInfo.from_mesh(jmesh), variant)
    return jb, cells._lm_cell(arch, cfg, cell, mesh, variant)


def _check_train(jout, out):
    jp = convert.flatten_tree(_np(jout[0]))
    js = convert.flatten_tree(_np(jout[1]))
    got_p = {k: v.detach() for k, v in out[0].items()}
    assert set(got_p) == set(jp)
    _assert_params_close(got_p, jp, js, "adam", 1)
    _assert_state_close(out[1], js, "adam", 1)
    assert int(out[2]) == int(jout[2]) == 1
    for k in ("loss", "grad_norm"):
        w = float(jout[3][k])
        assert abs(float(out[3][k]) - w) <= TOL * max(1.0, abs(w)), k


PARITY = [("qwen3-14b", "train_4k", "baseline"),
          ("qwen3-14b", "train_4k", "accum2"),
          ("qwen3-14b", "prefill_32k", "baseline"),
          ("qwen3-14b", "decode_32k", "baseline"),
          ("qwen3-moe-235b-a22b", "prefill_32k", "baseline"),
          ("deepfm", "train_batch", "baseline"),
          ("deepfm", "train_batch", "sparse_emb"),
          ("deepfm", "serve_p99", "baseline"),
          ("two-tower-retrieval", "serve_p99", "baseline"),
          ("two-tower-retrieval", "retrieval_cand", "baseline"),
          ("deepfm", "retrieval_cand", "baseline"),
          ("graphsage-reddit", "full_graph_sm", "baseline"),
          ("graphsage-reddit", "minibatch_lg", "baseline"),
          ("graphsage-reddit", "molecule", "baseline")]


@pytest.mark.parametrize("arch,shape,variant", PARITY,
                         ids=[f"{a}-{s}-{v}" for a, s, v in PARITY])
def test_bundle_fn_matches_jax(jmesh, mesh, arch, shape, variant):
    """The port's bundle ``fn`` on its materialized arguments against the
    JAX bundle's on its own (the same values: the first test)."""
    if registry.family(arch) == "lm":
        jb, pb = _lm_bundles(jmesh, mesh, arch, shape, variant)
    else:
        jb = _jbundle(jmesh, arch, shape, variant)
        pb = cells.build_cell(arch, shape, mesh, smoke=True,
                              variant=variant)
    jargs = jmaterialize(jb, seed=0)
    with compat.set_mesh(jmesh), _dispatch(arch in MOE_ARCHS):
        jout = jax.jit(jb.fn)(*jargs)
    out = pb.fn(*mat.materialize_bundle(pb, seed=0))
    kind = pb.cell.kind
    if pb.meta.get("has_opt"):
        _check_train(jout, out)
    elif kind == "decode":
        _close(out[0], jout[0])
        for g, w in zip(port_leaves(out[1]), jax.tree.leaves(jout[1])):
            _close(g, w)
    elif kind == "rec_retrieval":
        _close(out[0], jout[0])
        np.testing.assert_array_equal(out[1].numpy(), np.asarray(jout[1]))
    else:                               # prefill, rec_serve
        _close(out, jout)


# ---------------------------------------------------------------------------
# two-tower's a2a and psum16 bundles in a gloo world
# ---------------------------------------------------------------------------
RANK_SCRIPT = textwrap.dedent("""
    import os, sys
    import numpy as np, torch, torch.distributed as dist
    from repro_torch.launch import cells, materialize as mat, mesh as mm
    from repro_torch.roofline import analysis
    rank, world, rdv, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \\
        sys.argv[4]
    dist.init_process_group("gloo", init_method="file://" + rdv, rank=rank,
                            world_size=world)
    mesh = mm.make_local_mesh()
    res = {"shape": np.array(mesh.shape)}
    for variant in ("a2a", "psum16"):
        b = cells.build_cell("two-tower-retrieval", "serve_p99", mesh,
                             smoke=True, variant=variant)
        with analysis.Tally() as t:
            res[variant] = b.fn(*mat.materialize_bundle(b, seed=0)).numpy()
        res[variant + "_collectives"] = np.array(
            analysis.collective_bytes(t)["total"])
    np.savez(out, **res)
    dist.destroy_process_group()
""")


def test_a2a_and_psum16_bundles_in_a_gloo_world(jmesh, tmp_path):
    """Each rank of a world of ``WORLD`` (its own interpreter) builds the
    ``a2a`` and ``psum16`` serve_p99 bundles at its local mesh ((WORLD,
    1)) and scores the whole batch: the local path over the ``model``
    group of one, no collective, the JAX bundles' vectors."""
    rdv = str(tmp_path / "rdv")
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK_SCRIPT, str(r), str(WORLD), rdv,
         str(tmp_path / f"rank{r}.npz")], cwd=REPO, env=subprocess_env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(WORLD)]
    try:
        errs = [p.communicate(timeout=WORLD_TIMEOUT_S)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), errs
    for variant in ("a2a", "psum16"):
        jb = _jbundle(jmesh, "two-tower-retrieval", "serve_p99", variant)
        with compat.set_mesh(jmesh):
            want = np.asarray(jax.jit(jb.fn)(*jmaterialize(jb, seed=0)))
        for r in range(WORLD):
            got = np.load(tmp_path / f"rank{r}.npz")
            assert tuple(got["shape"]) == (WORLD, 1)
            assert int(got[variant + "_collectives"]) == 0
            np.testing.assert_allclose(got[variant], want, rtol=TOL,
                                       atol=TOL)
