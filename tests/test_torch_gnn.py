"""The port's GraphSAGE slice against the JAX package, on the CPU: the
cells and configs, the synthetic graphs, molecule batches and sampled
blocks (bitwise from the same numpy rng), the neighbour mean
(``NeighborMean`` over ``ref.csr_sum``) against ``jnp.take`` +
``segment_sum`` / deg, the three regimes' logits, losses and gradients
against ``jax.grad`` of the JAX ``gnn_loss``, one Adam step, the
converter, and both launchers.  Parameters come from the JAX package's
``sage_init``, carried across by ``core/convert.gnn_from_reference``.

Tolerances, each with its reason:

* integers and the synthetic float arrays: bitwise (the same numpy draws).
* ``ref.csr_sum`` against a scalar loop in ``j`` order: bitwise (the same
  fp32 adds in the same order).
* logits, losses: 1e-5 (rtol and atol); gradient leaves: 1e-5 x the
  leaf's max |g| (atol) and 1e-5 (rtol): fp32 sums (the neighbour sums,
  the products, the norms) taken in other orders by the two packages.
* one Adam step's parameters: 1e-5, except where Adam's update is
  ill-conditioned (sqrt(v̂) < 1e-6): there at lr, for
  ``tests/test_torch_train.py``'s reason (a gradient within two decades
  of eps moves the weight by up to lr for a ~1e-12 difference).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import graphsage_reddit as jgraphsage
from repro.configs import registry as jregistry
from repro.data import graph_sampler as jsampler
from repro.data import synthetic as jsynthetic
from repro.launch import cells as jcells
from repro.models import common as jcm
from repro.models import gnn as jgnn
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch.configs import graphsage_reddit, registry
from repro_torch.core import convert
from repro_torch.data import graph_sampler, synthetic
from repro_torch.kernels import ops, ref
from repro_torch.kernels import segment_sum as seg
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import gnn
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts

TOL = 1e-5              # logits, losses; gradients x their max |g|
ADAM_SENSITIVE = 1e-6   # sqrt(v̂) below this: Adam's step is ill-conditioned
LR = 1e-3               # OptConfig()'s, as the GNN cells train
MI = jcm.MeshInfo.single()
CELLS = [c.name for c in registry.GNN_CELLS]
REGIMES = ["full_graph", "minibatch", "molecule"]
KIND = {"full_graph": "full_graph_sm", "minibatch": "minibatch_lg",
        "molecule": "molecule"}


def _close(got, want, rtol=TOL, atol=TOL, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol, err_msg=what)


def _cell(regime):
    return registry.reduce_cell(registry.cell_by_name(KIND[regime], "gnn"))


def _cfgs(regime):
    cell = _cell(regime)
    jcell = jcells._reduce_cell("gnn", jregistry.cell_by_name(
        jregistry.get("graphsage-reddit"), KIND[regime]))
    d = jcell.dims
    jcfg = dataclasses.replace(jgraphsage.SMOKE, d_feat=d["d_feat"],
                               n_classes=d["n_classes"],
                               fanouts=tuple(d.get("fanouts",
                                                   jgraphsage.SMOKE.fanouts)))
    return cell, gnn.cell_config(graphsage_reddit.SMOKE, cell), jcfg


def _jax_params(jcfg, seed=0):
    params, _ = jcm.unbox(jgnn.sage_init(jax.random.key(seed), jcfg))
    return jax.tree.map(np.asarray, params)


def _arrays(regime, seed):
    return launch_train.gnn_arrays(np.random.default_rng(seed),
                                   _cell(regime))


def _jax_batch(arrays):
    return {k: jnp.asarray(v) for k, v in arrays.items()}


# ---------------------------------------------------------------------------
# cells, configs, data
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", CELLS)
def test_gnn_cells_match_jax(name):
    jspec = jregistry.get("graphsage-reddit")
    jcell = jregistry.cell_by_name(jspec, name)
    cell = registry.cell_by_name(name, "gnn")
    assert dataclasses.asdict(cell) == dataclasses.asdict(jcell)
    assert dataclasses.asdict(registry.reduce_cell(cell)) == \
        dataclasses.asdict(jcells._reduce_cell("gnn", jcell))
    assert [c.name for c in registry.GNN_CELLS] == \
        [c.name for c in jspec.cells]


def test_graphsage_configs_and_family_match_jax():
    jspec = jregistry.get("graphsage-reddit")
    assert registry.family("graphsage-reddit") == jspec.family == "gnn"
    assert registry.GNN_ARCHS["graphsage-reddit"] is graphsage_reddit
    for got, want in ((graphsage_reddit.CONFIG, jspec.config),
                      (graphsage_reddit.SMOKE, jspec.smoke)):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    with pytest.raises(KeyError):
        registry.family("deepseek-7b")
    with pytest.raises(KeyError, match="no gnn cell"):
        registry.cell_by_name("train_batch", "gnn")


@pytest.mark.parametrize("n,e,d,c,seed", [(200, 800, 24, 5, 0),
                                          (2708, 10556, 16, 7, 1),
                                          (1, 5, 3, 2, 2)])
def test_random_graph_bitwise(n, e, d, c, seed):
    got = synthetic.random_graph(np.random.default_rng(seed), n, e, d, c)
    want = jsynthetic.random_graph(np.random.default_rng(seed), n, e, d, c)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("g,n,e,d,c,seed", [(4, 10, 16, 8, 3, 0),
                                            (128, 30, 64, 32, 10, 1),
                                            (3, 2, 1, 1, 2, 2)])
def test_molecule_batch_bitwise(g, n, e, d, c, seed):
    got = synthetic.molecule_batch(np.random.default_rng(seed), g, n, e, d, c)
    want = jsynthetic.molecule_batch(np.random.default_rng(seed), g, n, e, d,
                                     c)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("fanouts,seed", [((4, 3), 0), ((15, 10), 1),
                                          ((1, 1), 2)])
def test_csr_graph_and_sample_block_bitwise(fanouts, seed):
    g = synthetic.random_graph(np.random.default_rng(seed), 500, 2000, 24, 5)
    csr = graph_sampler.CSRGraph(500, g["edges"])
    jcsr = jsampler.CSRGraph(500, g["edges"])
    np.testing.assert_array_equal(csr.indptr, jcsr.indptr)
    np.testing.assert_array_equal(csr.indices, jcsr.indices)
    seeds = np.random.default_rng(seed + 10).integers(0, 500, 8)
    got = graph_sampler.sample_block(np.random.default_rng(seed), csr,
                                     g["feats"], g["labels"], seeds, fanouts)
    want = jsampler.sample_block(np.random.default_rng(seed), jcsr,
                                 g["feats"], g["labels"], seeds, fanouts)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert graph_sampler.block_shapes(8, fanouts, 24) == \
        jsampler.block_shapes(8, fanouts, 24)


@pytest.mark.parametrize("regime", REGIMES)
def test_launcher_batches_bitwise(regime):
    """``gnn_arrays`` draws what the JAX launcher's ``_real_batch`` draws
    from the same rng."""
    from repro.launch import train as jlaunch_train
    cell = _cell(regime)
    jcell = jcells._reduce_cell("gnn", jregistry.cell_by_name(
        jregistry.get("graphsage-reddit"), cell.name))
    got = launch_train.gnn_arrays(np.random.default_rng(3), cell)
    want = jlaunch_train._real_batch(jregistry.get("graphsage-reddit"), None,
                                     jcell, np.random.default_rng(3))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


# ---------------------------------------------------------------------------
# the neighbour sum and the neighbour mean
# ---------------------------------------------------------------------------
def _graphs():
    """(name, n, src, dst): the edge cases the mean must take."""
    rng = np.random.default_rng(5)
    n = 40
    src = rng.integers(0, n, 150)
    dst = rng.integers(0, n // 2, 150)          # nodes >= 20: in-degree 0
    out = [("random_with_zero_in_degree", n, src, dst)]
    loops = np.arange(n)
    out.append(("self_loops", n, np.concatenate([loops, src]),
                np.concatenate([loops, dst])))
    out.append(("duplicate_edges", n, np.repeat(src[:30], 4),
                np.repeat(dst[:30], 4)))
    hub = np.concatenate([np.zeros(300, np.int64), src])   # node 0 -> many
    out.append(("hub_source", n, hub, np.concatenate(
        [rng.integers(0, n, 300), dst])))
    out.append(("no_edges", n, np.zeros(0, np.int64), np.zeros(0, np.int64)))
    return out


def _loop_sum(x, indptr, indices):
    """``csr_sum`` by a scalar loop: each segment from +0.0 in j order."""
    out = np.zeros((len(indptr) - 1, x.shape[1]), x.dtype)
    for r in range(len(indptr) - 1):
        acc = np.zeros(x.shape[1], x.dtype)
        for j in range(indptr[r], indptr[r + 1]):
            acc = acc + x[indices[j]]
        out[r] = acc
    return out


@pytest.mark.parametrize("case", _graphs(), ids=lambda c: c[0])
def test_adjacency_is_the_sampler_csr(case):
    """The by-destination CSR is ``CSRGraph``'s (a stable sort of dst), the
    by-source one the same of the reversed edges; ``deg`` from indptr."""
    _, n, src, dst = case
    adj = seg.adjacency(torch.as_tensor(src), torch.as_tensor(dst), n)
    for (indptr, idx), edges in (
            ((adj.indptr_dst, adj.src_by_dst), np.stack([src, dst])),
            ((adj.indptr_src, adj.dst_by_src), np.stack([dst, src]))):
        want = graph_sampler.CSRGraph(n, edges)
        assert idx.dtype == torch.int32 and indptr.dtype == torch.int64
        np.testing.assert_array_equal(indptr.numpy(), want.indptr)
        np.testing.assert_array_equal(idx.numpy(), want.indices)
    np.testing.assert_array_equal(
        adj.deg[:, 0].numpy(),
        np.maximum(np.bincount(dst, minlength=n), 1).astype(np.float32))


@pytest.mark.parametrize("d", [1, 3, 16, 100])
@pytest.mark.parametrize("case", _graphs(), ids=lambda c: c[0])
def test_csr_sum_is_the_loop_in_j_order(case, d):
    _, n, src, dst = case
    adj = seg.adjacency(torch.as_tensor(src), torch.as_tensor(dst), n)
    x = np.random.default_rng(d).normal(size=(n, d)).astype(np.float32)
    got = ref.csr_sum(torch.as_tensor(x), adj.indptr_dst, adj.src_by_dst)
    np.testing.assert_array_equal(got.numpy(), _loop_sum(
        x, adj.indptr_dst.numpy(), adj.src_by_dst.numpy()))


def _jax_mean(h, src, dst, n):
    """The JAX package's full-graph aggregation (``models/gnn.py``)."""
    src, dst = jnp.asarray(src, jnp.int32), jnp.asarray(dst, jnp.int32)
    deg = jax.ops.segment_sum(jnp.ones_like(dst, dtype=h.dtype), dst,
                              num_segments=n)
    deg = jnp.maximum(deg, 1.0)[:, None]
    return jax.ops.segment_sum(jnp.take(h, src, axis=0), dst,
                               num_segments=n) / deg


@pytest.mark.parametrize("case", _graphs(), ids=lambda c: c[0])
def test_neighbor_mean_matches_jax(case):
    """Forward and the gradient w.r.t. h against ``jax.vjp`` of
    ``take`` + ``segment_sum`` / deg."""
    _, n, src, dst = case
    rng = np.random.default_rng(11)
    h = rng.normal(size=(n, 7)).astype(np.float32)
    g = rng.normal(size=(n, 7)).astype(np.float32)
    want, vjp = jax.vjp(lambda x: _jax_mean(x, src, dst, n), jnp.asarray(h))
    (want_g,) = vjp(jnp.asarray(g))
    adj = seg.adjacency(torch.as_tensor(src), torch.as_tensor(dst), n)
    x = torch.tensor(h, requires_grad=True)
    got = ops.neighbor_mean(x, adj)
    got.backward(torch.as_tensor(g))
    _close(got.detach(), want)
    _close(x.grad, want_g)


def test_neighbor_mean_gradcheck():
    _, n, src, dst = _graphs()[3]
    adj = seg.adjacency(torch.as_tensor(src), torch.as_tensor(dst), n)
    h = torch.randn(n, 3, dtype=torch.float64, requires_grad=True)
    adj64 = dataclasses.replace(adj, deg=adj.deg.double())
    assert torch.autograd.gradcheck(lambda x: ops.neighbor_mean(x, adj64),
                                    (h,))


@pytest.mark.parametrize("regime,want", [("full_graph", 3), ("molecule", 3),
                                         ("minibatch", 0)])
def test_neighbor_sums_a_step(regime, want, monkeypatch):
    """Each layer's mean once forward, and backward only into layer 2's
    input: layer 1's features need no gradient.  The minibatch regime's
    means are dense masked means, no neighbour sum."""
    calls = []
    real = ops.csr_sum
    monkeypatch.setattr(ops, "csr_sum",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    cell, cfg, _ = _cfgs(regime)
    params = gnn.sage_init(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = gnn.gnn_batch(_arrays(regime, 0), cell.kind, "cpu")
    step = ts.make_train_step(ts.gnn_loss_fn(cfg, regime), opt.OptConfig())
    step(params, opt.init_opt_state(params, opt.OptConfig()), 0, batch)
    assert len(calls) == want


def test_molecule_adjacency_drops_pads():
    edges = np.array([[[0, 1], [1, 1], [-1, -1]],
                      [[2, 0], [-1, -1], [-1, -1]]], np.int32)
    adj = gnn.molecule_adjacency(torch.as_tensor(edges), 3)
    assert adj.n_nodes == 6
    np.testing.assert_array_equal(adj.indptr_dst.numpy(),
                                  [0, 0, 2, 2, 3, 3, 3])
    np.testing.assert_array_equal(adj.src_by_dst.numpy(), [0, 1, 5])
    np.testing.assert_array_equal(adj.deg[:, 0].numpy(),
                                  [1, 2, 1, 1, 1, 1])


# ---------------------------------------------------------------------------
# the three regimes against jax.grad of gnn_loss
# ---------------------------------------------------------------------------
def _jax_logits(regime, jparams, jcfg, jb):
    if regime == "full_graph":
        return jgnn.sage_full_graph(jparams, jcfg, jb["feats"], jb["edges"],
                                    MI)
    if regime == "minibatch":
        return jgnn.sage_minibatch(jparams, jcfg, jb, MI)
    return jgnn.sage_molecule(jparams, jcfg, jb, MI)


def _port_logits(regime, params, cfg, batch):
    if regime == "full_graph":
        return gnn.sage_full_graph(params, cfg, batch["feats"], batch["adj"])
    if regime == "minibatch":
        return gnn.sage_minibatch(params, cfg, batch)
    return gnn.sage_molecule(params, cfg, batch, batch["adj"])


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("regime", REGIMES)
def test_regime_matches_jax(regime, seed):
    """Logits and loss within 1e-5; every gradient leaf within 1e-5 x its
    max |g| of ``jax.grad`` of the JAX ``gnn_loss``."""
    cell, cfg, jcfg = _cfgs(regime)
    jparams = _jax_params(jcfg, seed)
    arrays = _arrays(regime, seed)
    jb = _jax_batch(arrays)
    (jl, _), jg = jax.value_and_grad(
        lambda p: jgnn.gnn_loss(p, jcfg, jb, MI, regime), has_aux=True)(
        jax.tree.map(jnp.asarray, jparams))
    params = convert.gnn_from_reference(jparams, cfg, "cpu")
    batch = gnn.gnn_batch(arrays, cell.kind, "cpu")
    _close(_port_logits(regime, params, cfg, batch),
           _jax_logits(regime, jparams, jcfg, jb))
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    loss, metrics = gnn.gnn_loss(leaves, cfg, batch, regime)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    _close(loss.detach(), jl)
    assert float(metrics["loss"].detach()) == float(loss.detach())
    want = convert.flatten_tree(jax.tree.map(np.asarray, jg))
    assert list(want) == list(leaves)
    for (k, w), g in zip(want.items(), grads):
        _close(g, w, rtol=TOL, atol=TOL * max(float(np.abs(w).max()), 1e-30),
               what=k)


@pytest.mark.parametrize("regime", REGIMES)
def test_one_adam_step_matches_jax(regime):
    """``make_train_step(gnn_loss_fn)`` with ``OptConfig()`` (Adam on every
    leaf) against the JAX package's step from the same parameters: loss,
    grad_norm, parameters and optimizer state."""
    cell, cfg, jcfg = _cfgs(regime)
    jparams = _jax_params(jcfg, 2)
    arrays = _arrays(regime, 2)
    jp = jax.tree.map(jnp.asarray, jparams)
    js = jopt.init_opt_state(jp, jopt.OptConfig())
    jf = jax.jit(jts.make_train_step(jts.gnn_loss_fn(jcfg, None, MI, regime),
                                     jopt.OptConfig()))
    jp, js, jstep, jm = jf(jp, js, jnp.int32(0), _jax_batch(arrays))
    params = convert.gnn_from_reference(jparams, cfg, "cpu")
    state = opt.init_opt_state(params, opt.OptConfig())
    assert {k: sorted(v) for k, v in state.items()} == \
        {k: ["m", "v"] for k in params}
    fn = ts.make_train_step(ts.gnn_loss_fn(cfg, regime), opt.OptConfig())
    p, s, step, m = fn(params, state, 0, gnn.gnn_batch(arrays, cell.kind,
                                                       "cpu"))
    assert step == int(jstep) == 1
    _close(m["loss"], jm["loss"])
    _close(m["grad_norm"], jm["grad_norm"])
    want = convert.flatten_tree(jax.tree.map(np.asarray, jp))
    jstate = convert.flatten_tree(jax.tree.map(np.asarray, js))
    for k, w in want.items():
        err = np.abs(p[k].numpy() - w)
        vhat = jstate[f"{k}/v"] / (1 - 0.999)
        bound = np.where(np.sqrt(vhat) < ADAM_SENSITIVE, LR,
                         TOL + TOL * np.abs(w))
        assert (err <= bound).all(), (k, float(err.max()))
        for name in ("m", "v"):
            _close(s[k][name], jstate[f"{k}/{name}"],
                   atol=TOL * max(float(np.abs(jstate[f"{k}/{name}"]).max()),
                                  1e-30), what=f"{k}/{name}")


# ---------------------------------------------------------------------------
# the converter
# ---------------------------------------------------------------------------
def test_gnn_from_reference_checks_shapes():
    _, cfg, jcfg = _cfgs("full_graph")
    jparams = _jax_params(jcfg)
    params = convert.gnn_from_reference(jparams, cfg, "cpu")
    assert list(params) == list(gnn.param_shapes(cfg))
    assert {k: tuple(v.shape) for k, v in params.items()} == \
        gnn.param_shapes(cfg)
    port = gnn.sage_init(cfg, torch.Generator().manual_seed(0), "cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in port.items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in params.items()}
    np.testing.assert_array_equal(params["layers/0/w_self"].numpy(),
                                  jparams["layers"][0]["w_self"])
    wrong = jax.tree.map(lambda x: x, jparams)
    wrong["cls"] = wrong["cls"][:, :-1]
    with pytest.raises(ValueError, match="cls has shape"):
        convert.gnn_from_reference(wrong, cfg, "cpu")
    missing = {"layers": jparams["layers"][:1], "cls": jparams["cls"]}
    with pytest.raises(ValueError, match="needs parameters"):
        convert.gnn_from_reference(missing, cfg, "cpu")


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [None] + CELLS)
def test_train_launcher_runs_graphsage(shape, capsys):
    argv = ["--arch", "graphsage-reddit", "--smoke", "--device", "cpu",
            "--steps", "3"]
    out = launch_train.main(argv + (["--shape", shape] if shape else []))
    assert out["shape"] == (shape or "minibatch_lg")
    assert out["step"] == 3 and len(out["losses"]) == 3
    assert np.isfinite(out["losses"]).all()
    assert "done" in capsys.readouterr().out


@pytest.mark.parametrize("shape", [None] + CELLS)
def test_serve_launcher_runs_graphsage(shape, capsys):
    argv = ["--arch", "graphsage-reddit", "--smoke", "--device", "cpu",
            "--requests", "3"]
    out = launch_serve.main(argv + (["--shape", shape] if shape else []))
    assert out["shape"] == (shape or "molecule") and out["finite"]
    assert out["requests"] == 3
    assert f"graphsage-smoke/{shape or 'molecule'}: 3 requests" in \
        capsys.readouterr().out


def test_launchers_refuse_a_recsys_cell_for_graphsage():
    with pytest.raises(SystemExit):
        launch_train.main(["--arch", "graphsage-reddit", "--shape",
                           "train_batch", "--smoke", "--device", "cpu"])
    with pytest.raises(SystemExit):
        launch_serve.main(["--arch", "graphsage-reddit", "--shape",
                           "serve_p99", "--smoke", "--device", "cpu"])
    with pytest.raises(SystemExit):
        launch_serve.main(["--arch", "deepfm", "--shape", "molecule",
                           "--smoke", "--device", "cpu"])


def test_launchers_need_a_card_without_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--arch", "graphsage-reddit", "--smoke",
                           "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_serve.main(["--arch", "graphsage-reddit", "--smoke",
                           "--requests", "1"])
