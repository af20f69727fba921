"""The port's ``retrieval_cand`` slice against the JAX package, on the CPU,
at SMOKE with the JAX parameters carried over by ``core/convert``: the
registry's cells, the two-tower item tower, ``lax_top_k``'s order (ties,
signed zeros, NaN of either sign), ``serve_step.retrieval_fn`` (two-tower)
and ``bulk_rank_fn`` (DeepFM), and the launcher's ``--shape``.  The inputs
are made with numpy from a seed and given to both packages.

Top-k lists are compared so: values within 1e-5; indices equal wherever
the JAX list's neighbouring scores (the next unreturned one included) lie
more than 2e-5 apart, since the two packages' products differ by ~1e-7
and may order near-equal scores either way; and within the port's list,
equal values in ascending index order, as ``jax.lax.top_k`` gives them.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import deepfm as jdeepfm
from repro.configs import registry as jregistry
from repro.configs import two_tower_retrieval as jtt
from repro.launch import cells as jcells
from repro.launch import mesh as mesh_mod
from repro.models import common as jcm
from repro.models import recsys as jrec
from repro.serve import serve_step as jserve
from repro_torch.configs import deepfm, registry, two_tower_retrieval as tt
from repro_torch.core import convert
from repro_torch.data import synthetic
from repro_torch.launch import serve as launch_serve
from repro_torch.models import recsys as rec
from repro_torch.serve import serve_step

TOL = 1e-5                # fp32 forward, the same parameters in both
GAP = 2e-5                # scores closer than this may swap places


@pytest.fixture(scope="module")
def mi():
    return jcm.MeshInfo.from_mesh(mesh_mod.make_local_mesh())


@pytest.fixture(scope="module")
def jmesh():
    return mesh_mod.make_local_mesh()


def _jparams(jcfg):
    params, _ = jcm.unbox(jrec.recsys_init(jax.random.key(0), jcfg))
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def tt_params():
    return _jparams(jtt.SMOKE)


@pytest.fixture(scope="module")
def tt_model(tt_params):
    return convert.two_tower_from_reference(tt_params, tt.SMOKE, "cpu")


@pytest.fixture(scope="module")
def fm_params():
    return _jparams(jdeepfm.SMOKE)


@pytest.fixture(scope="module")
def fm_model(fm_params):
    return convert.deepfm_from_reference(fm_params, deepfm.SMOKE, "cpu")


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def assert_same_top_k(got, want, want_next=None):
    """``got`` (the port's values and indices) against ``want`` (the JAX
    package's, [..., k]); ``want_next``: the JAX package's (k+1)-th score
    of each row, or None when the list holds every score."""
    gv, gi = (t.numpy() for t in got)
    wv, wi = (np.asarray(a) for a in want)
    assert gv.shape == wv.shape and gi.shape == wi.shape
    np.testing.assert_allclose(gv, wv, rtol=0, atol=TOL)
    gv, gi, wv, wi = (a.reshape(-1, a.shape[-1]) for a in (gv, gi, wv, wi))
    nxt = (np.full(len(wv), -np.inf) if want_next is None
           else np.asarray(want_next).reshape(-1))
    for r in range(len(wv)):
        s = np.concatenate([[np.inf], wv[r], [nxt[r]]])
        apart = (s[1:-1] - s[2:] > GAP) & (s[:-2] - s[1:-1] > GAP)
        np.testing.assert_array_equal(gi[r][apart], wi[r][apart])
        tied = gv[r][1:] == gv[r][:-1]
        assert (gi[r][1:][tied] > gi[r][:-1][tied]).all()
        assert (np.diff(gv[r]) <= 0).all()


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", [c.name for c in jregistry.REC_CELLS])
def test_registry_cells_are_copies(name):
    jcell = next(c for c in jregistry.REC_CELLS if c.name == name)
    cell = registry.cell_by_name(name)
    assert dataclasses.asdict(cell) == dataclasses.asdict(jcell)
    assert dataclasses.asdict(registry.reduce_cell(cell)) == \
        dataclasses.asdict(jcells._reduce_cell("recsys", jcell))


@pytest.mark.parametrize("arch", list(registry.ARCHS))
def test_registry_maps_the_ported_archs_to_their_configs(arch):
    configs, jspec = registry.ARCHS[arch], jregistry.get(arch)
    assert jspec.family == "recsys"
    assert dataclasses.asdict(configs.CONFIG) == \
        dataclasses.asdict(jspec.config)
    assert dataclasses.asdict(configs.SMOKE) == \
        dataclasses.asdict(jspec.smoke)
    assert [c.name for c in registry.REC_CELLS] == \
        [c.name for c in jspec.cells]


def test_registry_refuses_unported_archs_and_unknown_cells():
    """deepseek-7b is an LM arch, not a recsys one: it serves and trains
    (``tests/test_torch_lm.py``, ``tests/test_torch_lm_train.py``: here
    its train_4k through the serve launcher, one step a request); an arch
    the port does not know refuses, naming ROADMAP; an LM cell is no
    recsys cell."""
    assert "deepseek-7b" not in registry.ARCHS
    assert "graphsage-reddit" not in registry.ARCHS      # not a recsys arch
    assert registry.family("deepseek-7b") == "lm"
    out = launch_serve.main(["--arch", "deepseek-7b", "--shape", "train_4k",
                             "--smoke", "--device", "cpu", "--requests",
                             "1"])
    assert out["finite"] and out["shape"] == "train_4k"
    with pytest.raises(SystemExit,
                       match="deepseek-8b is not ported.*ROADMAP"):
        launch_serve.main(["--arch", "deepseek-8b", "--smoke",
                           "--device", "cpu"])
    with pytest.raises(KeyError, match="no recsys cell"):
        registry.cell_by_name("decode_32k")
    assert registry.cell_by_name("decode_32k", "lm").dims == {
        "seq": 32768, "batch": 128}


def test_registry_serves_graphsage_as_a_gnn_arch():
    """The arch this test once held as refused: the registry maps it to
    its GNN family, and the serve launcher answers its smoke."""
    assert registry.family("graphsage-reddit") == "gnn"
    out = launch_serve.main(["--arch", "graphsage-reddit", "--smoke",
                             "--device", "cpu", "--requests", "2"])
    assert out["shape"] == "molecule" and out["finite"]


# ---------------------------------------------------------------------------
# the item tower
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_item_tower_matches_jax(tt_params, tt_model, mi, seed):
    rng = np.random.default_rng(seed)
    ids = synthetic.zipf_ids(rng, tt.SMOKE.item_vocab, 300)
    cats = synthetic.zipf_ids(rng, tt.SMOKE.cat_vocab, 300)
    ids[:3] = -1                       # padding rows read zeros: row 1
    cats[1:4] = [-1, tt.SMOKE.cat_vocab - 1, 0]     # is all padding
    with torch.inference_mode():
        got = tt_model.item_tower(torch.from_numpy(ids),
                                  torch.from_numpy(cats))
    want = jrec.item_tower(tt_params, jtt.SMOKE, jnp.asarray(ids),
                           jnp.asarray(cats), mi)
    assert got.shape == (300, tt.SMOKE.tower_mlp[-1])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    norms = np.ones(300)
    norms[1] = 0                       # zero biases: the zero vector
    np.testing.assert_allclose(got.norm(dim=-1).numpy(), norms, rtol=TOL,
                               atol=TOL)


def test_item_tower_zero_vector_stays_zero(tt_params, mi):
    zeroed = dict(tt_params, item_mlp=[dict(layer, w=np.zeros_like(
        layer["w"])) for layer in tt_params["item_mlp"]])
    model = convert.two_tower_from_reference(zeroed, tt.SMOKE, "cpu")
    ids = np.arange(10, dtype=np.int32)
    with torch.inference_mode():
        got = model.item_tower(torch.from_numpy(ids), torch.from_numpy(ids))
    want = jrec.item_tower(zeroed, jtt.SMOKE, jnp.asarray(ids),
                           jnp.asarray(ids), mi)
    assert torch.equal(got, torch.zeros(10, tt.SMOKE.tower_mlp[-1]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# lax_top_k's tie rule
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape,levels,k", [
    ((300,), 5, 50), ((4, 300), 7, 1), ((4, 300), 7, 120),
    ((3, 64), 2, 64), ((2, 1000), 1000, 100)])
def test_lax_top_k_matches_jax_on_repeated_scores(shape, levels, k):
    """Scores with deliberate repeats (a few levels, ties across the cut)
    give exactly ``jax.lax.top_k``'s values and indices."""
    rng = np.random.default_rng(levels + k)
    scores = (rng.integers(0, levels, shape) * 0.25 - 1).astype(np.float32)
    gv, gi = rec.lax_top_k(torch.from_numpy(scores), k)
    wv, wi = jax.lax.top_k(jnp.asarray(scores), k)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    if levels < 1000:                  # the k-th value repeats
        assert ((scores == np.asarray(wv)[..., -1:]).sum(-1) > 1).all()


NEG_NAN = np.array([0xFFC00000], dtype=np.uint32).view(np.float32)[0]


def _same_as_jax_top_k(scores, k):
    """``lax_top_k`` against ``jax.lax.top_k``: indices equal, values
    bitwise (signed zeros and NaN payloads included)."""
    gv, gi = rec.lax_top_k(torch.from_numpy(scores), k)
    wv, wi = jax.lax.top_k(jnp.asarray(scores), k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gv.numpy().view(np.uint32),
                                  np.asarray(wv).view(np.uint32))


@pytest.mark.parametrize("row", [
    [0., -0., 0., -0., 1.], [-0., 0., -1.], [1., NEG_NAN, 3., 2.],
    [np.nan, np.inf, -np.inf, NEG_NAN, 0., -0., np.nan, -np.inf]])
def test_lax_top_k_orders_signed_zeros_and_nan_as_jax(row):
    """The float total order: +0.0 above -0.0, a positive NaN above +inf,
    a negative NaN below -inf; equal keys by ascending index."""
    scores = np.array(row, dtype=np.float32)
    for k in range(len(row) + 1):
        _same_as_jax_top_k(scores, k)


_SPECIAL = [0.0, -0.0, np.inf, -np.inf, np.nan, float(NEG_NAN), 1.0, -1.0,
            np.array([0x7F800001], dtype=np.uint32).view(np.float32)[0],
            np.array([0xFF800001], dtype=np.uint32).view(np.float32)[0]]


@settings(deadline=None, max_examples=60, database=None)
@given(data=st.data(), n=st.integers(1, 40), rows=st.integers(1, 3))
def test_lax_top_k_matches_jax_with_signed_zeros_and_nan(data, n, rows):
    """Rows drawn from finite values, signed zeros, infinities and NaNs of
    either sign (two payloads each): the same indices as ``jax.lax.top_k``
    and bitwise the same values, for every k."""
    vals = data.draw(st.lists(
        st.one_of(st.sampled_from(_SPECIAL),
                  st.floats(-2, 2, width=32, allow_nan=False)),
        min_size=rows * n, max_size=rows * n))
    scores = np.array(vals, dtype=np.float32).reshape(rows, n)
    k = data.draw(st.integers(0, n))
    _same_as_jax_top_k(scores, k)


def test_lax_top_k_refuses_more_than_the_scores():
    with pytest.raises(ValueError, match="top_k"):
        rec.lax_top_k(torch.zeros(5), 6)


# ---------------------------------------------------------------------------
# the serving steps against the JAX package's
# ---------------------------------------------------------------------------
def _user_batch(rng, users):
    batch = synthetic.recsys_batch(rng, tt.SMOKE, users)
    for k in ("item_id", "item_cat"):
        batch.pop(k)
    return batch


@pytest.mark.parametrize("n", [64, 4096])
@pytest.mark.parametrize("seed", [0, 1])
def test_retrieval_fn_matches_jax(tt_params, tt_model, mi, jmesh, n, seed):
    """The smoke cell (8 users, 64 candidates) and 4,096 zipf candidates,
    where (item, category) pairs repeat and equal scores meet in the top
    100."""
    rng = np.random.default_rng(seed)
    users = registry.reduce_cell(registry.REC_CELLS[3]).dims["batch"]
    batch = _user_batch(rng, users)
    ids = synthetic.zipf_ids(rng, tt.SMOKE.item_vocab, n)
    cats = synthetic.zipf_ids(rng, tt.SMOKE.cat_vocab, n)
    k = min(100, n)
    got = serve_step.retrieval_fn(tt.SMOKE, tt_model, top_k=k)(
        batch, ids, cats)
    jstep = jserve.retrieval_fn(jtt.SMOKE, jmesh, mi, top_k=min(k + 1, n))
    wv, wi = jstep(tt_params, _jbatch(batch), jnp.asarray(ids),
                   jnp.asarray(cats))
    nxt = None if k == n else np.asarray(wv)[:, k]
    assert got[0].shape == (users, k) and got[1].shape == (users, k)
    assert_same_top_k(got, (np.asarray(wv)[:, :k], np.asarray(wi)[:, :k]),
                      nxt)
    if n == 4096:
        assert len(set(zip(ids, cats))) < n             # repeats
        assert (got[0][:, 1:] == got[0][:, :-1]).any()  # exact ties


@pytest.mark.parametrize("n", [64, 4096])
@pytest.mark.parametrize("seed", [0, 1])
def test_bulk_rank_fn_matches_jax(fm_params, fm_model, mi, jmesh, n, seed):
    """DeepFM's retrieval_cand: the logits of n candidate rows and their
    top 100 (at most n), as the JAX package's bulk_rank_fn gives them."""
    batch = synthetic.recsys_batch(np.random.default_rng(seed),
                                   deepfm.SMOKE, n)
    batch.pop("label")
    k = min(100, n)
    got = serve_step.bulk_rank_fn(deepfm.SMOKE, fm_model, top_k=k)(batch)
    jstep = jserve.bulk_rank_fn(jdeepfm.SMOKE, jmesh, mi,
                                top_k=min(k + 1, n))
    wv, wi = jstep(fm_params, _jbatch(batch))
    nxt = None if k == n else np.asarray(wv)[k:k + 1]
    assert got[0].shape == (k,) and got[0].dtype == torch.float32
    assert_same_top_k(got, (np.asarray(wv)[:k], np.asarray(wi)[:k]), nxt)


def test_retrieval_uploads_one_copy(tt_model, monkeypatch):
    """The user's columns and both candidate columns cross in one buffer."""
    uploaded = []
    upload = serve_step._upload

    def record(batch, device):
        uploaded.append(upload(batch, device))
        return uploaded[-1]

    monkeypatch.setattr(serve_step, "_upload", record)
    rng = np.random.default_rng(3)
    batch = _user_batch(rng, 2)
    ids = synthetic.zipf_ids(rng, tt.SMOKE.item_vocab, 50)
    cats = synthetic.zipf_ids(rng, tt.SMOKE.cat_vocab, 50)
    serve_step.retrieval_fn(tt.SMOKE, tt_model, top_k=10)(batch, ids, cats)
    (up,) = uploaded
    assert list(up) == ["user_id", "hist_items", "dense", "cand_ids",
                        "cand_cats"]
    assert len({t.untyped_storage().data_ptr() for t in up.values()}) == 1
    np.testing.assert_array_equal(up["cand_ids"].numpy(), ids)
    np.testing.assert_array_equal(up["cand_cats"].numpy(), cats)


def test_steps_refuse_the_other_arch(tt_model, fm_model):
    with pytest.raises(ValueError, match="bulk_rank_fn"):
        serve_step.retrieval_fn(deepfm.SMOKE, fm_model)
    with pytest.raises(ValueError, match="retrieval_fn"):
        serve_step.bulk_rank_fn(tt.SMOKE, tt_model)
    with pytest.raises(NotImplementedError, match="gcn is not ported"):
        serve_step.bulk_rank_fn(dataclasses.replace(deepfm.SMOKE, arch="gcn"),
                                fm_model)
    with pytest.raises(NotImplementedError, match="two-tower"):
        rec.retrieval_scores(fm_model, {}, [0], [0])
    with pytest.raises(NotImplementedError, match="pointwise"):
        rec.bulk_rank(tt_model, {})


# ---------------------------------------------------------------------------
# the launcher's --shape
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["two-tower-retrieval", "deepfm"])
def test_launcher_retrieval_cand_on_the_cpu(arch, capsys):
    out = launch_serve.main(["--arch", arch, "--shape", "retrieval_cand",
                             "--smoke", "--device", "cpu", "--requests", "2"])
    assert out["shape"] == "retrieval_cand" and out["candidates"] == 64
    assert out["finite"] and out["p99_ms"] >= out["p50_ms"] > 0
    assert out["rows"] == (64 if arch == "deepfm" else 8)
    assert "/retrieval_cand: 2 requests of " in capsys.readouterr().out


@pytest.mark.parametrize("arch", list(registry.ARCHS))
def test_launcher_serve_bulk_on_the_cpu(arch, capsys):
    out = launch_serve.main(["--arch", arch, "--shape", "serve_bulk",
                             "--smoke", "--device", "cpu", "--requests", "2"])
    assert out["shape"] == "serve_bulk" and out["rows"] == 8
    assert out["candidates"] is None and out["finite"]
    assert "/serve_bulk: 2 requests of 8 rows on cpu" in \
        capsys.readouterr().out


def test_launcher_refuses_training_and_a_batch_for_retrieval():
    """train_batch is the train launcher's (python -m
    repro_torch.launch.train); --batch sets no retrieval cell's rows."""
    with pytest.raises(SystemExit, match="repro_torch.launch.train"):
        launch_serve.main(["--arch", "deepfm", "--shape", "train_batch",
                           "--smoke", "--device", "cpu"])
    with pytest.raises(SystemExit):
        launch_serve.main(["--arch", "deepfm", "--shape", "retrieval_cand",
                           "--smoke", "--device", "cpu", "--batch", "3"])
