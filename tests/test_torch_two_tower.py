"""The port's two-tower serving slice against the JAX package, on the CPU, at
SMOKE with the JAX parameters carried over by ``two_tower_from_reference``:
the config copy, ``embed_bag``, the user tower through ``recsys_score``,
the scoring step with and without a feature engine, the converter's checks
and the launcher.  The inputs are made with numpy from a seed and given to
both packages."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import two_tower_retrieval as jtt
from repro.core import engine as jeng
from repro.launch import mesh as mesh_mod
from repro.models import common as jcm
from repro.models import embedding_service as jes
from repro.models import recsys as jrec
from repro.serve import serve_step as jserve
from repro_torch.configs import two_tower_retrieval as tt
from repro_torch.core import convert
from repro_torch.data import synthetic
from repro_torch.kernels import embedding_bag as bag
from repro_torch.launch import serve as launch_serve
from repro_torch.models import embedding_service as es
from repro_torch.models import recsys as rec
from repro_torch.serve import serve_step

TOL = 1e-5                # fp32 forward, the same parameters in both
CFG, JCFG = tt.SMOKE, jtt.SMOKE
N_ITEMS = 600             # feature keys 1..600; item ids reach 999
SHARD_BYTES = 1 << 15     # several shards at N_ITEMS
FIELDS = list(launch_serve.FEATURE_FIELDS)


@pytest.fixture(scope="module")
def mi():
    return jcm.MeshInfo.from_mesh(mesh_mod.make_local_mesh())


@pytest.fixture(scope="module")
def jparams():
    params, _ = jcm.unbox(jrec.recsys_init(jax.random.key(0), JCFG))
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def model(jparams):
    return convert.two_tower_from_reference(jparams, CFG, "cpu")


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize("name", ["CONFIG", "SMOKE"])
def test_configs_are_copies(name):
    assert dataclasses.asdict(getattr(tt, name)) == \
        dataclasses.asdict(getattr(jtt, name))


def test_recsys_init_lays_out_the_reference_parameters(jparams):
    m = rec.recsys_init(CFG, seed=3, device="cpu")
    assert isinstance(m, rec.TwoTower)
    for k in ("user_table", "item_table", "cat_table"):
        assert tuple(getattr(m, k).shape) == jparams[k].shape
    for tower in ("user_mlp", "item_mlp"):
        assert [tuple(w.shape) for w in getattr(m, f"{tower}_w")] == \
            [layer["w"].shape for layer in jparams[tower]]
        assert [tuple(b.shape) for b in getattr(m, f"{tower}_b")] == \
            [layer["b"].shape for layer in jparams[tower]]
    assert m.param_bytes() == 4 * sum(
        np.size(x) for x in jax.tree.leaves(jparams))
    assert float(m.user_table.abs().max()) <= 2 * 0.05
    assert torch.equal(m.item_table, rec.recsys_init(
        CFG, seed=3, device="cpu").item_table)


def test_published_width_parameter_bytes():
    """CONFIG's parameters, counted from the shapes two_tower_init lays
    out: 30.8 GB, which one H100 holds whole."""
    c = tt.CONFIG
    d = c.embed_dim

    def mlp(dims):
        return sum(i * o + o for i, o in zip(dims[:-1], dims[1:]))

    user = mlp((2 * d + c.n_dense,) + c.tower_mlp)
    item = mlp((2 * d,) + c.tower_mlp)
    assert (user, item) == (1_189_632, 1_181_440)
    tables = (c.user_vocab + c.item_vocab + c.cat_vocab) * d
    assert 4 * (tables + user + item) == 30_831_884_288


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_embed_bag_matches_jax(mi, mode, weighted):
    rng = np.random.default_rng(4)
    table = (0.05 * rng.normal(size=(300, 16))).astype(np.float32)
    ids = rng.integers(-1, 300, (21, 9)).astype(np.int32)
    ids[3] = -1
    w = rng.random((21, 9)).astype(np.float32) if weighted else None
    got = es.embed_bag(torch.from_numpy(table), torch.from_numpy(ids),
                       None if w is None else torch.from_numpy(w), mode)
    want = jes.embed_bag(jnp.asarray(table), jnp.asarray(ids),
                         None if w is None else jnp.asarray(w), mode, mi)
    assert got.dtype == torch.float32 and got.shape == (21, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_user_vectors_match_jax(jparams, model, mi, seed):
    """recsys_score's two-tower answer is the JAX user tower's: unit-norm
    user vectors [B, tower_mlp[-1]], not probabilities."""
    batch = synthetic.recsys_batch(np.random.default_rng(seed), CFG, 96)
    got = rec.recsys_score(model, batch)
    want = jrec.recsys_score(jparams, JCFG, _jbatch(batch), mi)
    assert got.shape == (96, CFG.tower_mlp[-1]) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(got.norm(dim=-1).numpy(), 1.0, rtol=TOL,
                               atol=TOL)


def test_user_tower_padding_and_zero_vector(jparams, model, mi):
    """Fully padded histories (the bag gives zeros) and a zero MLP output,
    which the JAX tower divides by 1e-6 instead of its norm."""
    batch = synthetic.recsys_batch(np.random.default_rng(8), CFG, 40)
    batch["hist_items"][:5] = -1
    batch["hist_items"][5, :] = CFG.item_vocab - 1
    got = rec.recsys_score(model, batch)
    want = jrec.recsys_score(jparams, JCFG, _jbatch(batch), mi)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    zeroed = convert.two_tower_from_reference(
        dict(jparams, user_mlp=[dict(layer, w=np.zeros_like(layer["w"]))
                                for layer in jparams["user_mlp"]]),
        CFG, "cpu")
    assert torch.equal(rec.recsys_score(zeroed, batch),
                       torch.zeros(40, CFG.tower_mlp[-1]))


def _jax_engine(n_items):
    _, keys, feats, pop = launch_serve.feature_engine(n_items, SHARD_BYTES,
                                                      device="cpu")
    return jeng.MultiTableEngine(
        [jeng.ScalarTable("item_pop", keys, pop)],
        [jeng.EmbeddingTable("item_feats", keys,
                             feats.view(np.uint8).reshape(n_items, -1),
                             hot_fraction=0.25)],
        max_shard_bytes=SHARD_BYTES, version=1)


def test_score_fn_with_and_without_a_feature_engine_matches_jax(
        jparams, model, mi):
    """The same batches through the port's and the JAX package's
    recsys_score_fn: with no source, and behind a feature engine keyed by
    the batch's item_id (ids past N_ITEMS and id 0 miss), whose item_feats
    rows are spliced into the dense columns."""
    engine, *_ = launch_serve.feature_engine(N_ITEMS, SHARD_BYTES,
                                             device="cpu")
    jmesh = mesh_mod.make_local_mesh()
    steps = [(serve_step.recsys_score_fn(CFG, model),
              jserve.recsys_score_fn(JCFG, jmesh, mi)),
             (serve_step.recsys_score_fn(CFG, model, feature_engine=engine,
                                         feature_fields=FIELDS),
              jserve.recsys_score_fn(JCFG, jmesh, mi,
                                     feature_engine=_jax_engine(N_ITEMS),
                                     feature_fields=FIELDS))]
    for seed in range(3):
        batch = synthetic.recsys_batch(np.random.default_rng(20 + seed),
                                       CFG, 64)
        assert (batch["item_id"] > N_ITEMS).any()
        outs = []
        for step, jstep in steps:
            got = step(batch)
            want = jstep(jparams, batch)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=TOL, atol=TOL)
            outs.append(got)
        assert not torch.allclose(outs[0], outs[1])   # the splice mattered


def test_upload_is_one_copy_of_the_towers_columns(model, monkeypatch):
    """The step uploads exactly the user tower's columns, contiguous, in
    one buffer."""
    uploaded = []
    upload = serve_step._upload

    def record(batch, device):
        uploaded.append(upload(batch, device))
        return uploaded[-1]

    monkeypatch.setattr(serve_step, "_upload", record)
    batch = synthetic.recsys_batch(np.random.default_rng(1), CFG, 30)
    serve_step.recsys_score_fn(CFG, model)(batch)
    (up,) = uploaded
    assert list(up) == ["user_id", "hist_items", "dense"]
    assert len({t.untyped_storage().data_ptr() for t in up.values()}) == 1
    for k, t in up.items():
        assert t.is_contiguous()
        np.testing.assert_array_equal(t.numpy(), batch[k])
    assert up["hist_items"].dtype == torch.int32
    assert up["dense"].dtype == torch.float32


@pytest.mark.parametrize("key", ["user_table", "item_table", "cat_table",
                                 "user_mlp.0.w", "item_mlp.1.b",
                                 "missing_layer", "extra"])
def test_two_tower_from_reference_checks_every_shape(jparams, key):
    p = dict(jparams, user_mlp=[dict(x) for x in jparams["user_mlp"]],
             item_mlp=[dict(x) for x in jparams["item_mlp"]])
    if key == "missing_layer":
        p["item_mlp"] = p["item_mlp"][:-1]
    elif key == "extra":
        p["pos_table"] = np.zeros((3, 4), np.float32)
    elif "." in key:
        tower, i, wb = key.split(".")
        p[tower][int(i)][wb] = p[tower][int(i)][wb][..., :-1]
    else:
        p[key] = p[key][:-1]
    with pytest.raises(ValueError):
        convert.two_tower_from_reference(p, CFG, "cpu")


def test_two_tower_from_reference_rejects_another_config(jparams):
    with pytest.raises(ValueError):
        convert.two_tower_from_reference(jparams, tt.CONFIG, "cpu")
    with pytest.raises(ValueError, match="not two_tower"):
        convert.two_tower_from_reference(
            jparams, dataclasses.replace(CFG, arch="deepfm"), "cpu")


def test_launcher_scores_two_tower_on_the_cpu(capsys):
    before = bag.launches["embedding_bag"]
    out = launch_serve.main(["--arch", "two-tower-retrieval", "--smoke",
                             "--device", "cpu", "--requests", "2"])
    assert out["finite"] and out["requests"] == 2 and out["rows"] == 8
    assert out["arch"] == CFG.name
    assert out["p99_ms"] >= out["p50_ms"] > 0
    assert bag.launches["embedding_bag"] == before      # the plain version
    assert "two-tower-smoke/serve_p99: 2 requests of 8 rows on cpu" in \
        capsys.readouterr().out


def test_two_tower_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rec.recsys_init(CFG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_serve.main(["--arch", "two-tower-retrieval", "--smoke",
                           "--requests", "1"])
