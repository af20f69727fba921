"""The port's DeepFM serving slice against the JAX package, on the CPU:
configs and synthetic batches, ``hash_ids`` and ``embed_lookup``, DeepFM
scoring with the JAX parameters carried over, the scoring step behind a
``FeatureClient`` across a delta and a ``min_version`` read, the step
behind the ``QueryServer`` with 4 concurrent clients against the JAX step
behind the JAX server, and the launcher (its ``--feature-server`` mode
too).  The inputs are made with numpy from a seed and given to both
packages."""
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import Consistency as JConsistency
from repro.api import FeatureClient as JFeatureClient
from repro.configs import deepfm as jdeepfm
from repro.core import engine as jeng
from repro.data import synthetic as jsyn
from repro.launch import mesh as mesh_mod
from repro.models import common as jcm
from repro.models import embedding_service as jes
from repro.models import recsys as jrec
from repro.serve import serve_step as jserve
from repro.serve.scheduler import BatchPolicy as JBatchPolicy
from repro.serve.server import QueryServer as JQueryServer
from repro_torch import api
from repro_torch.configs import deepfm, registry
from repro_torch.core import convert
from repro_torch.data import synthetic
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import embedding_service as es
from repro_torch.models import recsys as rec
from repro_torch.serve import serve_step
from repro_torch.serve.scheduler import BatchPolicy
from repro_torch.serve.server import QueryServer

TOL = 1e-5                # fp32 forward, the same parameters in both
N_ITEMS = 2000
SHARD_BYTES = 1 << 15     # several shards at N_ITEMS
FIELDS = list(launch_serve.FEATURE_FIELDS)


@pytest.fixture(scope="module")
def mi():
    return jcm.MeshInfo.from_mesh(mesh_mod.make_local_mesh())


@pytest.fixture(scope="module")
def jparams():
    params, _ = jcm.unbox(jrec.recsys_init(jax.random.key(0), jdeepfm.SMOKE))
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def model(jparams):
    return convert.deepfm_from_reference(jparams, deepfm.SMOKE, "cpu")


# ---------------------------------------------------------------------------
# copies
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["CONFIG", "SMOKE"])
def test_configs_are_copies(name):
    assert dataclasses.asdict(getattr(deepfm, name)) == \
        dataclasses.asdict(getattr(jdeepfm, name))


@pytest.mark.parametrize("arch", ["deepfm", "din", "two_tower"])
def test_synthetic_batches_match(arch):
    kw = dict(name="t", arch=arch, embed_dim=4, seq_len=6,
              n_sparse_fields=5, field_vocab=50, item_vocab=300,
              cat_vocab=20, user_vocab=40)
    got = synthetic.recsys_batch(np.random.default_rng(5),
                                 rec.RecsysConfig(**kw), 33)
    want = jsyn.recsys_batch(np.random.default_rng(5),
                             jrec.RecsysConfig(**kw), 33)
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


# ---------------------------------------------------------------------------
# embedding service
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("vocab", [1, 97, 1 << 20, 2**31 - 1])
def test_hash_ids_bitwise(vocab):
    rng = np.random.default_rng(vocab)
    ids = np.concatenate([
        rng.integers(-5, 2**31 - 1, 2000, dtype=np.int64),
        [-1, 0, 1, 2**31 - 1, -(2**31)]]).astype(np.int32).reshape(5, -1)
    got = es.hash_ids(torch.from_numpy(ids), vocab)
    want = np.asarray(jes.hash_ids(jnp.asarray(ids), vocab))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_embed_lookup_bitwise(mi):
    """-1 gives zeros, an id past the table NaN (jnp.take's fill mode),
    everything else the row; NaN rows count as equal."""
    rng = np.random.default_rng(11)
    vocab = 50
    table = rng.normal(size=(vocab, 6)).astype(np.float32)
    ids = rng.integers(-1, vocab + 8, (40, 7)).astype(np.int32)
    ids[0, :3] = [-1, vocab, vocab - 1]
    got = es.embed_lookup(torch.from_numpy(table), torch.from_numpy(ids))
    want = np.asarray(jes.embed_lookup(jnp.asarray(table), jnp.asarray(ids),
                                       mi))
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.isnan(got.numpy()[ids >= vocab]).all()
    assert (got.numpy()[ids < 0] == 0).all()


def test_table_init_is_seeded_and_cut_at_two_sigma():
    def draw(seed):
        g = torch.Generator().manual_seed(seed)
        return es.table_init(es.TableCfg("t", 5000, 8), generator=g,
                             device="cpu")

    a = draw(0)
    assert a.shape == (5000, 8) and a.dtype == torch.float32
    assert float(a.abs().max()) <= 2 * 0.05
    assert 0.03 < float(a.std()) < 0.05     # 0.05 * std of N(0,1) cut at 2
    assert torch.equal(a, draw(0)) and not torch.equal(a, draw(1))


# ---------------------------------------------------------------------------
# DeepFM
# ---------------------------------------------------------------------------
def test_recsys_init_lays_out_the_reference_parameters(jparams):
    m = rec.recsys_init(deepfm.SMOKE, seed=3, device="cpu")
    assert tuple(m.field_table.shape) == jparams["field_table"].shape
    assert tuple(m.w1_table.shape) == jparams["w1_table"].shape
    assert tuple(m.dense_w1.shape) == jparams["dense_w1"].shape
    assert tuple(m.bias.shape) == jparams["bias"].shape
    assert [tuple(w.shape) for w in m.mlp_w] == \
        [layer["w"].shape for layer in jparams["mlp"]]
    assert [tuple(b.shape) for b in m.mlp_b] == \
        [layer["b"].shape for layer in jparams["mlp"]]
    assert m.param_bytes() == 4 * sum(
        np.size(x) for x in jax.tree.leaves(jparams))


@pytest.mark.parametrize("seed", [0, 1])
def test_deepfm_scores_match_jax(jparams, model, mi, seed):
    batch = synthetic.recsys_batch(np.random.default_rng(seed),
                                   deepfm.SMOKE, 96)
    got = rec.recsys_score(model, batch)
    want = jrec.recsys_score(jparams, jdeepfm.SMOKE,
                             {k: jnp.asarray(v) for k, v in batch.items()},
                             mi)
    assert got.shape == (96,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_deepfm_logits_match_jax(jparams, model, mi):
    """The logits too: the sigmoid flattens differences far from 0."""
    batch = synthetic.recsys_batch(np.random.default_rng(9), deepfm.SMOKE,
                                   64)
    with torch.inference_mode():
        got = model(torch.from_numpy(batch["sparse_ids"]),
                    torch.from_numpy(batch["dense"]))
    want = jrec.deepfm_forward(jparams, jdeepfm.SMOKE, batch, mi)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def _corrupt(params, key):
    p = dict(params, mlp=[dict(layer) for layer in params["mlp"]])
    if key == "missing_layer":
        p["mlp"] = p["mlp"][:-1]
    elif key.startswith("mlp"):
        p["mlp"][0]["w"] = p["mlp"][0]["w"][:, :-1]
    else:
        p[key] = np.zeros((1,) + np.shape(p[key]), np.float32)
    return p


@pytest.mark.parametrize("key", ["field_table", "w1_table", "dense_w1",
                                 "bias", "mlp.0.w", "missing_layer"])
def test_deepfm_from_reference_checks_every_shape(jparams, key):
    with pytest.raises(ValueError):
        convert.deepfm_from_reference(_corrupt(jparams, key), deepfm.SMOKE,
                                      "cpu")


def test_deepfm_from_reference_rejects_another_config(jparams):
    with pytest.raises(ValueError):
        convert.deepfm_from_reference(jparams, deepfm.CONFIG, "cpu")
    with pytest.raises(ValueError, match="not deepfm"):
        convert.deepfm_from_reference(
            jparams, dataclasses.replace(deepfm.SMOKE, arch="din"), "cpu")


@pytest.mark.parametrize("arch", ["din", "bst"])
def test_din_and_bst_rank_through_bulk_rank(arch):
    """DIN's and BST's retrieval_cand: the bulk-ranking step and the
    model's bulk_rank rank their candidate rows (the launcher's cell is
    held in test_torch_bulk_rank.py), and the step still refuses an arch
    the port lacks."""
    cfg = registry.ARCHS[arch].SMOKE
    model = rec.recsys_init(cfg, device="cpu")
    batch = synthetic.recsys_batch(np.random.default_rng(0), cfg, 30)
    values, indices = serve_step.bulk_rank_fn(cfg, model, top_k=5,
                                              chunk_rows=7)(batch)
    assert values.shape == indices.shape == (5,)
    want = rec.bulk_rank(model, batch, 5)
    torch.testing.assert_close(values, want[0], rtol=0, atol=1e-6)
    with torch.inference_mode():
        logits = model(*rec._columns(model, batch))
    torch.testing.assert_close(values, logits[indices], rtol=0, atol=1e-6)
    with pytest.raises(NotImplementedError, match="not ported.*ROADMAP"):
        serve_step.bulk_rank_fn(dataclasses.replace(cfg, arch="gcn"), model)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rec.recsys_init(deepfm.SMOKE)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_serve.main(["--arch", "deepfm", "--smoke", "--requests", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_serve.main(["--arch", "deepfm", "--smoke", "--feature-server",
                           "--requests", "1"])


# ---------------------------------------------------------------------------
# the scoring step behind a FeatureClient
# ---------------------------------------------------------------------------
def _feature_data(n_items, seed=0):
    rng = np.random.default_rng(seed)
    keys = np.arange(1, n_items + 1, dtype=np.uint64)
    feats = rng.normal(size=(n_items, 8)).astype(np.float32)
    pop = rng.integers(0, 1 << 20, n_items).astype(np.uint64)
    return keys, feats, pop


def _jax_engine(n_items):
    keys, feats, pop = _feature_data(n_items)
    return jeng.MultiTableEngine(
        [jeng.ScalarTable("item_pop", keys, pop)],
        [jeng.EmbeddingTable("item_feats", keys,
                             feats.view(np.uint8).reshape(n_items, -1),
                             hot_fraction=0.25)],
        max_shard_bytes=SHARD_BYTES, version=1)


def _request(seed, absent=0.1):
    rng = np.random.default_rng(seed)
    batch = launch_serve.request_batch(rng, deepfm.SMOKE, 80, N_ITEMS)
    miss = rng.random(80) < absent
    batch["item_id"][miss] += N_ITEMS        # keys the tables do not hold
    return batch


def test_launcher_engine_holds_the_reference_data():
    engine, keys, feats, pop = launch_serve.feature_engine(
        N_ITEMS, SHARD_BYTES, device="cpu")
    k, f, p = _feature_data(N_ITEMS)
    np.testing.assert_array_equal(keys, k)
    np.testing.assert_array_equal(feats, f)
    np.testing.assert_array_equal(pop, p)
    res = engine.query({"item_pop": keys, "item_feats": keys})
    assert res["item_pop"].found.all()
    np.testing.assert_array_equal(res["item_pop"].payloads, pop)
    np.testing.assert_array_equal(
        res["item_feats"].values.view(np.float32).reshape(-1, 8), feats)


def test_score_fn_matches_jax_across_a_delta(jparams, model, mi,
                                             monkeypatch):
    engine, keys, feats, pop = launch_serve.feature_engine(
        N_ITEMS, SHARD_BYTES, device="cpu")
    jengine = _jax_engine(N_ITEMS)
    client = api.FeatureClient(api.EngineBackend(engine))
    jclient = JFeatureClient(jengine)
    step = serve_step.recsys_score_fn(deepfm.SMOKE, model,
                                      feature_client=client,
                                      feature_fields=FIELDS)
    jmesh = mesh_mod.make_local_mesh()
    jstep = jserve.recsys_score_fn(jdeepfm.SMOKE, jmesh, mi,
                                   feature_client=jclient,
                                   feature_fields=FIELDS)
    uploaded = []
    upload = serve_step._upload
    monkeypatch.setattr(serve_step, "_upload",
                        lambda b, d: uploaded.append(b) or upload(b, d))

    def check(step, jstep, batch, pop):
        got = step(batch)
        want = jstep(jparams, batch)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL)
        # the spliced columns: the rows as written, times found
        ids = batch["item_id"]
        found = ids <= N_ITEMS
        i = np.where(found, ids - 1, 0)
        dense = uploaded[-1]["dense"]
        np.testing.assert_array_equal(dense[:, :8],
                                      feats[i] * found[:, None])
        np.testing.assert_array_equal(
            dense[:, 8], pop[i].astype(np.float32) * found)
        np.testing.assert_array_equal(dense[:, 9:], batch["dense"][:, 9:])

    for seed in range(2):
        check(step, jstep, _request(seed), pop)
    upd = keys[np.random.default_rng(7).choice(N_ITEMS, 16, replace=False)]
    new_pop = np.arange(16, dtype=np.uint64) + 7
    client.update(2, upserts={"item_pop": (upd, new_pop)})
    jclient.update(2, upserts={"item_pop": (upd, new_pop)})
    pop2 = pop.copy()
    pop2[(upd - 1).astype(np.int64)] = new_pop
    v2 = api.Consistency.min_version(2)
    step2 = serve_step.recsys_score_fn(
        deepfm.SMOKE, model, feature_fields=FIELDS,
        feature_client=api.FeatureClient(api.EngineBackend(engine),
                                         default_consistency=v2))
    jstep2 = jserve.recsys_score_fn(
        jdeepfm.SMOKE, jmesh, mi, feature_fields=FIELDS,
        feature_client=JFeatureClient(
            jengine, default_consistency=JConsistency.min_version(2)))
    batch = _request(2, absent=0.0)
    batch["item_id"][:16] = upd.astype(np.int64)
    check(step2, jstep2, batch, pop2)
    np.testing.assert_array_equal(uploaded[-1]["dense"][:16, 8],
                                  new_pop.astype(np.float32))


def test_score_fn_behind_the_server_matches_jax(jparams, model, mi,
                                                monkeypatch):
    """DeepFM SMOKE's step behind the port's QueryServer against the JAX
    step behind the JAX QueryServer, on the same requests from 4 clients at
    once: before an item_pop delta, then through a min_version(2) session
    after it.  Probabilities within TOL; every request's spliced columns
    the rows as written at its version, times found."""
    engine, keys, feats, pop = launch_serve.feature_engine(
        N_ITEMS, SHARD_BYTES, device="cpu")
    jengine = _jax_engine(N_ITEMS)
    server = QueryServer(engine, BatchPolicy(max_batch_keys=4096))
    jserver = JQueryServer(jengine, JBatchPolicy(max_batch_keys=4096))
    jmesh = mesh_mod.make_local_mesh()
    uploaded = {}                       # client thread -> its last batch
    upload = serve_step._upload

    def record(b, d):
        uploaded[threading.get_ident()] = b
        return upload(b, d)
    monkeypatch.setattr(serve_step, "_upload", record)

    def clients(step, jstep, seeds, pop, upd=None):
        errors = []

        def client(c):
            try:
                for seed in seeds[c::4]:
                    batch = _request(seed)
                    if upd is not None:
                        batch["item_id"][:len(upd)] = upd.astype(np.int64)
                    got = step(batch)
                    dense = uploaded[threading.get_ident()]["dense"]
                    want = jstep(jparams, batch)
                    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                               rtol=TOL, atol=TOL)
                    ids = batch["item_id"]
                    found = ids <= N_ITEMS
                    i = np.where(found, ids - 1, 0)
                    np.testing.assert_array_equal(
                        dense[:, :8], feats[i] * found[:, None])
                    np.testing.assert_array_equal(
                        dense[:, 8], pop[i].astype(np.float32) * found)
            except Exception as e:  # noqa: BLE001 — surfaced below
                errors.append(e)

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors[:3]

    try:
        step = serve_step.recsys_score_fn(
            deepfm.SMOKE, model, feature_server=server,
            feature_fields=FIELDS)
        jstep = jserve.recsys_score_fn(
            jdeepfm.SMOKE, jmesh, mi, feature_server=jserver,
            feature_fields=FIELDS)
        clients(step, jstep, list(range(8)), pop)
        assert server.stats_snapshot().completed == 8
        upd = keys[np.random.default_rng(7).choice(N_ITEMS, 16,
                                                   replace=False)]
        new_pop = np.arange(16, dtype=np.uint64) + 7
        api.FeatureClient(server).update(2, upserts={"item_pop": (upd,
                                                                   new_pop)})
        JFeatureClient(jserver).update(2, upserts={"item_pop": (upd,
                                                                 new_pop)})
        pop2 = pop.copy()
        pop2[(upd - 1).astype(np.int64)] = new_pop
        step2 = serve_step.recsys_score_fn(
            deepfm.SMOKE, model, feature_fields=FIELDS,
            feature_client=api.FeatureClient(
                server, default_consistency=api.Consistency.min_version(2)))
        jstep2 = jserve.recsys_score_fn(
            jdeepfm.SMOKE, jmesh, mi, feature_fields=FIELDS,
            feature_client=JFeatureClient(
                jserver, default_consistency=JConsistency.min_version(2)))
        clients(step2, jstep2, list(range(8, 16)), pop2, upd)
        assert engine.stats.versions_served == {1, 2}
    finally:
        server.close()
        jserver.close()


def test_score_fn_over_an_engine_and_without_a_source(model):
    engine, *_ = launch_serve.feature_engine(200, SHARD_BYTES, device="cpu")
    batch = _request(4)
    batch["item_id"] %= 200
    via_engine = serve_step.recsys_score_fn(
        deepfm.SMOKE, model, feature_engine=engine, feature_fields=FIELDS)
    via_client = serve_step.recsys_score_fn(
        deepfm.SMOKE, model, feature_fields=FIELDS,
        feature_client=api.FeatureClient(api.EngineBackend(engine)))
    assert torch.equal(via_engine(batch), via_client(batch))
    plain = serve_step.recsys_score_fn(deepfm.SMOKE, model)
    assert torch.equal(plain(batch), rec.recsys_score(model, batch))


@pytest.mark.parametrize("case", ["two_sources", "no_fields", "duplicate",
                                  "server", "field_shape"])
def test_score_fn_validation(model, case):
    engine, *_ = launch_serve.feature_engine(50, SHARD_BYTES, device="cpu")
    client = api.FeatureClient(api.EngineBackend(engine))
    kw = dict(feature_client=client, feature_fields=FIELDS)
    if case == "two_sources":
        kw["feature_engine"] = engine
    elif case == "no_fields":
        kw["feature_fields"] = []
    elif case == "duplicate":
        kw["feature_fields"] = [("item_pop", "item_id")] * 2
    elif case == "server":
        # a server beside a client is two sources; alone it is served
        # (test_score_fn_behind_the_server_matches_jax)
        with QueryServer(engine, start=False) as server:
            with pytest.raises(ValueError, match="feature_server"):
                serve_step.recsys_score_fn(deepfm.SMOKE, model,
                                           feature_server=server, **kw)
            with pytest.raises(ValueError, match="feature_fields"):
                serve_step.recsys_score_fn(deepfm.SMOKE, model,
                                           feature_server=server)
        return
    if case != "field_shape":
        with pytest.raises(ValueError):
            serve_step.recsys_score_fn(deepfm.SMOKE, model, **kw)
        return
    step = serve_step.recsys_score_fn(deepfm.SMOKE, model, **kw)
    batch = _request(1)
    batch["item_id"] = batch["item_id"][:-1]
    with pytest.raises(ValueError, match="1-D of length 80"):
        step(batch)


def test_upload_is_one_copy_of_both_columns():
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 1000, (9, 5)).astype(np.int64)
    dense = rng.normal(size=(9, 13)).astype(np.float32)
    up = serve_step._upload({"sparse_ids": ids, "dense": dense},
                            torch.device("cpu"))
    assert up["sparse_ids"].dtype == torch.int32
    assert up["dense"].dtype == torch.float32
    assert up["dense"].untyped_storage().data_ptr() == \
        up["sparse_ids"].untyped_storage().data_ptr()
    np.testing.assert_array_equal(up["sparse_ids"].numpy(), ids)
    np.testing.assert_array_equal(up["dense"].numpy(), dense)
    ids[0, 0] = 2**40
    with pytest.raises(ValueError, match="int32"):
        serve_step._upload({"sparse_ids": ids, "dense": dense},
                           torch.device("cpu"))


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------
def test_launcher_scores_on_the_cpu(capsys):
    out = launch_serve.main(["--arch", "deepfm", "--smoke", "--device", "cpu",
                             "--requests", "2"])
    assert out["finite"] and out["requests"] == 2 and out["rows"] == 8
    assert out["p99_ms"] >= out["p50_ms"] > 0
    assert "deepfm-smoke/serve_p99: 2 requests of 8 rows on cpu" in \
        capsys.readouterr().out


def test_launcher_feature_server_on_the_cpu(capsys):
    """--feature-server in process: 4 scoring clients and one PREFETCH
    client behind the QueryServer, a delta while they run."""
    out = launch_serve.main(["--arch", "deepfm", "--smoke", "--feature-server",
                             "--clients", "4", "--prefetch-clients", "1",
                             "--device", "cpu", "--requests", "3"])
    assert out["finite"] and out["scored"] + out["shed"] == 12
    assert out["rows"] == 8 and out["p99_ms"] >= out["p50_ms"] > 0
    snap = out["server"]
    assert snap.per_class["RANKING"].submitted == 12
    assert snap.per_class["RANKING"].completed == out["scored"]
    assert snap.per_class["PREFETCH"].submitted >= 1
    assert snap.failed == 0
    assert 1 in out["versions_served"]
    assert set(out["versions_served"]) <= {1, 2}
    printed = capsys.readouterr().out
    assert "deepfm-smoke/serve_p99/feature-server: 4 clients x 3 requests " \
        "of 8 rows on cpu" in printed
    assert f"server: {snap.summary()}" in printed


@pytest.mark.parametrize("arch", ["din", "two-tower-retrieval"])
def test_launcher_feature_server_needs_sparse_ids(arch):
    with pytest.raises(SystemExit, match="sparse_ids"):
        launch_serve.main(["--arch", arch, "--smoke", "--feature-server",
                           "--device", "cpu"])


@pytest.mark.parametrize("arch", ["qwen3_14b", "deepseek-7b"])
def test_launcher_refuses_unported_archs(arch):
    """An arch the port does not know (``qwen3_14b`` is not the registry's
    ``qwen3-14b``) exits naming ROADMAP before any model is built, also for
    the retrieval_cand cell the recsys archs all serve.  The LM archs this
    test once held as refused now serve their smoke prefill and decode
    and train (the serve launcher's train_4k, a step a request, and the
    train launcher); what still refuses is an LM cell that is no train
    cell in the train launcher.  (The LM slices' own tests:
    ``tests/test_torch_lm.py``, ``tests/test_torch_lm_train.py``.)"""
    lm_arch = arch.replace("_", "-")
    if arch != lm_arch:
        with pytest.raises(SystemExit, match=f"{arch} is not ported.*ROADMAP"):
            launch_serve.main(["--arch", arch, "--shape", "retrieval_cand",
                               "--device", "cpu"])
    assert registry.family(lm_arch) == "lm"
    for shape in ("decode_32k", "prefill_32k"):
        out = launch_serve.main(["--arch", lm_arch, "--shape", shape,
                                 "--smoke", "--device", "cpu",
                                 "--requests", "1"])
        assert out["finite"] and out["shape"] == shape
    out = launch_serve.main(["--arch", lm_arch, "--shape", "train_4k",
                             "--smoke", "--device", "cpu", "--requests",
                             "1"])
    assert out["finite"] and out["shape"] == "train_4k"
    out = launch_train.main(["--arch", lm_arch, "--smoke", "--device", "cpu",
                             "--steps", "1"])
    assert np.isfinite(out["losses"]).all() and out["step"] == 1
    with pytest.raises(SystemExit, match="decode_32k is not a train cell; "
                       "serve it with python -m repro_torch.launch.serve"):
        launch_train.main(["--arch", lm_arch, "--shape", "decode_32k",
                           "--smoke", "--device", "cpu"])
