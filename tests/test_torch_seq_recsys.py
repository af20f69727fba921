"""The port's DIN and BST serving slice against the JAX package, on the CPU:
the config copies, ``layer_norm``, BST's transformer block, DIN's attention
weights, both models' probabilities and logits with the JAX parameters
carried over by ``din_from_reference`` / ``bst_from_reference`` (at SMOKE
and at a narrower config), padding and out-of-table ids, the scoring step,
the converters' checks and the launcher.  The inputs are made with numpy
from a seed and given to both packages."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import bst as jbst
from repro.configs import din as jdin
from repro.launch import mesh as mesh_mod
from repro.models import common as jcm
from repro.models import embedding_service as jes
from repro.models import recsys as jrec
from repro.serve import serve_step as jserve
from repro_torch.configs import bst, din
from repro_torch.core import convert
from repro_torch.data import synthetic
from repro_torch.launch import serve as launch_serve
from repro_torch.models import common as cm
from repro_torch.models import recsys as rec
from repro_torch.serve import serve_step

TOL = 1e-5                # fp32 forward, the same parameters in both
# a second, narrower config of each arch: short histories, one attention
# layer (DIN), two heads and two blocks (BST)
NARROW = {
    "din": dict(name="din-narrow", arch="din", embed_dim=4, seq_len=3,
                item_vocab=60, cat_vocab=7, n_dense=3, attn_mlp=(8,),
                mlp=(8,)),
    "bst": dict(name="bst-narrow", arch="bst", embed_dim=8, seq_len=3,
                item_vocab=60, cat_vocab=7, n_dense=3, n_blocks=2,
                n_heads=2, mlp=(8,)),
}
PORT = {"din": din, "bst": bst}
JAX = {"din": jdin, "bst": jbst}
FROM_REFERENCE = {"din": convert.din_from_reference,
                  "bst": convert.bst_from_reference}
CASES = [("din", "smoke"), ("din", "narrow"), ("bst", "smoke"),
         ("bst", "narrow")]


def _configs(arch, size):
    """(port config, JAX config) of ``arch`` at ``size``."""
    if size == "smoke":
        return PORT[arch].SMOKE, JAX[arch].SMOKE
    return (rec.RecsysConfig(**NARROW[arch]),
            jrec.RecsysConfig(**NARROW[arch]))


@pytest.fixture(scope="module")
def mi():
    return jcm.MeshInfo.from_mesh(mesh_mod.make_local_mesh())


_CACHE = {}


def _pair(arch, size):
    """(cfg, jcfg, JAX parameters with numpy leaves, the port's model with
    them carried over), built once per module."""
    if (arch, size) not in _CACHE:
        cfg, jcfg = _configs(arch, size)
        params, _ = jcm.unbox(jrec.recsys_init(jax.random.key(0), jcfg))
        params = jax.tree.map(np.asarray, params)
        _CACHE[arch, size] = (cfg, jcfg, params,
                              FROM_REFERENCE[arch](params, cfg, "cpu"))
    return _CACHE[arch, size]


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _both(arch, size, batch, mi):
    """The port's and the JAX package's probabilities of ``batch``."""
    cfg, jcfg, params, model = _pair(arch, size)
    got = rec.recsys_score(model, batch)
    want = np.asarray(jrec.recsys_score(params, jcfg, _jbatch(batch), mi))
    return got, want


# ---------------------------------------------------------------------------
# copies and layout
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["CONFIG", "SMOKE"])
@pytest.mark.parametrize("arch", ["din", "bst"])
def test_configs_are_copies(arch, name):
    assert dataclasses.asdict(getattr(PORT[arch], name)) == \
        dataclasses.asdict(getattr(JAX[arch], name))


@pytest.mark.parametrize("arch,size", CASES)
def test_recsys_init_lays_out_the_reference_parameters(arch, size):
    cfg, _, params, _ = _pair(arch, size)
    m = rec.recsys_init(cfg, seed=3, device="cpu")
    assert type(m) is {"din": rec.DIN, "bst": rec.BST}[arch]
    got = {k: tuple(v.shape) for k, v in m.named_parameters()}
    want = {}
    for k, v in params.items():
        if isinstance(v, list):
            for i, layer in enumerate(v):
                for name, leaf in layer.items():
                    want[(k, i, name)] = leaf.shape
        else:
            want[k] = v.shape
    # the port names an MLP's layers {name}_w.{i} / {name}_b.{i}, a block's
    # weights blocks.{i}.{name}
    flat = {}
    for (k, i, name), shape in ((k, s) for k, s in want.items()
                                if isinstance(k, tuple)):
        key = (f"blocks.{i}.{name}" if k == "blocks"
               else f"{k}_{name}.{i}")
        flat[key] = shape
    flat.update({k: s for k, s in want.items() if not isinstance(k, tuple)})
    assert got == flat
    assert m.param_bytes() == 4 * sum(
        np.size(x) for x in jax.tree.leaves(params))
    assert float(m.item_table.abs().max()) <= 2 * 0.05
    assert torch.equal(m.item_table, rec.recsys_init(
        cfg, seed=3, device="cpu").item_table)


def test_published_width_parameter_bytes():
    """CONFIG's parameters, counted from the shapes the two inits lay out:
    DIN 7.2 GB and BST 12.8 GB, mostly the 100M-row item tables."""
    def mlp(dims):
        return sum(i * o + o for i, o in zip(dims[:-1], dims[1:]))

    c = din.CONFIG
    d = c.embed_dim
    din_params = (c.item_vocab + c.cat_vocab) * d \
        + mlp((8 * d,) + c.attn_mlp + (1,)) \
        + mlp((4 * d + c.n_dense,) + c.mlp + (1,))
    assert 4 * din_params == 7_207_388_968
    c = bst.CONFIG
    d, s = c.embed_dim, c.seq_len + 1
    bst_params = c.item_vocab * d + s * d \
        + c.n_blocks * (4 * d * d + 8 * d * d + 4 * d) \
        + mlp((s * d + c.n_dense,) + c.mlp + (1,))
    assert 4 * bst_params == 12_805_467_268


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(5, 8), (3, 7, 32), (2, 1)])
def test_layer_norm_matches_jax(shape):
    rng = np.random.default_rng(len(shape))
    x = rng.normal(3.0, 2.0, size=shape).astype(np.float32)
    x[0] = 1.5                                  # a constant row: var 0
    g = rng.normal(size=shape[-1]).astype(np.float32)
    b = rng.normal(size=shape[-1]).astype(np.float32)
    got = cm.layer_norm(torch.from_numpy(x), torch.from_numpy(g),
                        torch.from_numpy(b))
    want = jcm.layer_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_layer_norm_keeps_a_bfloat16_input_bfloat16():
    """Computed in fp32 and cast back, as the JAX package does: the same
    bfloat16 values out of the same bfloat16 inputs."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 16)).astype(np.float32)
    g = rng.normal(size=16).astype(np.float32)
    xb = torch.from_numpy(x).bfloat16()
    got = cm.layer_norm(xb, torch.from_numpy(g), torch.zeros(16))
    want = jcm.layer_norm(jnp.asarray(xb.float().numpy(), jnp.bfloat16),
                          jnp.asarray(g), jnp.zeros(16))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("n_heads", [1, 2, 4])
def test_bst_block_matches_jax(n_heads):
    """Random weights and inputs, with rows that mask some keys, one key,
    and none (every score -1e30: an even spread in both)."""
    rng = np.random.default_rng(n_heads)
    b, s, d = 6, 5, 8
    p = {k: rng.normal(size=shape).astype(np.float32) * 0.3
         for k, shape in [("wq", (d, d)), ("wk", (d, d)), ("wv", (d, d)),
                          ("wo", (d, d)), ("ln1_g", (d,)), ("ln1_b", (d,)),
                          ("ffn1", (d, 4 * d)), ("ffn2", (4 * d, d)),
                          ("ln2_g", (d,)), ("ln2_b", (d,))]}
    assert sorted(p) == sorted(rec.BST_BLOCK)
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    mask = rng.random((b, s)) < 0.6
    mask[0], mask[1], mask[2] = True, False, False
    mask[2, 3] = True
    got = rec._bst_block({k: torch.from_numpy(v) for k, v in p.items()},
                         torch.from_numpy(x), n_heads, torch.from_numpy(mask))
    want = jrec._bst_block({k: jnp.asarray(v) for k, v in p.items()},
                           jnp.asarray(x), n_heads, jnp.asarray(mask))
    assert got.shape == (b, s, d) and bool(got.isfinite().all())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("size", ["smoke", "narrow"])
def test_din_attention_weights_match_jax(mi, size):
    """The unnormalised weights a step, before the head, against the JAX
    package's own steps of ``din_forward``; padded steps weigh 0."""
    cfg, jcfg, params, model = _pair("din", size)
    batch = synthetic.recsys_batch(np.random.default_rng(7), cfg, 50)
    cols = [torch.from_numpy(batch[k]) for k in model.inputs[:4]]
    with torch.inference_mode():
        got, hist, target = model.attention(*cols)
    it, ct = jnp.asarray(params["item_table"]), jnp.asarray(
        params["cat_table"])
    jhist = jnp.concatenate([jes.embed_lookup(it, batch["hist_items"], mi),
                             jes.embed_lookup(ct, batch["hist_cats"], mi)],
                            axis=-1)
    jtarget = jnp.concatenate(
        [jes.embed_lookup(it, batch["target_item"], mi),
         jes.embed_lookup(ct, batch["target_cat"], mi)], axis=-1)
    tgt = jnp.broadcast_to(jtarget[:, None], jhist.shape)
    feat = jnp.concatenate([jhist, tgt, jhist - tgt, jhist * tgt], axis=-1)
    score = jrec._mlp_apply(params["attn_mlp"], feat,
                            act=jax.nn.sigmoid)[..., 0]
    want = np.asarray(score * (batch["hist_items"] >= 0))
    assert got.shape == (50, cfg.seq_len)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(hist.numpy(), np.asarray(jhist))
    np.testing.assert_array_equal(target.numpy(), np.asarray(jtarget))
    assert (got.numpy()[batch["hist_items"] < 0] == 0).all()
    assert (got.numpy()[batch["hist_items"] >= 0] != 0).any()


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("arch,size", CASES)
def test_scores_match_jax(mi, arch, size, seed):
    cfg = _pair(arch, size)[0]
    batch = synthetic.recsys_batch(np.random.default_rng(seed), cfg, 96)
    got, want = _both(arch, size, batch, mi)
    assert got.shape == (96,) and got.dtype == torch.float32
    assert ((got > 0) & (got < 1)).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch,size", CASES)
def test_logits_match_jax(mi, arch, size):
    """The logits too: the sigmoid flattens differences far from 0."""
    cfg, jcfg, params, model = _pair(arch, size)
    batch = synthetic.recsys_batch(np.random.default_rng(9), cfg, 64)
    with torch.inference_mode():
        got = model(*[torch.from_numpy(batch[k]) for k in model.inputs])
    forward = {"din": jrec.din_forward, "bst": jrec.bst_forward}[arch]
    want = forward(params, jcfg, _jbatch(batch), mi)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def _edge_batch(cfg, seed):
    """A batch whose rows 0-5 are edge cases: 0 all padding (DIN pools
    nothing), 1 one valid step, 2 every id 0, 3 every id the table's last,
    4 a history id past the table, 5 a target id past the table."""
    batch = synthetic.recsys_batch(np.random.default_rng(seed), cfg, 24)
    for col in ("hist_items", "hist_cats"):
        batch[col][0] = -1
        batch[col][1, 1:] = -1
    for col, vocab in (("item", cfg.item_vocab), ("cat", cfg.cat_vocab)):
        batch[f"hist_{col}s"][2] = 0
        batch[f"target_{col}"][2] = 0
        batch[f"hist_{col}s"][3] = vocab - 1
        batch[f"target_{col}"][3] = vocab - 1
    batch["hist_items"][4, 0] = cfg.item_vocab + 5
    batch["target_item"][5] = cfg.item_vocab
    return batch


@pytest.mark.parametrize("arch,size", CASES)
def test_padding_edge_ids_and_past_the_table(mi, arch, size):
    cfg, _, _, model = _pair(arch, size)
    batch = _edge_batch(cfg, 3)
    got, want = _both(arch, size, batch, mi)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    nan = np.isnan(got.numpy())
    # an id past the table reads a NaN row in both packages
    assert nan[[4, 5]].all() and np.isnan(want[[4, 5]]).all()
    assert not nan[:4].any() and not nan[6:].any()
    if arch == "din":
        with torch.inference_mode():
            w, _, _ = model.attention(*[torch.from_numpy(batch[k])
                                        for k in model.inputs[:4]])
        assert torch.equal(w[0], torch.zeros(cfg.seq_len))   # pooled = 0
        assert (w[1, 1:] == 0).all() and w[1, 0] != 0


def test_bst_padded_steps_reach_the_head(mi):
    """A padded step is not zeroed in BST: its position row goes through
    the block into the head, so two batches that differ only in a padded
    step's position table row score differently, in both packages."""
    cfg, jcfg, params, _ = _pair("bst", "smoke")
    batch = _edge_batch(cfg, 4)
    moved = dict(params, pos_table=params["pos_table"].copy())
    moved["pos_table"][cfg.seq_len - 1] += 0.5    # row 1's last step: padding
    model = convert.bst_from_reference(moved, cfg, "cpu")
    got = rec.recsys_score(model, batch)
    want = np.asarray(jrec.recsys_score(moved, jcfg, _jbatch(batch), mi))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    before, _ = _both("bst", "smoke", batch, mi)
    assert not torch.allclose(got[1], before[1], rtol=0, atol=1e-7)


# ---------------------------------------------------------------------------
# the scoring step, the converters and the launcher
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["din", "bst"])
def test_score_fn_matches_jax(mi, arch, monkeypatch):
    """The port's and the JAX package's recsys_score_fn (no feature source)
    on the same batches; the port uploads exactly the model's columns, in
    one buffer."""
    cfg, jcfg, params, model = _pair(arch, "smoke")
    uploaded = []
    upload = serve_step._upload
    monkeypatch.setattr(serve_step, "_upload",
                        lambda b, d: uploaded.append(upload(b, d))
                        or uploaded[-1])
    step = serve_step.recsys_score_fn(cfg, model)
    jstep = jserve.recsys_score_fn(jcfg, mesh_mod.make_local_mesh(), mi)
    for seed in range(2):
        batch = synthetic.recsys_batch(np.random.default_rng(30 + seed), cfg,
                                       40)
        got = step(batch)
        want = jstep(params, _jbatch(batch))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL)
        up = uploaded[-1]
        assert tuple(up) == model.inputs
        assert len({t.untyped_storage().data_ptr() for t in up.values()}) == 1


def _corrupt(params, key):
    p = {k: ([dict(x) for x in v] if isinstance(v, list) else v)
         for k, v in params.items()}
    if key == "missing_layer":
        p["mlp"] = p["mlp"][:-1]
    elif key == "missing_name":
        first = next(k for k in p if not isinstance(p[k], list))
        del p[first]
    elif key == "extra":
        p["user_table"] = np.zeros((3, 4), np.float32)
    elif "." in key:
        group, i, name = key.split(".")
        p[group][int(i)][name] = p[group][int(i)][name][..., :-1]
    else:
        p[key] = p[key][:-1]
    return p


@pytest.mark.parametrize("arch,key", [
    ("din", "item_table"), ("din", "cat_table"), ("din", "attn_mlp.0.w"),
    ("din", "attn_mlp.2.b"), ("din", "mlp.1.w"), ("din", "missing_layer"),
    ("din", "missing_name"), ("din", "extra"),
    ("bst", "item_table"), ("bst", "pos_table"), ("bst", "blocks.0.wq"),
    ("bst", "blocks.0.ffn1"), ("bst", "blocks.0.ln2_b"), ("bst", "mlp.0.b"),
    ("bst", "missing_layer"), ("bst", "missing_name"), ("bst", "extra")])
def test_from_reference_checks_every_name_and_shape(arch, key):
    cfg, _, params, _ = _pair(arch, "smoke")
    with pytest.raises(ValueError):
        FROM_REFERENCE[arch](_corrupt(params, key), cfg, "cpu")


@pytest.mark.parametrize("arch", ["din", "bst"])
def test_from_reference_rejects_another_config(arch):
    cfg, _, params, _ = _pair(arch, "smoke")
    with pytest.raises(ValueError):
        FROM_REFERENCE[arch](params, PORT[arch].CONFIG, "cpu")
    with pytest.raises(ValueError, match=f"not {arch}"):
        FROM_REFERENCE[arch](params, dataclasses.replace(cfg, arch="deepfm"),
                             "cpu")
    with pytest.raises(ValueError):
        FROM_REFERENCE[arch](params, _pair(arch, "narrow")[0], "cpu")


def test_bst_block_missing_a_weight_is_refused():
    cfg, _, params, _ = _pair("bst", "narrow")
    p = dict(params, blocks=[dict(b) for b in params["blocks"]])
    del p["blocks"][1]["wo"]
    with pytest.raises(ValueError, match="blocks.1.wo"):
        convert.bst_from_reference(p, cfg, "cpu")


@pytest.mark.parametrize("shape", ["serve_p99", "serve_bulk"])
@pytest.mark.parametrize("arch", ["din", "bst"])
def test_launcher_scores_on_the_cpu(arch, shape, capsys):
    out = launch_serve.main(["--arch", arch, "--shape", shape, "--smoke",
                             "--device", "cpu", "--requests", "2"])
    assert out["finite"] and out["requests"] == 2 and out["rows"] == 8
    assert out["arch"] == PORT[arch].SMOKE.name and out["shape"] == shape
    assert f"{arch}-smoke/{shape}: 2 requests of 8 rows on cpu" in \
        capsys.readouterr().out


@pytest.mark.parametrize("arch", ["din", "bst"])
def test_entry_points_default_to_the_card(arch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rec.recsys_init(PORT[arch].SMOKE)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_serve.main(["--arch", arch, "--smoke", "--requests", "1"])
