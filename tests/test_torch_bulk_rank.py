"""DIN's and BST's ``retrieval_cand`` in the port against the JAX package,
on the CPU, at SMOKE with the JAX parameters carried over by
``convert.din_from_reference`` / ``bst_from_reference``: ``bulk_rank_fn``
over N candidate rows from ``synthetic.recsys_batch`` (each with its own
history, as the JAX cell's batch) scored in row slices of every size
tested, its top 100 (at most N) held to ``repro.serve.serve_step.
bulk_rank_fn``'s on the same batch (values within 1e-5, indices by
``test_torch_retrieval.assert_same_top_k``'s tie rule); how the slices
fill one logits tensor; what still refuses; and the launcher's
``--shape retrieval_cand``.  The inputs are made with numpy from a seed
and given to both packages."""
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
from repro.models import recsys as jrec
from repro.serve import serve_step as jserve
from repro_torch.configs import bst, din, two_tower_retrieval as tt
from repro_torch.core import convert
from repro_torch.data import synthetic
from repro_torch.launch import serve as launch_serve
from repro_torch.models import recsys as rec
from repro_torch.serve import serve_step
from test_torch_retrieval import assert_same_top_k

PORT = {"din": din.SMOKE, "bst": bst.SMOKE}
JAX = {"din": jdin.SMOKE, "bst": jbst.SMOKE}
FROM_REFERENCE = {"din": convert.din_from_reference,
                  "bst": convert.bst_from_reference}
TOP_K = 100
_MODELS, _WANT = {}, {}


@pytest.fixture(scope="module")
def jmesh():
    return mesh_mod.make_local_mesh()


@pytest.fixture(scope="module")
def mi(jmesh):
    return jcm.MeshInfo.from_mesh(jmesh)


def _pair(arch):
    """(JAX parameters with numpy leaves, the port's model with them)."""
    if arch not in _MODELS:
        params, _ = jcm.unbox(jrec.recsys_init(jax.random.key(0), JAX[arch]))
        params = jax.tree.map(np.asarray, params)
        _MODELS[arch] = (params, FROM_REFERENCE[arch](params, PORT[arch],
                                                      "cpu"))
    return _MODELS[arch]


def _batch(arch, n, seed):
    batch = synthetic.recsys_batch(np.random.default_rng(seed), PORT[arch], n)
    batch.pop("label")
    return batch


def _want(arch, n, seed, jmesh, mi):
    """The JAX package's top min(101, n) of the batch: (values, indices)
    as numpy, once per (arch, n, seed)."""
    if (arch, n, seed) not in _WANT:
        params, _ = _pair(arch)
        step = jserve.bulk_rank_fn(JAX[arch], jmesh, mi,
                                   top_k=min(TOP_K + 1, n))
        batch = {k: jnp.asarray(v) for k, v in _batch(arch, n, seed).items()}
        _WANT[arch, n, seed] = tuple(np.asarray(a)
                                     for a in step(params, batch))
    return _WANT[arch, n, seed]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("chunk", ["n", 17, 64])
@pytest.mark.parametrize("n", [64, 1000])
@pytest.mark.parametrize("arch", ["din", "bst"])
def test_bulk_rank_fn_matches_jax(arch, n, chunk, seed, jmesh, mi):
    """n candidate rows in slices of ``chunk`` rows (``"n"``: one slice):
    the top 100 (at most n) logits as the JAX package's unsliced
    ``bulk_rank_fn`` gives them."""
    _, model = _pair(arch)
    k = min(TOP_K, n)
    rows = n if chunk == "n" else chunk
    got = serve_step.bulk_rank_fn(PORT[arch], model, top_k=k,
                                  chunk_rows=rows)(_batch(arch, n, seed))
    wv, wi = _want(arch, n, seed, jmesh, mi)
    nxt = None if k == n else wv[k:k + 1]
    assert got[0].shape == (k,) and got[0].dtype == torch.float32
    assert got[1].dtype == torch.int64
    assert_same_top_k(got, (wv[:k], wi[:k]), nxt)


@pytest.mark.parametrize("arch", ["din", "bst"])
def test_slices_fill_one_logits_tensor(arch, monkeypatch):
    """1000 rows in slices of 64: 16 forwards of at most 64 rows, in
    order, and one ``lax_top_k`` over all 1000 logits, which are the
    slices' own; the default slice (262,144 rows) is one forward."""
    _, model = _pair(arch)
    cls = type(model)
    forward, top_k = cls.forward, rec.lax_top_k
    seen, ranked = [], []

    def record_forward(self, *cols):
        out = forward(self, *cols)
        seen.append((cols[0].clone(), out.clone()))
        return out

    def record_top_k(scores, k):
        ranked.append(scores.clone())
        return top_k(scores, k)

    monkeypatch.setattr(cls, "forward", record_forward)
    monkeypatch.setattr(rec, "lax_top_k", record_top_k)
    batch = _batch(arch, 1000, 3)
    values, indices = rec.bulk_rank(model, batch, TOP_K, chunk_rows=64)
    assert [len(c) for c, _ in seen] == [64] * 15 + [40]
    hist = torch.cat([c for c, _ in seen])
    assert torch.equal(hist, torch.from_numpy(batch["hist_items"]))
    (scores,) = ranked
    assert scores.shape == (1000,) and scores.dtype == torch.float32
    assert torch.equal(scores, torch.cat([o for _, o in seen]))
    assert torch.equal(values, scores[indices])
    seen.clear()
    ranked.clear()
    rec.bulk_rank(model, batch, TOP_K)
    assert [len(c) for c, _ in seen] == [1000] and len(ranked) == 1


@pytest.mark.parametrize("arch", ["din", "bst"])
def test_bulk_rank_uploads_one_copy(arch, monkeypatch):
    """The model's columns of all N rows cross in one buffer; the slices
    are views of it."""
    _, model = _pair(arch)
    uploaded = []
    upload = serve_step._upload

    def record(batch, device):
        uploaded.append(upload(batch, device))
        return uploaded[-1]

    monkeypatch.setattr(serve_step, "_upload", record)
    batch = _batch(arch, 200, 4)
    serve_step.bulk_rank_fn(PORT[arch], model, top_k=10, chunk_rows=50)(batch)
    (up,) = uploaded
    assert list(up) == list(model.inputs)
    assert len({t.untyped_storage().data_ptr() for t in up.values()}) == 1
    for k in model.inputs:
        np.testing.assert_array_equal(up[k].numpy(), batch[k])


def test_bulk_rank_refuses_what_it_does_not_rank():
    """Two-tower retrieves through ``retrieval_fn`` (its step and its model
    are refused here), an arch the port lacks is not ported, and a slice
    holds at least one row."""
    tt_model = rec.recsys_init(tt.SMOKE, device="cpu")
    with pytest.raises(ValueError, match="not two_tower.*retrieval_fn"):
        serve_step.bulk_rank_fn(tt.SMOKE, tt_model)
    with pytest.raises(NotImplementedError, match="retrieval_scores"):
        rec.bulk_rank(tt_model, {})
    with pytest.raises(NotImplementedError, match="deepseek is not ported"):
        serve_step.bulk_rank_fn(
            dataclasses.replace(din.SMOKE, arch="deepseek"), None)
    _, model = _pair("din")
    with pytest.raises(ValueError, match="chunk_rows"):
        rec.bulk_rank(model, _batch("din", 8, 0), 5, chunk_rows=0)


@pytest.mark.parametrize("arch", ["din", "bst"])
def test_launcher_retrieval_cand_serves_din_and_bst(arch, capsys):
    out = launch_serve.main(["--arch", arch, "--shape", "retrieval_cand",
                             "--smoke", "--device", "cpu", "--requests", "2"])
    assert out["shape"] == "retrieval_cand" and out["candidates"] == 64
    assert out["rows"] == 64 and out["finite"]
    assert out["arch"] == PORT[arch].name
    assert f"{arch}-smoke/retrieval_cand: 2 requests of 64 candidate rows, " \
        "top 64 on cpu" in capsys.readouterr().out
