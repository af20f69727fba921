"""The port's training slice against the JAX package, on the CPU: the losses,
the optimizer rules, the FM term's gradient, both recsys train steps for
all four archs at SMOKE, ``delta_ids``, the checkpoint (both ways across
the packages) and the train launcher.  Inputs are made with numpy from a
seed and fed to both packages; parameters come from the JAX package's init,
carried across by ``core/convert.py``.

Tolerances, each with its reason:

* integers (``delta_ids``, steps): bitwise.
* losses and gradients: 1e-5 (rtol and atol), fp32 sums taken in other
  orders by the two packages (observed ~1e-7 relative).
* the optimizer on identical inputs: 1e-6 (rtol and atol); the same fp32
  arithmetic, scalars from the step computed in float32 in both.
  Adafactor's momentum is stored in bf16: a one-ulp fp32 difference before
  the cast can move it by one bf16 ulp, so it is held at 2^-8 relative.
* whole steps: each step starts from the JAX package's parameters and
  state of the step before, so both packages always take identical
  inputs.  Parameters are then held at 1e-5, except where Adam's update is
  ill-conditioned: Adam moves a weight by lr * m̂ / (sqrt(v̂) + 1e-8), and
  where sqrt(v̂) < 1e-6 (a gradient within two decades of eps) a gradient
  difference of the sums' order (~1e-12) moves the weight by up to lr.
  There, and only there, they are held at lr.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.core import compat
from repro.data import synthetic as jsynthetic
from repro.kernels import ref as jref
from repro.launch import mesh as mesh_mod
from repro.models import common as jcm
from repro.models import recsys as jrec
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch.configs import registry
from repro_torch.core import convert
from repro_torch.data import synthetic
from repro_torch.kernels import embedding_bag as bag
from repro_torch.kernels import fused_fm as fm
from repro_torch.kernels import ops, ref
from repro_torch.launch import train as launch_train
from repro_torch.models import common as cm
from repro_torch.models import recsys as rec
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts

TOL = 1e-5              # losses, gradients: fp32 sums in other orders
OPT_TOL = 1e-6          # the optimizer on identical inputs
BF16_RTOL = 2.0 ** -8   # one bf16 ulp
ADAM_SENSITIVE = 1e-6   # sqrt(v̂) below this: Adam's step is ill-conditioned
ARCHS = list(registry.ARCHS)     # din, bst, two-tower-retrieval, deepfm
LR = 0.01


@pytest.fixture(scope="module")
def mesh():
    return mesh_mod.make_local_mesh()


@pytest.fixture(scope="module")
def mi(mesh):
    return jcm.MeshInfo.from_mesh(mesh)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree) -> dict:
    """A JAX tree -> {path: float32 numpy}, in leaf order."""
    return {k: np.asarray(v, np.float32)
            for k, v in convert.flatten_tree(_np(tree)).items()}


def _close(got, want, rtol, atol, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol, err_msg=what)


def _jax_init(arch, seed=0):
    jcfg = jregistry.get(arch).smoke
    params, _ = jcm.unbox(jrec.recsys_init(jax.random.key(seed), jcfg))
    return jcfg, _np(params)


def _batch(cfg, rows, seed):
    b = synthetic.recsys_batch(np.random.default_rng(seed), cfg, rows)
    if cfg.arch == "two_tower":
        b.pop("label", None)
    return b


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.as_tensor(v) for k, v in b.items()}


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(7,), (3, 5), (64,)])
def test_bce_with_logits_matches_jax(shape):
    rng = np.random.default_rng(len(shape))
    logits = rng.normal(size=shape).astype(np.float32) * 4
    logits.flat[0] = 0.0                  # the maximum's tie, split evenly
    labels = (rng.random(shape) < 0.3).astype(np.float32)
    want, wg = jax.value_and_grad(jcm.bce_with_logits)(jnp.asarray(logits),
                                                       jnp.asarray(labels))
    x = torch.tensor(logits, requires_grad=True)
    got = cm.bce_with_logits(x, torch.tensor(labels))
    got.backward()
    _close(got.detach(), want, TOL, TOL)
    _close(x.grad, wg, TOL, TOL)


@pytest.mark.parametrize("shape,masked", [((6, 11), False), ((6, 11), True),
                                          ((2, 3, 5), True), ((9, 9), False)])
def test_softmax_xent_matches_jax(shape, masked):
    rng = np.random.default_rng(shape[-1])
    logits = rng.normal(size=shape).astype(np.float32) * 3
    labels = rng.integers(0, shape[-1], shape[:-1]).astype(np.int32)
    mask = (rng.random(shape[:-1]) < 0.6).astype(np.float32) if masked \
        else None

    def jloss(x):
        return jcm.softmax_xent(x, jnp.asarray(labels),
                                None if mask is None else jnp.asarray(mask))

    want, wg = jax.value_and_grad(jloss)(jnp.asarray(logits))
    x = torch.tensor(logits, requires_grad=True)
    got = cm.softmax_xent(x, torch.tensor(labels).long(),
                          None if mask is None else torch.tensor(mask))
    got.backward()
    _close(got.detach(), want, TOL, TOL)
    _close(x.grad, wg, TOL, TOL)


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------
def _opt_tree(rng):
    """A parameter tree with an MLP, a bias, a table and an embedding."""
    return {"mlp": [{"w": rng.normal(size=(6, 5)).astype(np.float32),
                     "b": rng.normal(size=(5,)).astype(np.float32)}],
            "item_table": rng.normal(size=(7, 3)).astype(np.float32),
            "embed": rng.normal(size=(4, 2)).astype(np.float32),
            "bias": np.float32(rng.normal())}


def _assert_state_close(got: dict, want_tree, rtol=OPT_TOL, atol=OPT_TOL):
    want = convert.flatten_tree(_np(want_tree))
    got_flat = {f"{k}/{n}": v for k, st in got.items() for n, v in st.items()}
    assert list(got_flat) == list(want)
    for k, w in want.items():
        g = got_flat[k]
        if g.dtype == torch.bfloat16:               # adafactor's momentum
            _close(g.float(), np.asarray(w, np.float32), BF16_RTOL, atol, k)
        else:
            _close(g, w, rtol, atol, k)


@pytest.mark.parametrize("rule", ["adam", "adafactor", "adagrad_rows"])
@pytest.mark.parametrize("clip,decay", [(1.0, 0.0), (0.0, 0.0), (1.0, 0.01),
                                        (5.0, 0.0)])
def test_each_rule_matches_jax_on_the_same_inputs(rule, clip, decay):
    rng = np.random.default_rng(3)
    tree = _opt_tree(rng)
    jcfg = jopt.OptConfig(lr=0.05, dense_rule=rule, table_rule=rule,
                          grad_clip=clip, weight_decay=decay)
    cfg = opt.OptConfig(lr=0.05, dense_rule=rule, table_rule=rule,
                        grad_clip=clip, weight_decay=decay)
    jp = jax.tree.map(jnp.asarray, tree)
    js = jopt.init_opt_state(jp, jcfg)
    _assert_state_close(opt.init_opt_state(
        convert.params_from_reference(tree, "cpu"), cfg), js)
    for step in range(1, 4):
        # each step from JAX's parameters and state: identical inputs
        p = convert.params_from_reference(_np(jp), "cpu")
        s = convert.opt_state_from_reference(_np(js), "cpu")
        g = jax.tree.map(
            lambda x: (rng.normal(size=np.shape(x)) * 2).astype(np.float32),
            tree)
        jp, js, jn = jopt.apply_updates(jp, jax.tree.map(jnp.asarray, g),
                                        js, jcfg, jnp.int32(step))
        p, s, n = opt.apply_updates(
            p, convert.params_from_reference(g, "cpu"), s, cfg, step)
        _close(n, jn, OPT_TOL, OPT_TOL)
        want = _flat(jp)
        assert list(p) == list(want)
        for k, v in p.items():
            _close(v, want[k], OPT_TOL, OPT_TOL, k)
        _assert_state_close(s, js)


def test_rule_for_path_and_state_shapes():
    cfg = opt.OptConfig()
    params = {"item_table": torch.zeros(10, 4), "mlp/w": torch.zeros(4, 4),
              "embed": torch.zeros(6, 2)}
    st = opt.init_opt_state(params, cfg)
    assert set(st["item_table"]) == {"acc"}          # adagrad rows
    assert set(st["embed"]) == {"acc"}
    assert set(st["mlp/w"]) == {"m", "v"}            # adam
    assert st["item_table"]["acc"].shape == (10,)    # one per row
    af = opt.init_opt_state({"w": torch.zeros(8, 4), "b": torch.zeros(4)},
                            opt.OptConfig(dense_rule="adafactor"))
    assert af["w"]["m"].dtype == torch.bfloat16
    assert af["w"]["vr"].shape == (8,) and af["w"]["vc"].shape == (4,)
    assert set(af["b"]) == {"m", "v"}
    with pytest.raises(ValueError):
        opt.init_opt_state(params, opt.OptConfig(dense_rule="sgd"))


@pytest.mark.parametrize("rule", ["adam", "adafactor", "adagrad_rows"])
def test_rules_descend(rule):
    """tests/test_optimizer.py's quadratic, on the port."""
    lr = 0.5 if rule == "adagrad_rows" else 0.05
    cfg = opt.OptConfig(lr=lr, dense_rule=rule, table_rule=rule,
                        grad_clip=0.0)
    params = {"w": torch.tensor(np.random.default_rng(0).normal(
        size=(16, 8)), dtype=torch.float32)}
    state = opt.init_opt_state(params, cfg)

    def loss(p):
        return ((p["w"] - 1.0) ** 2).mean()

    l0 = float(loss(params))
    for i in range(60):
        w = params["w"].clone().requires_grad_()
        (g,) = torch.autograd.grad(loss({"w": w}), [w])
        params, state, _ = opt.apply_updates(params, {"w": g}, state, cfg,
                                             i + 1)
    assert float(loss(params)) < 0.2 * l0, rule


def test_grad_clip_bounds_update():
    cfg = opt.OptConfig(lr=1.0, grad_clip=1.0, dense_rule="adam")
    params = {"w": torch.zeros(4)}
    state = opt.init_opt_state(params, cfg)
    newp, _, gnorm = opt.apply_updates(params, {"w": torch.full((4,), 1e6)},
                                       state, cfg, 1)
    assert float(gnorm) > 1e5
    assert bool(newp["w"].isfinite().all())
    assert float(newp["w"].abs().max()) < 10.0


# ---------------------------------------------------------------------------
# the FM term's gradient
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 1, 1), (7, 3, 5), (33, 39, 10),
                                   (5, 13, 17)])
def test_fused_fm_backward_plain_matches_jax_grad(dtype, shape):
    rng = np.random.default_rng(sum(shape))
    x = rng.normal(size=shape).astype(np.float32)
    g = rng.normal(size=shape[:1]).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    _, vjp = jax.vjp(jref.fused_fm, jx)
    (want,) = vjp(jnp.asarray(g))
    tx = torch.tensor(x).to(getattr(torch, dtype))
    got = ref.fused_fm_backward(tx, torch.tensor(g))
    assert got.dtype == tx.dtype and got.shape == shape
    if dtype == "float32":
        _close(got, want, TOL, TOL)
    else:                           # one bf16 ulp: the fp32 value's rounding
        _close(got.float(), np.asarray(want, np.float32), BF16_RTOL, TOL)


@pytest.mark.parametrize("shape", [(1, 1, 1), (4, 3, 5), (3, 6, 2)])
def test_fused_fm_function_gradcheck_on_the_cpu(shape):
    x = torch.tensor(np.random.default_rng(1).normal(size=shape),
                     dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(fm.FusedFM.apply, (x,))
    before = dict(fm.launches)
    out = fm.FusedFM.apply(x)
    (gx,) = torch.autograd.grad(out.sum() * 3.0, [x])
    torch.testing.assert_close(gx, ref.fused_fm_backward(
        x.detach(), torch.full((shape[0],), 3.0, dtype=torch.float64)))
    assert fm.launches == before                     # no kernel on the CPU


def test_fm_interaction_on_the_cpu_is_autograd_of_the_plain_version():
    x = torch.tensor(np.random.default_rng(2).normal(size=(9, 4, 3)),
                     dtype=torch.float32, requires_grad=True)
    g = torch.tensor(np.random.default_rng(3).normal(size=9),
                     dtype=torch.float32)
    (got,) = torch.autograd.grad(ops.fm_interaction(x), [x], g)
    torch.testing.assert_close(got, ref.fused_fm_backward(x.detach(), g),
                               rtol=TOL, atol=TOL)


def test_embedding_bag_on_the_cpu_stays_differentiable():
    """The bag's plain version carries its gradient on the CPU, autograd
    through it as it stands (the card runs ``EmbeddingBag``, the
    ``embedding_bag_backward`` kernel its gradient;
    tests/test_torch_cuda.py)."""
    table = torch.randn(20, 4, requires_grad=True)
    ids = torch.tensor([[1, 2, -1], [3, 3, 3]], dtype=torch.int32)
    ops.embedding_bag(table, ids, mode="mean").sum().backward()
    want = torch.zeros(20, 4)
    want[1] += 0.5
    want[2] += 0.5
    want[3] += 1.0
    torch.testing.assert_close(table.grad, want)


def _bag_case(mode_seed, v=30, b=9, n=6, d=5):
    """A bag batch with padding, an all-padding bag, an id repeated within
    a bag and across bags, and an id past the table."""
    rng = np.random.default_rng(mode_seed)
    table = rng.normal(size=(v, d)).astype(np.float32)
    ids = rng.integers(-1, v, size=(b, n)).astype(np.int32)
    ids[0] = -1                                  # all padding
    ids[1] = [4, 4, 4, -1, 7, -1]                # repeated in a bag
    ids[2:, 0] = 7                               # and across bags
    ids[3, 2] = v                                # past the table
    w = rng.random((b, n)).astype(np.float32)
    g = rng.normal(size=(b, d)).astype(np.float32)
    return table, ids, w, g


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_backward_plain_matches_jax_vjp(mode, weighted):
    """The plain bag gradient against ``jax.vjp`` of the JAX package's
    oracle, at 1e-6: the same terms, summed in other orders.  The id past
    the table counts in the mean and adds nothing (its bag's forward is
    NaN; the gradient is not)."""
    table, ids, w, g = _bag_case(7 + weighted)
    ww = w if weighted else None
    _, vjp = jax.vjp(lambda t: jref.embedding_bag(
        t, jnp.asarray(ids), None if ww is None else jnp.asarray(ww), mode),
        jnp.asarray(table))
    (want,) = vjp(jnp.asarray(g))
    got = ref.embedding_bag_backward(
        torch.tensor(g), torch.tensor(ids),
        None if ww is None else torch.tensor(ww), mode, table.shape[0])
    assert got.shape == table.shape and got.dtype == torch.float32
    _close(got, want, 1e-6, 1e-6)
    named = np.zeros(table.shape[0], bool)       # padding adds to no row
    named[ids[(ids >= 0) & (ids < table.shape[0])]] = True
    assert not bool(got[torch.tensor(~named)].any())


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_backward_terms_bound_the_plain_sum(mode, weighted):
    """``embedding_bag_backward_terms``: S is the gradient of |g| and |w|
    (so S >= |grad| and S = |grad| where every term has one sign), n each
    row's count of in-table ids."""
    table, ids, w, g = _bag_case(11 + weighted)
    args = (None if not weighted else torch.tensor(w), mode, table.shape[0])
    grad = ref.embedding_bag_backward(torch.tensor(g), torch.tensor(ids),
                                      *args)
    s, n = ref.embedding_bag_backward_terms(torch.tensor(g),
                                            torch.tensor(ids), *args)
    assert bool((s >= grad.abs()).all())
    pos = ref.embedding_bag_backward(torch.tensor(np.abs(g)),
                                     torch.tensor(ids), *args)
    torch.testing.assert_close(s, pos, rtol=0, atol=0)
    flat = ids[(ids >= 0) & (ids < table.shape[0])]
    assert n.tolist() == np.bincount(flat, minlength=table.shape[0]).tolist()


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_function_gradcheck_on_the_cpu(mode, weighted):
    """``EmbeddingBag`` on a CPU table (its plain forward and backward)
    under ``gradcheck`` in float64, padding, repeats and an id past the
    table included (its bag's NaN forward is left out of the check's
    output); no kernel launches."""
    table, ids, w, _ = _bag_case(13 + weighted)
    ids[3, 2] = -1 if mode == "sum" else ids[3, 2]
    keep = torch.ones(ids.shape[0], dtype=torch.bool)
    keep[3] = mode == "sum"                     # the NaN bag
    x = torch.tensor(table, dtype=torch.float64, requires_grad=True)
    wt = torch.tensor(w, dtype=torch.float64) if weighted else None
    before = dict(bag.launches)
    assert torch.autograd.gradcheck(
        lambda t: bag.EmbeddingBag.apply(t, torch.tensor(ids), wt,
                                         mode)[keep], (x,))
    assert bag.launches == before


def _u_i_logq(b, d, seed):
    rng = np.random.default_rng(seed)
    u, i = (rng.normal(size=(b, d)).astype(np.float32) for _ in range(2))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    i /= np.linalg.norm(i, axis=1, keepdims=True)
    return u, i, rng.normal(size=b).astype(np.float32)


@pytest.mark.parametrize("with_logq", [False, True])
@pytest.mark.parametrize("b,chunk", [(12, 5), (12, 12), (12, 64), (33, 8)])
def test_in_batch_softmax_matches_jax_softmax_xent(b, chunk, with_logq,
                                                    monkeypatch):
    """The lean in-batch softmax, ``chunk`` rows of logits at a time,
    against JAX's ``softmax_xent`` over the whole ``u @ i.T / 0.05 -
    logq``: the loss and its gradients w.r.t. u, i and logq at 1e-5."""
    u, i, logq = _u_i_logq(b, 8, b + chunk)

    def jloss(u_, i_, q_):
        logits = (u_ @ i_.T) / 0.05
        if with_logq:
            logits = logits - q_[None, :]
        return jcm.softmax_xent(logits, jnp.arange(b))

    want, wg = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(u), jnp.asarray(i), jnp.asarray(logq))
    monkeypatch.setattr(rec, "SOFTMAX_CHUNK", chunk)
    x = [torch.tensor(a, requires_grad=True) for a in (u, i, logq)]
    got = rec._in_batch_softmax(x[0], x[1], x[2] if with_logq else None)
    grads = torch.autograd.grad(got, x if with_logq else x[:2])
    _close(got.detach(), want, TOL, TOL)
    for gt, wt in zip(grads, wg):
        _close(gt, wt, TOL, TOL)


@pytest.mark.parametrize("with_logq", [False, True])
def test_two_tower_loss_in_chunks_matches_jax(with_logq, mesh, mi,
                                              monkeypatch):
    """JAX's ``two_tower_loss`` and its gradients on every parameter,
    against the port's with the in-batch softmax taken 5 rows at a time
    over a batch of 12, with and without the logQ correction, at 1e-5."""
    jcfg, jparams = _jax_init("two-tower-retrieval")
    cfg = registry.ARCHS["two-tower-retrieval"].SMOKE
    b = _batch(cfg, 12, 4)
    if with_logq:
        b["logq"] = np.random.default_rng(5).normal(size=12).astype(
            np.float32)
    with compat.set_mesh(mesh):
        jl, jg = jax.value_and_grad(
            lambda p: jrec.two_tower_loss(p, jcfg, _jb(b), mi))(
                jax.tree.map(jnp.asarray, jparams))
    monkeypatch.setattr(rec, "SOFTMAX_CHUNK", 5)
    loss, g = _grads(lambda p: rec.recsys_loss(p, cfg, _tb(b)),
                     convert.params_from_reference(jparams, "cpu"))
    _close(loss.detach(), jl, TOL, TOL)
    want = _flat(jg)
    for k in want:
        _close(g[k], want[k], TOL, TOL, k)


def test_in_batch_softmax_allocates_no_b_by_b_tensor(monkeypatch):
    """Every tensor the lean softmax's forward and backward make, recorded
    by a dispatch mode, holds fewer than B^2 elements (B = 12, D = 8,
    5 rows a chunk); the same mode sees the [B, B] logits of the plain
    ``softmax_xent`` over ``u @ i.T``."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Sizes(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.largest = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (tuple, list)) else [out]):
                if isinstance(t, torch.Tensor):
                    self.largest = max(self.largest, t.numel())
            return out

    b = 12
    u, i, logq = (torch.tensor(a, requires_grad=True)
                  for a in _u_i_logq(b, 8, 3))
    monkeypatch.setattr(rec, "SOFTMAX_CHUNK", 5)
    with Sizes() as lean:
        loss = rec._in_batch_softmax(u, i, logq)
        torch.autograd.grad(loss, [u, i, logq])
    assert 0 < lean.largest < b * b
    with Sizes() as plain:
        loss = cm.softmax_xent((u @ i.T) / 0.05 - logq[None],
                               torch.arange(b))
        torch.autograd.grad(loss, [u, i, logq])
    assert plain.largest >= b * b


def test_in_batch_softmax_takes_its_gradients_in_the_forward_pass(
        monkeypatch):
    """One pass over the chunks: a product a chunk under ``no_grad``; the
    logits, ``p @ i`` and ``p.T @ u`` a chunk under grad; none in the
    backward, which scales the saved gradients (here by 3, against the
    loss's own gradients times 3)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Products(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += func.overloadpacket in (torch.ops.aten.mm,
                                              torch.ops.aten.matmul)
            return func(*args, **(kwargs or {}))

    b, chunk = 12, 5
    chunks = -(-b // chunk)
    u, i, logq = (torch.tensor(a, requires_grad=True)
                  for a in _u_i_logq(b, 8, 4))
    monkeypatch.setattr(rec, "SOFTMAX_CHUNK", chunk)
    with torch.no_grad(), Products() as inference:
        want = rec._in_batch_softmax(u, i, logq)
    assert inference.n == chunks
    with Products() as fwd:
        loss = rec._in_batch_softmax(u, i, logq)
    assert fwd.n == 3 * chunks
    torch.testing.assert_close(loss.detach(), want, rtol=0, atol=0)
    once = torch.autograd.grad(loss, [u, i, logq], retain_graph=True)
    with Products() as bwd:
        thrice = torch.autograd.grad(3 * loss, [u, i, logq])
    assert bwd.n == 0
    for g3, g1 in zip(thrice, once):
        torch.testing.assert_close(g3, 3 * g1)


# ---------------------------------------------------------------------------
# the model's training half and the converters
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_params_of_and_model_from_params_round_trip(arch):
    jcfg, jparams = _jax_init(arch)
    cfg = registry.ARCHS[arch].SMOKE
    params = convert.params_from_reference(jparams, "cpu")
    assert list(params) == list(convert.flatten_tree(jparams))
    model = convert.model_from_params(cfg, params, "cpu")
    back = convert.params_of(model)
    assert list(back) == list(params)
    for k in params:
        assert torch.equal(back[k], params[k]), k
    # the same order and names as a model drawn by the port
    drawn = convert.params_of(rec.recsys_init(cfg, seed=1, device="cpu"))
    assert list(drawn) == list(params)
    assert all(drawn[k].shape == params[k].shape for k in params)


@pytest.mark.parametrize("arch", ["din", "bst", "deepfm"])
def test_training_forward_matches_the_serving_model(arch):
    cfg = registry.ARCHS[arch].SMOKE
    model = rec.recsys_init(cfg, seed=2, device="cpu")
    params = convert.params_of(model)
    b = _tb(_batch(cfg, 12, 5))
    logits = rec.FORWARD_ROWS[cfg.arch](params, cfg, b,
                                        rec.gather_rows(params, cfg, b))
    with torch.inference_mode():
        want = model(*[b[k] for k in model.inputs])
    torch.testing.assert_close(logits.detach(), want, rtol=1e-6, atol=1e-6)


def _grads(loss_fn, leaves: dict):
    x = {k: v.clone().requires_grad_() for k, v in leaves.items()}
    loss, _ = loss_fn(x)
    return loss, dict(zip(x, torch.autograd.grad(loss, list(x.values()))))


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_loss_and_gradients_match_jax(arch, mesh, mi):
    jcfg, jparams = _jax_init(arch)
    cfg = registry.ARCHS[arch].SMOKE
    b = _batch(cfg, 16, 0)
    with compat.set_mesh(mesh):
        (jl, _), jg = jax.value_and_grad(
            lambda p: jrec.recsys_loss(p, jcfg, _jb(b), mi), has_aux=True)(
                jax.tree.map(jnp.asarray, jparams))
    loss, g = _grads(lambda p: rec.recsys_loss(p, cfg, _tb(b)),
                     convert.params_from_reference(jparams, "cpu"))
    _close(loss.detach(), jl, TOL, TOL)
    want = _flat(jg)
    assert list(g) == list(want)
    for k in want:
        _close(g[k], want[k], TOL, TOL, k)


@pytest.mark.parametrize("arch", ARCHS)
def test_rows_loss_and_gradients_match_jax(arch, mesh, mi):
    """recsys_loss_rows, the sparse step's loss: gradients w.r.t. the dense
    parameters and the gathered rows."""
    jcfg, jparams = _jax_init(arch)
    cfg = registry.ARCHS[arch].SMOKE
    b = _batch(cfg, 16, 1)
    jp = jax.tree.map(jnp.asarray, jparams)
    with compat.set_mesh(mesh):
        jrows = jrec.gather_rows(jp, jcfg, _jb(b), mi)
        (jl, _), (jgp, jgr) = jax.value_and_grad(
            lambda p, r: jrec.recsys_loss_rows(p, jcfg, _jb(b), r, mi),
            argnums=(0, 1), has_aux=True)(jp, jrows)
    params = convert.params_from_reference(jparams, "cpu")
    rows = rec.gather_rows(params, cfg, _tb(b))
    for k in rows:
        _close(rows[k], jrows[k], 0, 0, k)           # the same gather
    tables = {t for t, _ in rec.table_ids(cfg, _tb(b)).values()}
    dense = {k: v for k, v in params.items() if k not in tables}
    leaves = {**dense, **{"rows/" + k: v for k, v in rows.items()}}
    loss, g = _grads(lambda x: rec.recsys_loss_rows(
        {**x, **{t: params[t] for t in tables}}, cfg, _tb(b),
        {k: x["rows/" + k] for k in rows}), leaves)
    _close(loss.detach(), jl, TOL, TOL)
    want_p = _flat(jgp)
    for k in dense:
        _close(g[k], want_p[k], TOL, TOL, k)
    for k in rows:
        _close(g["rows/" + k], jgr[k], TOL, TOL, k)


# ---------------------------------------------------------------------------
# whole train steps against the JAX package
# ---------------------------------------------------------------------------
def _assert_params_close(got: dict, want_tree, want_state_tree, step: int):
    """Parameters at 1e-5, except where JAX's Adam state says the update
    was ill-conditioned (sqrt(v̂) < ADAM_SENSITIVE): there at LR."""
    want = _flat(want_tree)
    state = convert.flatten_tree(_np(want_state_tree))
    assert list(got) == list(want)
    for k, w in want.items():
        err = np.abs(got[k].detach().float().numpy() - w)
        bound = np.full(w.shape, TOL) + TOL * np.abs(w)
        if f"{k}/v" in state and f"{k}/m" in state:       # an Adam leaf
            vhat = np.asarray(state[f"{k}/v"]) / (1 - 0.999 ** step)
            bound = np.where(np.sqrt(vhat) < ADAM_SENSITIVE, LR, bound)
        assert (err <= bound).all(), (k, float(err.max()))


def _step_fns(arch, mode, mesh, mi):
    jcfg = jregistry.get(arch).smoke
    cfg = registry.ARCHS[arch].SMOKE
    jocfg, ocfg = jopt.OptConfig(lr=LR), opt.OptConfig(lr=LR)
    if mode == "sparse":
        return (jax.jit(jts.make_sparse_recsys_train_step(
                    jcfg, mesh, mi, jocfg, emit_deltas=True)),
                ts.make_sparse_recsys_train_step(cfg, ocfg,
                                                 emit_deltas=True))
    accum = int(mode[-1])
    return (jax.jit(jts.make_train_step(jts.recsys_loss_fn(jcfg, mesh, mi),
                                        jocfg, accum_steps=accum)),
            ts.make_train_step(ts.recsys_loss_fn(cfg), ocfg,
                               accum_steps=accum))


@pytest.mark.parametrize("mode", ["dense1", "dense4", "sparse"])
@pytest.mark.parametrize("arch", ARCHS)
def test_three_steps_match_jax(arch, mode, mesh, mi):
    """Three steps of each package's step, each from the JAX package's
    parameters and optimizer state of the step before (carried across by
    ``convert``), on the same batch: loss, grad_norm, parameters, state
    and (sparse) delta_ids."""
    jcfg, jparams = _jax_init(arch)
    cfg = registry.ARCHS[arch].SMOKE
    jf, pf = _step_fns(arch, mode, mesh, mi)
    jp = jax.tree.map(jnp.asarray, jparams)
    js = jopt.init_opt_state(jp, jopt.OptConfig(lr=LR))
    jstep = jnp.int32(0)
    for i in range(3):
        b = _batch(cfg, 16, 10 + i)
        p = convert.params_from_reference(_np(jp), "cpu")
        s = convert.opt_state_from_reference(_np(js), "cpu")
        if i == 0:
            _assert_state_close(opt.init_opt_state(p, opt.OptConfig()), js)
        with compat.set_mesh(mesh):
            jp, js, jstep, jm = jf(jp, js, jstep, _jb(b))
        p, s, step, m = pf(p, s, i, _tb(b))
        assert step == int(jstep) == i + 1
        _close(m["loss"], jm["loss"], TOL, TOL)
        _close(m["grad_norm"], jm["grad_norm"], TOL, TOL)
        _assert_params_close(p, jp, js, i + 1)
        _assert_state_close(s, js, rtol=TOL, atol=TOL)
        if mode == "sparse":
            want = {k: np.asarray(v) for k, v in jm["delta_ids"].items()}
            assert sorted(m["delta_ids"]) == sorted(want)
            for t, ids in want.items():
                np.testing.assert_array_equal(m["delta_ids"][t].numpy(), ids)


@pytest.mark.parametrize("arch", ARCHS)
def test_sparse_train_matches_dense(arch):
    """tests/test_perf_paths.py's scenario on the port: the first step's
    losses agree, and four steps of each leave finite dense towers."""
    cfg = registry.ARCHS[arch].SMOKE
    ocfg = opt.OptConfig(lr=0.01)
    dense_fn = ts.make_train_step(ts.recsys_loss_fn(cfg), ocfg)
    sparse_fn = ts.make_sparse_recsys_train_step(cfg, ocfg)
    params = convert.params_of(rec.recsys_init(cfg, seed=0, device="cpu"))
    pd, sd, std = params, opt.init_opt_state(params, ocfg), 0
    ps = {k: v.clone() for k, v in params.items()}   # the sparse step is
    ss, sts = opt.init_opt_state(ps, ocfg), 0        # in place on tables
    for i in range(4):
        b = _tb(_batch(cfg, 16, i))
        pd, sd, std, md = dense_fn(pd, sd, std, b)
        ps, ss, sts, ms = sparse_fn(ps, ss, sts, b)
        if i == 0:
            assert abs(float(md["loss"]) - float(ms["loss"])) < 1e-4
    for k in pd:
        if "table" not in k:
            assert bool(ps[k].isfinite().all()), k


def test_grad_accumulation_equivalence():
    """tests/test_perf_paths.py's scenario on the port: one batch of 32 in
    one step or as 4 microbatches gives parameters within 1e-4."""
    cfg = registry.ARCHS["deepfm"].SMOKE
    params = convert.params_of(rec.recsys_init(cfg, seed=1, device="cpu"))
    ocfg = opt.OptConfig(lr=0.01)
    b = _tb(_batch(cfg, 32, 2))
    s = opt.init_opt_state(params, ocfg)
    p1, _, _, _ = ts.make_train_step(ts.recsys_loss_fn(cfg), ocfg)(
        params, s, 0, b)
    p4, _, _, _ = ts.make_train_step(ts.recsys_loss_fn(cfg), ocfg,
                                     accum_steps=4)(params, s, 0, b)
    assert max(float((p1[k] - p4[k]).abs().max()) for k in p1) < 1e-4


# ---------------------------------------------------------------------------
# delta_ids (tests/test_incremental_publish.py's scenarios)
# ---------------------------------------------------------------------------
def test_train_step_emits_delta_ids():
    def jloss(params, batch):
        rows = jnp.take(params["emb"], batch["ids"], axis=0)
        return (rows * batch["x"][:, None]).sum(), {}

    def loss(params, batch):
        rows = params["emb"][batch["ids"]]
        return (rows * batch["x"][:, None]).sum(), {}

    ids = np.array([3, 7, 3, 1], np.int32)
    step = ts.make_train_step(loss, opt.OptConfig(lr=0.01),
                              delta_ids_fn=lambda b: {"emb": b["ids"]})
    params = {"emb": torch.ones(32, 4)}
    state = opt.init_opt_state(params, opt.OptConfig(lr=0.01))
    batch = {"ids": torch.tensor(ids), "x": torch.ones(4)}
    p, _, _, metrics = step(params, state, 0, batch)
    assert set(metrics["delta_ids"]["emb"].tolist()) == {1, 3, 7}
    _, _, _, m0 = ts.make_train_step(loss, opt.OptConfig(lr=0.01))(
        params, state, 0, batch)
    assert "delta_ids" not in m0
    # and the step itself against JAX's
    jocfg = jopt.OptConfig(lr=0.01)
    jp = {"emb": jnp.ones((32, 4), jnp.float32)}
    jstep = jts.make_train_step(
        jloss, jocfg, delta_ids_fn=lambda b: {"emb": b["ids"].reshape(-1)})
    jp2, _, _, jm = jstep(jp, jopt.init_opt_state(jp, jocfg), jnp.int32(0),
                          {"ids": jnp.asarray(ids), "x": jnp.ones(4)})
    np.testing.assert_array_equal(metrics["delta_ids"]["emb"].numpy(),
                                  np.asarray(jm["delta_ids"]["emb"]))
    _close(p["emb"], jp2["emb"], OPT_TOL, OPT_TOL)


def test_sparse_train_step_emit_deltas(mesh, mi):
    jcfg, jparams = _jax_init("din")
    cfg = registry.ARCHS["din"].SMOKE
    b = jsynthetic.recsys_batch(np.random.default_rng(0), jcfg, 8)
    fn = ts.make_sparse_recsys_train_step(cfg, opt.OptConfig(lr=0.01),
                                          emit_deltas=True)
    params = convert.params_from_reference(jparams, "cpu")
    _, _, _, m = fn(params, opt.init_opt_state(params, opt.OptConfig()), 0,
                    _tb(b))
    ids = m["delta_ids"]["item_table"].reshape(-1).numpy()
    want = np.concatenate([b["hist_items"].reshape(-1),
                           b["target_item"].reshape(-1)])
    assert sorted(ids.tolist()) == sorted(want.tolist())
    assert "cat_table" in m["delta_ids"]
    # without emit_deltas, none
    _, _, _, m0 = ts.make_sparse_recsys_train_step(cfg, opt.OptConfig())(
        params, opt.init_opt_state(params, opt.OptConfig()), 0, _tb(b))
    assert "delta_ids" not in m0


# ---------------------------------------------------------------------------
# the checkpoint (tests/test_checkpoint.py's scenarios, and across packages)
# ---------------------------------------------------------------------------
def _roundtrip_tree():
    return {"a": np.arange(12.0, dtype=np.float32).reshape(3, 4),
            "nest": {"b": np.ones((5,), np.float32)}}


def test_checkpoint_roundtrip(tmp_path):
    params = {"a": torch.arange(12.0).reshape(3, 4),
              "nest/b": torch.ones(5, dtype=torch.bfloat16),
              "bias": torch.tensor(0.5)}
    state = opt.init_opt_state(params, opt.OptConfig(dense_rule="adafactor"))
    state["a"]["m"] += 0.25                          # a bf16 leaf of state
    ckpt.save(str(tmp_path / "c1"), params=params, opt_state=state, step=7,
              meta={"arch": "x"})
    assert ckpt.exists(str(tmp_path / "c1"))
    assert not os.path.exists(tmp_path / "c1" / "meta.json")
    p2, s2, step, meta = ckpt.restore(str(tmp_path / "c1"),
                                      params_like=params, opt_like=state)
    assert step == 7 and meta == {"arch": "x"}
    for k in params:
        assert p2[k].dtype == params[k].dtype and torch.equal(p2[k],
                                                              params[k])
        assert p2[k].data_ptr() != params[k].data_ptr()     # fresh tensors
    for k in state:
        for n in state[k]:
            assert torch.equal(s2[k][n], state[k][n]), (k, n)


def test_checkpoint_async_save_snapshots_first(tmp_path):
    params = {"w": torch.ones(4, 4)}
    t = ckpt.save(str(tmp_path / "c3"), params=params, step=3,
                  async_save=True)
    params["w"].add_(1.0)                # after the snapshot: not saved
    t.join(timeout=60)
    assert not t.is_alive() and ckpt.exists(str(tmp_path / "c3"))
    p2, _, step, _ = ckpt.restore(str(tmp_path / "c3"), params_like=params)
    assert step == 3 and torch.equal(p2["w"], torch.ones(4, 4))


def test_checkpoint_restart_resumes_training(tmp_path):
    """Six steps uninterrupted against three, a save and restore, and three
    more: the same losses and parameters, bitwise (the same arithmetic on
    the CPU)."""
    cfg = registry.ARCHS["deepfm"].SMOKE
    ocfg = opt.OptConfig(lr=0.01)
    step_fn = ts.make_train_step(ts.recsys_loss_fn(cfg), ocfg)
    params0 = convert.params_of(rec.recsys_init(cfg, seed=0, device="cpu"))
    batches = [_tb(_batch(cfg, 32, 42 + i)) for i in range(6)]
    p, s, st = params0, opt.init_opt_state(params0, ocfg), 0
    ref_losses = []
    for b in batches:
        p, s, st, m = step_fn(p, s, st, b)
        ref_losses.append(float(m["loss"]))
    ref_params = p
    p, s, st = params0, opt.init_opt_state(params0, ocfg), 0
    for b in batches[:3]:
        p, s, st, m = step_fn(p, s, st, b)
    ckpt.save(str(tmp_path / "c4"), params=p, opt_state=s, step=st)
    p2, s2, st2, _ = ckpt.restore(str(tmp_path / "c4"), params_like=p,
                                  opt_like=s)
    assert st2 == 3
    resumed = []
    for b in batches[3:]:
        p2, s2, st2, m = step_fn(p2, s2, st2, b)
        resumed.append(float(m["loss"]))
    assert resumed == ref_losses[3:]
    for k in p2:
        assert torch.equal(p2[k], ref_params[k]), k


def test_jax_checkpoint_restores_in_the_port_and_back(tmp_path, mesh, mi):
    """A checkpoint the JAX package writes (DeepFM SMOKE after two steps,
    with a bf16 leaf) restores in the port, and one the port writes
    restores in the JAX package: every leaf bitwise; then both packages
    take the third step from it alike."""
    jcfg, jparams = _jax_init("deepfm")
    cfg = registry.ARCHS["deepfm"].SMOKE
    jocfg = jopt.OptConfig(lr=LR)
    jf = jax.jit(jts.make_train_step(jts.recsys_loss_fn(jcfg, mesh, mi),
                                     jocfg))
    jp = jax.tree.map(jnp.asarray, jparams)
    js, jst = jopt.init_opt_state(jp, jocfg), jnp.int32(0)
    with compat.set_mesh(mesh):
        for i in range(2):
            jp, js, jst, _ = jf(jp, js, jst, _jb(_batch(cfg, 16, i)))
    extra = {"x": jnp.arange(6, dtype=jnp.bfloat16)}
    jckpt.save(str(tmp_path / "jax"), params={**jp, **extra},
               opt_state=js, step=int(jst), meta={"from": "jax"})
    like = convert.params_from_reference(_np(jp), "cpu")
    like["x"] = torch.zeros(6, dtype=torch.bfloat16)
    s_like = opt.init_opt_state(convert.params_from_reference(_np(jp), "cpu"),
                                opt.OptConfig())
    p, s, step, meta = ckpt.restore(str(tmp_path / "jax"), params_like=like,
                                    opt_like=s_like)
    assert step == 2 and meta == {"from": "jax"}
    assert torch.equal(p.pop("x"), torch.arange(6, dtype=torch.bfloat16))
    for k, v in _flat(jp).items():
        np.testing.assert_array_equal(p[k].numpy(), v)
    _assert_state_close(s, js, rtol=0, atol=0)
    # the port writes, the JAX package restores
    ckpt.save(str(tmp_path / "port"), params=p, opt_state=s, step=step,
              meta={"from": "port"})
    jp2, js2, jstep2, jmeta = jckpt.restore(str(tmp_path / "port"),
                                            params_like=jp, opt_like=js)
    assert jstep2 == 2 and jmeta == {"from": "port"}
    for a, b in zip(jax.tree.leaves(jp2), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(jax.tree.leaves(js2), jax.tree.leaves(js)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # the third step, resumed in each package from the other's checkpoint
    b = _batch(cfg, 16, 2)
    with compat.set_mesh(mesh):
        jp3, _, _, jm = jf(jp2, js2, jnp.int32(jstep2), _jb(b))
    p3, _, _, m = ts.make_train_step(ts.recsys_loss_fn(cfg),
                                     opt.OptConfig(lr=LR))(p, s, step, _tb(b))
    _close(m["loss"], jm["loss"], TOL, TOL)


def test_checkpoint_bf16_leaf_crosses_both_ways(tmp_path):
    """adafactor's bf16 momentum: the JAX layout's byte view and @dtype
    entry, written by either package, read by the other."""
    tree = _roundtrip_tree()
    jstate = jopt.init_opt_state(jax.tree.map(jnp.asarray, tree),
                                 jopt.OptConfig(dense_rule="adafactor"))
    jstate = jax.tree.map(lambda x: x + jnp.asarray(0.375, x.dtype), jstate)
    jckpt.save(str(tmp_path / "j"), params=tree, opt_state=jstate, step=1)
    params = convert.params_from_reference(tree, "cpu")
    state = opt.init_opt_state(params, opt.OptConfig(dense_rule="adafactor"))
    _, s, _, _ = ckpt.restore(str(tmp_path / "j"), params_like=params,
                              opt_like=state)
    assert s["a"]["m"].dtype == torch.bfloat16
    _assert_state_close(s, jstate, rtol=0, atol=0)
    ckpt.save(str(tmp_path / "p"), params=params, opt_state=s, step=1)
    _, js, _, _ = jckpt.restore(str(tmp_path / "p"), params_like=tree,
                                opt_like=jstate)
    for a, b in zip(jax.tree.leaves(js), jax.tree.leaves(jstate)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_train_launcher_smoke_on_the_cpu(arch, capsys):
    out = launch_train.main(["--arch", arch, "--smoke", "--device", "cpu",
                             "--steps", "3"])
    assert out["device"] == "cpu" and out["step"] == 3 and out["rows"] == 8
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()
    text = capsys.readouterr().out
    assert "step    1 loss=" in text and "s/step)" in text
    assert text.rstrip().endswith("done")


def test_train_launcher_resumes_from_its_checkpoint(tmp_path, capsys):
    args = ["--arch", "deepfm", "--smoke", "--device", "cpu", "--ckpt-dir",
            str(tmp_path / "ck"), "--ckpt-every", "2"]
    first = launch_train.main(args + ["--steps", "2"])
    assert ckpt.exists(str(tmp_path / "ck")) and first["step"] == 2
    again = launch_train.main(args + ["--steps", "1"])
    assert "resumed at step 2" in capsys.readouterr().out
    assert again["step"] == 3


def test_train_launcher_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--arch", "deepfm", "--smoke", "--steps", "1"])


def test_train_launcher_trains_graphsage(capsys):
    """The arch ``test_train_launcher_refusals`` once refused: three steps
    of its default cell (``minibatch_lg``) at smoke size."""
    out = launch_train.main(["--arch", "graphsage-reddit", "--smoke",
                             "--device", "cpu", "--steps", "3"])
    assert out["shape"] == "minibatch_lg" and out["step"] == 3
    assert np.isfinite(out["losses"]).all()
    assert "done" in capsys.readouterr().out


def test_train_launcher_refusals():
    with pytest.raises(SystemExit):
        launch_train.main(["--arch", "deepfm", "--shape", "serve_p99",
                           "--smoke", "--device", "cpu"])
    with pytest.raises(SystemExit, match="deepseek-8b is not ported"):
        launch_train.main(["--arch", "deepseek-8b", "--smoke",
                           "--device", "cpu"])
    with pytest.raises(SystemExit, match="prefill_32k is not a train cell"):
        launch_train.main(["--arch", "deepseek-7b", "--shape", "prefill_32k",
                           "--smoke", "--device", "cpu"])
    with pytest.raises(SystemExit):
        launch_train.main(["--arch", "deepfm", "--smoke", "--device", "cpu",
                           "--steps", "0"])
