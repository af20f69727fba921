"""The port's LM training slice against the JAX package, on the CPU: the
optimizer's fp32 scaling of the clipped gradient and its in-place, block
by block update; ``_chunked_xent``; ``lm_loss`` (loss, metrics and every
gradient) of the five LM configs with and without remat; two train steps
under Adam and Adafactor, with and without gradient accumulation; the
optimizer rule; an LM checkpoint's resume; ``lm_batch``; both launchers'
LM training.  Parameters come from the JAX package's ``lm_init`` (key 0)
through ``core/convert.lm_from_reference``, or from ``materialize`` where
a launcher's are compared; tokens from numpy seeds.

Tolerances, each with its reason:

* the optimizer on integer gradients whose every sum is exact in any
  order (squares of small integers; Adafactor's and row-wise Adagrad's
  means over at most two elements): bitwise, params, state and norm, as
  is the in-place update against the functional one on any input.
* float32 losses, metrics and gradients: 1e-5 of the largest |value| of
  each (fp32 sums taken in other orders; measured up to 5.1e-6, deepseek-
  v3's MLA).
* bf16 (the configs as published): each gradient leaf's normwise error
  against JAX's float32 gradient (the same parameters, upcast) at most
  twice JAX's own bf16 error (measured up to 1.72x, qwen3-14b's q_gamma;
  the two packages round bf16 intermediates at different points); losses
  within ``BF16_LOSS_TOL`` of JAX's bf16 loss, relative (measured up to
  5.9e-4, deepseek-v3, whose bf16 routing differs by a slot or two).
* train steps: losses and ``grad_norm`` at 1e-5; parameters at 1e-5 except
  where JAX's state says the step is a sign (Adam's sqrt(v-hat), or
  Adafactor's unfactored sqrt(v) of a vector, below ``ADAM_SENSITIVE``:
  there within lr, the momentum within 2 (1 - b1)); fp32 state at 1e-5,
  Adafactor's
  bf16 momentum within one bf16 ulp (2^-7 of it: a momentum 1e-6 away
  in fp32 may round to the next bf16 value; seen once in 512).
* MoE configs: JAX's dispatch clobbers a kept slot when an expert
  overflows (``tests/test_torch_lm.py``), so where slots drop they are held
  to JAX with the kept-only dispatch (``_kept_only_moe_apply``), and with
  room for every token (capacity factor E / k) to JAX as shipped.
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.core import compat
from repro.data import synthetic as jsynthetic
from repro.launch import cells as jcells
from repro.launch import mesh as mesh_mod
from repro.launch import train as jtrain
from repro.launch.materialize import materialize as jmaterialize
from repro.launch.materialize import materialize_bundle
from repro.models import common as jcm
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch.configs import registry
from repro_torch.core import convert
from repro_torch.data import synthetic
from repro_torch.launch import cells
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import lm
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts

sys.path.insert(0, __file__.rsplit("/", 1)[0])
from test_torch_lm import JAX_CONFIGS, _kept_only_moe_apply  # noqa: E402

TOL = 1e-5
BF16_LOSS_TOL = 2.0 ** -7
BF16_RTOL = 2.0 ** -7            # one bf16 ulp, at most 2^-7 of the value
ADAM_SENSITIVE = 1e-6
LR = 0.01
ARCHS = list(registry.LM_ARCHS)
MOE_ARCHS = ["deepseek-v3-671b", "qwen3-moe-235b-a22b"]
B, S, CHUNK = 2, 40, 16          # the loss's and attention's chunk: 16


@pytest.fixture(scope="module")
def mesh():
    return mesh_mod.make_local_mesh()


@pytest.fixture(scope="module")
def mi(mesh):
    return jcm.MeshInfo.from_mesh(mesh)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def tt(a) -> torch.Tensor:
    return convert._from_numpy(np.asarray(a), "cpu")


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _equal(got: torch.Tensor, want) -> bool:
    w = tt(want)
    return got.dtype == w.dtype and torch.equal(_bits(got), _bits(w))


def _rel(got, want) -> float:
    """max |got - want| / max |want|."""
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _configs(arch, **kw):
    return (dataclasses.replace(JAX_CONFIGS[arch].SMOKE, **kw),
            dataclasses.replace(registry.LM_ARCHS[arch].SMOKE, **kw))


def _room(jcfg, cfg):
    """Both configs with a capacity factor of E / k: no slot drops."""
    def r(c):
        return dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=c.moe.n_experts / c.moe.top_k))
    return r(jcfg), r(cfg)


def _jparams(jcfg):
    params, _ = jcm.unbox(jlm.lm_init(jax.random.key(0), jcfg))
    return _np(params)


def _tokens(cfg, b=B, s=S, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)) \
        .astype(np.int32)


class _dispatch:
    """JAX's MoE with the kept-only dispatch while inside (``kept``)."""

    def __init__(self, kept: bool):
        self.kept = kept

    def __enter__(self):
        self.old = jmoe.moe_apply
        if self.kept:
            jmoe.moe_apply = _kept_only_moe_apply

    def __exit__(self, *exc):
        jmoe.moe_apply = self.old


# ---------------------------------------------------------------------------
# the optimizer: the clipped gradient in fp32, the in-place update
# ---------------------------------------------------------------------------
def _exact_tree(rng):
    """bf16 and fp32 leaves whose every reduction is exact (module
    docstring: no mean over more than two elements): an embedding
    (row-wise Adagrad), a stack of 2 x 1 matrices, a 2 x 2 matrix and a
    vector."""
    bf = ml_dtypes.bfloat16
    return {"embed": rng.normal(size=(8, 2)).astype(bf),
            "layers": {"w": rng.normal(size=(16, 2, 1)).astype(bf),
                       "b": rng.normal(size=(2, 2)).astype(np.float32)},
            "v": rng.normal(size=(6,)).astype(bf)}


@pytest.mark.parametrize("clip", [1.0, 0.0, 1e4])
@pytest.mark.parametrize("rule", ["adam", "adafactor", "adagrad_rows"])
def test_apply_updates_matches_jax_bitwise_on_bf16_leaves(rule, clip):
    """Three steps of both packages' ``apply_updates`` on the same bf16,
    fp32 and mixed leaves, with integer gradients (every sum exact): the
    clip active (1.0; the global norm ~ 40), off (0) and inactive (1e4).
    Parameters, state and norm bitwise.  With the clip active this fails
    where a bf16 gradient is scaled in bf16 (torch's ``bf16 * 0-dim
    fp32``): JAX scales it in fp32."""
    rng = np.random.default_rng(0)
    tree = _exact_tree(rng)
    jcfg = jopt.OptConfig(lr=0.05, dense_rule=rule, grad_clip=clip)
    cfg = opt.OptConfig(lr=0.05, dense_rule=rule, grad_clip=clip)
    jp = jax.tree.map(jnp.asarray, tree)
    js = jopt.init_opt_state(jp, jcfg)
    p = convert.params_from_reference(tree, "cpu")
    s = opt.init_opt_state(p, cfg)
    for step in (1, 2, 3):
        g = jax.tree.map(lambda a: rng.integers(-3, 4, size=a.shape)
                         .astype(a.dtype), tree)
        jp, js, jn = jopt.apply_updates(jp, jax.tree.map(jnp.asarray, g),
                                        js, jcfg, jnp.int32(step))
        p, s, n = opt.apply_updates(
            p, convert.params_from_reference(g, "cpu"), s, cfg, step)
        assert float(n) == float(jn)
        for k, w in convert.flatten_tree(_np(jp)).items():
            assert _equal(p[k], w), (step, k)
        for k, w in convert.flatten_tree(_np(js)).items():
            path, name = k.rsplit("/", 1)
            assert _equal(s[path][name], w), (step, k)


@pytest.mark.parametrize("rule", ["adam", "adafactor", "adagrad_rows"])
def test_in_place_update_matches_functional_bitwise(rule, monkeypatch):
    """``apply_updates_`` against ``apply_updates`` on random bf16 and
    fp32 leaves (a stack, an expert stack, a table, a matrix, a vector) at
    blocks of 64 elements, the clip active: every parameter and state
    entry the same bits, the same norm; the gradients dropped."""
    monkeypatch.setattr(opt, "BLOCK_ELEMENTS", 64)
    rng = np.random.default_rng(1)
    shapes = {"dense_layers/w": ((3, 8, 16), torch.bfloat16),
              "moe_layers/w": ((2, 4, 8, 16), torch.bfloat16),
              "embed": ((40, 8), torch.bfloat16),
              "mtp/proj": ((16, 8), torch.float32),
              "final_ln": ((24,), torch.bfloat16)}
    cfg = opt.OptConfig(lr=0.05, dense_rule=rule)

    def draw():
        return {k: torch.from_numpy(rng.normal(size=sh) * 3).to(dt)
                for k, (sh, dt) in shapes.items()}
    params = draw()
    state = opt.init_opt_state(params, cfg)
    p1, s1 = params, state
    p2 = {k: v.clone() for k, v in params.items()}
    s2 = {k: {n: t.clone() for n, t in st.items()} for k, st in state.items()}
    for step in (1, 2):
        g = draw()
        p1, s1, n1 = opt.apply_updates(p1, g, s1, cfg, step)
        left = dict(g)
        n2 = opt.apply_updates_(p2, left, s2, cfg, step)
        assert not left and torch.equal(n1, n2)
        for k in p1:
            assert torch.equal(_bits(p1[k]), _bits(p2[k])), (step, k)
            for n in s1[k]:
                assert torch.equal(_bits(s1[k][n]), _bits(s2[k][n])), (k, n)


def test_update_blocks_keep_each_rules_unit():
    """Adafactor's blocks are whole matrices of the last two axes;
    row-wise Adagrad's whole rows; Adam's any elements."""
    p = torch.zeros(3, 5, 7, 9)
    st = opt._leaf_state("adafactor", p)
    blocks = opt.update_blocks("adafactor", p, st)
    assert all(b.shape[1:] == (7, 9) and sb["vr"].shape[1:] == (7,)
               and sb["vc"].shape[1:] == (9,) for b, sb in blocks)
    assert sum(b.shape[0] for b, _ in blocks) == 15
    rows = opt.update_blocks("adagrad_rows", torch.zeros(10, 4, 3),
                             {"acc": torch.zeros(10)})
    assert all(b.shape[1] == 12 and sb["acc"].shape[0] == b.shape[0]
               for b, sb in rows)
    small = torch.zeros(2, 3)
    assert opt.update_blocks("adafactor", small,
                             opt._leaf_state("adafactor", small))[0][0] \
        is small


# ---------------------------------------------------------------------------
# the chunked cross entropy
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("s,project", [(12, False), (32, False), (39, False),
                                       (39, True)])
def test_chunked_xent_matches_jax(s, project, mi):
    """At a chunk of 16: one projection (s <= chunk), two whole chunks, a
    padded third, and MTP's projection (no final norm): the loss and its
    gradients with respect to h, ``unembed`` and ``final_ln`` at 1e-5."""
    jcfg, cfg = _configs("qwen3-14b", dtype="float32", loss_chunk=CHUNK)
    jp = _jparams(jcfg)
    rng = np.random.default_rng(2)
    h = rng.normal(size=(B, s, jcfg.d_model)).astype(np.float32)
    tg = rng.integers(0, jcfg.vocab, (B, s)).astype(np.int32)

    def jloss(leaves, h):
        p = {**jp, **leaves}
        proj = (lambda hx: hx @ p["unembed"]) if project else None
        return jlm._chunked_xent(p, jcfg, h, jnp.asarray(tg), mi, proj)
    jleaves = {k: jnp.asarray(jp[k]) for k in ("unembed", "final_ln")}
    want, (jg, jgh) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jleaves, jnp.asarray(h))

    params = convert.lm_from_reference(jp, cfg, "cpu")
    leaves = {k: params[k].clone().requires_grad_()
              for k in ("unembed", "final_ln")}
    th = torch.from_numpy(h).requires_grad_()
    p = {**params, **leaves}
    proj = (lambda hx: hx @ p["unembed"]) if project else None
    got = lm._chunked_xent(p, cfg, th, torch.from_numpy(tg), proj)
    grads = torch.autograd.grad(got, [th, *leaves.values()],
                                allow_unused=True)
    assert abs(got.item() - float(want)) <= TOL * abs(float(want))
    assert _rel(grads[0], jgh) <= TOL
    for (k, g) in zip(leaves, grads[1:]):
        w = np.asarray(jg[k])
        if project and k == "final_ln":
            assert g is None and not w.any()
        else:
            assert _rel(g, w) <= TOL, k


# ---------------------------------------------------------------------------
# lm_loss: loss, metrics, gradients
# ---------------------------------------------------------------------------
JAX_LOSS = {}


def jax_loss(mesh, mi, jcfg, jp, tokens, kept: bool):
    """JAX's ``value_and_grad(lm_loss)`` -> (loss, metrics, {path:
    float32 gradient}), once per module."""
    key = (jcfg, kept)
    if key not in JAX_LOSS:
        fn = jax.jit(jax.value_and_grad(
            lambda p, b: jlm.lm_loss(p, jcfg, b, mesh, mi), has_aux=True))
        with _dispatch(kept), compat.set_mesh(mesh):
            (loss, metrics), g = fn(jp, {"tokens": jnp.asarray(tokens)})
        JAX_LOSS[key] = (float(loss), {k: float(v) for k, v in
                                       metrics.items()},
                         {k: np.asarray(v, np.float32) for k, v in
                          convert.flatten_tree(_np(g)).items()})
    return JAX_LOSS[key]


def port_loss(cfg, params, tokens):
    loss, metrics, grads = ts._value_and_grad(
        ts.lm_loss_fn(cfg), params, {"tokens": torch.from_numpy(tokens)})
    return loss.item(), {k: v.item() for k, v in metrics.items()}, grads


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_matches_jax_float32(arch, remat, mesh, mi):
    """seq 40 at query and loss chunks of 16 (the padded branch): the
    loss, every metric (``xent``, ``moe_aux``, ``moe_dropped``, ``mtp``,
    ``loss``) and every gradient leaf at 1e-5; an MoE config against JAX's
    kept-only dispatch, and with room for every token against JAX as
    shipped."""
    kw = dict(dtype="float32", loss_chunk=CHUNK, q_chunk=CHUNK, remat=remat)
    jcfg, cfg = _configs(arch, **kw)
    runs = [(jcfg, cfg, jcfg.moe is not None)]
    if jcfg.moe is not None:
        runs.append((*_room(jcfg, cfg), False))
    for jc, c, kept in runs:
        jp = _jparams(jc)
        tokens = _tokens(c)
        want_l, want_m, want_g = jax_loss(mesh, mi, dataclasses.replace(
            jc, remat=False), jp, tokens, kept)
        got_l, got_m, got_g = port_loss(
            c, convert.lm_from_reference(jp, c, "cpu"), tokens)
        assert abs(got_l - want_l) <= TOL * abs(want_l)
        assert set(got_m) == set(want_m)
        for k, w in want_m.items():
            assert abs(got_m[k] - w) <= TOL * max(abs(w), 1.0), k
        assert list(got_g) == list(want_g)
        for k, w in want_g.items():
            assert got_g[k].dtype == torch.float32
            assert _rel(got_g[k], w) <= TOL, k


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_matches_jax_bf16(arch, remat, mesh, mi):
    """The configs as published (bf16), the same chunks: each gradient
    leaf (bf16) no further from JAX's float32 gradient than twice JAX's
    own bf16 gradient, normwise; the losses within ``BF16_LOSS_TOL`` of
    JAX's bf16; every metric finite."""
    kw = dict(loss_chunk=CHUNK, q_chunk=CHUNK, remat=remat)
    jcfg, cfg = _configs(arch, **kw)
    jp = _jparams(jcfg)
    tokens = _tokens(cfg)
    kept = jcfg.moe is not None
    j32 = dataclasses.replace(jcfg, dtype="float32", remat=False)
    _, _, g32 = jax_loss(mesh, mi, j32, jax.tree.map(
        lambda a: a.astype(np.float32), jp), tokens, kept)
    jl, jm, g16 = jax_loss(mesh, mi, dataclasses.replace(jcfg, remat=False),
                           jp, tokens, kept)
    got_l, got_m, got_g = port_loss(
        cfg, convert.lm_from_reference(jp, cfg, "cpu"), tokens)
    assert np.isfinite(list(got_m.values())).all()
    for k in ("loss", "xent", "mtp"):
        if k in jm:
            assert abs(got_m[k] - jm[k]) <= BF16_LOSS_TOL * abs(jm[k]), k
    for k, w in g32.items():
        assert got_g[k].dtype == cfg.torch_dtype \
            or k.endswith("moe/router")
        n = np.linalg.norm(w)
        mine = np.linalg.norm(got_g[k].float().numpy() - w) / n
        theirs = np.linalg.norm(g16[k] - w) / n
        assert mine <= 2 * theirs, (k, mine, theirs)


def test_lm_loss_without_remat_equals_remat_bitwise():
    """The layer remat recomputes the same forward: the loss and every
    gradient the same bits (qwen3-14b's and deepseek-v3's SMOKE, bf16)."""
    for arch in ("qwen3-14b", "deepseek-v3-671b"):
        cfg = dataclasses.replace(registry.LM_ARCHS[arch].SMOKE,
                                  loss_chunk=CHUNK, q_chunk=CHUNK)
        params = lm.lm_init(cfg, seed=3, device="cpu")
        tokens = _tokens(cfg)
        a = port_loss(dataclasses.replace(cfg, remat=True), params, tokens)
        b = port_loss(cfg, params, tokens)
        assert a[0] == b[0] and a[1] == b[1]
        for k in a[2]:
            assert torch.equal(_bits(a[2][k]), _bits(b[2][k])), k


def test_layers_unbind_each_stack_once():
    """Under autograd a stack is one node: ``layers`` unbinds each leaf
    once, and the gradient of a stack comes back whole."""
    cfg = registry.LM_ARCHS["qwen3-14b"].SMOKE
    params = {k: v.detach().requires_grad_() for k, v in
              lm.lm_init(cfg, seed=0, device="cpu").items()}
    views = lm.layers(params, "dense_layers")
    assert len(views) == cfg.n_layers
    fns = {views[i]["attn/wq"].grad_fn for i in range(cfg.n_layers)}
    assert len(fns) == 1 and "Unbind" in type(fns.pop()).__name__
    loss, _ = lm.lm_loss(params, cfg, {"tokens": torch.from_numpy(
        _tokens(cfg))})
    g, = torch.autograd.grad(loss, [params["dense_layers/attn/wq"]])
    assert g.shape == params["dense_layers/attn/wq"].shape


# ---------------------------------------------------------------------------
# two train steps against JAX's
# ---------------------------------------------------------------------------
def _sign_like(state: dict, k: str, rule: str, step: int):
    """Where leaf ``k``'s step is a sign (its per-element second moment's
    root below ``ADAM_SENSITIVE``: Adam's v-hat, Adafactor's unfactored v
    of a vector), by JAX's state; else None."""
    if f"{k}/v" not in state:
        return None
    v = state[f"{k}/v"]
    if rule == "adam":
        v = v / (1 - 0.999 ** step)
    return np.sqrt(v) < ADAM_SENSITIVE


def _assert_params_close(got: dict, want: dict, state: dict, rule: str,
                         step: int):
    for k, w in want.items():
        err = np.abs(got[k].float().numpy() - w)
        bound = np.full(w.shape, TOL) + TOL * np.abs(w)
        sign = _sign_like(state, k, rule, step)
        if sign is not None:
            bound = np.where(sign, LR, bound)
        assert (err <= bound).all(), (k, float(err.max()))


def _assert_state_close(got: dict, want: dict, rule: str, step: int):
    """fp32 state at 1e-5, bf16 within one ulp; a sign-like element's
    momentum within 2 (1 - b1), the most a flipped sign moves it."""
    for k, w in want.items():
        path, name = k.rsplit("/", 1)
        g = got[path][name].float().numpy()
        rtol = BF16_RTOL if got[path][name].dtype == torch.bfloat16 else TOL
        sign = _sign_like(want, path, rule, step)
        if name == "m" and sign is not None:
            g = np.where(sign, w, g)
            assert (np.abs(got[path][name].float().numpy() - w)[sign]
                    <= 0.2 + TOL).all(), k
        np.testing.assert_allclose(g, w, rtol=rtol, atol=TOL, err_msg=k)


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("rule", ["adam", "adafactor"])
@pytest.mark.parametrize("arch", ["qwen3-14b", "deepseek-v3-671b"])
def test_two_train_steps_match_jax(arch, rule, accum, mesh, mi):
    """Two steps of ``make_train_step(lm_loss_fn)`` (in place) against the
    JAX package's, each from JAX's parameters and state of the step before
    (carried across by ``convert``), float32, 4 x 40 tokens a step (two
    microbatches of 2 with ``accum``), Adam or Adafactor on the layers
    (forced on SMOKE), row-wise Adagrad on the tables: loss, grad_norm,
    parameters and state (deepseek-v3 with the kept-only dispatch)."""
    jcfg, cfg = _configs(arch, dtype="float32", loss_chunk=CHUNK,
                         q_chunk=CHUNK)
    jocfg = jopt.OptConfig(lr=LR, dense_rule=rule)
    ocfg = opt.OptConfig(lr=LR, dense_rule=rule)
    with _dispatch(jcfg.moe is not None):
        jfn = jax.jit(jts.make_train_step(jts.lm_loss_fn(jcfg, mesh, mi),
                                          jocfg, accum_steps=accum))
        fn = ts.make_train_step(ts.lm_loss_fn(cfg), ocfg,
                                accum_steps=accum, in_place=True)
        jp = jax.tree.map(jnp.asarray, _jparams(jcfg))
        js = jopt.init_opt_state(jp, jocfg)
        jstep = jnp.int32(0)
        for i in range(2):
            tokens = _tokens(cfg, b=4, seed=10 + i)
            p = convert.lm_from_reference(_np(jp), cfg, "cpu")
            s = convert.opt_state_from_reference(_np(js), "cpu")
            with compat.set_mesh(mesh):
                jp, js, jstep, jm = jfn(jp, js, jstep,
                                        {"tokens": jnp.asarray(tokens)})
            p2, s2, step, m = fn(p, s, i, {"tokens": torch.from_numpy(
                tokens)})
            assert p2 is p and s2 is s and step == int(jstep) == i + 1
            for k in ("loss", "grad_norm"):
                assert abs(m[k].item() - float(jm[k])) \
                    <= TOL * abs(float(jm[k])), k
            state = {k: np.asarray(v, np.float32) for k, v in
                     convert.flatten_tree(_np(js)).items()}
            _assert_params_close(p, {k: np.asarray(v, np.float32) for k, v
                                     in convert.flatten_tree(
                                         _np(jp)).items()}, state, rule,
                                 i + 1)
            _assert_state_close(s, state, rule, i + 1)


def test_in_place_step_equals_functional_step():
    """The LM step in place and functional: the same loss, parameters
    and state, bit for bit (deepseek-v3's SMOKE, bf16, Adafactor)."""
    cfg = registry.LM_ARCHS["deepseek-v3-671b"].SMOKE
    ocfg = opt.OptConfig(dense_rule="adafactor")
    params = lm.lm_init(cfg, seed=4, device="cpu")
    p1, s1 = params, opt.init_opt_state(params, ocfg)
    p2 = {k: v.clone() for k, v in params.items()}
    s2 = opt.init_opt_state(p2, ocfg)
    f1 = ts.make_train_step(ts.lm_loss_fn(cfg), ocfg)
    f2 = ts.make_train_step(ts.lm_loss_fn(cfg), ocfg, in_place=True)
    for i in range(2):
        batch = {"tokens": torch.from_numpy(_tokens(cfg, s=17, seed=i))}
        p1, s1, _, m1 = f1(p1, s1, i, batch)
        _, _, _, m2 = f2(p2, s2, i, batch)
        assert m1["loss"].item() == m2["loss"].item()
    for k in p1:
        assert torch.equal(_bits(p1[k]), _bits(p2[k])), k
        for n in s1[k]:
            assert torch.equal(_bits(s1[k][n]), _bits(s2[k][n])), (k, n)


# ---------------------------------------------------------------------------
# the optimizer rule, lm_batch, checkpoints
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_opt_cfg_is_the_cell_builders_and_kept_when_cut(arch):
    """``cells.opt_cfg`` is the JAX cell builder's ``_opt_cfg`` for the
    published and the SMOKE config; a config cut in depth keeps its
    published depth's rule (qwen3-14b cut to 30 layers stays on
    Adafactor, where the cell builder would fall to Adam); the recsys and
    GNN families train with ``OptConfig()``."""
    spec = jregistry.get(arch)
    configs = registry.LM_ARCHS[arch]
    for cfg, jcfg in ((configs.CONFIG, spec.config),
                      (configs.SMOKE, spec.smoke)):
        assert dataclasses.asdict(cells.opt_cfg("lm", cfg)) == \
            dataclasses.asdict(jcells._opt_cfg("lm", jcfg))
    cut = dataclasses.replace(configs.CONFIG, n_layers=2)
    assert cells.published_layers(cut) == configs.CONFIG.n_layers
    assert cells.opt_cfg("lm", cut) == cells.opt_cfg("lm", configs.CONFIG)
    if arch == "qwen3-14b":
        cut30 = dataclasses.replace(configs.CONFIG, n_layers=30)
        assert cells.opt_cfg("lm", cut30).dense_rule == "adafactor"
        assert jcells._opt_cfg("lm", dataclasses.replace(
            spec.config, n_layers=30)).dense_rule == "adam"
    for family in ("recsys", "gnn"):
        assert cells.opt_cfg(family, configs.CONFIG) == opt.OptConfig()
    assert opt.rule_for_path("unembed", cells.opt_cfg(
        "lm", configs.CONFIG)) == "adagrad_rows"


def test_lm_batch_is_the_jax_packages():
    for seed in (0, 5):
        want = jsynthetic.lm_batch(np.random.default_rng(seed), 3, 17, 500)
        got = synthetic.lm_batch(np.random.default_rng(seed), 3, 17, 500)
        assert got["tokens"].dtype == np.int32
        np.testing.assert_array_equal(got["tokens"], want["tokens"])


def test_lm_checkpoint_resumes_bitwise(tmp_path):
    """deepseek-v3's SMOKE (bf16 leaves, Adafactor's bf16 momentum, the
    MoE's fp32 router): two steps, a save, a third step; restored from the
    save into fresh tensors, the third step again: every parameter and
    state entry the same bits."""
    cfg = registry.LM_ARCHS["deepseek-v3-671b"].SMOKE
    ocfg = opt.OptConfig(dense_rule="adafactor")
    fn = ts.make_train_step(ts.lm_loss_fn(cfg), ocfg, in_place=True)
    params = lm.lm_init(cfg, seed=5, device="cpu")
    state = opt.init_opt_state(params, ocfg)
    batches = [{"tokens": torch.from_numpy(_tokens(cfg, s=17, seed=20 + i))}
               for i in range(3)]
    step = 0
    for b in batches[:2]:
        params, state, step, _ = fn(params, state, step, b)
    ckpt.save(str(tmp_path), params=params, opt_state=state, step=step,
              meta={"arch": cfg.name})
    like_p = lm.lm_init(cfg, seed=6, device="cpu")
    p2, s2, step2, meta = ckpt.restore(str(tmp_path), params_like=like_p,
                                       opt_like=opt.init_opt_state(
                                           like_p, ocfg))
    assert step2 == 2 and meta == {"arch": cfg.name}
    params, state, _, m1 = fn(params, state, step, batches[2])
    p2, s2, _, m2 = fn(p2, s2, step2, batches[2])
    assert m1["loss"].item() == m2["loss"].item()
    for k in params:
        assert params[k].dtype == p2[k].dtype
        assert torch.equal(_bits(params[k]), _bits(p2[k])), k
        for n in state[k]:
            assert torch.equal(_bits(state[k][n]), _bits(s2[k][n])), (k, n)


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------
def _jax_train_losses(arch, mesh, steps: int):
    """The JAX train launcher's first ``steps`` losses at ``--smoke``: its
    cell, its materialised parameters and its batches (MoE configs with
    the kept-only dispatch)."""
    spec = jregistry.get(arch)
    with _dispatch(spec.smoke.moe is not None):
        bundle = jcells.build_cell(arch, "train_4k", mesh, smoke=True)
        params, state, step = materialize_bundle(bundle, seed=0)[:3]
        fn = jax.jit(bundle.fn)
        rng = np.random.default_rng(0)
        losses = []
        with compat.set_mesh(mesh):
            for _ in range(steps):
                batch = jtrain._real_batch(spec, spec.smoke, bundle.cell,
                                           rng)
                params, state, step, m = fn(params, state, step, batch)
                losses.append(float(m["loss"]))
    return losses


@pytest.mark.parametrize("arch", ARCHS)
def test_train_launcher_trains_lm_smoke_as_the_jax_launcher(arch, mesh,
                                                            capsys):
    """``--smoke --device cpu --steps 3``: the rule printed, the
    parameters ``materialize``'d as the JAX launcher's, its batches; each
    loss within ``BF16_LOSS_TOL`` of the JAX launcher's step."""
    out = launch_train.main(["--arch", arch, "--smoke", "--device", "cpu",
                             "--steps", "3"])
    printed = capsys.readouterr().out
    cfg = registry.LM_ARCHS[arch].SMOKE
    assert (out["shape"], out["rows"], out["step"]) == ("train_4k", 2, 3)
    assert f"{cfg.name}/train_4k: adam (d_model" in printed
    assert "parameters: materialize(seed=0)" in printed and "done" in printed
    want = _jax_train_losses(arch, mesh, 3)
    for got, w in zip(out["losses"], want):
        assert abs(got - w) <= BF16_LOSS_TOL * abs(w), (out["losses"], want)
    assert np.isfinite(out["grad_norms"]).all()


def test_train_launcher_lm_resumes(tmp_path, capsys):
    d = str(tmp_path / "ck")
    out = launch_train.main(["--arch", "qwen3-14b", "--smoke", "--device",
                             "cpu", "--steps", "2", "--ckpt-every", "2",
                             "--ckpt-dir", d])
    assert out["rows"] == 2 and ckpt.exists(d)
    out = launch_train.main(["--arch", "qwen3-14b", "--smoke", "--device",
                             "cpu", "--steps", "1", "--ckpt-dir", d])
    assert out["step"] == 3 and "resumed at step 2" in \
        capsys.readouterr().out


@pytest.mark.parametrize("arch", ["qwen3-14b", "deepseek-v3-671b"])
def test_serve_train_requests_are_the_jax_launchers(arch, mesh):
    """The serve launcher's train_4k request i is ``materialize(
    bundle.args[1:], seed=i + 1)`` of the JAX cell builder's bundle, bit
    for bit: the optimizer state, the step and the tokens."""
    bundle = jcells.build_cell(arch, "train_4k", mesh, smoke=True)
    cfg = registry.LM_ARCHS[arch].SMOKE
    cell = registry.reduce_cell(registry.cell_by_name("train_4k", "lm"))
    for seed in (1, 2):
        want = jmaterialize(bundle.args[1:], seed=seed)
        state, step, batch = launch_serve.lm_train_request(
            cfg, cells.opt_cfg("lm", cfg), cell, cell.dims["batch"], seed,
            torch.device("cpu"))
        jstate = convert.flatten_tree(_np(want[0]))
        assert sorted(jstate) == sorted(f"{k}/{n}" for k, st in
                                        state.items() for n in st)
        for k, w in jstate.items():
            path, name = k.rsplit("/", 1)
            assert _equal(state[path][name], w), k
        assert step == int(want[1])
        assert _equal(batch["tokens"], want[2]["tokens"])


@pytest.mark.parametrize("arch", ["qwen3-14b", "qwen3-moe-235b-a22b"])
def test_serve_train_4k_answers_the_jax_launchers_losses(arch, mesh):
    """``--shape train_4k --smoke --device cpu --requests 2``: each
    request a train step from the launcher's parameters on its
    materialised state and tokens; its loss within ``BF16_LOSS_TOL`` of the
    JAX launcher's step on the same (the MoE with the kept-only
    dispatch)."""
    out = launch_serve.main(["--arch", arch, "--shape", "train_4k",
                             "--smoke", "--device", "cpu", "--requests",
                             "2"])
    assert out["finite"] and out["rule"] == "adam"
    spec = jregistry.get(arch)
    with _dispatch(spec.smoke.moe is not None):
        bundle = jcells.build_cell(arch, "train_4k", mesh, smoke=True)
        params = materialize_bundle(bundle, seed=0)[0]
        fn = jax.jit(bundle.fn)
        with compat.set_mesh(mesh):
            want = [float(fn(params, *jmaterialize(bundle.args[1:],
                                                   seed=i + 1))[3]["loss"])
                    for i in range(2)]
    for got, w in zip(out["losses"], want):
        assert abs(got - w) <= BF16_LOSS_TOL * abs(w), (out["losses"], want)
