"""The port's LM serving slice against the JAX package, on the CPU: the
norms and rope, the chunked attention core, GQA and MLA prefill and decode
(outputs and caches), the MoE (output, aux loss, dropped share, and the
reference's clobbered slot), the five LM configs' prefill and chained
decode, ``materialize``, the converter, the cells and the launchers.
Parameters come from the JAX package's ``lm_init`` / ``*_init`` (key 0
unless stated), carried across by ``core/convert.lm_from_reference`` or
``convert.flatten_tree``.

Tolerances, each with its reason:

* integers, ``materialize``'s draws, bf16 weights across the converter:
  bitwise (the same numpy draws; the same bytes).
* float32 model outputs and caches: 1e-5 (rtol and atol), the port's
  model-output tolerance: fp32 sums (products, softmax, norms) taken in
  other orders by the two packages.
* ``rope_angles``: the inverse frequencies are fp32's ``1 / base ** (2i /
  dim)`` in both packages, and at base 1e6 one may lie an ulp away
  (measured: one of 64 at dim 128, the cosine then 1.2e-5 off at position
  524,287); so each cosine and sine is held to position x one ulp of its
  inverse frequency, plus one ulp of the angle (its rounding) and 2^-23
  (the result's).  At base 1e4 the angles are bitwise, the results 2^-23.
* bf16 (the configs as published): logits within 3e-2 of the largest
  |logit| (atol), caches within 3e-2 of their largest entry.  Measured on
  the CPU: 2.04e-2 (deepseek-v3-671b), 1.34e-2 (qwen3-14b), 1.23e-2
  (deepseek-7b), 1.15e-2 (qwen3-moe), 9.1e-3 (nemotron).  The two packages
  round bf16 intermediates at different points (XLA each op's result,
  PyTorch's CPU kernels keep some accumulators in fp32), and single
  roundings of 2^-8 grow through the layers: the port's bf16 logits lie as
  far from JAX's bf16 as JAX's bf16 lie from its own float32 (1.34e-2 for
  qwen3-14b, 1.06e-2 for nemotron).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import deepseek_7b as jdeepseek_7b
from repro.configs import deepseek_v3_671b as jdeepseek_v3
from repro.configs import nemotron_4_340b as jnemotron
from repro.configs import qwen3_14b as jqwen3_14b
from repro.configs import qwen3_moe_235b as jqwen3_moe
from repro.configs import registry as jregistry
from repro.core import compat
from repro.core.distributed import route_by_owner as jroute_by_owner
from repro.launch import cells as jcells
from repro.launch import materialize as jmat
from repro.launch import mesh as mesh_mod
from repro.models import attention as jattn
from repro.models import common as jcm
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.serve import serve_step as jss
from repro_torch.configs import registry
from repro_torch.core import convert
from repro_torch.launch import materialize as mat
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import attention as attn
from repro_torch.models import common as cm
from repro_torch.models import lm
from repro_torch.models import moe
from repro_torch.serve import serve_step

TOL = 1e-5
BF16_TOL = 3e-2       # of max |logit| (module docstring)
JAX_CONFIGS = {"qwen3-14b": jqwen3_14b, "deepseek-7b": jdeepseek_7b,
               "nemotron-4-340b": jnemotron, "deepseek-v3-671b": jdeepseek_v3,
               "qwen3-moe-235b-a22b": jqwen3_moe}
ARCHS = list(registry.LM_ARCHS)
MOE_ARCHS = ["deepseek-v3-671b", "qwen3-moe-235b-a22b"]
DECODE_STEPS = 4
B, S = 2, 32                    # registry.reduce_cell's LM size


@pytest.fixture(scope="module")
def mesh():
    m = mesh_mod.make_local_mesh()
    assert dict(zip(m.axis_names, m.devices.shape))["model"] == 1
    return m


@pytest.fixture(scope="module")
def mi(mesh):
    return jcm.MeshInfo.from_mesh(mesh)


def tt(a) -> torch.Tensor:
    """A JAX or numpy array -> a CPU tensor of the same dtype (bf16 by its
    bytes)."""
    return convert._from_numpy(np.asarray(a), "cpu")


def nn(t: torch.Tensor) -> np.ndarray:
    """A copy (the decode caches change in place)."""
    return t.detach().float().numpy().copy()


def close(got, want, tol=TOL):
    np.testing.assert_allclose(nn(got) if isinstance(got, torch.Tensor)
                               else np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def jparams(init, *args):
    """A JAX ``*_init``'s unboxed tree with numpy leaves."""
    params, _ = jcm.unbox(init(jax.random.key(0), *args))
    return jax.tree.map(np.asarray, params)


def f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


# ---------------------------------------------------------------------------
# norms, rope
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_rms_norm_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(3, 5, 64)) * 3, dtype)
    g = jnp.asarray(rng.normal(size=(64,)), dtype)
    want = jcm.rms_norm(x, g)
    got = cm.rms_norm(tt(x), tt(g))
    assert got.dtype == tt(want).dtype
    # fp32 inside both: one rounding of the product apart at most
    close(got, want, 1e-6 if dtype == jnp.float32 else 2 ** -8)


POSITIONS = np.array([0, 1, 2, 7, 1000, 32767, 65535, 131071, 300001,
                      524287], np.int32)


@pytest.mark.parametrize("base", [1e4, 1e6])
@pytest.mark.parametrize("dim", [16, 64, 128])
def test_rope_angles_match_jax_to_position_524287(base, dim):
    pos = POSITIONS[None]
    jc, js = jcm.rope_angles(jnp.asarray(pos), dim, base)
    tc, ts = cm.rope_angles(torch.from_numpy(pos), dim, base)
    inv = np.asarray(1.0 / (base ** (jnp.arange(0, dim, 2,
                                                dtype=jnp.float32) / dim)))
    # one ulp of the inverse frequency moves an angle by position x that
    # ulp, plus one rounding of the angle; then one rounding of the result
    ang = pos[..., None].astype(np.float32) * inv
    bound = (pos[..., None].astype(np.float64) * np.spacing(inv)
             + np.spacing(ang) + 2 ** -23)
    for got, want in ((tc, jc), (ts, js)):
        assert got.shape == want.shape and got.dtype == torch.float32
        err = np.abs(got.numpy().astype(np.float64) - np.asarray(want))
        assert (err <= bound).all(), float((err - bound).max())
        if base == 1e4:
            assert err.max() <= 2 ** -23


def test_apply_rope_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 9, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 524288, (2, 9)).astype(np.int32)
    jc, js = jcm.rope_angles(jnp.asarray(pos), 16, 1e4)
    want = jcm.apply_rope(jnp.asarray(x), jc[:, :, None], js[:, :, None])
    got = cm.apply_rope(torch.from_numpy(x), tt(jc)[:, :, None],
                        tt(js)[:, :, None])
    close(got, want, 1e-6)
    # rotate-half: the halves of the last axis, not interleaved pairs
    c0 = torch.zeros(1, 1, 1, 8)
    s1 = torch.ones(1, 1, 1, 8)
    xs = torch.arange(16.0).view(1, 1, 1, 16)
    assert cm.apply_rope(xs, c0, s1).flatten().tolist() == \
        [-v for v in range(8, 16)] + list(range(8))


def test_squared_relu_matches_jax():
    x = np.linspace(-3, 3, 41).astype(np.float32)
    close(cm.squared_relu(torch.from_numpy(x)),
          jcm.squared_relu(jnp.asarray(x)), 0)


# ---------------------------------------------------------------------------
# the attention core, GQA, MLA
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("sq,q_chunk,causal", [
    (24, 24, True), (24, 8, True), (21, 8, True), (21, 8, False),
    (5, 16, True)])
def test_chunked_attention_matches_jax(sq, q_chunk, causal):
    """One chunk, several, a length that is not a chunk multiple, and the
    unmasked core."""
    rng = np.random.default_rng(sq * 100 + q_chunk)
    b, hkv, g, dh, dv = 2, 2, 3, 8, 6
    q = rng.normal(size=(b, sq, hkv, g, dh)).astype(np.float32)
    k = rng.normal(size=(b, sq, hkv, dh)).astype(np.float32)
    v = rng.normal(size=(b, sq, hkv, dv)).astype(np.float32)
    want = jax.jit(lambda q, k, v: jattn._chunked_attention(
        q, k, v, q_chunk=q_chunk, causal=causal))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = attn._chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), q_chunk=q_chunk,
                                  causal=causal)
    close(got, want)


def _gqa_cfg(qk_norm):
    return attn.GQAConfig(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
                          qk_norm=qk_norm, rope_base=1e6, q_chunk=8)


def _jgqa(cfg):
    return jattn.GQAConfig(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("qk_norm", [False, True])
def test_gqa_apply_and_decode_match_jax(mesh, mi, qk_norm):
    cfg = _gqa_cfg(qk_norm)
    jp = jparams(jattn.gqa_init, _jgqa(cfg), jnp.float32)
    p = convert.flatten_tree({k: tt(v) for k, v in jp.items()})
    assert set(p) == set(attn.gqa_specs(cfg))
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 19, 64)).astype(np.float32)
    with compat.set_mesh(mesh):
        want_y, want_c = jax.jit(lambda p, x: jattn.gqa_apply(
            p, _jgqa(cfg), x, mi, return_cache=True))(jp, jnp.asarray(x))
    got_y, got_c = attn.gqa_apply(p, cfg, torch.from_numpy(x),
                                  return_cache=True)
    close(got_y, want_y)
    for name in ("k", "v"):
        close(got_c[name], want_c[name])

    smax = 24
    kc = rng.normal(size=(2, smax, 2, 16)).astype(np.float32)
    vc = rng.normal(size=(2, smax, 2, 16)).astype(np.float32)
    xd = rng.normal(size=(2, 1, 64)).astype(np.float32)
    pos = np.array([5, 23], np.int32)
    with compat.set_mesh(mesh):
        want_y, want_c = jax.jit(lambda p, x, c, pos: jattn.gqa_decode(
            p, _jgqa(cfg), x, c, pos, mi))(
            jp, jnp.asarray(xd), {"k": jnp.asarray(kc), "v": jnp.asarray(vc)},
            jnp.asarray(pos))
    cache = {"k": torch.from_numpy(kc.copy()), "v": torch.from_numpy(vc.copy())}
    got_y, got_c = attn.gqa_decode(p, cfg, torch.from_numpy(xd), cache,
                                   torch.from_numpy(pos))
    assert got_c is cache                  # updated in place
    close(got_y, want_y)
    for name in ("k", "v"):
        close(got_c[name], want_c[name])


def _mla_cfg():
    return attn.MLAConfig(d_model=64, n_heads=4, q_lora=48, kv_lora=32,
                          dh_nope=16, dh_rope=8, dv=12, q_chunk=8)


def test_mla_apply_and_decode_match_jax(mesh, mi):
    cfg = _mla_cfg()
    jcfg = jattn.MLAConfig(**dataclasses.asdict(cfg))
    jp = jparams(jattn.mla_init, jcfg, jnp.float32)
    p = {k: tt(v) for k, v in jp.items()}
    assert set(p) == set(attn.mla_specs(cfg))
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 19, 64)).astype(np.float32)
    with compat.set_mesh(mesh):
        want_y, want_c = jax.jit(lambda p, x: jattn.mla_apply(
            p, jcfg, x, mi, return_cache=True))(jp, jnp.asarray(x))
    got_y, got_c = attn.mla_apply(p, cfg, torch.from_numpy(x),
                                  return_cache=True)
    close(got_y, want_y)
    for name in ("ckv", "kr"):
        close(got_c[name], want_c[name])

    smax = 24
    ckv = rng.normal(size=(2, smax, 32)).astype(np.float32)
    kr = rng.normal(size=(2, smax, 8)).astype(np.float32)
    xd = rng.normal(size=(2, 1, 64)).astype(np.float32)
    pos = np.array([0, 17], np.int32)
    with compat.set_mesh(mesh):
        want_y, want_c = jax.jit(lambda p, x, c, pos: jattn.mla_decode(
            p, jcfg, x, c, pos, mi))(
            jp, jnp.asarray(xd),
            {"ckv": jnp.asarray(ckv), "kr": jnp.asarray(kr)},
            jnp.asarray(pos))
    cache = {"ckv": torch.from_numpy(ckv.copy()),
             "kr": torch.from_numpy(kr.copy())}
    got_y, got_c = attn.mla_decode(p, cfg, torch.from_numpy(xd), cache,
                                   torch.from_numpy(pos))
    assert got_c is cache
    close(got_y, want_y)
    for name in ("ckv", "kr"):
        close(got_c[name], want_c[name])


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------
def _moe_cfgs(cfg):
    return moe.MoEConfig(**dataclasses.asdict(cfg)), cfg


def _jmoe_run(mesh, mi, jp, jcfg, x):
    fn = jax.jit(lambda p, x: jmoe.moe_apply(p, jcfg, x, mesh, mi))
    with compat.set_mesh(mesh):
        y, aux, dropped = fn(jp, jnp.asarray(x))
    return np.asarray(y), float(aux), float(dropped)


def _moe_port(jp, cfg, x):
    p = convert.flatten_tree({k: v for k, v in jp.items()})
    p = {k: tt(v) for k, v in p.items()}
    assert set(p) == set(moe.moe_specs(cfg))
    y, aux, dropped = moe.moe_apply(p, cfg, torch.from_numpy(x))
    return nn(y), float(aux), float(dropped)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_apply_matches_jax_with_room_for_every_token(mesh, mi, arch):
    """At a capacity factor of E / k no expert can overflow, so no slot is
    dropped or clobbered: output, aux and dropped share equal JAX's."""
    jcfg = JAX_CONFIGS[arch].SMOKE.moe
    jcfg = dataclasses.replace(jcfg, capacity_factor=jcfg.n_experts
                               / jcfg.top_k)
    cfg = moe.MoEConfig(**dataclasses.asdict(jcfg))
    jp = jparams(jmoe.moe_init, jcfg, jnp.float32)
    x = np.random.default_rng(4).normal(size=(2, 16, 64)).astype(np.float32)
    want = _jmoe_run(mesh, mi, jp, jcfg, x)
    got = _moe_port(jp, cfg, x)
    close(got[0], want[0])
    assert got[1] == pytest.approx(want[1], rel=TOL, abs=TOL)
    assert got[2] == want[2] == 0.0


def _hand_mixture(jp, jcfg, x, keep_slot):
    """Each token's top-k mixture of its SwiGLU experts in float64, from
    JAX's own router and top-k; only the slots ``keep_slot`` [t, k] says
    (and the shared experts)."""
    t = np.asarray(x, np.float64).reshape(-1, x.shape[-1])
    probs = jax.nn.softmax(jnp.asarray(t, jnp.float32) @ jp["router"], -1)
    topv, topi = jax.lax.top_k(probs, jcfg.top_k)
    topv = np.asarray(topv / topv.sum(-1, keepdims=True), np.float64)
    topi = np.asarray(topi)
    w = {k: np.asarray(v, np.float64) for k, v in jp.items()
         if k != "shared"}

    def swiglu(v, wg, wu, wd):
        h = v @ wg
        return (h / (1 + np.exp(-h)) * (v @ wu)) @ wd

    out = np.zeros_like(t)
    for i in range(len(t)):
        for j in range(jcfg.top_k):
            if keep_slot[i, j]:
                e = topi[i, j]
                out[i] += topv[i, j] * swiglu(t[i], w["w_gate"][e],
                                              w["w_up"][e], w["w_down"][e])
    if jcfg.n_shared:
        s = {k: np.asarray(v, np.float64) for k, v in jp["shared"].items()}
        out += swiglu(t, s["w_gate"], s["w_up"], s["w_down"])
    return out, topi


@pytest.mark.parametrize("shape,drop,clobbered", [
    ((2, 32, 64), 0.03125, (2, 1)), ((2, 1, 64), 0.25, (0, 1))])
def test_moe_clobbered_slot_shown(mesh, mi, shape, drop, clobbered):
    """The reference's dispatch writes a zero for every dropped slot at
    ``(expert, 0)``, where a kept token sits whenever that expert
    overflows; on the CPU the zero wins.  qwen3-moe's SMOKE MoE in float32
    (key 0), x from ``default_rng(1)``: JAX drops ``drop`` of the slots and
    zeroes exactly one kept slot, ``clobbered`` (token, slot): token 2's
    second expert in a prefill batch [2, 32, 64] (capacity 20), token 0's
    in a decode batch [2, 1, 64] (capacity 1); every other token is the
    port's within
    1e-5, and on the clobbered token the port is the kept-only top-k
    mixture computed by hand (JAX is the same mixture without that
    slot's expert)."""
    jcfg = jqwen3_moe.SMOKE.moe
    cfg = moe.MoEConfig(**dataclasses.asdict(jcfg))
    jp = jparams(jmoe.moe_init, jcfg, jnp.float32)
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    jy, _, jdrop = _jmoe_run(mesh, mi, jp, jcfg, x)
    py, _, pdrop = _moe_port(jp, cfg, x)
    assert jdrop == pdrop == drop

    t = shape[0] * shape[1]
    k, e = jcfg.top_k, jcfg.n_experts
    cap = moe.capacity(cfg, t)
    _, topi = _hand_mixture(jp, jcfg, x, np.zeros((t, k), bool))
    r = jroute_by_owner(jnp.asarray(topi.reshape(-1), jnp.int32), e, cap)
    kept = np.asarray(r.kept).reshape(t, k)
    col = np.asarray(r.slot_col).reshape(t, k)
    overflowed = set(topi[~kept].tolist())
    # the kept slot at column 0 of each overflowing expert is zeroed
    hit = kept & (col == 0) & np.isin(topi, list(overflowed))
    assert hit.sum() == 1
    (tok, slot), = np.argwhere(hit)
    assert (tok, slot) == clobbered
    if shape[1] == 1:
        assert cap == 1

    jy, py = jy.reshape(t, -1), py.reshape(t, -1)
    others = np.arange(t) != tok
    close(py[others], jy[others])
    kept_only, _ = _hand_mixture(jp, jcfg, x, kept)
    close(py[tok], kept_only[tok])
    minus_slot = kept.copy()
    minus_slot[tok, slot] = False
    ref_clobbered, _ = _hand_mixture(jp, jcfg, x, minus_slot)
    close(jy[tok], ref_clobbered[tok])
    assert np.abs(jy[tok] - kept_only[tok]).max() > 100 * TOL


def _kept_only_moe_apply(params, cfg, x, mesh, mi, token_spec=None):
    """JAX's ``moe_apply`` at one rank, its dispatch writing the kept slots
    only (the dropped ones' writes dropped as out of bounds): the
    reference as the port reads it, for the LM parity of the MoE configs.
    Every other line is ``models/moe.py``'s ``_moe_body``."""
    b, s, d = x.shape
    t_loc = b * s
    x_loc = x.reshape(t_loc, d)
    e, k = cfg.n_experts, cfg.top_k
    logits = x_loc.astype(jnp.float32) @ params["router"]
    probs = jax.nn.softmax(logits, axis=-1)
    topv, topi = jax.lax.top_k(probs, k)
    if cfg.norm_topk:
        topv = topv / jnp.maximum(topv.sum(-1, keepdims=True), 1e-9)
    me = jnp.mean(probs, axis=0)
    ce = jnp.zeros((e,), jnp.float32).at[topi.reshape(-1)].add(
        1.0 / (t_loc * k))
    aux = e * jnp.sum(me * ce)
    cap = max(int(math.ceil(t_loc * k / e * cfg.capacity_factor)), 1)
    r = jroute_by_owner(topi.reshape(-1).astype(jnp.int32), e, cap)
    x_rep = jnp.repeat(x_loc, k, axis=0)
    send = jnp.zeros((e, cap, d), x_loc.dtype)
    send = send.at[jnp.where(r.kept, r.slot_row, e), r.slot_col].set(
        x_rep, mode="drop")
    dropped = r.n_dropped.astype(jnp.float32) / (t_loc * k)
    h = jnp.einsum("ecd,edf->ecf", send, params["w_gate"])
    u = jnp.einsum("ecd,edf->ecf", send, params["w_up"])
    y = jnp.einsum("ecf,efd->ecd", jax.nn.silu(h) * u, params["w_down"])
    per_slot = jnp.where(r.kept[:, None], y[r.slot_row, r.slot_col], 0)
    w = topv.reshape(-1)[:, None].astype(per_slot.dtype)
    out = jnp.sum((per_slot * w).reshape(t_loc, k, d), axis=1)
    if cfg.n_shared:
        sp = params["shared"]
        out = out + jmoe._swiglu(x_loc, sp["w_gate"], sp["w_up"],
                                 sp["w_down"])
    return out.reshape(x.shape), aux, dropped


# ---------------------------------------------------------------------------
# the five LM configs: prefill and chained decode
# ---------------------------------------------------------------------------
def _lm_inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    steps = rng.integers(0, cfg.vocab, (DECODE_STEPS, B)).astype(np.int32)
    pos = np.array([3, S - DECODE_STEPS], np.int32)
    return tokens, steps, pos


def _jax_lm(mesh, mi, jcfg, jp, tokens, steps, pos, cache_seed):
    prefill = jax.jit(jss.lm_prefill_fn(jcfg, mesh, mi))
    decode = jax.jit(jss.lm_decode_fn(jcfg, mesh, mi))
    shapes, _ = jlm.make_decode_cache_specs(jcfg, B, S)
    caches = jmat.materialize(shapes, seed=cache_seed)
    with compat.set_mesh(mesh):
        out = {"prefill": np.asarray(prefill(jp, jnp.asarray(tokens))
                                     .astype(jnp.float32)),
               "decode": [], "caches": []}
        p = jnp.asarray(pos)
        for tok in steps:
            logits, caches = decode(jp, jnp.asarray(tok), p, caches)
            out["decode"].append(np.asarray(logits.astype(jnp.float32)))
            out["caches"].append(jax.tree.map(np.asarray, caches))
            p = p + 1
    return out


LM_RUNS = {}


def lm_run(mesh, mi, arch, dtype):
    """JAX's and the port's prefill logits, 4 decode steps' logits and
    caches for ``arch``'s SMOKE at ``dtype``, once per module.  For the MoE
    configs JAX runs twice: as shipped, and with the kept-only dispatch
    (``_kept_only_moe_apply``)."""
    key = (arch, dtype)
    if key in LM_RUNS:
        return LM_RUNS[key]
    jcfg = JAX_CONFIGS[arch].SMOKE
    cfg = registry.LM_ARCHS[arch].SMOKE
    if dtype == "float32":
        jcfg, cfg = f32(jcfg), f32(cfg)
    jp = jparams(jlm.lm_init, jcfg)
    tokens, steps, pos = _lm_inputs(cfg, 5)
    run = {"jax": _jax_lm(mesh, mi, jcfg, jp, tokens, steps, pos, 6)}
    if jcfg.moe is not None:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jmoe, "moe_apply", _kept_only_moe_apply)
            run["kept_only"] = _jax_lm(mesh, mi, jcfg, jp, tokens, steps,
                                       pos, 6)
    params = convert.lm_from_reference(jp, cfg, "cpu")
    prefill, decode = serve_step.lm_prefill_fn(cfg), \
        serve_step.lm_decode_fn(cfg)
    caches = mat.materialize(lm.decode_cache_specs(cfg, B, S), seed=6)
    got = {"prefill": nn(prefill(params, torch.from_numpy(tokens))),
           "decode": [], "caches": [], "dropped": []}
    p = torch.from_numpy(pos)
    for tok in steps:
        logits, caches = decode(params, torch.from_numpy(tok), p, caches)
        got["decode"].append(nn(logits))
        got["caches"].append({kind: {n: nn(t) for n, t in e.items()}
                              for kind, e in caches.items()})
        p = p + 1
    taps = []
    lm.lm_backbone(params, cfg, torch.from_numpy(tokens), taps=taps)
    got["prefill_dropped"] = [float(d) for _, _, d in taps]
    run["port"] = got
    LM_RUNS[key] = run
    return run


def _lm_err(got, want) -> float:
    """max |got - want| over the prefill and decode logits, / max |want|."""
    err = max(np.abs(got["prefill"] - want["prefill"]).max(),
              *(np.abs(g - w).max() for g, w in zip(got["decode"],
                                                    want["decode"])))
    scale = max(np.abs(want["prefill"]).max(),
                *(np.abs(w).max() for w in want["decode"]))
    return float(err / scale)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_prefill_and_decode_match_jax_float32(mesh, mi, arch):
    """Prefill logits, then 4 chained decode steps' logits and caches, at
    1e-5.  The MoE configs are held to JAX with the kept-only dispatch, and
    to JAX as shipped where no expert overflowed (a prefill of 64 tokens
    at capacity 20, or a decode step of 2 at capacity 1, may overflow;
    ``test_moe_clobbered_slot_shown`` shows what the reference does
    then)."""
    run = lm_run(mesh, mi, arch, "float32")
    want, got = run.get("kept_only", run["jax"]), run["port"]
    close(got["prefill"], want["prefill"])
    for g, w in zip(got["decode"], want["decode"]):
        close(g, w)
    for g, w in zip(got["caches"], want["caches"]):
        assert set(g) == set(w)
        for kind in g:
            for name in g[kind]:
                close(g[kind][name], w[kind][name])
    if "kept_only" in run and not any(got["prefill_dropped"]):
        close(got["prefill"], run["jax"]["prefill"])


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_prefill_and_decode_match_jax_bf16(mesh, mi, arch):
    """The configs as published (bf16): logits within ``BF16_TOL`` of the
    largest |logit|, caches within one bf16 rounding of their largest
    entry, every logit finite."""
    run = lm_run(mesh, mi, arch, "bfloat16")
    want, got = run.get("kept_only", run["jax"]), run["port"]
    assert np.isfinite(got["prefill"]).all()
    assert all(np.isfinite(d).all() for d in got["decode"])
    assert _lm_err(got, want) <= BF16_TOL
    for g, w in zip(got["caches"], want["caches"]):
        for kind in g:
            for name in g[kind]:
                wv = np.asarray(w[kind][name], np.float32)
                err = np.abs(g[kind][name] - wv).max()
                assert err <= BF16_TOL * np.abs(wv).max(), (kind, name, err)


# ---------------------------------------------------------------------------
# configs, cells, parameter and cache shapes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_configs_match_jax(arch):
    port, jspec = registry.LM_ARCHS[arch], jregistry.get(arch)
    assert registry.family(arch) == jspec.family == "lm"
    for a, b in ((port.CONFIG, jspec.config), (port.SMOKE, jspec.smoke)):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert [dataclasses.asdict(c) for c in registry.LM_CELLS] == \
        [dataclasses.asdict(c) for c in jspec.cells]
    for c, jc in zip(registry.LM_CELLS, jspec.cells):
        assert dataclasses.asdict(registry.reduce_cell(c)) == \
            dataclasses.asdict(jcells._reduce_cell("lm", jc))
        assert registry.cell_by_name(c.name, "lm") == c


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_cache_specs_match_jax_at_published_width(arch):
    """Every path, shape and dtype of ``lm_init`` and of the decode caches
    at CONFIG, from ``jax.eval_shape`` (nothing allocated), in
    ``jax.tree_util``'s order; the bytes the launcher reckons."""
    cfg, jcfg = registry.LM_ARCHS[arch].CONFIG, jregistry.get(arch).config
    boxed = jax.eval_shape(lambda: jlm.lm_init(jax.random.key(0), jcfg))
    want = convert.flatten_tree(jcm.unbox(boxed)[0])
    got = lm.param_specs(cfg)
    assert list(got) == list(want)
    for k, spec in got.items():
        assert tuple(spec.shape) == want[k].shape, k
        assert str(spec.dtype or cfg.torch_dtype) == f"torch.{want[k].dtype}"
    assert lm.param_bytes(cfg) == sum(v.size * v.dtype.itemsize
                                      for v in want.values())
    jshapes, _ = jlm.make_decode_cache_specs(jcfg, 8, 4096)
    jflat = convert.flatten_tree(jshapes)
    flat = {f"{kind}/{name}": sd for kind, e in
            lm.decode_cache_specs(cfg, 8, 4096).items()
            for name, sd in sorted(e.items())}
    assert list(flat) == list(jflat)
    for k, sd in flat.items():
        assert sd.shape == jflat[k].shape
        assert str(sd.dtype) == f"torch.{jflat[k].dtype}"
    assert lm.cache_bytes(cfg, 8, 4096) == sum(
        v.size * v.dtype.itemsize for v in jflat.values())


@pytest.mark.parametrize("block", ["gqa", "mla", "moe"])
def test_block_inits_match_jax_shapes(block):
    """``gqa_init``, ``mla_init`` and ``moe_init`` on a torch generator:
    the JAX package's names, shapes and dtypes (the router in fp32 under a
    bf16 model), gains ones, weights scaled by 1/sqrt(fan in)."""
    cfgs = {"gqa": (_gqa_cfg(True), attn.gqa_init, jattn.gqa_init,
                    jattn.GQAConfig),
            "mla": (_mla_cfg(), attn.mla_init, jattn.mla_init,
                    jattn.MLAConfig),
            "moe": (moe.MoEConfig(**dataclasses.asdict(
                jdeepseek_v3.SMOKE.moe)), moe.moe_init, jmoe.moe_init,
                jmoe.MoEConfig)}
    cfg, init, jinit, jtype = cfgs[block]
    gen = torch.Generator().manual_seed(0)
    got = init(cfg, generator=gen, device="cpu", dtype=torch.bfloat16)
    want = convert.flatten_tree(jparams(
        jinit, jtype(**dataclasses.asdict(cfg)), jnp.bfloat16))
    assert set(got) == set(want)
    for k, v in got.items():
        assert tuple(v.shape) == want[k].shape, k
        assert str(v.dtype) == f"torch.{want[k].dtype}", k
        if "gamma" in k:
            assert bool((v == 1).all())
        else:
            fan_in = v.shape[-2]
            assert float(v.float().abs().max()) <= 2 / math.sqrt(fan_in) \
                * (1 + 2 ** -7)


def test_qwen3_14b_sizes_one_card_holds():
    """The sizes phase U of ``chip_smoke.py`` plans around: qwen3-14b's
    weights 29.5 GB, its decode_32k cache 42.9 GB at batch 8 and 687 GB at
    the cell's 128, long_500k's 85.9 GB."""
    cfg = registry.LM_ARCHS["qwen3-14b"].CONFIG
    assert round(lm.param_bytes(cfg) / 1e9, 1) == 29.5
    assert round(lm.cache_bytes(cfg, 8, 32768) / 1e9, 1) == 42.9
    assert round(lm.cache_bytes(cfg, 128, 32768) / 1e9) == 687
    assert round(lm.cache_bytes(cfg, 1, 524288) / 1e9, 1) == 85.9


# ---------------------------------------------------------------------------
# materialize, the converter
# ---------------------------------------------------------------------------
def test_materialize_matches_jax_bitwise():
    """Integers and floats of every dtype, nested dicts (keys sorted) and
    tuples, drawn from one rng in the JAX package's leaf order."""
    jtree = ({"v": jax.ShapeDtypeStruct((3, 7), jnp.bfloat16),
              "k": jax.ShapeDtypeStruct((2, 5), jnp.float32)},
             jax.ShapeDtypeStruct((4,), jnp.int32),
             [jax.ShapeDtypeStruct((6, 2), jnp.bfloat16)])
    tree = ({"v": cm.ShapeDtype((3, 7), torch.bfloat16),
             "k": cm.ShapeDtype((2, 5), torch.float32)},
            cm.ShapeDtype((4,), torch.int32),
            [cm.ShapeDtype((6, 2), torch.bfloat16)])
    for seed, high in ((0, None), (3, 100)):
        want = jax.tree.leaves(jmat.materialize(jtree, seed=seed,
                                                int_high=high))
        got = jax.tree.leaves(mat.materialize(tree, seed=seed, int_high=high),
                              is_leaf=lambda x: isinstance(x, torch.Tensor))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == tt(w).dtype and g.shape == w.shape
            assert torch.equal(g.view(torch.int16) if g.dtype ==
                               torch.bfloat16 else g, tt(w).view(torch.int16)
                               if g.dtype == torch.bfloat16 else tt(w))


def test_materialize_rounds_through_fp32_as_jnp_asarray():
    """A float64 draw just above a bf16 midpoint: ``jnp.asarray`` rounds it
    to fp32 (onto the midpoint), then to bf16 by ties-to-even, where one
    correct rounding would go up; ``draw_leaf`` rounds the same way."""
    vals = np.array([1 + 2 ** -8 + 2 ** -30, -(1 + 2 ** -8 + 2 ** -30)])

    class Fixed:
        def normal(self, loc, scale, size):
            return vals

    want = np.asarray(jnp.asarray(vals, jnp.bfloat16), np.float64)
    got = mat.draw_leaf(Fixed(), cm.ShapeDtype((2,), torch.bfloat16), 1.0,
                        None)
    assert want.tolist() == [1.0, -1.0]          # not 1 + 2^-7
    assert got.double().tolist() == want.tolist()


def test_lm_from_reference_checks_paths_shapes_and_dtypes():
    jcfg = jqwen3_14b.SMOKE
    cfg = registry.LM_ARCHS["qwen3-14b"].SMOKE
    jp = jparams(jlm.lm_init, jcfg)
    p = convert.lm_from_reference(jp, cfg, "cpu")
    assert list(p) == list(lm.param_specs(cfg))
    w = jp["dense_layers"]["attn"]["wq"]
    assert w.dtype.name == "bfloat16"
    assert torch.equal(p["dense_layers/attn/wq"].view(torch.int16),
                       torch.from_numpy(np.array(w).view(np.int16)))
    bad = jax.tree.map(lambda a: a, jp)
    del bad["dense_layers"]["ffn"]["w_up"]
    with pytest.raises(ValueError, match="needs parameters"):
        convert.lm_from_reference(bad, cfg, "cpu")
    bad = jax.tree.map(lambda a: a, jp)
    bad["unembed"] = bad["unembed"][:, :-1]
    with pytest.raises(ValueError, match="unembed has shape"):
        convert.lm_from_reference(bad, cfg, "cpu")
    bad = jax.tree.map(lambda a: a, jp)
    bad["embed"] = bad["embed"].astype(np.float32)
    with pytest.raises(ValueError, match="embed is float32"):
        convert.lm_from_reference(bad, cfg, "cpu")
    with pytest.raises(ValueError, match="needs parameters"):
        convert.lm_from_reference(jp, f32(registry.LM_ARCHS[
            "deepseek-7b"].SMOKE), "cpu")


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["qwen3-14b", "deepseek-v3-671b"])
@pytest.mark.parametrize("shape", ["decode_32k", "prefill_32k"])
def test_launcher_requests_are_the_jax_launchers(mesh, arch, shape):
    """The serve launcher's request i is ``materialize(bundle.args[1:],
    seed=i + 1)`` of the JAX cell builder's bundle, bit for bit."""
    bundle = jcells.build_cell(arch, shape, mesh, smoke=True)
    cfg = registry.LM_ARCHS[arch].SMOKE
    cell = registry.reduce_cell(registry.cell_by_name(shape, "lm"))
    for seed in (1, 2):
        want = jax.tree.leaves(jmat.materialize(
            bundle.args[1:], seed=seed, int_high=bundle.meta.get(
                "int_high")))
        got = jax.tree.leaves(
            launch_serve.lm_request(cfg, cell, cell.dims["batch"], seed,
                                    torch.device("cpu")),
            is_leaf=lambda x: isinstance(x, torch.Tensor))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            wt = tt(w)
            assert g.dtype == wt.dtype and torch.equal(
                g.view(torch.int16) if g.dtype == torch.bfloat16 else g,
                wt.view(torch.int16) if g.dtype == torch.bfloat16 else wt)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", ["decode_32k", "prefill_32k"])
def test_launcher_serves_lm_smoke_on_cpu(arch, shape, capsys):
    out = launch_serve.main(["--arch", arch, "--shape", shape, "--smoke",
                             "--device", "cpu", "--requests", "3"])
    assert out["finite"] and out["requests"] == 3
    assert (out["shape"], out["batch"], out["seq"]) == (shape, 2, 32)
    assert f"/{shape}: 3 requests of 2 x 32 on cpu" in capsys.readouterr().out


def test_launcher_lm_defaults_to_decode_32k_and_takes_batch():
    out = launch_serve.main(["--arch", "deepseek-7b", "--smoke", "--device",
                             "cpu", "--requests", "1", "--batch", "3"])
    assert (out["shape"], out["batch"]) == ("decode_32k", 3)


def test_launchers_refuse_lm_training():
    """What still refuses once LM training is ported: the train launcher
    trains an LM's train_4k only, and points a serving cell to the serve
    launcher, for every LM arch; an arch the port lacks names what the port
    runs (the cell builder and dry-run, the sharded LM serving among it)
    and what waits (training through the expert-parallel exchange, the
    dense weights' placement, the production mesh) in ROADMAP."""
    for arch in ARCHS:
        for shape in ("prefill_32k", "decode_32k", "long_500k"):
            with pytest.raises(SystemExit, match=f"{shape} is not a train "
                               "cell; serve it with python -m "
                               "repro_torch.launch.serve"):
                launch_train.main(["--arch", arch, "--shape", shape,
                                   "--smoke", "--device", "cpu"])
    for launcher in (launch_train, launch_serve):
        with pytest.raises(SystemExit, match="qwen3-15b is not ported.*five "
                           "LM archs \\(train_4k, prefill_32k.*serving "
                           "sequence-sharded and expert-parallel over a "
                           "torch.distributed world.*builds and dry-runs "
                           "every cell.*training through the "
                           "expert-parallel exchange, the dense weights' "
                           "FSDP / tensor-parallel placement and the "
                           "production mesh wait for ROADMAP queue 1, item "
                           "15\\.4"):
            launcher.main(["--arch", "qwen3-15b", "--smoke", "--device",
                           "cpu"])
