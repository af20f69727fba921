"""The port's sharded LM serving paths over ``torch.distributed`` against
the JAX package on the CPU: the mesh (``launch/mesh.make_mesh``), the two
flash-decode bodies (``models/attention.py``), the expert-parallel MoE
(``models/moe.py``), ``lm_decode_step`` and ``lm_prefill`` at a mesh
(``models/lm.py``), ``core/convert.lm_rank_share`` and the serve
launcher's ``--model-ranks``.

No process group is ever made in the pytest process.  Every torch world
runs in a child interpreter (this file run as a script) that spawns its
ranks with ``torch.multiprocessing`` (spawn: the pytest worker has JAX
loaded), one thread a rank, over gloo with a ``file://`` rendezvous under
the test's tmp dir.  The child runs in a session of its own and writes its
pid first; on a timeout the test kills the session and fails with the
child's stderr.  The JAX references come from one subprocess at 8 host
devices on ``compat.make_mesh((2, 4), ("data", "model"))``, writing an
``.npz`` that the worlds read their inputs from.  A rank imports this file,
so the file imports JAX inside its tests only.

Tolerances: float32 at 1e-5 (rtol and atol: fp32 sums in another order);
bf16 logits within ``BF16_TOL`` = 3e-2 of the largest |logit| and caches
within it of their largest entry (``tests/test_torch_lm.py``'s, with its
reasons); integers and a world of one against the one-device path
bitwise.  The MoE configs are held to JAX with a kept-only dispatch (the
reference's ``_moe_body`` with its dispatch writing the kept slots only,
``KEPT_ONLY_BODY``), and to JAX as shipped where no expert overflowed:
the reference writes a zero for every dropped slot over a kept one
(``tests/test_torch_lm.py::test_moe_clobbered_slot_shown``).
"""
import ctypes
import datetime
import os
import signal
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.core import convert
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import serve as launch_serve
from repro_torch.models import attention as attn
from repro_torch.models import lm
from repro_torch.models import moe

from conftest import subprocess_env

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD_TIMEOUT_S = 300
TOL = 1e-5
BF16_TOL = 3e-2
DATA, MODEL = 2, 4
SMAX, STEPS, B_LM = 16, 9, 2          # the reference's flash-decode test
LM_ARCHS = ("qwen3-14b", "deepseek-v3-671b")
MOE_ARCHS = ("qwen3-moe-235b-a22b", "deepseek-v3-671b")
DTYPES = ("float32", "bfloat16")
# (batch, positions): both sides of the 4-position shard boundaries
BODY_CASES = {"b1_last": (1, [3]), "b1_first": (1, [4]),
              "b4_edges": (4, [3, 4, 11, 12]), "b4_ends": (4, [0, 7, 8, 15])}
KV, G, DH = 2, 2, 8                   # the GQA body's heads
H, LAT, ROPE = 4, 12, 4               # the MLA body's heads and latents
MOE_SHAPES = {"prefill": (2, 16, 64), "decode": (2, 1, 64)}
PREFILL_SEQ, FALLBACK_SMAX = 8, 18

# the reference's _moe_body with its dispatch writing the kept slots only
KEPT_ONLY_BODY = textwrap.dedent("""
    def kept_only_body(params, x_loc, *, cfg, n_ep, axes, ep_axis):
        t_loc, d = x_loc.shape
        e, k = cfg.n_experts, cfg.top_k
        logits = x_loc.astype(jnp.float32) @ params["router"]
        probs = jax.nn.softmax(logits, axis=-1)
        topv, topi = jax.lax.top_k(probs, k)
        if cfg.norm_topk:
            topv = topv / jnp.maximum(topv.sum(-1, keepdims=True), 1e-9)
        me = jnp.mean(probs, axis=0)
        ce = jnp.zeros((e,), jnp.float32).at[topi.reshape(-1)].add(
            1.0 / (t_loc * k))
        aux = jax.lax.pmean(e * jnp.sum(me * ce), axes)
        cap = max(int(math.ceil(t_loc * k / e * cfg.capacity_factor)), 1)
        r = route_by_owner(topi.reshape(-1).astype(jnp.int32), e, cap)
        x_rep = jnp.repeat(x_loc, k, axis=0)
        send = jnp.zeros((e, cap, d), x_loc.dtype)
        send = send.at[jnp.where(r.kept, r.slot_row, e), r.slot_col].set(
            x_rep, mode="drop")
        dropped = jax.lax.pmean(
            r.n_dropped.astype(jnp.float32) / (t_loc * k), axes)
        recv = jax.lax.all_to_all(send, ep_axis, 0, 1, tiled=True)
        h = jnp.einsum("ecd,edf->ecf", recv, params["w_gate"])
        u = jnp.einsum("ecd,edf->ecf", recv, params["w_up"])
        y = jnp.einsum("ecf,efd->ecd", jax.nn.silu(h) * u, params["w_down"])
        back = jax.lax.all_to_all(y, ep_axis, 1, 0, tiled=True)
        per_slot = jnp.where(r.kept[:, None], back[r.slot_row, r.slot_col],
                             0)
        w = topv.reshape(-1)[:, None].astype(per_slot.dtype)
        out = jnp.sum((per_slot * w).reshape(t_loc, k, d), axis=1)
        if cfg.n_shared:
            s = params["shared"]
            out = out + moe_mod._swiglu(x_loc, s["w_gate"], s["w_up"],
                                        s["w_down"])
        return out, aux, dropped
""")

# ---------------------------------------------------------------------------
# the JAX references, one subprocess at 8 host devices
# ---------------------------------------------------------------------------
JAX_SCRIPT = textwrap.dedent("""
    import dataclasses, functools, math, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.configs import registry
    from repro.core import compat
    from repro.core.distributed import route_by_owner
    from repro.models import attention as attn, common as cm
    from repro.models import lm as lm_mod, moe as moe_mod
    {kept_only}
    SMAX, STEPS, B_LM = {lm_dims}
    KV, G, DH, H, LAT, ROPE = {body_dims}
    CASES = {cases}
    out = {{}}
    mesh = compat.make_mesh(({data}, {model}), ("data", "model"))
    mi = cm.MeshInfo.from_mesh(mesh)
    out["mesh_ids"] = np.array([[d.id for d in row] for row in
                                mesh.devices])

    def put(prefix, tree):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                           for p in path)
            a = np.asarray(leaf)
            if a.dtype.name == "bfloat16":
                out[f"{{prefix}}|b16|{{key}}"] = a.view(np.uint16)
            else:
                out[f"{{prefix}}|{{key}}"] = a

    def mla_flash(q_abs, qr, ckv, kr, ckv_new, kr_new, pos, scale):
        # mla_decode's dispatch to the flash body, as it stands there
        bspec = mi.dp if q_abs.shape[0] % {data} == 0 else None
        body = functools.partial(attn._mla_flash_body, axis="model",
                                 smax=SMAX, n_shards={model}, scale=scale)
        cspec = P(bspec, "model", None)
        fn = compat.shard_map(
            body, mesh=mesh, in_specs=(P(bspec), P(bspec), cspec, cspec,
                                       P(bspec), P(bspec), P(bspec)),
            out_specs=(P(bspec), cspec, cspec), check_vma=False)
        return fn(q_abs, qr, ckv, kr, ckv_new, kr_new, pos)

    rng = np.random.default_rng(0)
    with compat.set_mesh(mesh):
        for tag, (b, pos) in CASES.items():
            f = lambda *s: rng.normal(size=s).astype(np.float32)
            gqa = dict(qg=f(b, KV, G, DH), k=f(b, SMAX, KV, DH),
                       v=f(b, SMAX, KV, DH), k_new=f(b, KV, DH),
                       v_new=f(b, KV, DH), pos=np.array(pos, np.int32))
            o, k2, v2 = jax.jit(lambda q, k, v, kn, vn, p:
                                attn._sharded_cache_attn(
                                    mesh, mi, q, {{"k": k, "v": v}}, kn, vn,
                                    p))(*(gqa[n] for n in (
                                        "qg", "k", "v", "k_new", "v_new",
                                        "pos")))
            gqa.update(o_out=o, k_out=k2, v_out=v2)
            mla = dict(q_abs=f(b, H, LAT), qr=f(b, H, ROPE),
                       ckv=f(b, SMAX, LAT), kr=f(b, SMAX, ROPE),
                       ckv_new=f(b, LAT), kr_new=f(b, ROPE),
                       pos=np.array(pos, np.int32))
            ctx, c2, r2 = jax.jit(functools.partial(mla_flash, scale=0.3))(
                *(mla[n] for n in ("q_abs", "qr", "ckv", "kr", "ckv_new",
                                   "kr_new", "pos")))
            mla.update(ctx_out=ctx, ckv_out=c2, kr_out=r2)
            for name, v in gqa.items():
                out[f"gqa|{{tag}}|{{name}}"] = np.asarray(v)
            for name, v in mla.items():
                out[f"mla|{{tag}}|{{name}}"] = np.asarray(v)

        # lm_decode_step over 9 steps: test_flash_decode_matches_prefill_8dev
        shipped = moe_mod._moe_body
        for arch in {lm_archs}:
            for dtype in {dtypes}:
                cfg = dataclasses.replace(registry.get(arch).smoke,
                                          dtype=dtype)
                params, _ = cm.unbox(lm_mod.lm_init(jax.random.key(0), cfg))
                tag = f"lm|{{arch}}|{{dtype}}"
                put(tag + "|p", params)
                tokens = np.random.default_rng(1).integers(
                    0, cfg.vocab, (B_LM, STEPS)).astype(np.int32)
                out[tag + "|tokens"] = tokens
                variants = [("jax", shipped)]
                if cfg.moe is not None:
                    variants.append(("kept", kept_only_body))
                for name, body in variants:
                    moe_mod._moe_body = body
                    shapes, _ = lm_mod.make_decode_cache_specs(cfg, B_LM,
                                                               SMAX, mi)
                    caches = jax.tree.map(
                        lambda s: jnp.zeros(s.shape, s.dtype), shapes,
                        is_leaf=lambda x: isinstance(
                            x, jax.ShapeDtypeStruct))
                    step = jax.jit(lambda p, t, pos, c: lm_mod.lm_decode_step(
                        p, cfg, t, pos, c, mesh, mi))
                    for t in range(STEPS):
                        logits, caches = step(
                            params, jnp.asarray(tokens[:, t]),
                            jnp.asarray([t] * B_LM, jnp.int32), caches)
                        out[f"{{tag}}|{{name}}|logits{{t}}"] = np.asarray(
                            logits.astype(jnp.float32))
                    put(f"{{tag}}|{{name}}|caches", caches)
                moe_mod._moe_body = shipped

        # moe_apply in prefill (SP) and decode (replicated tokens)
        for arch in {moe_archs}:
            mcfg = registry.get(arch).smoke.moe
            params, _ = cm.unbox(moe_mod.moe_init(jax.random.key(0), mcfg,
                                                  jnp.float32))
            put(f"moe|{{arch}}|p", params)
            for mode, shape in {moe_shapes}.items():
                x = np.random.default_rng(2).normal(size=shape).astype(
                    np.float32)
                out[f"moe|{{arch}}|{{mode}}|x"] = x
                spec = P(None, None, None) if mode == "decode" else None
                for name, body in (("jax", shipped), ("kept",
                                                      kept_only_body)):
                    moe_mod._moe_body = body
                    y, aux, drop = jax.jit(lambda p, x: moe_mod.moe_apply(
                        p, mcfg, x, mesh, mi, token_spec=spec))(params, x)
                    for n, v in (("y", y), ("aux", aux), ("dropped", drop)):
                        out[f"moe|{{arch}}|{{mode}}|{{name}}|{{n}}"] = \\
                            np.asarray(v)
                moe_mod._moe_body = shipped
    np.savez(sys.argv[1], **out)
    print("JAX_REF_OK")
""").format(kept_only=KEPT_ONLY_BODY.strip(),
            lm_dims=(SMAX, STEPS, B_LM), body_dims=(KV, G, DH, H, LAT, ROPE),
            cases=BODY_CASES, data=DATA, model=MODEL, lm_archs=LM_ARCHS,
            dtypes=DTYPES, moe_archs=MOE_ARCHS, moe_shapes=MOE_SHAPES)


def _kill_session(tmp) -> None:
    """Kills the child's session: the child and every rank it spawned."""
    try:
        with open(os.path.join(tmp, "pid")) as f:
            os.killpg(int(f.read()), signal.SIGKILL)
    except (FileNotFoundError, ProcessLookupError, ValueError):
        pass


def _tail(text) -> str:
    if isinstance(text, bytes):
        text = text.decode(errors="replace")
    return (text or "")[-3000:]


class Started:
    """The JAX subprocess, the world of one and the launcher's run,
    started together and waited for one at a time."""

    def __init__(self, tmp):
        self.tmp = tmp
        self.ref = os.path.join(tmp, "ref.npz")
        self.procs = {}
        env = subprocess_env()
        self._start("jax", [sys.executable, "-c", JAX_SCRIPT, self.ref], env)
        os.makedirs(os.path.join(tmp, "world1"))
        self._start("world1", [sys.executable, os.path.abspath(__file__),
                               "world1", "1", os.path.join(tmp, "world1"),
                               ""], env, session=True)
        self._start("launcher", [
            sys.executable, "-m", "repro_torch.launch.serve", "--arch",
            "deepseek-v3-671b", "--smoke", "--device", "cpu", "--requests",
            "2", "--model-ranks", str(MODEL)], env, session=True)

    def _start(self, name, cmd, env, session=False):
        self.procs[name] = subprocess.Popen(
            cmd, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env=env, start_new_session=session)

    def wait(self, name):
        proc = self.procs[name]
        try:
            out, err = proc.communicate(timeout=WORLD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL) if name != "jax" \
                else proc.kill()
            out, err = proc.communicate()
            pytest.fail(f"{name} passed {WORLD_TIMEOUT_S} s:\n{_tail(err)}")
        return proc.returncode, out, err

    def close(self):
        for name, proc in self.procs.items():
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL) if name != "jax" \
                    else proc.kill()
                proc.communicate()


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    s = Started(str(tmp_path_factory.mktemp("sharded")))
    yield s
    s.close()


@pytest.fixture(scope="module")
def jax_ref(started):
    rc, out, err = started.wait("jax")
    assert "JAX_REF_OK" in out, _tail(err)
    with np.load(started.ref) as f:
        return dict(f)


def _rank_outputs(tmp, world) -> list:
    outs = []
    for rank in range(world):
        with np.load(os.path.join(tmp, f"rank{rank}.npz")) as f:
            outs.append(dict(f))
    return outs


@pytest.fixture(scope="module")
def world8(started, jax_ref, tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("world8"))
    cmd = [sys.executable, os.path.abspath(__file__), "world8",
           str(DATA * MODEL), tmp, started.ref]
    try:
        r = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                           timeout=WORLD_TIMEOUT_S, env=subprocess_env(),
                           start_new_session=True)
    except subprocess.TimeoutExpired as e:
        _kill_session(tmp)
        pytest.fail(f"world8 passed {WORLD_TIMEOUT_S} s:\n{_tail(e.stderr)}")
    assert r.returncode == 0, f"world8:\n{_tail(r.stderr)}"
    return _rank_outputs(tmp, DATA * MODEL)


@pytest.fixture(scope="module")
def world1(started):
    rc, out, err = started.wait("world1")
    assert rc == 0, f"world1:\n{_tail(err)}"
    return _rank_outputs(os.path.join(started.tmp, "world1"), 1)[0]


# ---------------------------------------------------------------------------
# what a rank runs (no JAX here)
# ---------------------------------------------------------------------------
def _tree(ref: dict, prefix: str) -> dict:
    """The flat ``path: array`` leaves saved under ``prefix``, bf16 back
    from its bits."""
    import ml_dtypes
    out = {}
    for k, v in ref.items():
        if k.startswith(prefix + "|b16|"):
            out[k[len(prefix) + 5:]] = v.view(ml_dtypes.bfloat16)
        elif k.startswith(prefix + "|"):
            out[k[len(prefix) + 1:]] = v
    return out


def _caches_tree(flat: dict) -> dict:
    out = {}
    for k, v in flat.items():
        kind, name = k.split("/")
        out.setdefault(kind, {})[name] = v
    return out


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy().copy()


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _bodies(mesh, ref: dict, out: dict) -> None:
    """Both flash bodies on this rank's slices of each case's inputs."""
    n = mesh.size("model")
    s_loc = SMAX // n
    seq = slice(mesh.model_index * s_loc, (mesh.model_index + 1) * s_loc)
    for tag, (b, _) in BODY_CASES.items():
        rows = mesh.batch_rows(b)
        g = {k.split("|")[2]: _t(v) for k, v in ref.items()
             if k.startswith(f"gqa|{tag}|")}
        o, k2, v2 = attn._flash_decode_body(
            g["qg"][rows], g["k"][rows, seq].clone(),
            g["v"][rows, seq].clone(), g["k_new"][rows], g["v_new"][rows],
            g["pos"][rows], group=mesh.model_group, index=mesh.model_index,
            smax=SMAX, n_shards=n)
        out.update({f"gqa|{tag}|o": _np(o), f"gqa|{tag}|k": _np(k2),
                    f"gqa|{tag}|v": _np(v2)})
        m = {k.split("|")[2]: _t(v) for k, v in ref.items()
             if k.startswith(f"mla|{tag}|")}
        ctx, c2, r2 = attn._mla_flash_body(
            m["q_abs"][rows], m["qr"][rows], m["ckv"][rows, seq].clone(),
            m["kr"][rows, seq].clone(), m["ckv_new"][rows],
            m["kr_new"][rows], m["pos"][rows], group=mesh.model_group,
            index=mesh.model_index, smax=SMAX, n_shards=n, scale=0.3)
        out.update({f"mla|{tag}|ctx": _np(ctx), f"mla|{tag}|ckv": _np(c2),
                    f"mla|{tag}|kr": _np(r2)})


def _zero_paths() -> None:
    for counts in (attn.DECODE_PATHS, moe.EP_PATHS):
        for k in counts:
            counts[k] = 0


def _paths() -> np.ndarray:
    return np.array([attn.DECODE_PATHS["flash"], attn.DECODE_PATHS["whole"],
                     moe.EP_PATHS["expert_parallel"], moe.EP_PATHS["local"]])


def _lm_decode(mesh, ref: dict, out: dict) -> None:
    """9 decode steps of each LM config and dtype from zero caches."""
    for arch in LM_ARCHS:
        for dtype in DTYPES:
            cfg = _cfg(arch, dtype)
            tag = f"lm|{arch}|{dtype}"
            params, _ = convert.lm_rank_share(_tree(ref, tag + "|p"), cfg,
                                              mesh, "cpu")
            tokens = _t(ref[tag + "|tokens"])
            caches = lm.make_decode_caches(cfg, B_LM, SMAX, "cpu", mesh)
            _zero_paths()
            with torch.no_grad():
                for t in range(STEPS):
                    logits, caches = lm.lm_decode_step(
                        params, cfg, tokens[:, t],
                        torch.full((B_LM,), t, dtype=torch.int32), caches,
                        mesh, SMAX)
                    out[f"{tag}|logits{t}"] = _np(logits)
            out[f"{tag}|paths"] = _paths()
            for kind, entry in caches.items():
                for name, c in entry.items():
                    out[f"{tag}|caches|{kind}/{name}"] = _np(c)


def _cfg(arch: str, dtype: str):
    import dataclasses
    return dataclasses.replace(registry.LM_ARCHS[arch].SMOKE, dtype=dtype)


def _moe(mesh, ref: dict, out: dict) -> None:
    """``moe_apply`` in prefill (this rank's rows) and decode (the whole
    batch) from this rank's experts."""
    import dataclasses
    n, m = mesh.size("model"), mesh.model_index
    for arch in MOE_ARCHS:
        cfg = moe.MoEConfig(**dataclasses.asdict(
            registry.LM_ARCHS[arch].SMOKE.moe))
        p = {k: _t(v) for k, v in _tree(ref, f"moe|{arch}|p").items()}
        e_loc = cfg.n_experts // n
        for w in ("w_gate", "w_up", "w_down"):
            p[w] = p[w][m * e_loc:(m + 1) * e_loc].clone()
        for mode in MOE_SHAPES:
            x = _t(ref[f"moe|{arch}|{mode}|x"])
            with torch.no_grad():
                if mode == "decode":
                    y, aux, drop = moe.moe_apply(p, cfg, x, mesh,
                                                 decode=True)
                else:
                    y, aux, drop = moe.moe_apply(
                        p, cfg, x[mesh.batch_rows(len(x))], mesh)
            out.update({f"moe|{arch}|{mode}|y": _np(y),
                        f"moe|{arch}|{mode}|aux": _np(aux),
                        f"moe|{arch}|{mode}|dropped": _np(drop)})


def _prefill_and_fallback(mesh, ref: dict, out: dict) -> None:
    """float32 deepseek-v3 and qwen3-14b: ``lm_prefill`` of 8 tokens into
    sliced caches, then 3 decode steps, against the same on one process
    (the whole model); and 3 decode steps at ``FALLBACK_SMAX`` = 18
    positions, which 4 ranks do not divide (the whole-cache path).  The
    MoE's capacity factor is E / k, so that no expert drops: a rank's
    capacity comes from its own tokens (the reference's rule, held to JAX
    by ``test_moe_apply_8dev_matches_jax``), so where experts overflow a
    prefill split over 4 ranks and one over a single process drop
    different slots."""
    import dataclasses
    tokens_all = torch.from_numpy(np.random.default_rng(3).integers(
        0, 512, (B_LM, PREFILL_SEQ + 3)).astype(np.int32))
    for arch in LM_ARCHS:
        cfg = _cfg(arch, "float32")
        if cfg.moe is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
        tag = f"lm|{arch}|float32"
        tree = _tree(ref, tag + "|p")
        share, _ = convert.lm_rank_share(tree, cfg, mesh, "cpu")
        whole = convert.lm_from_reference(tree, cfg, "cpu")
        rows = mesh.batch_rows(B_LM)
        for run, smax in (("prefill", SMAX), ("fallback", FALLBACK_SMAX)):
            _zero_paths()
            got, caches = _prefill_then_decode(share, cfg, tokens_all, smax,
                                               mesh)
            out[f"{tag}|{run}|paths"] = _paths()
            want, wc = _prefill_then_decode(whole, cfg, tokens_all, smax)
            out[f"{tag}|{run}|got"] = np.stack(got)
            out[f"{tag}|{run}|want"] = np.stack([w[rows] for w in want])
            mine = lm.cache_share(wc, mesh)
            out[f"{tag}|{run}|cache_err"] = np.array(max(
                float((caches[k][n] - mine[k][n]).abs().max())
                for k in caches for n in caches[k]))


def _prefill_then_decode(params, cfg, tokens, smax, mesh=None):
    """``lm_prefill`` of the first ``PREFILL_SEQ`` tokens into caches of
    ``smax`` positions, then one decode step a remaining token -> (each
    call's logits, the caches)."""
    with torch.no_grad():
        logits, caches = lm.lm_prefill(params, cfg, tokens[:, :PREFILL_SEQ],
                                       smax, mesh)
        out = [_np(logits)]
        for j in range(tokens.shape[1] - PREFILL_SEQ):
            pos = torch.full((tokens.shape[0],), PREFILL_SEQ + j,
                             dtype=torch.int32)
            logits, caches = lm.lm_decode_step(
                params, cfg, tokens[:, PREFILL_SEQ + j], pos, caches, mesh,
                smax)
            out.append(_np(logits))
    return out, caches


def _rank_world8(rank: int, ref: dict) -> dict:
    import torch.distributed as tdist
    mesh = mesh_mod.make_mesh(model=MODEL)
    out = {"coord": np.array([mesh.data_index, mesh.model_index]),
           "model_group": np.array(tdist.get_process_group_ranks(
               mesh.model_group)),
           "data_group": np.array(tdist.get_process_group_ranks(
               mesh.data_group))}
    _bodies(mesh, ref, out)
    _lm_decode(mesh, ref, out)
    _moe(mesh, ref, out)
    _prefill_and_fallback(mesh, ref, out)
    return out


def _rank_world1(rank: int, ref: dict) -> dict:
    """A world of one: the mesh's paths against the one-device paths on
    the same tensors (random weights from the port's ``lm_init``)."""
    import torch.distributed as tdist
    mesh = mesh_mod.make_mesh(model=1)
    out = {}
    for arch in LM_ARCHS:
        cfg = _cfg(arch, "float32")
        params = lm.lm_init(cfg, seed=0, device="cpu", mesh=mesh)
        same = lm.lm_init(cfg, seed=0, device="cpu")
        out[f"{arch}|init_equal"] = np.array(all(
            torch.equal(params[k], same[k]) for k in same))
        tokens = torch.from_numpy(np.random.default_rng(4).integers(
            0, cfg.vocab, (B_LM, 6)).astype(np.int32))
        with torch.no_grad():
            a, ca = lm.lm_prefill(params, cfg, tokens[:, :4], SMAX, mesh)
            b, cb = lm.lm_prefill(params, cfg, tokens[:, :4], SMAX)
            steps = [(a, b)]
            for j in range(2):
                pos = torch.full((B_LM,), 4 + j, dtype=torch.int32)
                a, ca = lm.lm_decode_step(params, cfg, tokens[:, 4 + j], pos,
                                          ca, mesh, SMAX)
                b, cb = lm.lm_decode_step(params, cfg, tokens[:, 4 + j], pos,
                                          cb)
                steps.append((a, b))
        out[f"{arch}|bitwise"] = np.array(
            all(torch.equal(x, y) for x, y in steps)
            and all(torch.equal(ca[k][n], cb[k][n]) for k in ca
                    for n in ca[k]))
    # the MoE body through the exchange over a group of one
    cfg = registry.LM_ARCHS["deepseek-v3-671b"].SMOKE
    mp = {k[len("moe_layers/moe/"):]: v[0] for k, v in lm.lm_init(
        cfg, seed=1, device="cpu").items() if k.startswith("moe_layers/moe/")}
    x = torch.randn(24, cfg.d_model, generator=torch.Generator().manual_seed(
        5)).to(cfg.torch_dtype)
    with torch.no_grad():
        local = moe._moe_body(mp, x, cfg.moe)
        exchanged = moe._moe_body(mp, x, cfg.moe, tdist.group.WORLD)
    out["moe_group_of_one_bitwise"] = np.array(all(
        torch.equal(p, q) for p, q in zip(local, exchanged)))
    # the flash bodies at one shard against the one-device decode paths
    gen = torch.Generator().manual_seed(6)
    b, smax = 3, 10
    pos = torch.tensor([0, 4, 9], dtype=torch.int32)
    gcfg = attn.GQAConfig(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8,
                          qk_norm=True)
    gp = attn.gqa_init(gcfg, generator=gen, device="cpu",
                       dtype=torch.float32)
    xd = torch.randn(b, 1, 32, generator=gen)
    kc, vc = (torch.randn(b, smax, 2, 8, generator=gen) for _ in range(2))
    y_whole, c_whole = attn.gqa_decode(gp, gcfg, xd, {"k": kc.clone(),
                                                      "v": vc.clone()}, pos)
    out["gqa_world1_err"] = np.array(_one_shard_gqa(
        gp, gcfg, xd, kc, vc, pos, y_whole, c_whole))
    mcfg = attn.MLAConfig(d_model=32, n_heads=4, q_lora=24, kv_lora=16,
                          dh_nope=8, dh_rope=4, dv=6)
    mlp = attn.mla_init(mcfg, generator=gen, device="cpu",
                        dtype=torch.float32)
    ckv, kr = torch.randn(b, smax, 16, generator=gen), \
        torch.randn(b, smax, 4, generator=gen)
    y_whole, c_whole = attn.mla_decode(mlp, mcfg, xd, {"ckv": ckv.clone(),
                                                       "kr": kr.clone()}, pos)
    out["mla_world1_err"] = np.array(_one_shard_mla(
        mlp, mcfg, xd, ckv, kr, pos, y_whole, c_whole))
    return out


def _one_shard_gqa(p, cfg, x, kc, vc, pos, y_whole, c_whole) -> float:
    """``_flash_decode_body`` at one shard through the world's collectives,
    wired as ``gqa_decode`` wires it -> max |difference| from the
    one-device path (output and caches)."""
    import torch.distributed as tdist
    b, h, kv, dh = x.shape[0], cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k_new, v_new = attn._gqa_qkv(p, cfg, x, pos)
    kc, vc = kc.clone(), vc.clone()
    o, kc, vc = attn._flash_decode_body(
        q.view(b, kv, h // kv, dh), kc, vc, k_new[:, 0], v_new[:, 0], pos,
        group=tdist.group.WORLD, index=0, smax=kc.shape[1], n_shards=1)
    y = o.view(b, 1, h * dh) @ p["wo"]
    return max(float((y - y_whole).abs().max()),
               float((kc - c_whole["k"]).abs().max()),
               float((vc - c_whole["v"]).abs().max()))


def _one_shard_mla(p, cfg, x, ckv, kr, pos, y_whole, c_whole) -> float:
    """``_mla_flash_body`` at one shard, wired as ``mla_decode`` wires it
    -> max |difference| from the one-device path."""
    import torch.distributed as tdist
    q_abs, qr, ckv_new, kr_new = attn._mla_absorbed(p, cfg, x, pos)
    ckv, kr = ckv.clone(), kr.clone()
    ctx, ckv, kr = attn._mla_flash_body(
        q_abs, qr, ckv, kr, ckv_new, kr_new, pos, group=tdist.group.WORLD,
        index=0, smax=ckv.shape[1], n_shards=1, scale=attn.mla_scale(cfg))
    y = attn._mla_out(p, cfg, ctx, x.dtype)
    return max(float((y - y_whole).abs().max()),
               float((ckv - c_whole["ckv"]).abs().max()),
               float((kr - c_whole["kr"]).abs().max()))


CASES = {"world8": _rank_world8, "world1": _rank_world1}


def _die_with_parent() -> None:
    """SIGKILL this rank when the child that spawned it dies."""
    ctypes.CDLL("libc.so.6").prctl(1, signal.SIGKILL)   # PR_SET_PDEATHSIG


def _rank_main(rank: int, world: int, case: str, tmp: str,
               ref_path: str) -> None:
    _die_with_parent()
    torch.set_num_threads(1)
    torch.distributed.init_process_group(
        "gloo", init_method="file://" + os.path.join(tmp, "rendezvous"),
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=WORLD_TIMEOUT_S // 2))
    try:
        ref = {}
        if ref_path:
            with np.load(ref_path) as f:
                ref = dict(f)
        out = CASES[case](rank, ref)
        np.savez(os.path.join(tmp, f"rank{rank}.npz"), **out)
    finally:
        torch.distributed.destroy_process_group()


def _child_main(case: str, world: str, tmp: str, ref_path: str) -> None:
    with open(os.path.join(tmp, "pid"), "w") as f:
        f.write(str(os.getpid()))
    torch.multiprocessing.spawn(_rank_main,
                                args=(int(world), case, tmp, ref_path),
                                nprocs=int(world), join=True)


# ---------------------------------------------------------------------------
# helpers of the checks
# ---------------------------------------------------------------------------
def _rank(d: int, m: int) -> int:
    return d * MODEL + m


def _rows(b: int, d: int) -> slice:
    if b % DATA:
        return slice(0, b)
    return slice(d * b // DATA, (d + 1) * b // DATA)


def _seq(smax: int, m: int) -> slice:
    s_loc = smax // MODEL
    return slice(m * s_loc, (m + 1) * s_loc)


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _whole_rows(world8, key: str, b: int) -> np.ndarray:
    """A per-row output (every model rank of a data row the same, checked)
    reassembled over the data rows."""
    parts = []
    for d in range(DATA if b % DATA == 0 else 1):
        first = world8[_rank(d, 0)][key]
        for m in range(1, MODEL):
            np.testing.assert_array_equal(world8[_rank(d, m)][key], first)
        parts.append(first)
    return np.concatenate(parts)


def _whole_cache(world8, key: str, b: int) -> np.ndarray:
    """A cache [..., B_loc, S_loc, ...] reassembled from every rank's
    slice (``lead`` axes before the batch: 0 for a body's, 1 for a
    stack's)."""
    lead = 1 if "|caches|" in key else 0
    rows = []
    for d in range(DATA if b % DATA == 0 else 1):
        rows.append(np.concatenate([world8[_rank(d, m)][key]
                                    for m in range(MODEL)], axis=lead + 1))
    return np.concatenate(rows, axis=lead)


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------
def test_make_mesh_rank_order_is_jax_device_order(jax_ref, world8):
    """Rank r sits where ``jax.make_mesh((2, 4), ("data", "model"))`` puts
    host device r, and its model and data groups are that row and
    column."""
    ids = jax_ref["mesh_ids"]
    for r, o in enumerate(world8):
        d, m = (int(v) for v in o["coord"])
        assert ids[d, m] == r
        assert o["model_group"].tolist() == ids[d].tolist()
        assert o["data_group"].tolist() == ids[:, m].tolist()


def test_make_mesh_without_a_world():
    """No process group (this process): ``model`` 1 is a world of one,
    more refuses; the batch rows and sequence split rules."""
    m = mesh_mod.make_mesh(model=1)
    assert (m.axis_names, m.shape, m.group) == (("data", "model"), (1, 1),
                                                None)
    with pytest.raises(ValueError, match="model=4 needs a torch"):
        mesh_mod.make_mesh(model=4)
    grid = mesh_mod.Mesh(("data", "model"), (2, 4), data_index=1,
                         model_index=3)
    assert grid.batch_rows(6) == slice(3, 6)
    assert grid.batch_rows(5) == slice(0, 5)
    assert (grid.seq_shards(16), grid.seq_shards(18)) == (4, 1)
    assert lm.decode_cache_specs(registry.LM_ARCHS["qwen3-14b"].SMOKE, 6,
                                 16, grid)["dense"]["k"].shape == \
        (2, 3, 4, 2, 16)
    with pytest.raises(ValueError, match="needs the cache's whole length"):
        attn.seq_shards(grid, None)


# ---------------------------------------------------------------------------
# the flash-decode bodies against JAX's shard_map
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("tag", list(BODY_CASES))
def test_gqa_flash_body_matches_jax(jax_ref, world8, tag):
    """``_flash_decode_body`` on 8 ranks against the reference's
    ``_sharded_cache_attn`` at (2, 4): the output and every shard of both
    caches, the new entry written only on its owning shard (B 1: the
    batch replicated over data; B 4: split)."""
    b, pos = BODY_CASES[tag]
    close(_whole_rows(world8, f"gqa|{tag}|o", b), jax_ref[f"gqa|{tag}|o_out"])
    for name in ("k", "v"):
        got = _whole_cache(world8, f"gqa|{tag}|{name}", b)
        close(got, jax_ref[f"gqa|{tag}|{name}_out"])
        changed = np.abs(got - jax_ref[f"gqa|{tag}|{name}"]).max(
            axis=(2, 3)) > 0
        assert changed.sum() == b and all(changed[i, p]
                                          for i, p in enumerate(pos))


@pytest.mark.parametrize("tag", list(BODY_CASES))
def test_mla_flash_body_matches_jax(jax_ref, world8, tag):
    b, _ = BODY_CASES[tag]
    close(_whole_rows(world8, f"mla|{tag}|ctx", b),
          jax_ref[f"mla|{tag}|ctx_out"])
    for name in ("ckv", "kr"):
        close(_whole_cache(world8, f"mla|{tag}|{name}", b),
              jax_ref[f"mla|{tag}|{name}_out"])


# ---------------------------------------------------------------------------
# lm_decode_step at (2, 4): the reference's test_flash_decode_matches_...
# ---------------------------------------------------------------------------
def _lm_want(jax_ref, arch, dtype) -> str:
    tag = f"lm|{arch}|{dtype}"
    return f"{tag}|kept" if f"{tag}|kept|logits0" in jax_ref else \
        f"{tag}|jax"


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_decode_8dev_matches_jax_float32(jax_ref, world8, arch):
    """9 decode steps from zero caches (the batch of 2 split over data,
    the 16 positions over model), float32: every step's logits and every
    rank's cache slices at 1e-5; every layer on the flash path and every
    MoE layer expert-parallel."""
    tag, want = f"lm|{arch}|float32", _lm_want(jax_ref, arch, "float32")
    cfg = _cfg(arch, "float32")
    for t in range(STEPS):
        close(_whole_rows(world8, f"{tag}|logits{t}", B_LM),
              jax_ref[f"{want}|logits{t}"])
    for key in [k for k in world8[0] if k.startswith(f"{tag}|caches|")]:
        close(_whole_cache(world8, key, B_LM),
              jax_ref[key.replace(tag, want)])
    for o in world8:
        flash, whole, ep, local = o[f"{tag}|paths"].tolist()
        assert (flash, whole) == (STEPS * cfg.n_layers, 0)
        assert (ep, local) == (STEPS * cfg.n_moe_layers, 0)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_decode_8dev_matches_jax_bf16(jax_ref, world8, arch):
    tag, want = f"lm|{arch}|bfloat16", _lm_want(jax_ref, arch, "bfloat16")
    scale = max(np.abs(jax_ref[f"{want}|logits{t}"]).max()
                for t in range(STEPS))
    for t in range(STEPS):
        got = _whole_rows(world8, f"{tag}|logits{t}", B_LM)
        assert np.isfinite(got).all()
        assert np.abs(got - jax_ref[f"{want}|logits{t}"]).max() \
            <= BF16_TOL * scale
    for key in [k for k in world8[0] if k.startswith(f"{tag}|caches|")]:
        wv = jax_ref[key.replace(tag, want).replace("|caches|",
                                                    "|caches|b16|")]
        import ml_dtypes
        wv = wv.view(ml_dtypes.bfloat16).astype(np.float32)
        err = np.abs(_whole_cache(world8, key, B_LM) - wv).max()
        assert err <= BF16_TOL * np.abs(wv).max(), (key, err)


@pytest.mark.parametrize("arch", LM_ARCHS)
@pytest.mark.parametrize("run", ["prefill", "fallback"])
def test_lm_prefill_and_fallback_match_one_process(world8, arch, run):
    """``lm_prefill`` writing each rank's cache slices (MoE in sequence
    parallel) then 3 decode steps, against the same on one process at
    1e-5 (logits and caches); at 18 positions, which 4 ranks do not
    divide, the whole-cache path (no flash) gives the same."""
    tag = f"lm|{arch}|float32|{run}"
    cfg = _cfg(arch, "float32")
    for o in world8:
        close(o[f"{tag}|got"], o[f"{tag}|want"])
        assert float(o[f"{tag}|cache_err"]) <= TOL
        flash, whole, ep, local = o[f"{tag}|paths"].tolist()
        n_attn = 3 * cfg.n_layers
        assert (flash, whole) == ((n_attn, 0) if run == "prefill"
                                  else (0, n_attn))
        assert (ep, local) == (4 * cfg.n_moe_layers, 0)


# ---------------------------------------------------------------------------
# moe_apply: sequence parallel in prefill, replicated in decode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", list(MOE_SHAPES))
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_apply_8dev_matches_jax(jax_ref, world8, arch, mode):
    """8 experts, 2 a rank: ``y`` at 1e-5 (prefill: each rank's rows
    gathered back along the sequence; decode: every rank the whole
    batch), ``aux`` at 1e-5 and ``dropped`` exactly, against JAX as
    shipped where no expert overflowed and the kept-only dispatch where
    one did."""
    tag = f"moe|{arch}|{mode}"
    shipped_drop = float(jax_ref[f"{tag}|jax|dropped"])
    want = "jax" if shipped_drop == 0 else "kept"
    if mode == "decode":
        got = world8[0][f"{tag}|y"]
        for o in world8[1:]:
            np.testing.assert_array_equal(o[f"{tag}|y"], got)
    else:
        got = _whole_rows(world8, f"{tag}|y", MOE_SHAPES[mode][0])
    close(got, jax_ref[f"{tag}|{want}|y"])
    for o in world8:
        close(o[f"{tag}|aux"], jax_ref[f"{tag}|{want}|aux"])
        assert float(o[f"{tag}|dropped"]) == float(
            jax_ref[f"{tag}|{want}|dropped"])
    assert float(jax_ref[f"{tag}|kept|dropped"]) == shipped_drop


# ---------------------------------------------------------------------------
# a world of one, the refusal, the launcher
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_world_of_one_is_the_one_device_path_bitwise(world1, arch):
    """At ``make_mesh(model=1)`` in a world of one, ``lm_init`` draws the
    same weights and ``lm_prefill`` then two decode steps give the
    one-device path's logits and caches bit for bit."""
    assert bool(world1[f"{arch}|init_equal"])
    assert bool(world1[f"{arch}|bitwise"])


def test_world_of_one_exchange_and_bodies(world1):
    """The MoE body through the ``all_to_all`` over a group of one is the
    local body bit for bit; both flash bodies at one shard, through their
    all-reduces, are the one-device decode within 1e-5."""
    assert bool(world1["moe_group_of_one_bitwise"])
    assert float(world1["gqa_world1_err"]) <= TOL
    assert float(world1["mla_world1_err"]) <= TOL


def test_moe_refuses_autograd_through_the_exchange(monkeypatch):
    """A model group of more than one rank (a stand-in: no process group
    is made here) with a parameter that records a gradient raises before
    any collective, naming item 15.4; the same call under no_grad gets
    past the check (to the collective, which the stand-in group lacks)."""
    cfg = registry.LM_ARCHS["qwen3-moe-235b-a22b"].SMOKE.moe
    p = moe.moe_init(cfg, generator=torch.Generator().manual_seed(0),
                     device="cpu", dtype=torch.float32)
    for w in ("w_gate", "w_up", "w_down"):
        p[w] = p[w][:4].clone()
    p["w_up"].requires_grad_(True)
    monkeypatch.setattr(moe.dist, "group_size", lambda group: 2)
    x = torch.randn(6, cfg.d_model)
    with pytest.raises(NotImplementedError, match="item 15.4"):
        moe._moe_body(p, x, cfg, group=object())
    monkeypatch.setattr(moe.dist, "all_to_all", _no_collective)
    with torch.no_grad(), pytest.raises(RuntimeError, match="collective"):
        moe._moe_body(p, x, cfg, group=object())


def _no_collective(*args):
    raise RuntimeError("collective reached")


def test_serve_launcher_model_ranks_on_cpu(started):
    """``launch.serve --arch deepseek-v3-671b --smoke --model-ranks 4`` on
    the CPU: four gloo ranks decode the SMOKE cell, each prints its line,
    every logit finite."""
    rc, out, err = started.wait("launcher")
    assert rc == 0, _tail(err)
    for r in range(MODEL):
        assert f"deepseek-v3-671b-smoke/decode_32k (rank {r} of {MODEL})" \
            in out
    assert f"at {MODEL} model ranks over gloo" in out
    assert "every rank finite: True" in out


def test_serve_launcher_model_ranks_refusals():
    with pytest.raises(SystemExit, match="train_4k at 2 ranks.*item 15.4"):
        launch_serve.main(["--arch", "qwen3-14b", "--shape", "train_4k",
                           "--smoke", "--device", "cpu", "--model-ranks",
                           "2"])
    with pytest.raises(SystemExit):
        launch_serve.main(["--arch", "deepfm", "--smoke", "--device", "cpu",
                           "--model-ranks", "2"])


if __name__ == "__main__":
    _child_main(*sys.argv[1:])
