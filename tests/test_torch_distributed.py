"""The port's sharded batch query (``core/distributed.py``) and two-tower's
``a2a`` / ``psum16`` user-tower lookups, held against the JAX package on
the CPU.

No process group is ever made in the pytest process.  Every torch world
runs in a child interpreter (this file run as a script) that spawns its
ranks with ``torch.multiprocessing`` (spawn, never fork: the pytest worker
has JAX loaded), each rank on one thread, over gloo with a ``file://``
rendezvous under the test's tmp dir (no TCP port for parallel workers to
collide on).  The child runs in a session of its own and writes its pid
first; on a timeout the test kills the whole session and fails with the
child's stderr, and every rank dies with the child.  The JAX references at
8 host devices come from one subprocess
(``XLA_FLAGS=--xla_force_host_platform_device_count=8``) that writes an
``.npz``: the worlds read their inputs from it too.

Integers and ``a2a`` rows are held bitwise, but where the reference's
clobbered slot touches them: when a destination overflows, the JAX
package writes a zero for each dropped query at ``(owner, 0)``, over the
kept query that holds that slot, and the port keeps the kept query
(``core/distributed.py``'s docstring).  ``psum16`` is held per element
within ``(S + 1) 2^-8 sum_s |partial_s|`` (bf16 partials summed in another
order than the JAX ``psum``).
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
from hypothesis import given, settings, strategies as st

from repro_torch.configs import two_tower_retrieval as tt
from repro_torch.core import convert
from repro_torch.core import distributed as tdist
from repro_torch.core import hashcore as hc
from repro_torch.core import neighborhash as nh
from repro_torch.models import embedding_service as es
from repro_torch.serve import serve_step

from conftest import subprocess_env

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD_TIMEOUT_S = 240
KEYS_SEED, N_KEYS, N_MISS, N_HIT = 3, 4000, 24, 1000
SHARDS = (1, 4, 8)
LOOKUPS = (("replicated", 2.0), ("a2a", 2.0), ("a2a", 0.5))
EMBED_VOCAB, EMBED_DIM, EMBED_ROWS, EMBED_L = 408, 12, 24, 7
EMBED_CASES = ("uniform", "past_vocab", "skewed")
TT_ROWS, TT_TOL, PSUM_TOWER_TOL = 16, 1e-5, 2e-2
IMPLS = ("a2a", "psum16")

# ---------------------------------------------------------------------------
# the JAX references, one subprocess at 8 host devices
# ---------------------------------------------------------------------------
JAX_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import two_tower_retrieval as tt
    from repro.core import compat, distributed as dist, hashcore as hc
    from repro.core import neighborhash as nh
    from repro.data import synthetic
    from repro.models import common as cm, embedding_service as es
    from repro.models import recsys as rec

    KEYS_SEED, N_KEYS, N_MISS, N_HIT = {keys}
    out = {{}}
    keys, payloads = nh.random_kv(N_KEYS, seed=KEYS_SEED)
    out["keys"], out["payloads"] = keys, payloads
    for s in {shards}:
        t = dist.build_sharded(keys, payloads, n_shards=s)
        for k, v in t.arrays.items():
            out[f"build{{s}}_{{k}}"] = v
        out[f"build{{s}}_meta"] = np.array([t.capacity, t.max_probes])

    # the two schemes at world 8 over a (1, 8) mesh
    st8 = dist.build_sharded(keys, payloads, n_shards=8)
    rng = np.random.default_rng(1)
    q = np.concatenate([keys[rng.choice(len(keys), N_HIT)],
                        rng.integers(2**62, 2**63, N_MISS).astype(np.uint64)])
    out["queries"] = q
    qh, ql = hc.key_split_np(q)
    mesh = compat.make_mesh((1, 8), ("data", "model"))
    for scheme, cf in {lookups}:
        fn = dist.make_distributed_lookup(mesh, st8, axis_name="model",
                                          scheme=scheme, capacity_factor=cf)
        with compat.set_mesh(mesh):
            res = fn(st8.device_arrays(), jnp.asarray(qh), jnp.asarray(ql))
        for name, v in zip(("found", "p_hi", "p_lo", "n_dropped"), res):
            out[f"{{scheme}}{{cf}}_{{name}}"] = np.asarray(v)

    # the embedding lookups at (2, 4), test_perf_paths' shapes
    mesh = compat.make_mesh((2, 4), ("data", "model"))
    mi = cm.MeshInfo.from_mesh(mesh)
    V, D, B, L = {embed}
    rng = np.random.default_rng(0)
    table = rng.normal(size=(V, D)).astype(np.float32)
    ids = rng.integers(-1, V, size=(B, L)).astype(np.int32)
    past = ids.copy()
    past[::3, 2] = V + rng.integers(0, 2 * V, len(past[::3, 2]))
    skewed = rng.integers(-1, V // 4, size=(B, L)).astype(np.int32)
    out["table"] = table
    # one jit a function: the three cases share a shape
    a2a = jax.jit(lambda t, x: es.embed_lookup_a2a(t, x, mesh, mi))
    psum = {{m: jax.jit(lambda t, x, m=m: es.embed_bag_psum(t, x, m, mesh, mi))
            for m in ("sum", "mean")}}
    for case, x in (("uniform", ids), ("past_vocab", past),
                    ("skewed", skewed)):
        out[f"ids_{{case}}"] = x
        with compat.set_mesh(mesh):
            out[f"a2a_{{case}}"] = np.asarray(a2a(table, x))
            for mode in ("sum", "mean"):
                out[f"psum_{{mode}}_{{case}}"] = np.asarray(
                    psum[mode](table, x))

    # two-tower's user tower at SMOKE on a (1, 4) mesh
    cfg = tt.SMOKE
    params, _ = cm.unbox(rec.two_tower_init(jax.random.key(0), cfg))
    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from flat(v, prefix + k + "|")
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                yield from flat(v, prefix + str(i) + "|")
        else:
            yield prefix[:-1], np.asarray(tree)
    for k, v in flat(params):
        out["p|" + k] = v
    batch = synthetic.recsys_batch(np.random.default_rng(5), cfg, {tt_rows})
    for k in ("user_id", "hist_items", "dense"):
        out["batch_" + k] = batch[k]
    mesh = compat.make_mesh((1, 4), ("data", "model"))
    mi = cm.MeshInfo.from_mesh(mesh)
    jb = {{k: jnp.asarray(v) for k, v in batch.items()}}
    with compat.set_mesh(mesh):
        for impl in ("xla", "a2a", "psum16"):
            tower = jax.jit(lambda p, b, impl=impl: rec.user_tower(
                p, cfg, b, mi, mesh, impl))
            out["tower_" + impl] = np.asarray(tower(params, jb))
    np.savez(sys.argv[1], **out)
    print("JAX_REF_OK")
""").format(keys=(KEYS_SEED, N_KEYS, N_MISS, N_HIT), shards=SHARDS,
            lookups=LOOKUPS,
            embed=(EMBED_VOCAB, EMBED_DIM, EMBED_ROWS, EMBED_L),
            tt_rows=TT_ROWS)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_ref") / "ref.npz"
    r = subprocess.run([sys.executable, "-c", JAX_SCRIPT, str(path)],
                       cwd=REPO, capture_output=True, text=True,
                       timeout=WORLD_TIMEOUT_S, env=subprocess_env())
    assert "JAX_REF_OK" in r.stdout, r.stderr[-3000:]
    with np.load(path) as f:
        return dict(f) | {"path": str(path)}


# ---------------------------------------------------------------------------
# the torch worlds: this file as a script, ranks spawned
# ---------------------------------------------------------------------------
def _tail(text) -> str:
    if isinstance(text, bytes):
        text = text.decode(errors="replace")
    return (text or "")[-3000:]


def run_world(tmp, case: str, world: int, ref_path: str) -> list:
    """Runs ``case`` on ``world`` ranks in a child interpreter -> each
    rank's outputs (a dict of arrays)."""
    cmd = [sys.executable, os.path.abspath(__file__), case, str(world),
           str(tmp), ref_path]
    try:
        r = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                           timeout=WORLD_TIMEOUT_S, env=subprocess_env(),
                           start_new_session=True)
    except subprocess.TimeoutExpired as e:
        _kill_session(tmp)
        pytest.fail(f"world {case} x{world} passed {WORLD_TIMEOUT_S} s:\n"
                    f"{_tail(e.stderr)}")
    assert r.returncode == 0, f"world {case} x{world}:\n{_tail(r.stderr)}"
    outs = []
    for rank in range(world):
        with np.load(os.path.join(tmp, f"rank{rank}.npz")) as f:
            outs.append(dict(f))
    return outs


def _kill_session(tmp) -> None:
    """Kills the child's session: the child and every rank it spawned."""
    try:
        with open(os.path.join(tmp, "pid")) as f:
            os.killpg(int(f.read()), signal.SIGKILL)
    except (FileNotFoundError, ProcessLookupError, ValueError):
        pass


@pytest.fixture(scope="module")
def world8(jax_ref, tmp_path_factory):
    return run_world(tmp_path_factory.mktemp("world8"), "lookups", 8,
                     jax_ref["path"])


@pytest.fixture(scope="module")
def world4(jax_ref, tmp_path_factory):
    return run_world(tmp_path_factory.mktemp("world4"), "two_tower", 4,
                     jax_ref["path"])


# ---------------------------------------------------------------------------
# what a rank runs
# ---------------------------------------------------------------------------
def _rank_lookups(rank: int, world: int, ref: dict) -> dict:
    """Both schemes at world 8 (one shard a rank), then the embedding
    lookups as 2 data rows x 4-rank model groups."""
    out = {}
    st_ = tdist.build_sharded(ref["keys"], ref["payloads"], world)
    qh, ql = hc.key_split_np(ref["queries"])
    n_loc = len(qh) // world
    for scheme, cf in LOOKUPS:
        fn = tdist.make_distributed_lookup(None, st_, scheme=scheme,
                                           capacity_factor=cf, device="cpu")
        if scheme == "a2a":
            sl = slice(rank * n_loc, (rank + 1) * n_loc)
            res = fn(qh[sl], ql[sl])
        else:
            res = fn(qh, ql)
        for name, v in zip(("found", "p_hi", "p_lo", "n_dropped"), res):
            out[f"{scheme}{cf}_{name}"] = v.view(torch.int32).numpy() \
                if v.dtype == torch.uint32 else v.numpy()
    groups = [torch.distributed.new_group([4 * d + m for m in range(4)])
              for d in range(2)]
    data, model = divmod(rank, 4)
    group = groups[data]
    rows = EMBED_VOCAB // 4
    block = torch.from_numpy(ref["table"][model * rows:(model + 1) * rows])
    half = EMBED_ROWS // 2
    for case in EMBED_CASES:
        ids = torch.from_numpy(ref[f"ids_{case}"][data * half:
                                                  (data + 1) * half])
        out[f"a2a_{case}"] = es.embed_lookup_a2a(block, ids, EMBED_VOCAB,
                                                 group).numpy()
        for mode in ("sum", "mean"):
            out[f"psum_{mode}_{case}"] = es.embed_bag_psum(
                block, ids, EMBED_VOCAB, mode, group).float().numpy()
    return out


def _tower_params(ref: dict) -> dict:
    return {k[2:].replace("|", "/"): torch.from_numpy(v)
            for k, v in ref.items() if k.startswith("p|")}


def _rank_two_tower(rank: int, world: int, ref: dict) -> dict:
    """The user tower from row blocks under ``a2a`` and ``psum16`` over the
    world, then each rank alone in a group of one (the short-cut)."""
    params, cfg = _tower_params(ref), tt.SMOKE
    batch = {k: ref["batch_" + k] for k in ("user_id", "hist_items",
                                            "dense")}
    out = {}
    for impl in IMPLS:
        model = convert.two_tower_row_blocks(params, cfg, rank, world)
        step = serve_step.recsys_score_fn(cfg, model, lookup_impl=impl)
        out["tower_" + impl] = step(batch).numpy()
    singles = [torch.distributed.new_group([r]) for r in range(world)]
    whole = convert.two_tower_row_blocks(params, cfg, 0, 1)
    for impl in ("xla",) + IMPLS:
        step = serve_step.recsys_score_fn(
            cfg, whole, lookup_impl=impl,
            group=None if impl == "xla" else singles[rank])
        out["single_" + impl] = step(batch).numpy()
    return out


CASES = {"lookups": _rank_lookups, "two_tower": _rank_two_tower}


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
        with np.load(ref_path) as f:
            out = CASES[case](rank, world, dict(f))
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
def _jax_dist():
    from repro.core import distributed as jdist
    return jdist


def clobber_touched(owner: np.ndarray, n_dest: int, cap: int) -> np.ndarray:
    """The queries whose answer the reference's clobbered slot may change:
    the kept query at ``(owner, 0)`` of each destination that overflows,
    and every query whose owner is past the last destination when that
    one overflows (the reference's clamped gather reads its slot 0)."""
    owner = np.asarray(owner)
    counts = np.bincount(owner[owner < n_dest], minlength=n_dest)
    touched = np.zeros(len(owner), bool)
    for d in np.flatnonzero(counts > cap):
        touched[np.flatnonzero(owner == d)[0]] = True
    if counts[n_dest - 1] > cap:
        touched |= owner >= n_dest
    return touched


def _u32(a) -> np.ndarray:
    return np.asarray(a).view(np.uint32)


def _truth(ref: dict, q: np.ndarray):
    order = np.argsort(ref["keys"])
    keys, pay = ref["keys"][order], ref["payloads"][order]
    i = np.clip(np.searchsorted(keys, q), 0, len(keys) - 1)
    found = keys[i] == q
    return found, np.where(found, pay[i], np.uint64(0))


def _lookup_owner(ref: dict) -> np.ndarray:
    hi, lo = hc.key_split_np(ref["queries"])
    return (hc.hash64_np(hi, lo) % np.uint32(8)).astype(np.int32)


def _lookup_outputs(outs: list, tag: str, scheme: str) -> dict:
    """The world's answer as the reference's ``out_specs`` give it: a2a
    concatenates the ranks' slices, replicated is every rank's (checked
    equal)."""
    names = ("found", "p_hi", "p_lo", "n_dropped")
    if scheme == "a2a":
        return {n: np.concatenate([o[f"{tag}_{n}"] for o in outs])
                for n in names}
    for o in outs[1:]:
        for n in names[:3]:
            np.testing.assert_array_equal(o[f"{tag}_{n}"],
                                          outs[0][f"{tag}_{n}"])
    return {n: outs[0][f"{tag}_{n}"] for n in names[:3]}


def _lookup_touched(ref: dict, scheme: str, cf: float) -> np.ndarray:
    n = len(ref["queries"])
    if scheme != "a2a":
        return np.zeros(n, bool)
    owner, n_loc = _lookup_owner(ref), n // 8
    cap = tdist.a2a_capacity(n_loc, 8, cf)
    return np.concatenate([clobber_touched(owner[r * n_loc:(r + 1) * n_loc],
                                           8, cap) for r in range(8)])


def _embed_touched(ids: np.ndarray) -> np.ndarray:
    """Per id of each data row: touched by the clobbered slot."""
    rows = EMBED_VOCAB // 4
    half = EMBED_ROWS // 2
    out = []
    for d in range(2):
        flat = ids[d * half:(d + 1) * half].reshape(-1)
        owner = np.maximum(flat, 0) // rows
        out.append(clobber_touched(owner, 4, tdist.a2a_capacity(
            flat.size, 4, 1.5)))
    return np.concatenate(out).reshape(ids.shape)


def _tower_touched(ref: dict, impl: str) -> np.ndarray:
    """The batch rows a clobbered slot may touch in the JAX user tower at
    4 shards: its user id's lookup, or (a2a) one of its history's."""
    cfg = tt.SMOKE
    uid, hist = ref["batch_user_id"], ref["batch_hist_items"]
    touched = clobber_touched(np.maximum(uid, 0) // (cfg.user_vocab // 4),
                              4, tdist.a2a_capacity(uid.size, 4, 1.5))
    if impl == "a2a":
        flat = hist.reshape(-1)
        touched |= clobber_touched(
            np.maximum(flat, 0) // (cfg.item_vocab // 4), 4,
            tdist.a2a_capacity(flat.size, 4, 1.5)).reshape(hist.shape).any(1)
    return touched


def _psum_bound(ref: dict, case: str, mode: str) -> np.ndarray:
    """(S + 1) 2^-8 sum_s |partial_s| per element (over the bag's count in
    ``mean``): S = 4 bf16 partials, each an fp32 sum of the rows its shard
    owns."""
    table, ids = ref["table"], ref[f"ids_{case}"].astype(np.int64)
    rows = EMBED_VOCAB // 4
    mag = np.zeros((ids.shape[0], table.shape[1]), np.float64)
    for s in range(4):
        mine = (ids >= s * rows) & (ids < (s + 1) * rows)
        part = (table[np.clip(ids, 0, EMBED_VOCAB - 1)]
                * mine[..., None]).sum(1)
        mag += np.abs(part)
    bound = 5 * 2.0 ** -8 * mag
    if mode == "mean":
        cnt = ((ids >= 0) & (ids < EMBED_VOCAB)).sum(1)
        bound /= np.maximum(cnt, 1)[:, None]
    return bound


# ---------------------------------------------------------------------------
# routing, in process (no collective)
# ---------------------------------------------------------------------------
def _routing_pair(owner: np.ndarray, n_dest: int, cap: int):
    import jax.numpy as jnp
    r_j = _jax_dist().route_by_owner(jnp.asarray(owner, jnp.int32), n_dest,
                                     cap)
    r_t = tdist.route_by_owner(torch.from_numpy(owner.astype(np.int32)),
                               n_dest, cap)
    return r_j, r_t


def _assert_same_routing(r_j, r_t) -> None:
    for f in ("dest", "slot_row", "slot_col", "kept"):
        a, b = np.asarray(getattr(r_j, f)), getattr(r_t, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert int(r_j.n_dropped) == int(r_t.n_dropped)
    assert r_t.n_dropped.dtype == torch.int32


@given(st.integers(1, 16), st.integers(0, 80), st.floats(0.1, 3.0),
       st.integers(0, 2**31 - 1))
@settings(max_examples=30, deadline=None)
def test_route_by_owner_matches_jax(n_dest, n, factor, seed):
    """Every field bitwise the JAX function's, overflow included (a
    capacity factor below 1 always drops)."""
    rng = np.random.default_rng(seed)
    owner = rng.integers(0, n_dest, n)
    cap = max(int(np.ceil(n / n_dest * factor)), 1)
    _assert_same_routing(*_routing_pair(owner, n_dest, cap))


@pytest.mark.parametrize("n_dest,cap", [(2, 3), (4, 1), (4, 6)])
def test_route_by_owner_past_the_last_destination_matches_jax(n_dest, cap):
    """An owner at or past ``n_dest`` (an embedding id past the table) is
    kept at a negative column, as the reference's fill-mode take of the
    start gives it."""
    owner = np.array([0, n_dest, 1, n_dest + 3, 1, n_dest - 1, 0, n_dest,
                      n_dest - 1, n_dest - 1])
    r_j, r_t = _routing_pair(owner, n_dest, cap)
    _assert_same_routing(r_j, r_t)
    assert r_t.kept[torch.from_numpy(owner >= n_dest)].all()


def test_scatter_keeps_the_clobbered_slot():
    """The clobbered slot: owners [0,0,0,1,0], 2 destinations, capacity 2.
    The JAX buffer loses query 0's value at (0, 0) to the dropped
    queries' zeros; the port's holds it, and every other entry agrees."""
    import jax.numpy as jnp
    owner = np.array([0, 0, 0, 1, 0])
    x = np.array([11, 12, 13, 14, 15], np.int32)
    r_j, r_t = _routing_pair(owner, 2, 2)
    (b_j,) = _jax_dist().scatter_to_buffers(r_j, [jnp.asarray(x)], 2, 2)
    (b_t,) = tdist.scatter_to_buffers(r_t, [torch.from_numpy(x)], 2, 2)
    assert np.asarray(b_j).tolist() == [[0, 12], [14, 0]]
    assert b_t.tolist() == [[11, 12], [14, 0]]
    (g_t,) = tdist.gather_from_buffers(r_t, [b_t])
    kept = r_t.kept.numpy()
    np.testing.assert_array_equal(g_t.numpy()[kept], x[kept])


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("n_dest,factor", [(3, 0.5), (5, 1.0), (8, 2.0)])
def test_scatter_gather_kept_bitwise(seed, n_dest, factor):
    """Kept queries' fields come back bitwise, 2-D rows too; the buffers
    equal the JAX ones everywhere but (owner, 0) of each overflowing
    destination, where the port holds the kept query (fill elsewhere)."""
    import jax.numpy as jnp
    rng = np.random.default_rng(seed)
    n = 40
    owner = rng.integers(0, n_dest, n)
    cap = max(int(np.ceil(n / n_dest * factor)), 1)
    x = rng.integers(1, 2**31 - 1, n).astype(np.int32)
    rows = rng.normal(size=(n, 3)).astype(np.float32)
    r_j, r_t = _routing_pair(owner, n_dest, cap)
    bufs_j = _jax_dist().scatter_to_buffers(
        r_j, [jnp.asarray(x), jnp.asarray(rows)], n_dest, cap, fill=7)
    bufs_t = tdist.scatter_to_buffers(
        r_t, [torch.from_numpy(x), torch.from_numpy(rows)], n_dest, cap,
        fill=7)
    counts = np.bincount(owner, minlength=n_dest)
    clobbered = np.zeros((n_dest, cap), bool)
    clobbered[counts > cap, 0] = True
    for b_j, b_t, v in zip(bufs_j, bufs_t, (x, rows)):
        b_j, b_t = np.asarray(b_j), b_t.numpy()
        np.testing.assert_array_equal(b_t[~clobbered], b_j[~clobbered])
        for d in np.flatnonzero(counts > cap):
            np.testing.assert_array_equal(
                b_t[d, 0], v[np.flatnonzero(owner == d)[0]])
    kept = r_t.kept.numpy()
    for b_t, v in zip(tdist.gather_from_buffers(r_t, bufs_t), (x, rows)):
        np.testing.assert_array_equal(b_t.numpy()[kept], v[kept])


# ---------------------------------------------------------------------------
# tables
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_shards", SHARDS)
def test_build_sharded_bitwise(jax_ref, n_shards):
    st_ = tdist.build_sharded(jax_ref["keys"], jax_ref["payloads"], n_shards)
    cap, max_probes = jax_ref[f"build{n_shards}_meta"]
    assert (st_.n_shards, st_.capacity, st_.max_probes) == \
        (n_shards, cap, max_probes)
    for k in tdist.WORDS:
        got, want = st_.arrays[k], jax_ref[f"build{n_shards}_{k}"]
        assert got.dtype == want.dtype == np.uint32
        np.testing.assert_array_equal(got, want, err_msg=k)


def test_host_table_answers_as_its_shard():
    keys, payloads = nh.random_kv(3000, seed=4)
    st_ = tdist.build_sharded(keys, payloads, 4)
    hi, lo = hc.key_split_np(keys)
    owner = hc.hash64_np(hi, lo) % np.uint32(4)
    for s in range(4):
        f, p = st_.host_table(s).lookup_host_batch(keys)
        assert (f == (owner == s)).all()
        np.testing.assert_array_equal(p[f], payloads[f])


def test_make_distributed_lookup_checks_its_group(monkeypatch):
    """A shard count other than the group's size raises before any
    collective (a stand-in group: no process group is made here)."""
    st_ = tdist.build_sharded(*nh.random_kv(100, seed=0), 2)
    monkeypatch.setattr(tdist, "group_size", lambda group: 1)
    with pytest.raises(ValueError, match="n_shards=2"):
        tdist.make_distributed_lookup(object(), st_, device="cpu")
    monkeypatch.setattr(tdist, "group_size", lambda group: 2)
    with pytest.raises(ValueError, match="unknown scheme"):
        tdist.make_distributed_lookup(object(), st_, scheme="ring",
                                      device="cpu")


# ---------------------------------------------------------------------------
# the worlds against the JAX mesh
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("scheme,cf", LOOKUPS)
def test_lookup_world8_matches_jax(jax_ref, world8, scheme, cf):
    """World 8 (one shard a rank, gloo) against the JAX (1, 8) mesh: every
    answer bitwise but where the clobbered slot touches it; there the port
    answers as the written data and the reference as not found; the same
    n_dropped a shard."""
    tag = f"{scheme}{cf}"
    got = _lookup_outputs(world8, tag, scheme)
    touched = _lookup_touched(jax_ref, scheme, cf)
    assert (scheme, cf) != ("a2a", 0.5) or touched.any()
    f_j = np.asarray(jax_ref[f"{tag}_found"]).astype(bool)
    np.testing.assert_array_equal(got["found"][~touched], f_j[~touched])
    for w in ("p_hi", "p_lo"):
        np.testing.assert_array_equal(_u32(got[w])[~touched],
                                      _u32(jax_ref[f"{tag}_{w}"])[~touched])
    # there the reference answers as the port or, clobbered, not found
    assert (~f_j | got["found"])[touched].all()
    if scheme == "a2a":
        np.testing.assert_array_equal(got["n_dropped"],
                                      jax_ref[f"{tag}_n_dropped"])
        assert got["n_dropped"].dtype == np.int32


@pytest.mark.parametrize("scheme,cf", LOOKUPS)
def test_lookup_world8_answers_the_written_data(jax_ref, world8, scheme, cf):
    """Every kept query answers its key's payload (hits) or not found
    (misses), the clobbered slot's included; every dropped one not found
    with a zero payload; the drops are a numpy recount of the overflow."""
    tag = f"{scheme}{cf}"
    got = _lookup_outputs(world8, tag, scheme)
    q = jax_ref["queries"]
    n_loc = len(q) // 8
    owner = _lookup_owner(jax_ref)
    dropped = np.zeros(len(q), bool)
    if scheme == "a2a":
        cap = tdist.a2a_capacity(n_loc, 8, cf)
        for r in range(8):
            o = owner[r * n_loc:(r + 1) * n_loc]
            for d in range(8):
                idx = np.flatnonzero(o == d)[cap:] + r * n_loc
                dropped[idx] = True
        assert got["n_dropped"].sum() == dropped.sum()
        assert (cf < 1) == bool(dropped.any())
    found_t, pay_t = _truth(jax_ref, q)
    pay = (_u32(got["p_hi"]).astype(np.uint64) << np.uint64(32)) | \
        _u32(got["p_lo"]).astype(np.uint64)
    np.testing.assert_array_equal(got["found"][~dropped], found_t[~dropped])
    np.testing.assert_array_equal(pay[~dropped], pay_t[~dropped])
    assert not got["found"][dropped].any() and not pay[dropped].any()


@pytest.mark.parametrize("case", EMBED_CASES)
def test_embed_lookup_a2a_world8_matches_jax(jax_ref, world8, case):
    """2 data rows x 4-rank model groups against the JAX (2, 4) mesh:
    rows bitwise but where the clobbered slot touches them (the skewed
    case overflows shard 0; there the port gives the id's own row), ids
    past the table included."""
    ids = jax_ref[f"ids_{case}"]
    half = EMBED_ROWS // 2
    got = np.concatenate([world8[4 * d][f"a2a_{case}"] for d in range(2)])
    for d in range(2):                 # every rank of a data row agrees
        for m in range(1, 4):
            np.testing.assert_array_equal(world8[4 * d + m][f"a2a_{case}"],
                                          got[d * half:(d + 1) * half])
    want = jax_ref[f"a2a_{case}"]
    touched = _embed_touched(ids)
    assert case != "skewed" or touched.any()
    np.testing.assert_array_equal(got[~touched], want[~touched])
    table = jax_ref["table"]
    rows_t = got[touched & (ids >= 0) & (ids < EMBED_VOCAB)]
    np.testing.assert_array_equal(
        rows_t, table[ids[touched & (ids >= 0) & (ids < EMBED_VOCAB)]])
    if case == "past_vocab":
        assert (ids >= EMBED_VOCAB).any()


@pytest.mark.parametrize("mode", ("sum", "mean"))
@pytest.mark.parametrize("case", EMBED_CASES)
def test_embed_bag_psum_world8_within_bf16_bound(jax_ref, world8, case,
                                                 mode):
    half = EMBED_ROWS // 2
    got = np.concatenate([world8[4 * d][f"psum_{mode}_{case}"]
                          for d in range(2)])
    for d in range(2):
        for m in range(1, 4):
            np.testing.assert_array_equal(
                world8[4 * d + m][f"psum_{mode}_{case}"],
                got[d * half:(d + 1) * half])
    want = jax_ref[f"psum_{mode}_{case}"]
    err = np.abs(got.astype(np.float64) - want)
    bound = _psum_bound(jax_ref, case, mode)
    print(f"psum16 {case} {mode}: max err {err.max():.3e}, "
          f"max err / bound {np.max(err / np.maximum(bound, 1e-30)):.3f}")
    assert (err <= bound).all()


@pytest.mark.parametrize("impl", IMPLS)
def test_two_tower_world4_matches_jax(jax_ref, world4, impl):
    """``TwoTower`` at SMOKE from row blocks of the JAX ``two_tower_init``
    weights (``convert.two_tower_row_blocks``) through
    ``recsys_score_fn(lookup_impl=...)`` at world 4, against the JAX
    ``user_tower`` on a (1, 4) mesh: a2a within 1e-5 but for rows the
    clobbered slot touches; psum16 within the JAX package's own psum16
    tolerance (``test_perf_paths``' 2e-2); every rank the same vectors,
    norms 1 +- 1e-5."""
    got = world4[0]["tower_" + impl]
    for o in world4[1:]:
        np.testing.assert_array_equal(o["tower_" + impl], got)
    want = jax_ref["tower_" + impl]
    ok = ~_tower_touched(jax_ref, impl)
    tol = TT_TOL if impl == "a2a" else PSUM_TOWER_TOL
    np.testing.assert_allclose(got[ok], want[ok], rtol=0, atol=tol)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("impl", IMPLS)
def test_two_tower_group_of_one_takes_the_local_path(jax_ref, world4, impl):
    """A group of one takes the reference's short-cut: the whole tables'
    local path (psum16's bag is the xla bag, bitwise; a2a's mean of the
    gathered rows within 1e-5 of it), and the xla tower within 1e-5 of the
    JAX one."""
    for o in world4:
        xla = o["single_xla"]
        if impl == "psum16":
            np.testing.assert_array_equal(o["single_psum16"], xla)
        else:
            np.testing.assert_allclose(o["single_a2a"], xla, rtol=0,
                                       atol=TT_TOL)
        np.testing.assert_allclose(xla, jax_ref["tower_xla"], rtol=0,
                                   atol=TT_TOL)


def test_row_blocks_are_views_checked_by_name_and_shape():
    cfg = tt.SMOKE
    from repro_torch.models import recsys as rec
    model = rec.recsys_init(cfg, device="cpu")
    blocks = convert.two_tower_row_blocks(model, cfg, 3, 4)
    assert blocks.user_table.shape == (cfg.user_vocab // 4, cfg.embed_dim)
    assert blocks.user_table.untyped_storage().data_ptr() == \
        model.user_table.untyped_storage().data_ptr()
    assert torch.equal(blocks.item_table, model.item_table[750:])
    assert blocks.cat_table.shape == model.cat_table.shape
    with pytest.raises(ValueError, match="whole tables"):
        blocks.item_tower(torch.zeros(2, dtype=torch.int32),
                          torch.zeros(2, dtype=torch.int32))
    params = convert.params_of(model)
    params.pop("user_mlp/1/b")
    with pytest.raises(ValueError, match="needs parameters"):
        convert.two_tower_row_blocks(params, cfg, 0, 4)
    with pytest.raises(ValueError, match="do not split"):
        convert.two_tower_row_blocks(model, cfg, 0, 3)
    with pytest.raises(ValueError, match="lookup_impl"):
        model.with_lookup("psum32")


if __name__ == "__main__":
    _child_main(*sys.argv[1:])
