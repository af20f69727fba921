"""What reserving the card's persisting L2 set-aside costs kernels that do
not use it, measured at ogbn-products' shape.

The port's ``csr_sum`` keeps the rows of its hottest sources in L2 by
reading every other row evict-first, and reserves no persisting set-aside
(``cudaLimitPersistingL2CacheSize``).  This one-off measurement shows why:
it builds chip_smoke.py's S.2 graph (``synthetic.random_graph`` at the
``ogb_products`` cell's size, seed 0, on the card), then, with the
set-aside released (0), reserved at the most the card allows, and released
again, times by CUDA events (median of 10, L2 flushed before each) a plain
``torch.add`` over x [N, 128] fp32 and the marked ``csr_sum`` launch of
GraphSAGE's layer-2 forward over x (``/ deg`` in the launch), each
launch's output held bitwise against the first.  The set-aside is
released when it ends, also on an error.

Run on a CUDA machine from the repository root (about a minute, most of
it the host graph; the small CUDA helper builds with ``nvcc`` into
``build/repro_torch/``):

    PYTHONPATH=src python scripts/l2_set_aside.py

It prints the card's name and power limit, then one JSON object: the
L2's bytes, the most a set-aside may take and what each phase was granted,
with ``add_ms`` and ``csr_sum_ms``.
"""
from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.data import synthetic
from repro_torch.kernels import build
from repro_torch.kernels import segment_sum as seg

HELPER = r"""
#include <cuda_runtime.h>
// The L2's bytes, the most a persisting set-aside may take and the one
// reserved now, after setting it to `want` bytes where want >= 0.
extern "C" int l2_set_aside(long long want, long long* l2, long long* most,
                            long long* now) {
  int dev = 0, m = 0, l = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&m, cudaDevAttrMaxPersistingL2CacheSize, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&l, cudaDevAttrL2CacheSize, dev);
  if (e == cudaSuccess && want >= 0)
    e = cudaDeviceSetLimit(cudaLimitPersistingL2CacheSize,
                           static_cast<size_t>(want < m ? want : m));
  size_t got = 0;
  if (e == cudaSuccess) e = cudaDeviceGetLimit(&got,
                                               cudaLimitPersistingL2CacheSize);
  *l2 = l; *most = m; *now = static_cast<long long>(got);
  return static_cast<int>(e);
}
"""
ITERS = 10


def helper() -> ctypes.CDLL:
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    src = os.path.join(build.BUILD_DIR, "l2_set_aside.cu")
    lib = os.path.join(build.BUILD_DIR, "libl2_set_aside.so")
    with open(src, "w") as f:
        f.write(HELPER)
    subprocess.run([build.nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-O2", "-shared", "-Xcompiler", "-fPIC", "-o", lib, src],
                   check=True)
    out = ctypes.CDLL(lib)
    out.l2_set_aside.argtypes = [ctypes.c_longlong] + [
        ctypes.POINTER(ctypes.c_longlong)] * 3
    out.l2_set_aside.restype = ctypes.c_int
    return out


def set_aside(lib: ctypes.CDLL, want: int) -> dict:
    got = [ctypes.c_longlong(0) for _ in range(3)]
    err = lib.l2_set_aside(want, *map(ctypes.byref, got))
    if err != 0:
        raise RuntimeError(f"l2_set_aside({want}) failed: CUDA error {err}")
    return dict(zip(("l2", "most", "set_aside"), (g.value for g in got)))


def time_ms(fn, flush: torch.Tensor) -> float:
    times = []
    for _ in range(ITERS):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main() -> int:
    if not torch.cuda.is_available():
        print("l2_set_aside.py needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    lib = helper()
    d = registry.cell_by_name("ogb_products", "gnn").dims
    host = synthetic.random_graph(np.random.default_rng(0), d["n_nodes"],
                                  d["n_edges"], d["d_feat"], d["n_classes"])
    edges = torch.as_tensor(host["edges"], device=dev)
    del host
    adj = seg.adjacency(edges[0], edges[1], d["n_nodes"])
    x = torch.randn(d["n_nodes"], 128, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(0))
    marked, any_hot = adj.hot_marked(128, seg.l2_bytes(dev))
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)

    def kernel():
        return seg.csr_sum(x, adj.indptr_dst, marked, adj.deg, any_hot)
    first = kernel()
    rows = []
    try:
        for tag, want in (("released", 0), ("reserved", 1 << 40),
                          ("released", 0)):
            row = {"phase": tag, **set_aside(lib, want)}
            row["add_ms"] = time_ms(lambda: torch.add(x, x), flush)
            row["csr_sum_ms"] = time_ms(kernel, flush)
            if not torch.equal(kernel(), first):
                raise RuntimeError(f"csr_sum's bits moved ({tag})")
            rows.append(row)
    finally:
        set_aside(lib, 0)
    hot = seg.hot_sources(adj.indptr_src, 128, seg.l2_bytes(dev))
    print(json.dumps({"x": list(x.shape), "nnz": int(marked.numel()),
                      "hot_rows": int(hot.numel()), "phases": rows}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
