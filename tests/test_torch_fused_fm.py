"""The port's plain FM term (``repro_torch.kernels.ref.fused_fm``, what a CPU
tensor runs through ``ops.fm_interaction``) against the JAX package's
Pallas kernel (in interpret mode) and its oracle, on the same inputs, at the
JAX package's own kernel-test tolerances.  The CUDA kernel itself is held
against the plain version on the card (``test_torch_cuda.py``).  Also the
nvcc build helper every kernel library goes through."""
import os

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import build
from repro_torch.kernels import fused_fm as fm
from repro_torch.kernels import ops, ref

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 5e-2)}


def _both(x: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype`` (bf16
    rounded once, in numpy, so both hold identical bits)."""
    jdt, tdt, _ = DTYPES[dtype]
    if dtype == "bfloat16":
        bits = x.astype(ml_dtypes.bfloat16)
        return (jnp.asarray(bits),
                torch.from_numpy(bits.view(np.int16))
                .view(torch.bfloat16))
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [(64, 39, 10), (130, 7, 16), (8, 2, 4)])
def test_plain_fm_matches_pallas_and_oracle(dtype, shape):
    """test_kernels.py::test_fused_fm_sweep's shapes and tolerances."""
    rng = np.random.default_rng(shape[0])
    jx, tx = _both(rng.normal(size=shape).astype(np.float32), dtype)
    got = ops.fm_interaction(tx)
    assert got.dtype == torch.float32 and got.shape == (shape[0],)
    tol = DTYPES[dtype][2]
    pallas = jops.fm_interaction(jx, impl="pallas", block_b=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(got.numpy(), np.asarray(jref.fused_fm(jx)),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("n_b", [1, 127, 128, 129])
def test_plain_fm_parity_around_the_tpu_block(n_b):
    """test_kernel_parity.py::test_fm_interaction_parity: B around the TPU
    kernel's block of 128, which the port has no need to pad to."""
    rng = np.random.default_rng(n_b)
    x = rng.normal(size=(n_b, 13, 8)).astype(np.float32)
    got = ops.fm_interaction(torch.from_numpy(x)).numpy()
    pallas = jops.fm_interaction(jnp.asarray(x), impl="pallas", block_b=128)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(jref.fused_fm(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)


def test_plain_fm_is_the_pairwise_dot_sum():
    """0.5 * sum_d[(sum_f x)^2 - sum_f x^2] == sum over field pairs f < g of
    <x_f, x_g>, the FM term it stands for (in float64; the plain version
    accumulates in fp32, hence 1e-5)."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(5, 6, 4)).astype(np.float32)
    x64 = x.astype(np.float64)
    want = np.array([sum(x64[b, f] @ x64[b, g] for f in range(6)
                         for g in range(f + 1, 6)) for b in range(5)])
    got = ref.fused_fm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_kernel_wrapper_takes_only_cuda_tensors():
    x = torch.zeros(4, 3, 2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fm.fused_fm(x)
    before = fm.launches["fused_fm"]
    ops.fm_interaction(x)
    assert fm.launches["fused_fm"] == before


@pytest.mark.parametrize("name", ["probe", "fused_fm", "embedding_bag"])
def test_build_library_command_and_cache(name, tmp_path, monkeypatch):
    """One nvcc per source, for sm_90a, into a library named by the
    source's digest, with ptxas's report beside it; a second call reuses
    the library and runs no compiler."""
    calls = []

    def fake_run(cmd, capture_output, text):
        calls.append(cmd)
        open(cmd[cmd.index("-o") + 1], "wb").close()
        return type("R", (), {"returncode": 0,
                              "stderr": "ptxas info: Used 32 registers"})()

    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(build, "nvcc", lambda: "/cuda/bin/nvcc")
    monkeypatch.setattr(build.subprocess, "run", fake_run)
    out = build.build_library(name)
    assert os.path.basename(out).startswith(f"lib{name}-")
    assert out.endswith(".so") and os.path.exists(out)
    with open(out + ".log") as f:
        assert "registers" in f.read()
    (cmd,) = calls
    assert cmd[:8] == ["/cuda/bin/nvcc", "-gencode",
                       "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                       "-shared", "-Xcompiler", "-fPIC"]
    assert cmd[-1] == os.path.join(build.CSRC, f"{name}.cu")
    assert build.build_library(name) == out and len(calls) == 1


def test_build_library_reports_nvcc_errors(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(build, "nvcc", lambda: "nvcc")
    monkeypatch.setattr(build.subprocess, "run", lambda *a, **k: type(
        "R", (), {"returncode": 2, "stderr": "error: bad"})())
    with pytest.raises(RuntimeError, match="nvcc failed on fused_fm.cu") \
            as err:
        build.build_library("fused_fm")
    assert "error: bad" in str(err.value)
    assert not os.listdir(tmp_path)
