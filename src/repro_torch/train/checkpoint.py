"""Checkpoint save and restore, from the JAX package's
``train/checkpoint.py``, in its on-disk layout: one ``ckpt.npz`` of
path-keyed leaves (``params::mlp::0::w``, ``opt::mlp::0::w::m``), then a
JSON sidecar (step, meta, leaf count) written as ``meta.json`` and renamed
to ``META.json``, the commit marker.  npz cannot hold bf16 or fp8: such a
leaf is stored as its bytes ([..., itemsize] uint8) beside a
``<key>@dtype`` entry naming its dtype, as there.  So a checkpoint written
by one package restores in the other.

An async save snapshots every leaf to host memory before its worker thread
starts, so the step loop may go on updating the tensors (the sparse step
does so in place) while the file is written.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Optional

import numpy as np
import torch

SEP = "::"


def _key(prefix: str, path: str) -> str:
    return SEP.join([prefix] + path.split("/"))


def _host(t: torch.Tensor) -> np.ndarray:
    """A copy of ``t`` in host memory as numpy (never a view of ``t``)."""
    t = t.detach().contiguous().to("cpu", copy=True)
    if t.dtype.is_floating_point and t.element_size() < 4 \
            and t.dtype != torch.float16:           # bf16, fp8: by bytes
        return t.reshape(-1).view(torch.uint8).reshape(
            tuple(t.shape) + (t.element_size(),)).numpy()
    return t.numpy()


def _flatten(params: dict, opt_state: Optional[dict]) -> dict:
    leaves = {_key("params", k): v for k, v in params.items()}
    for k, st in (opt_state or {}).items():
        leaves.update({_key("opt", f"{k}/{n}"): v for n, v in st.items()})
    out = {}
    for key, t in leaves.items():
        arr = _host(t)
        if arr.dtype == np.uint8 and t.dtype != torch.uint8:
            out[key + "@dtype"] = np.frombuffer(
                str(t.dtype).removeprefix("torch.").encode(), dtype=np.uint8)
        out[key] = arr
    return out


def save(path: str, *, params: dict, opt_state: Optional[dict] = None,
         step: int = 0, meta: Optional[dict] = None,
         async_save: bool = False) -> Optional[threading.Thread]:
    """Writes ``params`` (and ``opt_state``) at ``step``; with
    ``async_save`` the write runs on a started thread, which is returned
    (join it before relying on the files)."""
    os.makedirs(path, exist_ok=True)
    blobs = _flatten(params, opt_state)
    sidecar = {"step": int(step), "meta": meta or {},
               "n_leaves": len(blobs)}

    def write():
        np.savez(os.path.join(path, "ckpt.npz"), **blobs)
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(sidecar, f)
        os.replace(os.path.join(path, "meta.json"),
                   os.path.join(path, "META.json"))   # commit marker

    if async_save:
        t = threading.Thread(target=write)
        t.start()
        return t
    write()
    return None


def exists(path: str) -> bool:
    return os.path.exists(os.path.join(path, "META.json"))


def _leaf(data, key: str, like: torch.Tensor) -> torch.Tensor:
    arr = np.array(data[key], order="C")      # 0-d stays 0-d
    if key + "@dtype" in data:
        dtype = getattr(torch, bytes(data[key + "@dtype"]).decode())
        t = torch.from_numpy(arr).view(dtype).reshape(arr.shape[:-1])
    else:
        t = torch.from_numpy(arr)
    return t.to(device=like.device, dtype=like.dtype)


def restore(path: str, *, params_like: dict, opt_like: Optional[dict] = None):
    """-> (params, opt_state, step, meta), every leaf a fresh tensor of its
    ``*_like`` counterpart's dtype on its device."""
    with open(os.path.join(path, "META.json")) as f:
        sidecar = json.load(f)
    with np.load(os.path.join(path, "ckpt.npz")) as data:
        params = {k: _leaf(data, _key("params", k), v)
                  for k, v in params_like.items()}
        opt_state = None if opt_like is None else {
            k: {n: _leaf(data, _key("opt", f"{k}/{n}"), v)
                for n, v in st.items()}
            for k, st in opt_like.items()}
    return params, opt_state, sidecar["step"], sidecar["meta"]
