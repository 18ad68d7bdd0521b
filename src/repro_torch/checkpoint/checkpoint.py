"""Crash-consistent checkpoints with async writes and auto-resume.

The port of :mod:`repro.checkpoint`, and its files, leaf for leaf.

Layout: ``<dir>/step_<N:08d>/`` holding one ``.npy`` per leaf of the
reference's pytree (named by its '/'-joined tree path, escaped) plus
``manifest.json`` (step; each leaf's path, file, shape and dtype). Writes
go to ``step_<N>.tmp/``, the manifest is fsynced, and the directory is
renamed: a partially written checkpoint is never visible, so
:func:`latest_step` always resumes from a complete one.

The trees are the port's (nested dicts and lists of tensors, an
:class:`~repro_torch.optim.OptState`); the files hold the reference's
layout:

* dict keys in sorted order, a NamedTuple's fields as ``.step``, ``.mu``,
  ``.nu``, list and tuple items by index, as jax spells a path;
* a ``blocks`` list of per-layer dicts stacked over periods into the
  reference's tuple of per-pattern-position stacks
  (:func:`repro_torch.convert.stack_blocks`; ``period`` is the model's
  pattern length). With a one-block pattern, as every ported model has,
  ``params/blocks/0/attn/wq/w`` is ``[n_layers, d_model, n_heads * head_dim]``;
* bf16 leaves as their 16-bit patterns (an ``.npy`` of ``<V2``, as numpy
  writes ``ml_dtypes.bfloat16``) with ``"dtype": "bfloat16"`` in the
  manifest, never widened. Reading them back needs no ``ml_dtypes``.

:class:`AsyncCheckpointer` copies the tree to the host synchronously and
writes it on a thread; at most one write is in flight (a new save waits for
the previous), and a write's error surfaces on the next ``wait()``.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.convert import stack_blocks, unstack_blocks

__all__ = ["save", "restore", "latest_step", "AsyncCheckpointer"]

_MANIFEST = "manifest.json"
_BF16_BITS = np.dtype("V2")  # a bf16 leaf on the host: its bit patterns


def _esc(path_str: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]", "__", path_str)


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _numpy(x: torch.Tensor) -> np.ndarray:
    """A host tensor as numpy, sharing its storage: bf16 as ``V2``."""
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(_BF16_BITS)
    return x.numpy()


def _host_leaf(x) -> np.ndarray:
    """One leaf copied to the host, its bits kept. Always a copy, so the
    caller may update its tensors in place (a CPU tensor's ``.cpu()`` would
    share its storage)."""
    if isinstance(x, torch.Tensor):
        return _numpy(x.detach().to("cpu", copy=True))
    return np.array(x, copy=True)


def _stack_leaf(xs) -> np.ndarray:
    """One stacked host leaf of per-period leaves, bits kept: each layer's
    tensor copied once, straight into its slice of the stack."""
    first = xs[0]
    if not isinstance(first, torch.Tensor):
        return np.stack([np.asarray(x) for x in xs])
    out = torch.empty((len(xs), *first.shape), dtype=first.dtype)
    for i, x in enumerate(xs):
        out[i].copy_(x.detach())
    return _numpy(out)


def _to_host(tree: Any, period: int = 1) -> Any:
    """The port's tree as the reference's, every leaf a host array and
    each ``blocks`` list stacked into ``period`` stacks."""
    if isinstance(tree, dict):
        return {k: (stack_blocks(v, period, _stack_leaf) if k == "blocks" and isinstance(v, list)
                    else _to_host(v, period))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(_to_host(v, period) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v, period) for v in tree)
    return _host_leaf(tree)


def _flatten(tree: Any, prefix: str = ""):
    """``(path, leaf)`` in jax's order and spelling: sorted dict keys,
    ``.field`` for a NamedTuple, indices for lists and tuples; None has no
    leaves."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], f"{prefix}{k}/")
    elif _is_namedtuple(tree):
        for f, v in zip(tree._fields, tree):
            yield from _flatten(v, f"{prefix}.{f}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _write_npy(path: str, arr: np.ndarray) -> None:
    if arr.dtype != _BF16_BITS:
        np.save(path, arr)
        return
    # np.save writes a void dtype as '|V2'; the reference's bf16 files say
    # '<V2' (ml_dtypes' dtype string). The same header otherwise.
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False, "shape": arr.shape})
        f.write(np.ascontiguousarray(arr).tobytes())


def _save_host(ckpt_dir: str, step: int, host: Any) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "leaves": []}
    for ps, arr in _flatten(host):
        fn = _esc(ps) + ".npy"
        _write_npy(os.path.join(tmp, fn), arr)
        manifest["leaves"].append({
            "path": ps, "file": fn, "shape": list(arr.shape),
            "dtype": "bfloat16" if arr.dtype == _BF16_BITS else str(arr.dtype)})
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def save(ckpt_dir: str, step: int, tree: Any, period: int = 1) -> str:
    """Synchronous atomic save of ``tree`` (tensors on any device, or numpy
    arrays; ``period`` the model's pattern length). Returns the committed
    directory."""
    return _save_host(ckpt_dir, step, _to_host(tree, period))


def latest_step(ckpt_dir: str) -> Optional[int]:
    """Newest complete checkpoint step, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(ckpt_dir, name, _MANIFEST)):
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def _tensor(arr: np.ndarray, dtype_name: str, device) -> torch.Tensor:
    """One leaf read back on ``device``. ``arr`` is a freshly loaded array
    (or a layer of one), so on the CPU the tensor may share it."""
    arr = np.require(arr, requirements="C")  # keeps a 0-d leaf 0-d
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    if arr.dtype.kind == "V":
        raise ValueError(f"checkpoint leaf of dtype {dtype_name!r} has no torch dtype")
    return torch.from_numpy(arr).to(device)


def _unflatten(like: Any, prefix: str, load: Callable, take: Callable, period: int,
               n_periods: Optional[int] = None) -> Any:
    """A tree shaped like ``like`` (the port's layout), each leaf
    ``load(path, n_periods, like_leaf)``. A ``blocks`` list is read as its
    ``period`` stacks, walked on their first period (each leaf one stacked
    file), and unstacked into layers by ``take(stacked_leaf, period)``."""
    if like is None:
        return None
    if isinstance(like, dict):
        out = {}
        for k, v in like.items():
            if k == "blocks" and isinstance(v, list):
                n = len(v) // period
                stacks = tuple(_unflatten(v[pos], f"{prefix}{k}/{pos}/", load, take, period, n)
                               for pos in range(period)) if v else ()
                out[k] = unstack_blocks(stacks, n, take)
            else:
                out[k] = _unflatten(v, f"{prefix}{k}/", load, take, period, n_periods)
        return out
    if _is_namedtuple(like):
        return type(like)(*(_unflatten(v, f"{prefix}.{f}/", load, take, period, n_periods)
                            for f, v in zip(like._fields, like)))
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, f"{prefix}{i}/", load, take, period, n_periods)
                          for i, v in enumerate(like))
    return load(prefix[:-1], n_periods, like)


def restore(ckpt_dir: str, step: int, like: Any, device=None, period: int = 1) -> Any:
    """Restore into the structure of ``like`` (the port's layout: anything
    with ``.shape`` at the leaves; ``period`` the model's pattern length) as
    tensors on ``device`` (default ``cuda``), each in its checkpoint's
    dtype. Reads the reference's checkpoints as well as the port's. Raises
    ``KeyError`` for a leaf the checkpoint lacks and ``ValueError`` for a
    shape mismatch."""
    device = torch.device("cuda" if device is None else device)
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, _MANIFEST)) as f:
        manifest = json.load(f)
    by_path = {e["path"]: e for e in manifest["leaves"]}

    def load(ps, n_periods, leaf):
        if ps not in by_path:
            raise KeyError(f"checkpoint missing leaf {ps!r}")
        entry = by_path[ps]
        arr = np.load(os.path.join(d, entry["file"]))
        want = tuple(leaf.shape) if n_periods is None else (n_periods, *leaf.shape)
        if tuple(arr.shape) != want:
            raise ValueError(f"shape mismatch for {ps}: ckpt {arr.shape} vs model {want}")
        # A stacked leaf stays on the host, each period moved on its own.
        return _tensor(arr, entry["dtype"], device if n_periods is None else "cpu")

    return _unflatten(like, "", load, lambda t, i: t[i].to(device), period)


class AsyncCheckpointer:
    """Single-flight background checkpoint writer."""

    def __init__(self, ckpt_dir: str, keep: int = 3, period: int = 1):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self.period = period
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree: Any) -> None:
        self.wait()
        # The device-to-host copy happens here, synchronously, so the caller
        # may go on updating its tensors in place; the IO runs on a thread.
        host = _to_host(tree, self.period)

        def work():
            try:
                _save_host(self.ckpt_dir, step, host)
                self._gc()
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = sorted(
            int(m.group(1))
            for m in (re.fullmatch(r"step_(\d+)", n) for n in os.listdir(self.ckpt_dir))
            if m
        )
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s:08d}"), ignore_errors=True)
