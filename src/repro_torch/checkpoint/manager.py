"""Fault-tolerant checkpointing (PyTorch), in the reference's on-disk
format.

A directory per step, ``step_<N:010d>/``, holding ``arrays.npz`` (every
leaf of the tree as raw ``uint8`` bytes under ``a<i>``) and
``manifest.msgpack`` (the leaves' "/"-joined tree paths, numpy dtype
names and shapes, the step, and an ``extra`` metadata blob). The paths
and their order are the reference's: dict keys sorted, list and tuple
items by index, ``None`` skipped. So a checkpoint written by the
reference's ``repro.checkpoint.CheckpointManager`` restores here and one
written here restores there, bit for bit. A bf16 leaf is stored as its
raw bytes under the dtype name ``bfloat16`` and read back as a torch
bf16 tensor (numpy has no bf16 type).

Writes go to ``step_<N>.tmp`` and are renamed into place, so a crash
mid-save never publishes a half-written step. Saves can run on a
background thread (``async_save``); a failure there is raised by the
next :meth:`CheckpointManager.wait` or :meth:`CheckpointManager.save`
on the caller's thread. ``keep`` bounds the steps kept on disk (0 keeps
all).

Restores return CPU tensors: the caller moves them to its device.
"""
from __future__ import annotations

import os
import re
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import manifest

_TORCH_DTYPE_NAMES = {torch.float32: "float32", torch.float64: "float64",
                      torch.float16: "float16", torch.bfloat16: "bfloat16",
                      torch.int8: "int8", torch.int16: "int16",
                      torch.int32: "int32", torch.int64: "int64",
                      torch.uint8: "uint8", torch.bool: "bool"}


def flatten_with_paths(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """``[(path, leaf)]`` in the reference's order (``jax.tree_util``'s:
    dict keys sorted, list/tuple items by index, ``None`` an empty
    subtree), paths "/"-joined."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out.extend(flatten_with_paths(v, f"{prefix}/{k}" if prefix else k))
    return out


def unflatten_paths(by_path: Dict[str, Any], prefix: str = "",
                    listify: bool = True) -> Any:
    """Rebuild a nested tree from the "/"-joined paths of
    :meth:`CheckpointManager.restore_items` (the reference's function).

    Every path component becomes a dict key; with ``listify`` (default)
    a dict whose keys are exactly "0".."k-1" becomes a list. ``prefix``
    selects a subtree ("global_params", "local_trees/3", ...) and strips
    it from the keys: a serve process rebuilds an FL checkpoint's trees
    without knowing its structure up front."""
    if prefix and not prefix.endswith("/"):
        prefix = prefix + "/"
    root: Dict[str, Any] = {}
    for path, leaf in by_path.items():
        if prefix:
            if not path.startswith(prefix):
                continue
            path = path[len(prefix):]
        parts = path.split("/")
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = leaf

    def walk(node):
        if not isinstance(node, dict):
            return node
        out = {k: walk(v) for k, v in node.items()}
        if listify and out and all(k.isdigit() for k in out):
            idx = sorted(out, key=int)
            if idx == [str(i) for i in range(len(idx))]:
                return [out[k] for k in idx]
        return out

    return walk(root)


def _host(leaf: Any) -> Any:
    """A leaf as an owned host copy: a CPU tensor, or a numpy array (a
    later in-place update of the caller's tensor must not reach a save
    still in flight)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf, copy=True)


def _raw(leaf: Any) -> Tuple[np.ndarray, str, List[int]]:
    """(flat uint8 bytes, dtype name, shape) of a host leaf."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype not in _TORCH_DTYPE_NAMES:
            raise TypeError(f"cannot checkpoint a {leaf.dtype} tensor")
        t = leaf.contiguous()
        return (t.reshape(-1).view(torch.uint8).numpy(),
                _TORCH_DTYPE_NAMES[t.dtype], list(t.shape))
    arr = np.ascontiguousarray(leaf)
    return arr.reshape(-1).view(np.uint8), str(arr.dtype), list(arr.shape)


def _leaf(raw: np.ndarray, dtype: str, shape) -> torch.Tensor:
    """A CPU tensor from a leaf's stored bytes."""
    if dtype == "bfloat16":
        return torch.from_numpy(raw).view(torch.bfloat16).reshape(shape)
    return torch.from_numpy(raw.view(np.dtype(dtype)).reshape(shape))


class CheckpointManager:
    """Step directories under ``directory`` (module docstring)."""

    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = False):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._pending: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------- save
    def save(self, step: int, tree: Any, extra: Optional[Dict] = None) -> str:
        """Write ``tree`` (tensors, numpy arrays or scalars as leaves) and
        ``extra`` as step ``step``; returns the step's directory. With
        ``async_save`` the leaves are copied to the host here and
        written on a background thread."""
        host = [(p, _host(v)) for p, v in flatten_with_paths(tree)]
        if self.async_save:
            self.wait()   # re-raises a previous async save's failure
            self._pending = threading.Thread(
                target=self._write_guarded, args=(step, host, extra),
                daemon=True)
            self._pending.start()
        else:
            self._write(step, host, extra)
        return os.path.join(self.dir, f"step_{step:010d}")

    def _write_guarded(self, step: int, host, extra: Optional[Dict]):
        # a daemon thread's exception would die with the thread while the
        # caller trains on assuming the checkpoint exists: keep it for the
        # next wait()/save() to raise on the caller's thread
        try:
            self._write(step, host, extra)
        except BaseException as e:   # noqa: BLE001  (re-raised in wait)
            self._error = e

    def wait(self) -> None:
        """Join a save in flight; raise the failure of an async save."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write(self, step: int, host: List[Tuple[str, Any]],
               extra: Optional[Dict]) -> None:
        final = os.path.join(self.dir, f"step_{step:010d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        raws = [_raw(leaf) for _, leaf in host]
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{f"a{i}": raw for i, (raw, _, _) in enumerate(raws)})
        doc = {"step": step, "paths": [p for p, _ in host],
               "dtypes": [d for _, d, _ in raws],
               "shapes": [s for _, _, s in raws], "extra": extra or {}}
        with open(os.path.join(tmp, "manifest.msgpack"), "wb") as f:
            f.write(manifest.packb(doc))
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)   # atomic publish
        self._gc()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)

    # ---------------------------------------------------------- restore
    def all_steps(self) -> List[int]:
        """The published steps, ascending."""
        out = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(os.path.join(self.dir, name,
                                                 "manifest.msgpack")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        """The newest published step, or None."""
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore_items(self, step: Optional[int] = None
                      ) -> Tuple[Dict[str, torch.Tensor], Dict, int]:
        """Structure-free restore of ``step`` (default the latest):
        ``(by_path, extra, step)``, ``by_path`` mapping each "/"-joined
        tree path to a CPU tensor. For callers whose checkpointed
        structure depends on the data (an FL server's per-client
        state)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(d, "manifest.msgpack"), "rb") as f:
            doc = manifest.unpackb(f.read())
        by_path = {}
        with np.load(os.path.join(d, "arrays.npz")) as data:
            for i, p in enumerate(doc["paths"]):
                by_path[p] = _leaf(data[f"a{i}"], doc["dtypes"][i],
                                   doc["shapes"][i])
        return by_path, doc["extra"], int(doc["step"])

    def restore(self, step: Optional[int], target_tree: Any
                ) -> Tuple[Any, Dict]:
        """Restore into the structure of ``target_tree`` (shapes checked,
        each leaf cast to the target's dtype); returns (tree, extra)."""
        by_path, extra, _ = self.restore_items(step)

        def fill(tgt, path):
            if tgt is None:
                return None
            if isinstance(tgt, dict):
                return {k: fill(v, f"{path}/{k}" if path else str(k))
                        for k, v in tgt.items()}
            if isinstance(tgt, (list, tuple)):
                return type(tgt)(fill(v, f"{path}/{i}" if path else str(i))
                                 for i, v in enumerate(tgt))
            if path not in by_path:
                raise KeyError(f"checkpoint missing leaf '{path}'")
            got = by_path[path]
            want = tuple(np.shape(tgt))
            if tuple(got.shape) != want:
                raise ValueError(f"shape mismatch at {path}: "
                                 f"{tuple(got.shape)} vs {want}")
            if isinstance(tgt, torch.Tensor):
                return got.to(tgt.dtype)
            return got.numpy().astype(np.asarray(tgt).dtype)

        return fill(target_tree, ""), extra
