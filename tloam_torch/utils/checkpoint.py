"""Checkpoint / resume for the odometry pipeline.

Port of ``tloam_tpu/utils/checkpoint.py``. The full OdometryState (submap
buffers, poses, motion model) plus the trajectory so far round-trips
through one .npz, in the JAX package's layout: ``leaf_<i>`` in the JAX
``OdometryState`` leaf order (a NamedTuple's fields in order, a Cloud's
channels that are present; ``frame_idx`` is a 0-d int32 array on disk and a
host int here), ``poses``, ``n_leaves``, ``schema`` and ``config_fp``. A
checkpoint written by either package resumes in the other.

Restores are checked: a config fingerprint, the leaf count, each leaf's
shape and the schema entries must match, or loading raises ValueError.
Files are read with ``allow_pickle=False``; this module writes its schema
as a plain unicode array. The JAX package writes an object array there,
which only pickle could read, so such an entry is recognised from its
header and skipped unread.
"""
from __future__ import annotations

import hashlib
from pathlib import Path

import numpy as np
import torch

from tloam_torch.cloud import Cloud


def config_fingerprint(cfg) -> str:
    """Stable hash of a (frozen, nested-dataclass) pipeline config: any field
    change (capacities, thresholds, windows) changes the digest. The port's
    config classes are field-for-field copies of the JAX package's, so both
    packages give a config the same fingerprint."""
    return hashlib.sha256(repr(cfg).encode()).hexdigest()[:16]


def state_leaves(tree) -> list:
    """The leaves of a state in the JAX pytree order."""
    if isinstance(tree, Cloud):
        return [t for t in tree.channels() if t is not None]
    if isinstance(tree, tuple):
        return [leaf for v in tree for leaf in state_leaves(v)]
    return [tree]


def _rebuild(template, leaves):
    """The template's structure filled from an iterator of leaves."""
    if isinstance(template, Cloud):
        return Cloud(*(None if t is None else next(leaves) for t in template.channels()))
    if isinstance(template, tuple):
        vals = [_rebuild(v, leaves) for v in template]
        return type(template)(*vals) if hasattr(template, "_fields") else tuple(vals)
    return next(leaves)


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.cpu().numpy()
    return np.asarray(leaf, np.int32)  # frame_idx: JAX keeps a 0-d int32


def _schema_entry(a: np.ndarray) -> str:
    return f"{a.shape}|{a.dtype}"


def save_state(path: str | Path, state, poses: np.ndarray, cfg=None) -> None:
    arrays = {f"leaf_{i}": _host(leaf) for i, leaf in enumerate(state_leaves(state))}
    meta = {
        "n_leaves": np.asarray(len(arrays)),
        "schema": np.asarray([_schema_entry(a) for a in arrays.values()], dtype=str),
    }
    if cfg is not None:
        meta["config_fp"] = np.asarray(config_fingerprint(cfg))
    np.savez_compressed(str(path), poses=np.asarray(poses), **arrays, **meta)


def _entry_is_object(npz, key: str) -> bool:
    """Whether an .npz entry holds Python objects, read from its .npy header
    alone."""
    with npz.zip.open(f"{key}.npy") as f:
        version = np.lib.format.read_magic(f)
        read = np.lib.format.read_array_header_1_0 if version == (1, 0) else np.lib.format.read_array_header_2_0
        return read(f)[2].hasobject


def load_state(path: str | Path, template, cfg=None):
    """Restore a state saved by save_state (by either package); `template`
    gives the structure, dtypes and device (e.g. frontend.init_state(cfg)).
    Returns (state, poses (M,4,4)).

    Raises ValueError when the checkpoint's config fingerprint, leaf count,
    leaf shapes or schema do not match: a checkpoint saved under another
    config must not silently misload."""
    t_leaves = state_leaves(template)
    n = len(t_leaves)
    with np.load(str(path), allow_pickle=False) as data:
        if cfg is not None and "config_fp" in data.files:
            saved_fp = str(data["config_fp"])
            want_fp = config_fingerprint(cfg)
            if saved_fp != want_fp:
                raise ValueError(
                    f"checkpoint {path} was saved under a different pipeline config (fingerprint "
                    f"{saved_fp} != current {want_fp}); restore with the config it was saved with"
                )
        if "n_leaves" in data.files and int(data["n_leaves"]) != n:
            raise ValueError(
                f"checkpoint {path} holds {int(data['n_leaves'])} state leaves but the current "
                f"config's state has {n} — config mismatch"
            )
        arrays = []
        for i, t in enumerate(t_leaves):
            key = f"leaf_{i}"
            if key not in data.files:
                raise ValueError(f"checkpoint {path} is missing {key}")
            a = data[key]
            want = tuple(t.shape) if isinstance(t, torch.Tensor) else ()
            if tuple(a.shape) != want:
                raise ValueError(
                    f"checkpoint {path} leaf {i} has shape {tuple(a.shape)} but the current config "
                    f"expects {want} — capacities/windows changed since this checkpoint was saved"
                )
            arrays.append(a)
        if "schema" in data.files and not _entry_is_object(data, "schema"):
            schema = data["schema"]
            if schema.shape != (n,) or any(str(s) != _schema_entry(a) for s, a in zip(schema, arrays)):
                raise ValueError(f"checkpoint {path}: the schema does not describe its leaves")
        poses = data["poses"]
    leaves = (
        torch.tensor(a, dtype=t.dtype, device=t.device) if isinstance(t, torch.Tensor) else int(a)
        for a, t in zip(arrays, t_leaves)
    )
    return _rebuild(template, leaves), poses
