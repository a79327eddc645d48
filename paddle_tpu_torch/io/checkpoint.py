"""Checkpoint directories, format 2, one process (port of paddle_tpu's
`io/checkpoint.py`), on disk exactly as the JAX package writes them, so
that a checkpoint saved by either package loads and validates in the
other.

Layout and commit protocol:

* everything is written into ``{path}.tmp``;
* each array is one ``.npy`` file, ``{escaped_name}__full.npy`` for a 0-d
  array and ``{escaped_name}__0_0...npy`` (its zero offsets) otherwise;
  nested trees (optimizer slot dicts) flatten with '/'-joined names; a
  bf16 array is written with descr ``'<V2'`` (what `np.save` writes for
  an `ml_dtypes.bfloat16` array) and recorded as dtype ``"bfloat16"``;
* ``index.0.json`` records each array's shape, dtype and file, with the
  file's byte size and crc32; every file and the directory are fsynced;
* ``meta.json`` is written last, then ``{path}.tmp`` is renamed to
  ``{path}`` (an existing ``{path}`` is moved aside first).

`latest_checkpoint` returns the newest ``step_{n}`` that validates and
`gc_checkpoints` keeps the newest k. Loading gives tensors on the default
device (`set_device`; cuda, which raises without a GPU) or on `device=`.
A mesh or shardings (multi-GPU restore) are not ported and raise.
"""
from __future__ import annotations

import glob
import json
import os
import re
import shutil
import warnings
import zlib

import numpy as np
import torch

from ..core.arrays import dtype_name, to_numpy, to_tensor
from ..core.device import get_device, resolve_device

__all__ = ["save_sharded", "load_sharded", "save_checkpoint",
           "load_checkpoint", "CheckpointError", "validate_checkpoint",
           "is_valid_checkpoint", "list_checkpoints", "latest_checkpoint",
           "gc_checkpoints"]

FORMAT_VERSION = 2      # 1 = pre-checksum (still loadable/validatable)


class CheckpointError(RuntimeError):
    """A checkpoint directory is missing, incomplete, or corrupt."""


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "/"))
        else:
            out[key] = v
    return out


def _unflatten(flat):
    out = {}
    for k, v in flat.items():
        parts = k.split("/")
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return out


def _escape(name):
    return re.sub(r"[^A-Za-z0-9_.-]", "_", name)


def _no_mesh(mesh, shardings):
    if mesh is not None or shardings:
        raise NotImplementedError("mesh= / shardings=: multi-GPU restore is "
                                  "not ported to paddle_tpu_torch (one "
                                  "device)")


# -- integrity plumbing -------------------------------------------------------

def _file_crc32(path) -> int:
    crc = 0
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            crc = zlib.crc32(chunk, crc)
    return crc & 0xFFFFFFFF


def _fsync(path, flags=os.O_RDONLY):
    try:
        fd = os.open(path, flags)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    except OSError:        # pragma: no cover - fs without fsync support
        pass


def _fsync_dir(path):
    _fsync(path, os.O_RDONLY | getattr(os, "O_DIRECTORY", 0))


def _save_npy(dirpath, fname, array: np.ndarray) -> dict:
    """Write one array file and return its manifest fields."""
    full = os.path.join(dirpath, fname)
    if dtype_name(array) == "bfloat16":
        # the header np.save gives an ml_dtypes.bfloat16 array
        with open(full, "wb") as f:
            np.lib.format.write_array_header_1_0(
                f, {"descr": "<V2", "fortran_order": False,
                    "shape": array.shape})
            f.write(np.ascontiguousarray(array).view(np.uint16).tobytes())
    else:
        np.save(full, array)
    _fsync(full)
    return {"size": os.path.getsize(full), "crc32": _file_crc32(full)}


def _commit_dir(work, final):
    """Atomically publish `work` as `final`. An existing `final` is
    renamed aside first so a valid directory exists at every instant."""
    if os.path.exists(final):
        aside = final + ".old"
        shutil.rmtree(aside, ignore_errors=True)
        os.rename(final, aside)
        os.rename(work, final)
        shutil.rmtree(aside, ignore_errors=True)
    else:
        os.rename(work, final)
    _fsync_dir(os.path.dirname(final) or ".")


def _host(v) -> np.ndarray:
    return to_numpy(v) if isinstance(v, torch.Tensor) else np.asarray(v)


def save_sharded(path, tree, step=0, meta=None, atomic=True):
    """Write a (nested) dict of tensors or arrays as a checkpoint
    directory; with `atomic` (default) through ``{path}.tmp`` and a
    rename after ``meta.json``."""
    flat = _flatten(tree)
    final = path.rstrip("/")
    work = final + ".tmp" if atomic else final
    if atomic:
        shutil.rmtree(work, ignore_errors=True)   # stale orphan
    os.makedirs(work, exist_ok=True)

    index = {}
    for name, v in flat.items():
        arr = _host(v)
        fname = (f"{_escape(name)}__"
                 + ("_".join("0" * arr.ndim) if arr.ndim else "full")
                 + ".npy")
        shard = {"file": fname, "start": [0] * arr.ndim,
                 "stop": list(arr.shape)}
        shard.update(_save_npy(work, fname, arr))
        index[name] = {"shape": list(arr.shape), "dtype": dtype_name(arr),
                       "spec": None, "shards": [shard]}

    idx_path = os.path.join(work, "index.0.json")
    with open(idx_path, "w") as f:
        json.dump(index, f, indent=1)
    _fsync(idx_path)
    meta_path = os.path.join(work, "meta.json")
    with open(meta_path, "w") as f:
        json.dump({"step": int(step), "meta": meta or {},
                   "format": FORMAT_VERSION, "n_processes": 1}, f, indent=1)
    _fsync(meta_path)
    _fsync_dir(work)
    if atomic:
        _commit_dir(work, final)


# -- validation / discovery / retention --------------------------------------

def validate_checkpoint(path, deep=True):
    """Raise `CheckpointError` unless `path` is a complete checkpoint:
    parseable meta.json, at least one parseable index, every indexed
    file present with its recorded size and, with `deep`, its recorded
    crc32. Format 1 checkpoints (no checksums) validate on existence."""
    if not os.path.isdir(path):
        raise CheckpointError(f"{path}: not a directory")
    try:
        with open(os.path.join(path, "meta.json")) as f:
            json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointError(f"{path}: bad meta.json ({e})") from e
    idx_files = sorted(glob.glob(os.path.join(path, "index.*.json")))
    if not idx_files:
        raise CheckpointError(f"{path}: no index files")
    for idx_file in idx_files:
        try:
            with open(idx_file) as f:
                index = json.load(f)
        except (OSError, ValueError) as e:
            raise CheckpointError(
                f"{path}: bad {os.path.basename(idx_file)} ({e})") from e
        for name, entry in index.items():
            for sh in entry["shards"]:
                fp = os.path.join(path, sh["file"])
                if not os.path.isfile(fp):
                    raise CheckpointError(
                        f"{path}: {name} shard {sh['file']} missing")
                if "size" in sh and os.path.getsize(fp) != sh["size"]:
                    raise CheckpointError(
                        f"{path}: {sh['file']} size "
                        f"{os.path.getsize(fp)} != recorded {sh['size']}")
                if deep and "crc32" in sh and _file_crc32(fp) != sh["crc32"]:
                    raise CheckpointError(
                        f"{path}: {sh['file']} crc mismatch (torn or "
                        "corrupt write)")


def is_valid_checkpoint(path, deep=True) -> bool:
    try:
        validate_checkpoint(path, deep=deep)
        return True
    except CheckpointError:
        return False


def list_checkpoints(ckpt_dir):
    """All committed `step_{n}` directories under `ckpt_dir` (no
    validation), newest step first, as (step, path) pairs. `.tmp`/`.old`
    work directories never appear."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if not name.startswith("step_") or "." in name:
            continue
        try:
            s = int(name.split("_", 1)[1])
        except ValueError:
            continue
        out.append((s, os.path.join(ckpt_dir, name)))
    return sorted(out, reverse=True)


def latest_checkpoint(ckpt_dir, validate=True, deep=True):
    """Newest step-numbered checkpoint under `ckpt_dir` that validates
    (newest first; an invalid one is skipped with a warning), or None."""
    for _, path in list_checkpoints(ckpt_dir):
        if not validate:
            if os.path.exists(os.path.join(path, "meta.json")):
                return path
            continue
        try:
            validate_checkpoint(path, deep=deep)
            return path
        except CheckpointError as e:
            warnings.warn(f"skipping invalid checkpoint: {e}")
    return None


def gc_checkpoints(ckpt_dir, keep_last, protect=()):
    """Retention: delete all but the newest `keep_last` committed
    checkpoints, plus any orphaned `.tmp`/`.old` work directories.
    Paths in `protect` survive regardless."""
    if not keep_last or not os.path.isdir(ckpt_dir):
        return
    protect = {os.path.abspath(p) for p in protect}
    kept = 0
    for _, path in list_checkpoints(ckpt_dir):
        if kept < keep_last:
            kept += 1                    # protected entries count too
        elif os.path.abspath(path) not in protect:
            shutil.rmtree(path, ignore_errors=True)
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and (name.endswith(".tmp")
                                         or name.endswith(".old")):
            shutil.rmtree(os.path.join(ckpt_dir, name), ignore_errors=True)


def _read_full(path, entry):
    """One array, assembled from its shard files (a checkpoint the JAX
    package saved from a sharded array has several)."""
    shape = tuple(entry["shape"])
    shards = [np.load(os.path.join(path, sh["file"]), mmap_mode="r")
              for sh in entry["shards"]]
    if len(shards) == 1 and tuple(shards[0].shape) == shape:
        return np.array(shards[0])
    out = np.zeros(shape, dtype=shards[0].dtype)
    for sh, mm in zip(entry["shards"], shards):
        out[tuple(slice(a, b) for a, b in zip(sh["start"], sh["stop"]))] = mm
    return out


def load_sharded(path, mesh=None, shardings=None, validate=True,
                 device=None):
    """Restore the tree as tensors on `device` (default: the default
    device). `validate` (default) checks sizes and checksums first and
    raises `CheckpointError` on a torn or corrupt checkpoint.

    Returns (tree, step, meta)."""
    _no_mesh(mesh, shardings)
    dev = get_device() if device is None else resolve_device(device)
    if validate:
        validate_checkpoint(path)
    try:
        with open(os.path.join(path, "meta.json")) as f:
            header = json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointError(f"{path}: bad meta.json ({e})") from e
    arrays = {}
    for idx_file in sorted(glob.glob(os.path.join(path, "index.*.json"))):
        with open(idx_file) as f:
            for name, entry in json.load(f).items():
                if name not in arrays:
                    arrays[name] = entry
                else:
                    known = {tuple(s["start"])
                             for s in arrays[name]["shards"]}
                    arrays[name]["shards"].extend(
                        s for s in entry["shards"]
                        if tuple(s["start"]) not in known)
    flat = {name: to_tensor(_read_full(path, entry), dev, entry["dtype"])
            for name, entry in arrays.items()}
    return _unflatten(flat), header["step"], header["meta"]


# ---------------------------------------------------------------------------
# train-state convenience wrappers (params + optimizer slots + buffers)
# ---------------------------------------------------------------------------

def save_checkpoint(path, params, opt_state=None, state=None, step=0,
                    meta=None, keep_last=None):
    """Atomic checkpoint of the train state. With `keep_last=k` and a
    `step_{n}`-named `path`, older sibling checkpoints beyond the newest
    k (this one included) are garbage-collected after the commit."""
    tree = {"params": params}
    if opt_state:
        tree["opt"] = opt_state
    if state:
        tree["state"] = state
    save_sharded(path, tree, step=step, meta=meta)
    if keep_last and re.fullmatch(r"step_\d+",
                                  os.path.basename(path.rstrip("/"))):
        gc_checkpoints(os.path.dirname(path.rstrip("/")) or ".", keep_last,
                       protect=(path,))


def load_checkpoint(path, mesh=None, shardings=None, validate=True,
                    device=None):
    """(params, opt_state, state, step, meta) of a checkpoint directory,
    tensors on `device` (default: the default device)."""
    tree, step, meta = load_sharded(path, mesh=mesh, shardings=shardings,
                                    validate=validate, device=device)
    return (tree.get("params", {}), tree.get("opt", {}),
            tree.get("state", {}), step, meta)
