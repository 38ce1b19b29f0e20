"""Checkpoints in the reference's on-disk format (port of the reference
package's ``distributed/checkpoint.py``, for a world of one process).

Layout on disk, exactly the reference's, so either package reads the
other's checkpoint:

    path/
      metadata_p{proc}.json    the process's shard index (shapes, dtypes,
                               the box of each shard) and object values
      shards_p{proc}.npz       the shards' data; bf16 stored as a uint16
                               view

``state_dict`` maps names to tensors (nested dicts flatten with dotted
keys); any other value is an object stored in the metadata as JSON.
Here every tensor is one shard whose box is the whole tensor. A load
reassembles each tensor from the boxes of every ``metadata_p*.json``
under ``path`` (a checkpoint that several processes wrote loads whole)
and copies it into the target tensor in place, so its storage, and the
addresses a captured CUDA graph holds, stay. Placing a tensor onto a
sharded layout (resharding across meshes) waits for ROADMAP A13 part 2
and raises.
"""

from __future__ import annotations

import glob
import json
import os

import numpy as np
import torch

from ..framework.io import from_numpy, to_numpy
from ..testing import faults as _faults

__all__ = ["save_state_dict", "load_state_dict", "collect_state_shards",
           "write_state_shards"]

_NUMPY_DTYPE = {torch.float32: "float32", torch.float64: "float64",
                torch.float16: "float16", torch.bfloat16: "bfloat16",
                torch.int8: "int8", torch.uint8: "uint8",
                torch.int16: "int16", torch.int32: "int32",
                torch.int64: "int64", torch.bool: "bool"}


def _json_safe(v):
    """JSON encoder for numpy scalars and arrays among the object values."""
    if isinstance(v, np.ndarray):
        return {"__ndarray__": v.tolist(), "dtype": str(v.dtype)}
    if isinstance(v, np.generic):
        return v.item()
    raise TypeError(f"checkpoint object value not serializable: {type(v)}")


def _json_restore(v):
    if isinstance(v, dict) and "__ndarray__" in v:
        return np.asarray(v["__ndarray__"], dtype=v["dtype"])
    return v


def _no_resharding(key, t):
    if type(t).__name__ == "DTensor":
        raise NotImplementedError(
            f"checkpoint tensor {key!r} is sharded over a device mesh: "
            "sharded checkpoints and resharding on load are not ported "
            "yet (ROADMAP A13 part 2, sharded checkpoints)")


def _flatten(state_dict, prefix=""):
    """flat_key -> value, plus flat_key -> (owner dict, key) for
    writeback."""
    out, owners = {}, {}
    for k, v in state_dict.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            sub, sub_owners = _flatten(v, key)
            out.update(sub)
            owners.update(sub_owners)
        else:
            out[key] = v
            owners[key] = (state_dict, k)
    return out, owners


def collect_state_shards(state_dict, process_index=None):
    """Snapshot ``state_dict`` to host memory: ``(proc, meta, data)``.

    The device-to-host copy happens here, so once this returns the caller
    may go on changing the tensors: the synchronous phase of an async
    checkpoint (:class:`~paddle_tpu_torch.distributed.checkpoint_manager
    .CheckpointManager` writes the snapshot from a background thread).
    """
    flat, _ = _flatten(state_dict)
    proc = 0 if process_index is None else int(process_index)
    meta = {"tensors": {}}
    data = {}
    for key, t in flat.items():
        if not isinstance(t, torch.Tensor):
            meta.setdefault("objects", {})[key] = t
            continue
        _no_resharding(key, t)
        arr, dt = to_numpy(t)
        name = f"{key}@0"
        data[name] = arr
        meta["tensors"][key] = {
            "shape": list(t.shape), "dtype": _NUMPY_DTYPE.get(t.dtype, dt),
            "shards": [{"box": [[0, d] for d in t.shape], "array": name,
                        "file": f"shards_p{proc}.npz", "dtype": dt}]}
    return proc, meta, data


def write_state_shards(path, proc, meta, data, fsync=False):
    """Write one process's collected snapshot under ``path``; returns the
    file basenames written. With ``fsync=True`` each file is flushed to
    stable storage before this returns (the durability half of the
    checkpoint manager's two-phase commit)."""
    os.makedirs(path, exist_ok=True)
    shard_name = f"shards_p{proc}.npz"
    meta_name = f"metadata_p{proc}.json"
    shard_path = os.path.join(path, shard_name)
    _faults.fire("ckpt.write", path=shard_path)
    with open(shard_path, "wb") as f:
        np.savez(f, **data)
        if fsync:
            f.flush()
            os.fsync(f.fileno())
    meta_path = os.path.join(path, meta_name)
    _faults.fire("ckpt.write", path=meta_path)
    with open(meta_path, "w") as f:
        json.dump(meta, f, default=_json_safe)
        if fsync:
            f.flush()
            os.fsync(f.fileno())
    return [shard_name, meta_name]


def save_state_dict(state_dict, path, process_index=None):
    """Write ``state_dict``'s tensors and objects under ``path``.

    This writes straight into ``path``: a crash mid-save leaves a torn
    checkpoint. Durable training checkpoints go through
    :class:`~paddle_tpu_torch.distributed.checkpoint_manager
    .CheckpointManager`, which wraps this format in an atomic two-phase
    commit.
    """
    proc, meta, data = collect_state_shards(state_dict, process_index)
    write_state_shards(path, proc, meta, data)


def _merged_metadata(path):
    meta_files = sorted(glob.glob(os.path.join(path, "metadata_p*.json")))
    if not meta_files:
        raise FileNotFoundError(f"no metadata_p*.json under {path}")
    meta = {"tensors": {}, "objects": {}}
    for mf in meta_files:
        with open(mf) as f:
            m = json.load(f)
        for key, entry in m.get("tensors", {}).items():
            tgt = meta["tensors"].setdefault(
                key, {"shape": entry["shape"], "dtype": entry["dtype"],
                      "shards": []})
            known = {json.dumps(s["box"]) for s in tgt["shards"]}
            for s in entry["shards"]:
                if json.dumps(s["box"]) not in known:
                    tgt["shards"].append(s)
        meta["objects"].update(m.get("objects", {}))
    return meta


@torch.no_grad()
def load_state_dict(state_dict, path):
    """Fill ``state_dict``'s tensors in place from the checkpoint under
    ``path`` (object values are written back into their dicts); returns
    ``state_dict``. Raises when a tensor is missing, has another shape, or
    its shards do not cover it."""
    flat, owners = _flatten(state_dict)
    meta = _merged_metadata(path)
    files = {}

    def shard_data(sh):
        fname = sh["file"]
        if fname not in files:
            files[fname] = np.load(os.path.join(path, fname))
        return from_numpy(files[fname][sh["array"]], sh["dtype"])

    try:
        missing = []
        for key, t in flat.items():
            if not isinstance(t, torch.Tensor):
                if key in meta["objects"]:
                    d, k = owners[key]
                    d[k] = _json_restore(meta["objects"][key])
                else:
                    missing.append(key)
                continue
            _no_resharding(key, t)
            entry = meta["tensors"].get(key)
            if entry is None:
                missing.append(key)
                continue
            if list(entry["shape"]) != list(t.shape):
                raise ValueError(
                    f"checkpoint tensor {key!r} has shape "
                    f"{entry['shape']}, target expects {list(t.shape)}")
            if not entry["shards"]:
                raise ValueError(
                    f"checkpoint tensor {key!r} has no shards in the "
                    f"metadata under {path}: the checkpoint is likely "
                    "incomplete (truncated metadata, or a multi-process "
                    "save missing a process's metadata)")
            boxes = entry["shards"]
            whole = [[0, d] for d in entry["shape"]]
            if len(boxes) == 1 and boxes[0]["box"] == whole:
                full = shard_data(boxes[0])
            else:
                first = shard_data(boxes[0])
                full = torch.empty(entry["shape"], dtype=first.dtype)
                covered = torch.zeros(entry["shape"], dtype=torch.bool)
                for sh in boxes:
                    sl = tuple(slice(b[0], b[1]) for b in sh["box"])
                    full[sl] = shard_data(sh)
                    covered[sl] = True
                if not bool(covered.all()):
                    raise ValueError(
                        f"checkpoint for {key!r} does not cover the full "
                        "tensor (a multi-process checkpoint loaded "
                        "without all shard files?)")
            t.copy_(full.reshape(t.shape))
        if missing:
            raise KeyError(
                f"checkpoint at {path} is missing tensors: {missing[:5]}"
                + ("..." if len(missing) > 5 else ""))
    finally:
        # np.load keeps the zip open for lazy member reads
        for f in files.values():
            f.close()
    return state_dict
