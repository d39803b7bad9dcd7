"""Checkpoint serialization: the state pytree as a flat zip archive.

Replaces the reference's field-by-field binary dumps
(src/memory-interface.h:12-36, predictor.cpp:389-420) with a single archive
per checkpoint. The contract is the reference tester's invariant set
(src/runner/tester.cpp): save -> load -> save must be byte-identical, and an
in-memory copy must equal a disk roundtrip.

Layout: keys are '/'-joined pytree paths; dtypes and shapes are preserved
exactly. Values are raw numpy arrays, so the checkpoint is portable between
backends (CPU and GPU).

Sparse encoding (the reference switches to key/value encoding when its tables
are mostly empty, src/memory/long-term-memory.cpp:17-28, 92-103): any large
leaf whose dominant value covers more than SPARSE_THRESHOLD of its elements is
stored as (fill, flat indices of exceptions, exception values). The dominant
value is detected by sampling, then counted exactly, so the switch is always
safe; reconstruction is exact, preserving save∘load = identity. A
briefly-trained multi-GB state (arenas still mostly at their init sentinel)
shrinks by >10x.

The archive carries a format version in the zip comment; loading a checkpoint
written by an older incompatible build raises a clear error instead of a
shape assert downstream.
"""
from __future__ import annotations

import io
import zipfile
from typing import Any, Dict

import jax
import numpy as np

# v3: the coder's sticky overflow flag left the state pytree (encoder renorm
# bytes now exit as scan outputs and cannot overflow a device buffer)
CKPT_VERSION = 3
_COMMENT_PREFIX = b"gmix-tpu-ckpt v"
SPARSE_THRESHOLD = 0.75  # dominant-value fraction above which a leaf goes sparse
SPARSE_MIN_BYTES = 1 << 20  # don't bother below 1 MiB


class CheckpointVersionError(RuntimeError):
    pass


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    else:
        out[prefix.rstrip("/")] = np.asarray(tree)
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> Any:
    root: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split("/")
        d = root
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = val
    return root


def _dominant_value(arr: np.ndarray):
    """Candidate fill value by sampling (cheap), or None for tiny/0-d arrays."""
    flat = arr.reshape(-1)
    if flat.size == 0:
        return None
    sample = flat[:: max(1, flat.size // 4096)]
    vals, counts = np.unique(sample, return_counts=True)
    return vals[np.argmax(counts)]


def _write_npy(zf: zipfile.ZipFile, name: str, arr: np.ndarray) -> None:
    buf = io.BytesIO()
    np.lib.format.write_array(buf, np.ascontiguousarray(arr))
    zi = zipfile.ZipInfo(name, date_time=(1980, 1, 1, 0, 0, 0))
    zf.writestr(zi, buf.getvalue())


def save_state(path: str, state: Any) -> None:
    flat = _flatten(jax.device_get(state))
    # deterministic, uncompressed archive (exception values are mostly
    # incompressible; speed matters more; compression can be layered)
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as zf:
        zf.comment = _COMMENT_PREFIX + str(CKPT_VERSION).encode()
        for key in sorted(flat):
            arr = flat[key]
            # NB: this numpy's ascontiguousarray/read_array both promote 0-d
            # arrays to (1,), so scalars are marked so load_state can restore
            # the exact shape
            if arr.ndim == 0:
                _write_npy(zf, key + ".npy0", arr)
                continue
            if arr.nbytes >= SPARSE_MIN_BYTES:
                fill = _dominant_value(arr)
                flatv = arr.reshape(-1)
                if fill is not None:
                    # NaN never equals itself; such leaves just stay dense
                    exc = np.flatnonzero(flatv != fill)
                    if flatv.size - exc.size >= SPARSE_THRESHOLD * flatv.size:
                        idx = exc.astype(
                            np.uint32 if flatv.size <= 0xFFFFFFFF else np.uint64
                        )
                        _write_npy(zf, key + ".sp.idx", idx)
                        _write_npy(zf, key + ".sp.val", flatv[exc])
                        _write_npy(zf, key + ".sp.fill", fill.reshape(1))
                        _write_npy(
                            zf, key + ".sp.shape", np.asarray(arr.shape, np.int64)
                        )
                        continue
            _write_npy(zf, key + ".npy", arr)


def load_state(path: str) -> Any:
    flat: Dict[str, np.ndarray] = {}
    sparse: Dict[str, Dict[str, np.ndarray]] = {}
    with zipfile.ZipFile(path, "r") as zf:
        comment = zf.comment
        if not comment.startswith(_COMMENT_PREFIX):
            raise CheckpointVersionError(
                f"{path}: not a gmix-tpu v{CKPT_VERSION} checkpoint (it predates "
                "the versioned format or is a foreign file); re-create it with "
                "this build"
            )
        ver = int(comment[len(_COMMENT_PREFIX) :])
        if ver != CKPT_VERSION:
            raise CheckpointVersionError(
                f"{path}: incompatible checkpoint version {ver} (this build "
                f"reads v{CKPT_VERSION}); re-create the checkpoint"
            )
        for name in zf.namelist():
            with zf.open(name) as f:
                arr = np.lib.format.read_array(f)
            if name.endswith(".npy0"):
                flat[name[: -len(".npy0")]] = arr.reshape(())
            elif name.endswith(".npy"):
                flat[name[: -len(".npy")]] = arr
            else:
                base, _, part = name.rpartition(".sp.")
                sparse.setdefault(base, {})[part] = arr
    for base, parts in sparse.items():
        shape = tuple(int(x) for x in parts["shape"])
        fill = parts["fill"][0]
        out = np.full(int(np.prod(shape)) if shape else 1, fill, dtype=fill.dtype)
        out[parts["idx"].astype(np.int64)] = parts["val"]
        flat[base] = out.reshape(shape)
    return _unflatten(flat)


def copy_state(state: Any) -> Any:
    """Deep on-device copy (Predictor::Copy, predictor.cpp:42-48)."""
    return jax.tree_util.tree_map(lambda x: x.copy(), state)
