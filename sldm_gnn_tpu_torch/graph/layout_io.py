"""Save precomputed SpMM layouts to disk and load them back.

Port of ``sldm_gnn_tpu/graph/layout_io.py``, in its file format: one
``.npz`` holding the arrays and a JSON header (the class name, the static
fields, the nested layouts), int8 arrays whose values fit [-8, 7] packed
two to a byte, and arrays of ``raw_threshold`` bytes or more written as
raw ``<stem>.<field>.npy`` side-cars beside it. A file written by either
package loads in the other with the same bits. Tensors go to numpy on
save (bf16 as 2-byte void, as numpy stores JAX's bfloat16) and come back
as CPU tensors on load; move them with ``layout.to(device)``.

:func:`cached_layouts` wraps a layout builder with an on-disk cache under
the caller's own key.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

from ..ops.spmm_banded import BandedBlocks
from ..ops.spmm_dense import DenseBlocks
from ..ops.spmm_hybrid import HybridLayout
from .csr import BlockedEdges

_NONE = "__none__"
_I4_SUFFIX = "__i4"
# each layout class and the fields the JAX package marks static (JSON
# header, not arrays); the header names the class
_STATIC = {BlockedEdges: ("tile", "step_chunks"), DenseBlocks: ("tile",),
           BandedBlocks: ("tile", "wsz", "k", "wide"),
           HybridLayout: ("n_pad", "dense_k", "k_per_step", "dense_frac")}
_BY_NAME = {cls.__name__: cls for cls in _STATIC}


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _to_tensor(a: np.ndarray) -> torch.Tensor:
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:  # bfloat16
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True, order="C"))


def _flatten(layout, prefix: str, arrays: dict) -> dict:
    """The header of `layout`; its arrays go into `arrays` under dotted
    keys (nested layouts under their field's prefix, None as a marker)."""
    cls = type(layout)
    header = {"class": cls.__name__, "static": {}, "nested": {}}
    for f in dataclasses.fields(cls):
        v = getattr(layout, f.name)
        if f.name in _STATIC[cls]:
            header["static"][f.name] = v.item() if isinstance(v, np.generic) else v
        elif type(v) in _STATIC:
            header["nested"][f.name] = _flatten(v, f"{prefix}{f.name}.", arrays)
        elif v is None:
            arrays[prefix + f.name] = np.asarray(_NONE)
        else:
            arrays[prefix + f.name] = _to_numpy(v)
    return header


def _unflatten(z: dict, prefix: str, header: dict):
    cls = _BY_NAME[header["class"]]
    kwargs = dict(header["static"])
    for f in dataclasses.fields(cls):
        if f.name in kwargs:
            continue
        if f.name in header["nested"]:
            kwargs[f.name] = _unflatten(z, f"{prefix}{f.name}.", header["nested"][f.name])
        else:
            a = z[prefix + f.name]
            is_none = a.shape == () and a.dtype.kind in "US" and str(a) == _NONE
            kwargs[f.name] = None if is_none else _to_tensor(a)
    return cls(**kwargs)


def _pack_int4(a: np.ndarray) -> np.ndarray:
    """int8 values in [-8, 7] -> two nibbles a byte (uint8), low first."""
    flat = np.ascontiguousarray(a, np.int8).reshape(-1)
    if len(flat) % 2:
        flat = np.concatenate([flat, np.zeros(1, np.int8)])
    u = flat.view(np.uint8)
    return ((u[0::2] & 0x0F) | ((u[1::2] & 0x0F) << 4)).astype(np.uint8)


_I4_LUT = None


def _unpack_int4(p: np.ndarray, shape) -> np.ndarray:
    # a 256-entry byte -> (low, high) int8 table: column 0 the sign-extended
    # low nibble, column 1 the high one, so reshape(-1) is the stream
    global _I4_LUT
    if _I4_LUT is None:
        b = np.arange(256, dtype=np.int16)
        lo = (((b & 0x0F) ^ 8) - 8).astype(np.int8)
        hi = ((((b >> 4) & 0x0F) ^ 8) - 8).astype(np.int8)
        _I4_LUT = np.stack([lo, hi], axis=1)
    n = int(np.prod(shape))
    return _I4_LUT[p].reshape(-1)[:n].reshape(shape)


def save_layout(path: str | Path, layout, *, pack_int4: bool = True,
                raw_threshold: int | None = 16 * 2**20) -> None:
    """Write one layout (nested ones included) to ``path`` (.npz).

    ``pack_int4``: int8 arrays of at least 4096 values, all in [-8, 7],
    are stored as nibbles; :func:`load_layout` unpacks them to int8.
    ``raw_threshold``: arrays of at least this many bytes (after packing)
    go to ``<stem>.<field>.npy`` beside the npz (None: none do); the npz
    and its side-cars are one artifact."""
    if type(layout) not in _STATIC:
        raise TypeError(f"unknown layout type {type(layout).__name__}")
    arrays: dict = {}
    header = _flatten(layout, "", arrays)
    if pack_int4:
        i4, packed = {}, {}
        for k, v in arrays.items():
            if (v.dtype == np.int8 and v.size >= 4096 and int(v.min(initial=0)) >= -8
                    and int(v.max(initial=0)) <= 7):
                packed[k + _I4_SUFFIX] = _pack_int4(v)
                i4[k] = list(v.shape)
            else:
                packed[k] = v
        arrays = packed
        header["__i4__"] = i4
    p = Path(path)
    raw = {}
    if raw_threshold is not None:
        for k in sorted(arrays):
            if arrays[k].nbytes >= raw_threshold:
                fn = f"{p.stem}.{k}.npy"
                np.save(p.parent / fn, arrays.pop(k))
                raw[k] = fn
    header["__raw__"] = raw
    np.savez(path, __layout_header__=np.asarray(json.dumps(header)), **arrays)


def load_layout(path: str | Path):
    """Read a layout written by :func:`save_layout` of either package, as
    CPU tensors."""
    p = Path(path)
    with np.load(path, allow_pickle=False) as z:
        header = json.loads(str(z["__layout_header__"]))
        data = {k: z[k] for k in z.files if k != "__layout_header__"}
    for k, fn in header.get("__raw__", {}).items():
        data[k] = np.load(p.parent / fn, allow_pickle=False)
    i4 = header.get("__i4__", {})
    if i4:
        out = {}
        for k, v in data.items():
            base = k[: -len(_I4_SUFFIX)]
            if k.endswith(_I4_SUFFIX) and base in i4:
                out[base] = _unpack_int4(v, i4[base])
            else:
                out[k] = v
        data = out
    return _unflatten(data, "", header)


def cached_layouts(cache_dir: str | Path, key: str, build):
    """``build()``'s tuple, kept under ``cache_dir/key-<i>.npz`` (layouts)
    and ``cache_dir/key.json`` (the other elements, e.g. the padded node
    count). ``key`` must encode everything the layouts depend on."""
    cache_dir = Path(cache_dir)
    cache_dir.mkdir(parents=True, exist_ok=True)
    meta_p = cache_dir / f"{key}.json"
    if meta_p.is_file():
        meta = json.loads(meta_p.read_text())
        return tuple(load_layout(cache_dir / f"{key}-{i}.npz") if kind == "layout"
                     else meta["values"][str(i)] for i, kind in enumerate(meta["kinds"]))
    result = tuple(build())
    kinds, values = [], {}
    for i, item in enumerate(result):
        if type(item) in _STATIC:
            save_layout(cache_dir / f"{key}-{i}.npz", item)
            kinds.append("layout")
        else:
            kinds.append("value")
            values[str(i)] = item.item() if isinstance(item, np.generic) else item
    # the manifest last: a save cut off midway leaves no valid entry
    meta_p.write_text(json.dumps({"kinds": kinds, "values": values}))
    return result
