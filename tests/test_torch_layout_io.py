"""The port's layout files (sldm_gnn_tpu_torch.graph.layout_io) against the
JAX package's (tests/test_layout_io.py's layouts and sizes): a layout
that either package's save_layout writes loads in the other bit for bit,
int4-packed count tiles and raw .npy side-cars included, and
cached_layouts serves the port's builders from disk."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sldm_gnn_tpu.graph import csr as jcsr
from sldm_gnn_tpu.graph import layout_io as jio
from sldm_gnn_tpu.ops import spmm_banded as jsb
from sldm_gnn_tpu.ops import spmm_dense as jsd
from sldm_gnn_tpu.ops import spmm_hybrid as jsh

from sldm_gnn_tpu_torch.graph import csr as tcsr
from sldm_gnn_tpu_torch.graph import layout_io as tio
from sldm_gnn_tpu_torch.ops import spmm_banded as tsb
from sldm_gnn_tpu_torch.ops import spmm_dense as tsd
from sldm_gnn_tpu_torch.ops import spmm_hybrid as tsh


def _graph(rng, n=1000, deg=5, reach=50):
    dst = np.repeat(np.arange(n, dtype=np.int64), deg)
    src = np.clip(dst + rng.integers(-reach, reach + 1, n * deg), 0, n - 1)
    return src, dst


def _bits(v) -> np.ndarray:
    """A field's array with its dtype; bf16 as its 16 bits."""
    if isinstance(v, torch.Tensor):
        return v.view(torch.int16).numpy() if v.dtype == torch.bfloat16 else v.numpy()
    a = np.asarray(v)
    return a.view(np.int16) if a.dtype.itemsize == 2 and a.dtype.kind == "V" or \
        str(a.dtype) == "bfloat16" else a


def _assert_same(t, j):
    """A port layout `t` equals a JAX layout `j`, field by field, bits and dtypes."""
    assert type(t).__name__ == type(j).__name__
    for f in dataclasses.fields(type(j)):
        tv, jv = getattr(t, f.name), getattr(j, f.name)
        if jv is None:
            assert tv is None, f.name
        elif f.metadata.get("static"):
            assert tv == jv or (tv != tv and jv != jv), f.name  # NaN dense_frac
        elif dataclasses.is_dataclass(jv):
            _assert_same(tv, jv)
        else:
            assert isinstance(tv, torch.Tensor) and tv.device.type == "cpu", f.name
            a, b = _bits(tv), _bits(jv)
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)


def _layouts(rng, kind):
    """(port layout, JAX layout) built from the same graph."""
    if kind == "banded":
        src, dst = _graph(rng)
        return (tsb.prepare_banded_mean_aggregate(src, dst, 1000, tile=64, k=4)[0],
                jsb.prepare_banded_mean_aggregate(src, dst, 1000, tile=64, k=4)[0])
    if kind in ("dense", "dense_bf16"):
        src, dst = _graph(rng)
        bf16 = kind == "dense_bf16"
        t = tsd.prepare_dense_mean_aggregate(src, dst, 1000, tile=64,
                                             dtype=torch.bfloat16 if bf16 else np.float32)[1]
        j = jsd.prepare_dense_mean_aggregate(src, dst, 1000, tile=64,
                                             dtype=jnp.bfloat16 if bf16 else np.float32)[1]
        assert t.a.dtype == (torch.bfloat16 if bf16 else torch.float32)
        return t, j
    if kind == "onehot":
        src, dst = _graph(rng)
        n_pad = tcsr.pad_nodes(1000, 64)
        w = tcsr.mean_weights(dst, n_pad)
        kw = dict(weight=w, tile=64, edge_chunk=32)
        return (tcsr.block_edges(dst, src, n_pad, **kw), jcsr.block_edges(dst, src, n_pad, **kw))
    if kind == "int4":
        n = 4096
        dst = np.repeat(np.arange(n, dtype=np.int64), 3)
        src = np.clip(dst + rng.integers(-40, 41, len(dst)), 0, n - 1)
        return (tsb.build_banded_counts(src, dst, n, tile=32, k=2),
                jsb.build_banded_counts(src, dst, n, tile=32, k=2))
    src, dst = _graph(rng, n=1200, deg=6, reach=40)
    kw = dict(tile=32, min_pair_edges=8, a_budget_bytes=1e6)
    return (tsh.prepare_hybrid_mean_aggregate(src, dst, 1200, **kw)[0],
            jsh.prepare_hybrid_mean_aggregate(src, dst, 1200, **kw)[0])


KINDS = ["banded", "dense", "dense_bf16", "onehot", "int4", "hybrid"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("raw_threshold", [16 * 2**20, 1024], ids=["npz", "sidecars"])
def test_files_cross_between_packages(tmp_path, rng, kind, raw_threshold):
    t, j = _layouts(rng, kind)
    _assert_same(t, j)  # the builders agree to begin with
    jio.save_layout(tmp_path / "j.npz", j, raw_threshold=raw_threshold)
    tio.save_layout(tmp_path / "t.npz", t, raw_threshold=raw_threshold)
    _assert_same(tio.load_layout(tmp_path / "j.npz"), j)
    _assert_same(tio.load_layout(tmp_path / "t.npz"), j)
    back = jio.load_layout(tmp_path / "t.npz")
    _assert_same(t, back)
    with np.load(tmp_path / "j.npz") as zj, np.load(tmp_path / "t.npz") as zt:
        assert sorted(zj.files) == sorted(zt.files)
    assert sorted(p.name[1:] for p in tmp_path.glob("t.*.npy")) == \
        sorted(p.name[1:] for p in tmp_path.glob("j.*.npy"))
    if raw_threshold == 1024 and kind != "onehot":
        assert list(tmp_path.glob("t.*.npy"))


def test_int4_packing(tmp_path, rng):
    """Count tiles in [-8, 7] are stored as nibbles, exactly as the JAX
    package stores them; larger counts stay int8."""
    t, _ = _layouts(rng, "int4")
    assert int(t.a.max()) <= 7
    tio.save_layout(tmp_path / "b.npz", t)
    jio.save_layout(tmp_path / "jb.npz", jio.load_layout(tmp_path / "b.npz"))
    with np.load(tmp_path / "b.npz") as z, np.load(tmp_path / "jb.npz") as zj:
        assert "a__i4" in z.files and "a" not in z.files
        np.testing.assert_array_equal(z["a__i4"], zj["a__i4"])
        assert z["a__i4"].nbytes * 2 >= t.a.numel() - 1
    got = tio.load_layout(tmp_path / "b.npz")
    assert got.a.dtype == torch.int8 and torch.equal(got.a, t.a)
    big = dataclasses.replace(t, a=t.a.clone())
    big.a.view(-1)[0] = 9
    tio.save_layout(tmp_path / "b.npz", big)
    with np.load(tmp_path / "b.npz") as z:
        assert "a" in z.files
    assert torch.equal(tio.load_layout(tmp_path / "b.npz").a, big.a)
    tio.save_layout(tmp_path / "c.npz", t, pack_int4=False)
    with np.load(tmp_path / "c.npz") as z:
        assert "a" in z.files
    with pytest.raises(TypeError, match="unknown layout"):
        tio.save_layout(tmp_path / "d.npz", object())


def test_cached_layouts(tmp_path, rng):
    n = 800
    src, dst = _graph(rng, n=n)
    calls = []

    def build():
        calls.append(1)
        return tsb.prepare_banded_mean_aggregate(src, dst, n, tile=64, k=4)

    r1 = tio.cached_layouts(tmp_path, "k1", build)
    r2 = tio.cached_layouts(tmp_path, "k1", build)
    assert len(calls) == 1
    jr = jsb.prepare_banded_mean_aggregate(src, dst, n, tile=64, k=4)
    for a, b in zip(r2[:2], jr[:2]):
        _assert_same(a, b)
    assert r1[2] == r2[2] == jr[2]
    # the JAX package reads the port's cache entry
    r3 = jio.cached_layouts(tmp_path, "k1", lambda: pytest.fail("rebuilt"))
    _assert_same(r1[0], r3[0])
    tio.cached_layouts(tmp_path, "k2", build)
    assert len(calls) == 2


def test_hybrid_cache_and_moves(tmp_path, rng):
    t, _ = _layouts(rng, "hybrid")
    r = tio.cached_layouts(tmp_path, "h", lambda: (t, t.n_pad))
    r2 = tio.cached_layouts(tmp_path, "h", lambda: pytest.fail("rebuilt"))
    assert r2[1] == t.n_pad and r2[0].dense_frac == t.dense_frac
    moved = r2[0].to("cpu")
    assert torch.equal(moved.onehot_fwd.weight, t.onehot_fwd.weight)
    assert r[0] is t
