"""The port's int8 path (sldm_gnn_tpu_torch.ops.quant and the int8 banded
aggregation of ops.spmm_banded) against the JAX package's on the CPU, at
the sizes of tests/test_spmm_banded.py:168-210, inputs from numpy with a
seed: quantization bit for bit (both round half to even), the plain version
of csrc/spmm_banded_int8.cu against the JAX Pallas kernel in interpret mode
at the JAX test's 1e-6, and the contracts of the JAX kernel as ValueErrors."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sldm_gnn_tpu.ops import quant as jq
from sldm_gnn_tpu.ops import spmm_banded as jsb

from sldm_gnn_tpu_torch.ops import quant as tq
from sldm_gnn_tpu_torch.ops import spmm_banded as tsb

INT8_RTOL = INT8_ATOL = 1e-6  # test_spmm_banded.py:186


def _banded_graph(rng, n=3000, deg=6, reach=90):
    dst = np.repeat(np.arange(n, dtype=np.int64), deg)
    return np.clip(dst + rng.integers(-reach, reach + 1, n * deg), 0, n - 1), dst


def _features(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    x.flat[:4] = [1.5, -2.5, 0.5, 3.0]  # round-half-even ties once scaled
    return x


@pytest.mark.parametrize("shape", [(257, 16), (64, 1), (3, 128)])
def test_quantize_tensor_bit_equal_to_jax(rng, shape):
    x = _features(rng, shape)
    q, s = tq.quantize_tensor_xla(torch.from_numpy(x))
    jqv, js = jq.quantize_tensor_xla(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.shape == (1,) and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    # the scale makes the absmax land on 127: a tie case exactly
    x2 = np.array([[127.0, 63.5, -0.5, 1.5, 2.5]], np.float32)
    q2, _ = tq.quantize_tensor_xla(torch.from_numpy(x2))
    np.testing.assert_array_equal(q2.numpy(), np.asarray(jq.quantize_tensor_xla(jnp.asarray(x2))[0]))
    zero = tq.quantize_tensor_xla(torch.zeros(4, 4))
    assert float(zero[1]) == pytest.approx(1e-12) and not zero[0].any()


def test_quantize_rows_bit_equal_to_jax(rng):
    x = _features(rng, (300, 24))
    x[7] = 0.0
    q, s = tq.quantize_rows_xla(torch.from_numpy(x))
    jqv, js = jq.quantize_rows_xla(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tq.dequantize_rows(q, s).numpy(),
                                  np.asarray(jq.dequantize_rows(jqv, js)))


# (tile, D): the JAX test's, then tiles 32 and 128 at D 4 and 40 (rows the
# CUDA kernel's TMA cannot take) and 128; "exact" is one row that takes
# each of 1152 sources (9 tiles of 128) EXACT_COUNTS times with xq = 127:
# 124 times (a multiple of 4) but 123 at source 1087 and 126 at the last,
# so the sum up to 1087 is odd and past 2^24 and the rest adds 2 mod 4. The
# exact sum, 18141823, rounds once to a multiple of 4; a sum accumulated in
# f32 rounds at 1087 and ends 2 off (checked in the test).
INT8_CASES = [(64, 16), (32, 4), (32, 40), (32, 128), (128, 4), (128, 40), (128, 128), "exact"]
EXACT_COUNTS = np.full(1152, 124, np.int64)
EXACT_COUNTS[1087], EXACT_COUNTS[-1] = 123, 126


def _f32_sums(contrib, g):
    """An f32 accumulator adding the exact sums of g consecutive terms in order."""
    acc = np.float32(0)
    for i in range(0, len(contrib), g):
        acc = np.float32(acc + np.float32(int(contrib[i:i + g].sum())))
    return acc


def _int8_case(rng, case):
    if case == "exact":
        n = len(EXACT_COUNTS)
        src = np.repeat(np.arange(n, dtype=np.int64), EXACT_COUNTS)
        dst = np.full(len(src), n // 2, np.int64)
        return src, dst, n, 128, 128
    tile, d = case
    src, dst = _banded_graph(rng)
    return src, dst, 3000, tile, d


INT8_IDS = [c if isinstance(c, str) else f"tile{c[0]}-D{c[1]}" for c in INT8_CASES]


@pytest.mark.parametrize("case", INT8_CASES, ids=INT8_IDS)
def test_int8_plain_matches_pallas(rng, case):
    src, dst, n, tile, d = _int8_case(rng, case)
    fwd, _, n_pad = tsb.prepare_banded_mean_aggregate(src, dst, n, tile=tile, k=4)
    jf, _, _ = jsb.prepare_banded_mean_aggregate(src, dst, n, tile=tile, k=4)
    if case == "exact":
        assert fwd.s_span == 9
        x = np.ones((n_pad, d), np.float32)  # quantized to 127 everywhere
    else:
        x = rng.standard_normal((n_pad, d)).astype(np.float32)
    jxq, js = jq.quantize_tensor_xla(jnp.asarray(x))
    xq, s = tq.quantize_tensor_xla(torch.from_numpy(x))
    got = tsb.spmm_banded_int8(xq, s, fwd)
    assert got.dtype == torch.float32 and got.shape == (n_pad, d)
    want = np.asarray(jsb.spmm_banded_int8_pallas(jxq, js, jax.tree.map(jnp.asarray, jf),
                                                  interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=INT8_RTOL, atol=INT8_ATOL)
    # the exact integer sums, as test_spmm_banded.py:178-186 writes them
    want_int = np.zeros((n_pad, d), np.int64)
    np.add.at(want_int, dst, xq.numpy().astype(np.int64)[src])
    if case == "exact":
        total = int(EXACT_COUNTS.sum()) * 127
        assert want_int[n // 2, 0] == total > 2 ** 24
        # the case tells an exact sum from one accumulated in f32
        for g in (1, 16, 32, 64):
            assert _f32_sums(EXACT_COUNTS * 127, g) != np.float32(total)
    exact = (want_int.astype(np.float32) * s.numpy()[0]) * fwd.row_scale.numpy()
    np.testing.assert_array_equal(got.numpy(), exact)
    if case == "exact":
        return
    # the convenience wrapper
    got_w = tsb.spmm_banded_infer_int8(torch.from_numpy(x), fwd)
    want_w = np.asarray(jsb.spmm_banded_infer_int8(jnp.asarray(x), jax.tree.map(jnp.asarray, jf),
                                                   interpret=True))
    np.testing.assert_allclose(got_w.numpy(), want_w, rtol=INT8_RTOL, atol=INT8_ATOL)
    full = tsb.spmm_banded_xla(torch.from_numpy(x), fwd).numpy()
    assert np.abs(got_w.numpy() - full).max() / np.abs(full).max() < 5e-2


def test_int8_contracts_raise(rng):
    src, dst = _banded_graph(rng, n=1000, deg=3)
    fwd, rev, n_pad = tsb.prepare_banded_mean_aggregate(src, dst, 1000, tile=64, k=4)
    ffwd, _, _ = tsb.prepare_banded_mean_aggregate(src, dst, 1000, tile=64, k=4,
                                                   dtype=np.float32)
    xq, s = tq.quantize_tensor_xla(torch.from_numpy(
        rng.standard_normal((n_pad, 8)).astype(np.float32)))
    bad = [(xq, s, rev, "row scale"), (xq, s, ffwd, "int8 count tiles"),
           (xq, s, dataclasses.replace(fwd, wide=True), "not wide"),
           (xq, s, dataclasses.replace(fwd, cmap=torch.zeros(4, dtype=torch.int32)), "cmap"),
           (xq.float(), s, fwd, "must be int8"), (xq, s.reshape(1, 1), fwd, "shape")]
    for a, b, lay, msg in bad:
        for fn in (tsb.spmm_banded_int8, tsb.spmm_banded_int8_plain):
            with pytest.raises(ValueError, match=msg):
                fn(a, b, lay)
    before = tsb.spmm_banded_int8.launches
    assert torch.equal(tsb.spmm_banded_int8(xq, s, fwd), tsb.spmm_banded_int8_plain(xq, s, fwd))
    assert tsb.spmm_banded_int8.launches == before  # CPU tensors launch nothing
