"""The port's per-row int8 quantizer (sldm_gnn_tpu_torch.ops.quant) against
the JAX package's on the CPU, inputs made with numpy from a seed:

  * the plain version of csrc/quant_rows.cu within one int8 step of
    quantize_rows_pallas in interpret mode (tests/test_quant.py:33's
    bound), its scales equal, and bit-equal to the port's
    quantize_rows_xla;
  * stochastic rounding: the TPU's random bits cannot be matched and the
    JAX test of it is skipped on the CPU, so the port is held to that
    test's statistics (mean within 0.003 of 0.3 over 20 seeds, std > 0);
    its hash repeats per seed and equals the same hash in Python integers;
  * int8_matmul equals the JAX package's bit for bit.

The CUDA kernel runs only on the card, where chip_smoke.py holds it
against this plain version bit for bit."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sldm_gnn_tpu.ops import quant as jquant

from sldm_gnn_tpu_torch.ops import quant as tquant


def _cases(rng):
    x = rng.standard_normal((256, 128)).astype(np.float32)
    return {
        "normal": x,
        "scaled": x[:64, :32] * 3,
        "odd_width": rng.standard_normal((64, 100)).astype(np.float32),
        # a zero row (scale clamps to 1e-12) and exact .5 multiples
        "edges": np.concatenate([np.zeros((8, 64), np.float32),
                                 np.tile(np.arange(-32, 32, dtype=np.float32) + 0.5, (56, 1))]),
    }


@pytest.mark.parametrize("case", ["normal", "scaled", "odd_width", "edges"])
def test_plain_matches_pallas_interpret(rng, case):
    x = _cases(rng)[case]
    q_t, s_t = tquant.quantize_rows_plain(torch.from_numpy(x))
    q_j, s_j = jquant.quantize_rows_pallas(jnp.asarray(x), block_rows=8, interpret=True)
    assert q_t.dtype == torch.int8 and s_t.dtype == torch.float32
    assert tuple(q_t.shape) == x.shape and tuple(s_t.shape) == (x.shape[0], 1)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-6)
    # round to nearest: a tie can land one step apart (tests/test_quant.py:33)
    assert np.abs(q_t.numpy().astype(int) - np.asarray(q_j).astype(int)).max() <= 1
    # and the port's XLA function computes the same bits
    q_x, s_x = tquant.quantize_rows_xla(torch.from_numpy(x))
    assert torch.equal(q_t, q_x) and torch.equal(s_t, s_x)
    q_jx, s_jx = jquant.quantize_rows_xla(jnp.asarray(x))
    np.testing.assert_array_equal(q_x.numpy(), np.asarray(q_jx))
    np.testing.assert_array_equal(s_x.numpy(), np.asarray(s_jx))


def test_roundtrip_bound(rng):
    """tests/test_quant.py:16: half a step per element."""
    x = rng.standard_normal((64, 32)).astype(np.float32) * 3
    q, s = tquant.quantize_rows(torch.from_numpy(x))
    back = tquant.dequantize_rows(q, s).numpy()
    assert (np.abs(back - x) <= s.numpy() / 2 + 1e-6).all()


def test_cpu_tensors_take_the_plain_version(rng):
    x = torch.from_numpy(rng.standard_normal((40, 24)).astype(np.float32))
    before = tquant.quantize_rows.launches
    for kw in ({}, {"stochastic": True, "seed": 3}):
        got, want = tquant.quantize_rows(x, **kw), tquant.quantize_rows_plain(x, **kw)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert tquant.quantize_rows.launches == before


def test_stochastic_rounding_unbiased():
    """tests/test_quant.py:41-58's statistic: 0.3 * 127 = 38.1 dithers
    between 38 and 39 with mean 38.1."""
    row = np.full(128, 0.3, np.float32)
    row[0] = 1.0
    x = torch.from_numpy(np.tile(row, (8, 1)))
    vals = []
    for seed in range(20):
        q, s = tquant.quantize_rows(x, stochastic=True, seed=seed)
        vals.append(tquant.dequantize_rows(q, s).numpy()[:, 1:].mean())
        assert set(np.unique(q.numpy()[:, 1:])) <= {38, 39}
    np.testing.assert_allclose(np.mean(vals), 0.3, atol=0.003)
    assert np.std(vals) > 0


def test_stochastic_floor_and_clamp(rng):
    """Every stochastic value is the floor or the ceiling of x / s, within
    [-127, 127]; the anchors (|x| = absmax) are exact."""
    x = rng.standard_normal((32, 64)).astype(np.float32)
    q, s = tquant.quantize_rows_plain(torch.from_numpy(x), stochastic=True, seed=7)
    scaled = x / s.numpy()
    qn = q.numpy().astype(np.float64)
    assert ((qn == np.floor(scaled)) | (qn == np.floor(scaled) + 1)).all()
    assert np.abs(qn).max() == 127


def _fmix32(h: int) -> int:
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & 0xFFFFFFFF
    return h ^ (h >> 16)


def test_hash_repeats_per_seed_and_equals_integer_arithmetic():
    n, d = 6, 40
    u0 = tquant.uniform_hash(5, n, d)
    assert torch.equal(u0, tquant.uniform_hash(5, n, d))
    assert not torch.equal(u0, tquant.uniform_hash(6, n, d))
    assert u0.dtype == torch.float32 and float(u0.min()) >= 0.0 and float(u0.max()) < 1.0
    for seed in (0, 5, 2 ** 31 - 1, -1):
        u = tquant.uniform_hash(seed, n, d)
        for r in range(n):
            hr = _fmix32(_fmix32(r) ^ (seed & 0xFFFFFFFF))
            for c in range(d):
                h = _fmix32((hr + c * 0x9E3779B9) & 0xFFFFFFFF)
                want = np.array([(h >> 9) | 0x3F800000], np.uint32).view(np.float32)[0] - 1.0
                assert u[r, c].item() == want
    # the draws are spread: 4 bins of 2400 hold a quarter each within 5 %
    counts = np.histogram(tquant.uniform_hash(1, 60, 40).numpy(), bins=4, range=(0, 1))[0]
    assert np.abs(counts / counts.sum() - 0.25).max() < 0.05


def test_contracts_raise(rng):
    x = rng.standard_normal((16, 8)).astype(np.float32)
    for fn in (tquant.quantize_rows, tquant.quantize_rows_plain):
        with pytest.raises(ValueError, match="float32"):
            fn(torch.from_numpy(x).double())
        with pytest.raises(ValueError, match="float32"):
            fn(torch.from_numpy(x[0]))
    with pytest.raises(AssertionError):  # the JAX kernel's own row contract
        jquant.quantize_rows_pallas(jnp.asarray(x[:12]), block_rows=8, interpret=True)


def test_int8_matmul_equals_jax(rng):
    x = rng.standard_normal((32, 64)).astype(np.float32)
    w = rng.standard_normal((64, 16)).astype(np.float32)
    qx, sx = tquant.quantize_rows_xla(torch.from_numpy(x))
    qw, sw = tquant.quantize_rows_xla(torch.from_numpy(w.T.copy()))
    got = tquant.int8_matmul(qx, sx, qw, sw)
    want = jquant.int8_matmul(*(jnp.asarray(t.numpy()) for t in (qx, sx, qw, sw)))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    err = np.abs(got.numpy() - x @ w) / (np.abs(x @ w).mean() + 1e-6)
    assert err.mean() < 0.05
