"""The port's v1 GRU scan (ops/gru_cuda: gru_scan_fwd/_bwd, GruScanFn,
gru_forward_v1) against the JAX package's gru_scan_pallas /
gru_forward_pallas in interpret mode and the f32 XLA scan, on the same
numpy-seeded inputs. On the CPU the wrappers run the kernels' plain
versions; the CUDA kernels (csrc/gru_scan.cu) run only on the card
(chip_smoke.py)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sldm_gnn_tpu.ops.gru import gru_forward as jax_gru_forward
from sldm_gnn_tpu.ops.gru import init_gru_params
from sldm_gnn_tpu.ops.gru_pallas import _run_bwd, gru_forward_pallas, gru_scan_pallas

from sldm_gnn_tpu_torch.ops import gru_cuda
from sldm_gnn_tpu_torch.ops.gru import GRUParams, gru_forward

NAMES = ("w_ih0", "w_hh0", "b_ih0", "b_hh0", "w_ih", "w_hh", "b_ih", "b_hh")


def _t(a):
    return torch.from_numpy(np.array(a))


def _params(p, grad=False) -> GRUParams:
    return GRUParams(*[_t(a).requires_grad_(grad and a.size > 0) for a in p])


@pytest.mark.parametrize("layers", [1, 2])
def test_forward_matches_pallas_and_scan(rng, layers):
    B, T, D, H = 16, 12, 6, 8
    p = init_gru_params(jax.random.PRNGKey(0), D, H, layers)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    out_p, h_p = gru_forward_pallas(p, jnp.asarray(x), interpret=True)
    out_x, h_x = jax_gru_forward(p, jnp.asarray(x))
    out_t, h_t = gru_cuda.gru_forward_v1(_params(p), _t(x))
    assert out_t.shape == (B, T, H) and h_t.shape == (B, H)
    for want in (out_p, out_x):
        np.testing.assert_allclose(out_t.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_p), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_x), rtol=1e-5, atol=1e-5)
    # and the port's own f32 scan
    out_s, _ = gru_forward(_params(p), _t(x))
    np.testing.assert_allclose(out_t.numpy(), out_s.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("layers,tol", [(1, (2e-4, 2e-5)), (2, (5e-4, 5e-5))])
def test_grads_match_pallas(rng, layers, tol):
    """d(sum(out * coef) + sum(h_last^2)) by x and every GRU parameter,
    through GruScanFn (the BPTT plain version on the CPU) against jax.grad
    through gru_forward_pallas (interpret), tests/test_gru_pallas.py's
    bounds."""
    B, T, D, H = (8, 10, 5, 8) if layers == 1 else (4, 6, 3, 8)
    p = init_gru_params(jax.random.PRNGKey(layers), D, H, layers)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    coef = rng.standard_normal((B, T, H)).astype(np.float32)

    def loss_j(pp, xx):
        out, h = gru_forward_pallas(pp, xx, interpret=True)
        return jnp.sum(out * coef) + jnp.sum(h ** 2)

    gx_j, gp_j = jax.grad(loss_j, argnums=(1, 0))(p, jnp.asarray(x))
    pt = _params(p, grad=True)
    xt = _t(x).requires_grad_()
    out, h = gru_cuda.gru_forward_v1(pt, xt)
    loss = (out * _t(coef)).sum() + (h ** 2).sum()
    live = [i for i, a in enumerate(pt) if a.requires_grad]
    grads = torch.autograd.grad(loss, [xt] + [pt[i] for i in live])
    rtol, atol = tol
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(gx_j), rtol=rtol, atol=atol)
    for i, g in zip(live, grads[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(getattr(gp_j, NAMES[i])), rtol=rtol,
                                   atol=atol, err_msg=NAMES[i])


# (T, N, H): the first case, then the card sweep's ragged widths (H not a
# multiple of 4 or of 16, H past 96 where dW_hh takes two passes), N not a
# multiple of either row tile (16, 32) and one frame; then one row, the
# flagship's H 96, the widest H of each row tile (112 of 32 rows, 128 of
# 16) and the first of the 16-row tile (113), and N at and around a tile
BWD_SHAPES = [(7, 9, 8), (5, 65, 20), (1, 23, 33), (3, 25, 100), (1, 65, 100),
              (2, 1, 8), (1, 1, 128), (2, 24, 64), (3, 32, 96), (2, 33, 112), (2, 17, 113),
              (2, 16, 128), (4, 31, 48), (3, 63, 16), (2, 40, 97), (5, 8, 24), (2, 48, 72),
              (2, 64, 1)]


@pytest.mark.parametrize("T,B,H", BWD_SHAPES, ids=[f"T{t}-N{b}-H{h}" for t, b, h in BWD_SHAPES])
def test_bwd_plain_matches_pallas_bwd_kernel(rng, T, B, H):
    """gru_scan_bwd_plain against the JAX BPTT kernel itself (_run_bwd,
    interpret) on the JAX forward's hs: dxproj, dW_hh and db_hh."""
    p = init_gru_params(jax.random.PRNGKey(5), 4, H, 1)
    xproj = (rng.standard_normal((T, B, 3 * H)) * 0.8).astype(np.float32)
    g = rng.standard_normal((T, B, H)).astype(np.float32)
    hs = gru_scan_pallas(jnp.asarray(xproj), p.w_hh0, p.b_hh0, True)
    dxp_j, dw_j, db_j = _run_bwd(jnp.asarray(xproj), hs, p.w_hh0, p.b_hh0, jnp.asarray(g),
                                 interpret=True)
    hs_t = gru_cuda.gru_scan_fwd(_t(xproj), _t(p.w_hh0), _t(p.b_hh0))
    np.testing.assert_allclose(hs_t.numpy(), np.asarray(hs), rtol=1e-5, atol=1e-5)
    dxp, dw, db = gru_cuda.gru_scan_bwd(_t(xproj), hs_t, _t(p.w_hh0), _t(p.b_hh0), _t(g))
    for got, want in ((dxp, dxp_j), (dw, dw_j), (db, np.asarray(db_j).reshape(-1))):
        scale = np.abs(np.asarray(want)).max() + 1e-6
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4 * scale)


def test_strided_xproj_and_cotangent(rng):
    """The wrappers take xproj and the cotangent as strided views (the
    transposed [B, T, 3H] projection), as gru_forward_v1 passes them."""
    B, T, H = 5, 6, 8
    w = _t(rng.standard_normal((H, 3 * H)).astype(np.float32) * 0.3)
    b = _t(rng.standard_normal(3 * H).astype(np.float32) * 0.1)
    xp_btc = _t(rng.standard_normal((B, T, 3 * H)).astype(np.float32))
    g_bth = _t(rng.standard_normal((B, T, H)).astype(np.float32))
    view, dense = xp_btc.transpose(0, 1), xp_btc.transpose(0, 1).contiguous()
    hs = gru_cuda.gru_scan_fwd(view, w, b)
    assert torch.equal(hs, gru_cuda.gru_scan_fwd(dense, w, b))
    a = gru_cuda.gru_scan_bwd(view, hs, w, b, g_bth.transpose(0, 1))
    c = gru_cuda.gru_scan_bwd(dense, hs, w, b, g_bth.transpose(0, 1).contiguous())
    assert all(torch.equal(u, v) for u, v in zip(a, c))


def test_scan_refuses_bad_shapes():
    w = torch.zeros(8, 24)
    b = torch.zeros(24)
    with pytest.raises(ValueError, match="xproj"):
        gru_cuda.gru_scan_fwd(torch.zeros(3, 2, 23), w, b)
    with pytest.raises(ValueError, match="w_hh"):
        gru_cuda.gru_scan_fwd(torch.zeros(3, 2, 24), torch.zeros(8, 23), b)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        gru_cuda.gru_scan_fwd(torch.zeros(3, 2, 24, device="meta"), w, b)


def _rup(a, b):
    return -(-a // b) * b


def _bwd_smem(h, rows):
    """csrc/gru_scan.cu's bwd_smem(HG, rows): W_hh with each gate padded
    to HG = H rounded up to 16, in rows of LD = 3 HG rounded up to 32; the
    dhp tile [rows, LD], the hprev tile [rows, LH = HG rounded up to 32],
    b_hh [3 HG]; f32."""
    hg = _rup(h, 16)
    ld, lh = _rup(3 * hg, 32), _rup(hg, 32)
    return 4 * (hg * ld + rows * (ld + lh) + 3 * hg)


def _fwd_smem(h, mtiles):
    """csrc/gru_scan.cu's fwd_smem(HG, mt): W_hh with each gate padded to
    HG = H rounded up to 16, in rows of LD = 3 HG rounded up to 32; the
    carry tile [16 mt, LH = HG rounded up to 32], b_hh [3 HG]; f32."""
    hg = _rup(h, 16)
    return 4 * (hg * _rup(3 * hg, 32) + 16 * mtiles * _rup(hg, 32) + 3 * hg)


def test_scan_widest_h_within_the_shared_memory_formula():
    """SCAN_WIDEST_H against the shared memory of csrc/gru_scan.cu
    (fwd_smem / bwd_smem) and the H100's 232 448-byte opt-in: each
    kernel's widest H is the widest whose narrowest block fits (the
    forward's one m-tile of 16 rows, the backward's 16-row tile), and
    neither is below its first design's (forward 128, backward 123)."""
    limit = 232448
    for kind, smem, rows, first in (("forward", _fwd_smem, 1, 128),
                                    ("backward", _bwd_smem, 16, 123)):
        h = gru_cuda.SCAN_WIDEST_H[kind]
        assert smem(h, rows) <= limit < smem(h + 1, rows)
        assert h >= first
