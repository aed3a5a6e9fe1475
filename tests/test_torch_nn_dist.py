"""``nn_min_sq_both`` and the Chamfer / F-score built on it: the port's
plain version against rald_tpu's Pallas kernel (interpret mode), a scipy
cKDTree oracle at metric coordinate scale, the empty-prediction semantics,
and -- on the card only -- the CUDA kernel, bitwise.

Both sides compute exact float32 subtract-square (no |a|^2+|b|^2-2ab):
rtol 1e-6 against JAX; 1e-5 against scipy's float64 distances."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from rald_torch.eval.chamfer import batched_cd_fscore_graph, chamfer_and_fscore_batch
from rald_torch.ops import nn_dist_kernel as tn
from rald_tpu.ops.nn_dist_kernel import BIG as J_BIG
from rald_tpu.ops.nn_dist_kernel import nn_min_sq_both as j_both


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `python -m pytest -m gpu` on the card")
    return torch.device("cuda")


def _clouds(bsz, n, m, seed, pad_a=0, pad_b=0):
    """Metric-scale points (~15 m) with BIG rows padding each frame's tail."""
    rng = np.random.default_rng(seed)
    a = rng.uniform([0, -15, -5], [15.8, 15, 5], size=(bsz, n, 3)).astype(np.float32)
    b = (a[:, rng.choice(n, m)] + rng.normal(scale=0.2, size=(bsz, m, 3))).astype(np.float32)
    if pad_a:
        a[:, -pad_a:] = tn.BIG
    if pad_b:
        b[:, -pad_b:] = tn.BIG
    return a, b


def test_big_matches_reference():
    assert tn.BIG == J_BIG


@pytest.mark.parametrize("n,m,pad_a,pad_b", [(300, 200, 0, 0), (257, 130, 17, 9), (40, 1000, 5, 0)])
def test_plain_matches_pallas(n, m, pad_a, pad_b):
    a, b = _clouds(2, n, m, seed=n + m, pad_a=pad_a, pad_b=pad_b)
    j_row, j_col = j_both(jnp.asarray(a), jnp.asarray(b), tile_a=64, tile_b=128, interpret=True)
    row, col = tn.nn_min_sq_both_plain(torch.from_numpy(a), torch.from_numpy(b), chunk_elems=4096)
    # padded rows' own outputs are garbage the caller masks: compare real rows
    np.testing.assert_allclose(row.numpy()[:, :n - pad_a], np.asarray(j_row)[:, :n - pad_a],
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(col.numpy()[:, :m - pad_b], np.asarray(j_col)[:, :m - pad_b],
                               rtol=1e-6, atol=0)


def test_plain_both_directions_match_swapped_call_bitwise():
    a, b = _clouds(1, 500, 300, seed=5)
    row, col = tn.nn_min_sq_both_plain(torch.from_numpy(a), torch.from_numpy(b), chunk_elems=7000)
    col2, row2 = tn.nn_min_sq_both_plain(torch.from_numpy(b), torch.from_numpy(a))
    assert torch.equal(row, row2) and torch.equal(col, col2)


def test_plain_matches_kdtree_oracle():
    a, b = _clouds(1, 3000, 1200, seed=6)
    row, col = tn.nn_min_sq_both_plain(torch.from_numpy(a), torch.from_numpy(b))
    d_ab, _ = cKDTree(b[0].astype(np.float64)).query(a[0].astype(np.float64))
    d_ba, _ = cKDTree(a[0].astype(np.float64)).query(b[0].astype(np.float64))
    np.testing.assert_allclose(np.sqrt(row.numpy()[0]), d_ab, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.sqrt(col.numpy()[0]), d_ba, rtol=1e-5, atol=1e-6)


def _oracle_cd_f(pred, gt, tau):
    d_pg, _ = cKDTree(gt.astype(np.float64)).query(pred.astype(np.float64))
    d_gp, _ = cKDTree(pred.astype(np.float64)).query(gt.astype(np.float64))
    p, r = (d_pg < tau).mean(), (d_gp < tau).mean()
    return 0.5 * d_pg.mean() + 0.5 * d_gp.mean(), (2 * p * r / (p + r) if p + r > 0 else 0.0)


def test_chamfer_fscore_matches_scipy_at_metric_scale():
    """tests/test_native.py::TestChamferOracleExactness at the port: exact at
    ~15 m coordinates, where |a|^2+|b|^2-2ab loses the small distances."""
    rng = np.random.default_rng(11)
    pred = rng.uniform([0, -15, -5], [15.8, 15, 5], size=(4000, 3)).astype(np.float32)
    gt = (pred[rng.choice(4000, 1500)] + rng.normal(scale=0.15, size=(1500, 3))).astype(np.float32)
    want_cd, want_f = _oracle_cd_f(pred, gt, 0.1)
    cds, fs = chamfer_and_fscore_batch([pred], [gt], 0.1, device="cpu")
    assert cds[0] == pytest.approx(want_cd, rel=1e-5)
    assert fs[0] == pytest.approx(want_f, abs=1e-5)


def test_batched_graph_ragged_and_empty_predictions():
    """Per-frame masks; an empty prediction gives CD inf and F 0."""
    rng = np.random.default_rng(12)
    pred = rng.uniform([0, -15, -5], [15.8, 15, 5], size=(3, 600, 3)).astype(np.float32)
    gt = rng.uniform([0, -15, -5], [15.8, 15, 5], size=(3, 400, 3)).astype(np.float32)
    pmask = np.zeros((3, 600), bool)
    pmask[0, :600] = True
    pmask[1, :123] = True  # frame 2 stays empty
    gmask = np.ones((3, 400), bool)
    gmask[1, 350:] = False
    cd, f = batched_cd_fscore_graph(torch.from_numpy(pred), torch.from_numpy(pmask),
                                    torch.from_numpy(gt), torch.from_numpy(gmask), 0.5)
    for i in range(2):
        want_cd, want_f = _oracle_cd_f(pred[i][pmask[i]], gt[i][gmask[i]], 0.5)
        assert float(cd[i]) == pytest.approx(want_cd, rel=1e-5)
        assert float(f[i]) == pytest.approx(want_f, abs=1e-5)
    assert np.isinf(float(cd[2])) and float(f[2]) == 0.0
    cds, fs = chamfer_and_fscore_batch([pred[0], np.zeros((0, 3))], [gt[0], gt[1]], 0.5,
                                       device="cpu")
    assert np.isinf(cds[1]) and fs[1] == 0.0


def test_cpu_tensor_takes_plain_path_without_counting():
    from rald_torch.ops import reset_launch_counts

    a, b = _clouds(1, 64, 32, seed=13)
    reset_launch_counts()
    got = tn.nn_min_sq_both(torch.from_numpy(a), torch.from_numpy(b))
    want = tn.nn_min_sq_both_plain(torch.from_numpy(a), torch.from_numpy(b))
    assert tn.nn_min_sq_both.launches == 0
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_wrapper_rejects_bad_shapes():
    with pytest.raises(ValueError, match="need"):
        tn.nn_min_sq_both(torch.zeros(1, 4, 2), torch.zeros(1, 4, 3))
    with pytest.raises(ValueError, match="need"):
        tn.nn_min_sq_both(torch.zeros(1, 4, 3), torch.zeros(2, 4, 3))


@pytest.mark.gpu
@pytest.mark.parametrize("bsz,n,m,pad_a,pad_b", [(1, 500_000, 10_000, 1000, 100),
                                                 (8, 500_000, 10_000, 4096, 17),
                                                 (2, 3001, 257, 0, 0)])
def test_cuda_kernel_bitwise_equals_plain(cuda, bsz, n, m, pad_a, pad_b):
    a, b = _clouds(bsz, n, m, seed=bsz, pad_a=pad_a, pad_b=pad_b)
    ta, tb = torch.from_numpy(a).to(cuda), torch.from_numpy(b).to(cuda)
    before = tn.nn_min_sq_both.launches
    row, col = tn.nn_min_sq_both(ta, tb)
    row_p, col_p = tn.nn_min_sq_both_plain(ta, tb)
    col_s, row_s = tn.nn_min_sq_both(tb, ta)
    torch.cuda.synchronize()
    assert tn.nn_min_sq_both.launches == before + 2
    assert torch.equal(row, row_p) and torch.equal(col, col_p)
    assert torch.equal(row, row_s) and torch.equal(col, col_s)
