"""``nn_min_sq_both``, ``nn_min_sq_batch`` and the Chamfer / F-score built on
them (the engine's batched graph and the host APIs): the port's plain
versions against rald_tpu's Pallas kernels (interpret mode) and host APIs,
a scipy cKDTree oracle at metric coordinate scale, the empty-prediction
semantics, and -- on the card only -- the CUDA kernels, bitwise.

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


# ------------------------------------------------------ the split of the M axis
H100_SMS = 132


def _slices(m: int, s: int) -> list:
    """``[(start, end), ...]``: the b rows of each of the ``s`` slices. The
    kernel's cut in ``rald_torch/csrc/nn_dist.cu`` (``jb`` / ``je``) is the
    source of truth: chunks ``[k C / s, (k + 1) C / s)`` of ``C = ceil(m /
    CHUNK)``."""
    chunks = -(-m // tn.CHUNK)
    return [(k * chunks // s * tn.CHUNK, min((k + 1) * chunks // s * tn.CHUNK, m))
            for k in range(s)]


@pytest.mark.parametrize("sm_count", [114, 132, 144])
def test_split_plan_is_one_at_the_main_shape(sm_count):
    """Batch 8 of 5e5 predictions: the a tiles alone fill the card (H100
    PCIe, SXM and a larger card)."""
    assert tn.split_plan(8, 500_000, 10_000, sm_count) == 1


@pytest.mark.parametrize("bsz,n,m", [(1, 16384, 524288), (1, 32768, 16384),
                                     (1, 500_000, 10_000), (1, 524288, 16384),
                                     (8, 3001, 200_000)])
def test_split_plan_reaches_the_target_grid(bsz, n, m):
    """The host API's reverse pass, a small eval prediction, batch 1 of the
    main shape: at least WAVES blocks per SM, no more slices than chunks."""
    s = tn.split_plan(bsz, n, m, H100_SMS)
    assert 1 < s <= -(-m // tn.CHUNK)
    assert bsz * -(-n // tn.TILE_A) * s >= tn.WAVES * H100_SMS


@pytest.mark.parametrize("bsz,n,m", [(8, 500_000, 10_000), (1, 500_000, 10_000),
                                     (1, 16384, 524288), (1, 32768, 16384), (1, 524288, 16384)])
def test_split_plan_is_the_least_that_reaches_the_target(bsz, n, m):
    """No more slices than the target grid needs: one slice fewer falls
    short of WAVES blocks per SM (each slice adds a block's set-up and, for
    S > 1, atomic row stores)."""
    s = tn.split_plan(bsz, n, m, H100_SMS)
    tiles = bsz * -(-n // tn.TILE_A)
    assert s == 1 or tiles * (s - 1) < tn.WAVES * H100_SMS


@pytest.mark.parametrize("n,m", [(3001, 257), (700, 63), (700, 1), (4096, 130), (9000, 64)])
def test_split_plan_caps_at_one_chunk_a_slice(n, m):
    """A b set too small to reach the target: one chunk a slice, never more
    slices than chunks (M up to one chunk: one slice)."""
    assert tn.split_plan(1, n, m, H100_SMS) == -(-m // tn.CHUNK)


@pytest.mark.parametrize("m", [1, 63, 64, 65, 257, 10_000, 16384, 100_003, 524288])
def test_split_slices_cover_m_exactly(m):
    """Every slice count the kernel takes (1 to ceil(M / CHUNK)), including
    ones that divide neither M nor its chunks: contiguous, from 0 to M, none
    empty."""
    chunks = -(-m // tn.CHUNK)
    plans = {tn.split_plan(b, n, m, H100_SMS) for b, n in [(1, 16384), (1, 500_000), (8, 500_000)]}
    for s in sorted({1, 2, 3, 7, 132, chunks // 3, chunks - 1, chunks} | plans):
        if not 1 <= s <= chunks:
            continue
        sl = _slices(m, s)
        assert len(sl) == s and sl[0][0] == 0 and sl[-1][1] == m
        assert all(e > st for st, e in sl), (m, s)
        assert all(sl[k][1] == sl[k + 1][0] for k in range(s - 1))


def test_split_minima_combine_bitwise():
    """The kernel's combine of per-slice minima (min over slices for the
    rows, slices side by side for the columns) is bitwise the unsplit
    result."""
    a, b = _clouds(2, 300, 1000, seed=41, pad_a=3, pad_b=17)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    want_row, want_col = tn.nn_min_sq_both_plain(ta, tb)
    row = torch.full_like(want_row, float("inf"))
    cols = []
    for st, e in _slices(1000, 7):
        r, c = tn.nn_min_sq_both_plain(ta, tb[:, st:e].contiguous())
        row = torch.minimum(row, r)
        cols.append(c)
    assert torch.equal(row, want_row) and torch.equal(torch.cat(cols, 1), want_col)


# shapes on the card: the product batch 1 and 8, a ragged batch, the host
# API's reverse pass (GT 1e4 -> 16384 rows against 5e5 predictions ->
# 524288), a small-grid batch with BIG pads, and an M that no slice count
# divides
CUDA_SHAPES = [(1, 500_000, 10_000, 1000, 100), (8, 500_000, 10_000, 4096, 17),
               (2, 3001, 257, 0, 0), (1, 16384, 524288, 6384, 24288),
               (8, 3001, 200_000, 1, 500), (1, 4099, 100_003, 3, 2)]


@pytest.mark.gpu
@pytest.mark.parametrize("bsz,n,m,pad_a,pad_b", CUDA_SHAPES)
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


# ------------------------------------------------------ nn_min_sq_batch (B3)
@pytest.mark.parametrize("n,m,pad_a,pad_b", [(300, 200, 0, 0), (257, 130, 17, 9)])
def test_batch_plain_matches_pallas(n, m, pad_a, pad_b):
    """Within 1 float32 ulp (rtol 1e-6, as for nn_min_sq_both above): XLA's
    CPU backend contracts the interpreted kernel's ``acc += d * d`` into
    fused multiply-adds, which the exact separate roundings of the port (and
    of its CUDA kernel, bitwise on the card) do not."""
    from rald_tpu.ops.nn_dist_kernel import nn_min_sq_batch as j_batch

    a, b = _clouds(2, n, m, seed=n * m, pad_a=pad_a, pad_b=pad_b)
    want = np.asarray(j_batch(jnp.asarray(a), jnp.asarray(b), tile_a=64, tile_b=128,
                              interpret=True))
    got = tn.nn_min_sq_batch_plain(torch.from_numpy(a), torch.from_numpy(b), chunk_elems=4096)
    np.testing.assert_allclose(got.numpy()[:, :n - pad_a], want[:, :n - pad_a], rtol=1e-6, atol=0)


def test_batch_is_the_row_output_of_both():
    a, b = _clouds(2, 700, 90, seed=21, pad_b=10)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    from rald_torch.ops import reset_launch_counts

    reset_launch_counts()
    got = tn.nn_min_sq_batch(ta, tb)
    assert tn.nn_min_sq_batch.launches == 0  # CPU: the plain version, uncounted
    assert torch.equal(got, tn.nn_min_sq_both_plain(ta, tb)[0])
    with pytest.raises(ValueError, match="need"):
        tn.nn_min_sq_batch(torch.zeros(1, 4, 3), torch.zeros(1, 4, 2))


# ------------------------------------------------------ host Chamfer APIs
def _metric_pair(seed, n=3000, m=1200):
    rng = np.random.default_rng(seed)
    pred = rng.uniform([0, -15, -5], [15.8, 15, 5], size=(n, 3)).astype(np.float32)
    gt = (pred[rng.choice(n, m)] + rng.normal(scale=0.15, size=(m, 3))).astype(np.float32)
    return pred, gt


def test_host_apis_match_scipy():
    from rald_torch.eval import chamfer as tc

    pred, gt = _metric_pair(31)
    d, _ = cKDTree(gt.astype(np.float64)).query(pred.astype(np.float64))
    np.testing.assert_allclose(tc.nearest_neighbor_dists(pred, gt, device="cpu").numpy(), d,
                               rtol=1e-5, atol=1e-6)
    want_cd, want_f = _oracle_cd_f(pred, gt, 0.1)
    cd, f = tc.chamfer_and_fscore(pred, gt, 0.1, device="cpu")
    assert cd == pytest.approx(want_cd, rel=1e-5) and f == pytest.approx(want_f, abs=1e-5)
    assert tc.chamfer_distance(pred, gt, device="cpu") == pytest.approx(want_cd, rel=1e-5)
    # the masked forms on padded tensors
    pm = np.arange(4096) < len(pred)
    gm = np.arange(2048) < len(gt)
    pp = np.full((4096, 3), tn.BIG, np.float32)
    pp[:len(pred)] = pred
    gp = np.full((2048, 3), tn.BIG, np.float32)
    gp[:len(gt)] = gt
    args = [torch.from_numpy(v) for v in (pp, pm, gp, gm)]
    cd2, f2 = tc.masked_chamfer_fscore(*args, 0.1)
    assert float(cd2) == pytest.approx(want_cd, rel=1e-5) and float(f2) == pytest.approx(want_f, abs=1e-5)
    assert float(tc.masked_chamfer(*args)) == pytest.approx(want_cd, rel=1e-5)
    assert tc.chamfer_and_fscore(np.zeros((0, 3)), gt, 0.1, device="cpu") == (float("inf"), 0.0)
    assert tc.chamfer_distance(np.zeros((0, 3)), gt, device="cpu") == float("inf")


def test_host_apis_match_jax():
    """JAX's host APIs use |a|^2+|b|^2-2ab, which loses small distances at
    ~15 m coordinates: 1e-3 relative."""
    from rald_torch.eval import chamfer as tc
    from rald_tpu.eval import chamfer as jc

    pred, gt = _metric_pair(32, n=2000, m=700)
    cd, f = tc.chamfer_and_fscore(pred, gt, 0.25, device="cpu")
    j_cd, j_f = jc.chamfer_and_fscore(pred, gt, 0.25)
    assert cd == pytest.approx(j_cd, rel=1e-3) and f == pytest.approx(j_f, rel=1e-3)
    assert tc.chamfer_distance(pred, gt, device="cpu") == pytest.approx(
        jc.chamfer_distance(pred, gt), rel=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("bsz,n,m,pad_a,pad_b", CUDA_SHAPES)
def test_cuda_batch_kernel_bitwise(cuda, bsz, n, m, pad_a, pad_b):
    a, b = _clouds(bsz, n, m, seed=bsz + 1, pad_a=pad_a, pad_b=pad_b)
    ta, tb = torch.from_numpy(a).to(cuda), torch.from_numpy(b).to(cuda)
    before = tn.nn_min_sq_batch.launches
    row = tn.nn_min_sq_batch(ta, tb)
    row_both, _ = tn.nn_min_sq_both(ta, tb)
    row_p = tn.nn_min_sq_batch_plain(ta, tb)
    torch.cuda.synchronize()
    assert tn.nn_min_sq_batch.launches == before + 1
    assert torch.equal(row, row_p) and torch.equal(row, row_both)


@pytest.mark.gpu
def test_cuda_host_chamfer_matches_cpu(cuda):
    from rald_torch.eval import chamfer as tc

    pred, gt = _metric_pair(33)
    before = tn.nn_min_sq_batch.launches
    cd, f = tc.chamfer_and_fscore(pred, gt, 0.1, device=cuda)
    assert tn.nn_min_sq_batch.launches == before + 2
    cd_c, f_c = tc.chamfer_and_fscore(pred, gt, 0.1, device="cpu")
    assert cd == pytest.approx(cd_c, rel=1e-5) and f == f_c
