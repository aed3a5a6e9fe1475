"""The port's radar DSP (``rald_torch.dsp``) against ``rald_tpu.dsp`` on the
same numpy inputs, at ``tests/test_dsp.py``'s small shapes.

Bars, stated before the runs:
- ``virtual_array`` / ``velocity_compensation``: 1e-6 (the array sum is
  exact: each virtual position sums its pairs, as JAX's 0/1 matmul does);
- ``raeivv_map`` / ``raeivv_map_batch``: intensity dB within 1e-3 abs;
  velocity equal and validity equal on >= 99 % of cells (both can flip on
  near-ties between two FFT libraries, as ``tests/test_dsp.py:141`` says);
- the Weibull quantiles, ``os_cfar``, ``nq_cfar_2d``, ``mask_real_2d``:
  masks equal, quantiles / SNR / velocity within 1e-5 relative;
- ``weighted_allocation``, ``budgeted_topk``, ``cube_idx2coord``, the
  params and bins: bitwise;
- ``rae_interpo``: within 1e-5 abs at values <= 30;
- ``cfar_points_from_cube``: equal budgets, >= 99.9 % of cells shared.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_parity  # noqa: F401  (one torch thread per test worker)
from rald_torch import dsp as tdsp
from rald_tpu import dsp as jdsp
from rald_tpu.dsp.rae import raeivv_map_batch as j_raeivv_map_batch

REPO_CFG = "configs/preprocess"
TXL = np.array([[0, 0, 0], [2, 2, 1], [1, 4, 0]])
RXL = np.array([[0, 0, 0], [1, 1, 0], [2, 2, 0], [3, 3, 0]])
# tx 1 lands on tx 0's (el, az) positions shifted by one azimuth cell: three
# positions collide and must accumulate
TXL_COLLIDE = np.array([[0, 0, 0], [1, 1, 0], [2, 2, 1]])


def _params(pkg, **kw):
    # the preprocess fixture's chirp: range 64, doppler 32 (the get_bins
    # quirk shows only where the two differ)
    d = dict(num_tx=3, num_rx=4, num_chirps=32, num_adc_samples=64,
             range_fftsize=64, doppler_fftsize=32, azimuth_fftsize=8, elevation_fftsize=2)
    d.update(kw)
    return pkg.RadarParams(**d)


def _adc(seed, shape=(3, 4, 32, 64)):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("name", ["1843_coloradar.yml", "1843_coloradar_test_set.yml"])
def test_params_bins_and_antenna_array_are_bitwise_jax(name):
    import dataclasses

    from rald_tpu.dsp.bins import get_angle_bins as j_angle

    from rald_torch.dsp.bins import get_angle_bins as t_angle

    tp = tdsp.RadarParams.from_yaml(f"{REPO_CFG}/{name}")
    jp = jdsp.RadarParams.from_yaml(f"{REPO_CFG}/{name}")
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    assert (tp.max_range, tp.chirp_time, tp.ramp_end_time) == (jp.max_range, jp.chirp_time, jp.ramp_end_time)
    for t_arr, j_arr in zip(tdsp.parse_antenna_array(f"{REPO_CFG}/antenna_array.txt"),
                            jdsp.parse_antenna_array(f"{REPO_CFG}/antenna_array.txt")):
        np.testing.assert_array_equal(t_arr, j_arr)
    for sizes in [(128, 128, 8, 2), (64, 32, 32, 16), (0, 16, 0, 4)]:
        for a, b in zip(tdsp.get_bins(*sizes, tp), jdsp.get_bins(*sizes, jp)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t_angle(16, (-20, 20), 0.5), j_angle(16, (-20, 20), 0.5))
    assert [tdsp.fft_size(n) for n in (1, 5, 64, 100)] == [jdsp.fft_size(n) for n in (1, 5, 64, 100)]
    assert tdsp.get_max_velocity(3, 77e9, 1.3e-4) == jdsp.get_max_velocity(3, 77e9, 1.3e-4)


def test_host_helpers_are_bitwise_jax(tmp_path):
    """``load_adc_frame`` (int16 IQ file, DC removal), ``complex_to_iq``,
    ``as_static_layout``, ``virtual_array_shape`` and ``steering_matrix``."""
    from rald_tpu.dsp import rae as jrae

    from rald_torch.dsp import rae as trae

    rng = np.random.default_rng(14)
    rng.integers(-300, 300, size=(3, 4, 32, 64, 2), dtype=np.int16).tofile(tmp_path / "f.bin")
    got = trae.load_adc_frame(tmp_path / "f.bin", _params(tdsp))
    np.testing.assert_array_equal(got, jrae.load_adc_frame(tmp_path / "f.bin", _params(jdsp)))
    assert got.dtype == np.float32 and got.shape == (3, 4, 32, 64, 2)
    adc = _adc(15)
    np.testing.assert_array_equal(trae.complex_to_iq(adc), jrae.complex_to_iq(adc))
    assert trae.as_static_layout(TXL) == jrae.as_static_layout(TXL)
    for txl in (TXL, TXL_COLLIDE):
        assert tdsp.virtual_array_shape(txl, RXL) == jdsp.virtual_array_shape(txl, RXL)
    az, el = np.linspace(-1.2, 1.2, 7), np.linspace(-0.3, 0.3, 7)
    np.testing.assert_array_equal(tdsp.steering_matrix(TXL, RXL, az, el),
                                  jdsp.steering_matrix(TXL, RXL, az, el))


@pytest.mark.parametrize("txl", [TXL, TXL_COLLIDE], ids=["awr1843", "colliding"])
def test_virtual_array_matches_jax(txl):
    adc = _adc(5, (3, 4, 6, 8))
    want = np.asarray(jdsp.virtual_array(jnp.asarray(adc), txl, RXL))
    got = tdsp.virtual_array(_t(adc), txl, RXL).numpy()
    assert got.shape == want.shape and got.dtype == np.complex64
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if txl is TXL_COLLIDE:
        # the colliding positions hold the sum of both pairs
        np.testing.assert_allclose(got[0, 1], adc[0, 1] + adc[1, 0], rtol=0, atol=1e-6)
    # leading frame axes go through in one call
    batched = tdsp.virtual_array(_t(np.stack([adc, 2 * adc])), txl, RXL).numpy()
    np.testing.assert_array_equal(batched[0], got)


def test_velocity_compensation_matches_jax():
    got = tdsp.velocity_compensation(3, 32)
    assert got.dtype == torch.complex64 and got.shape == (3, 1, 32, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(jdsp.velocity_compensation(3, 32)),
                               rtol=0, atol=1e-6)


def _rae_close(got, want):
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got[..., 0], want[..., 0], rtol=0, atol=1e-3)
    assert (got[..., 1] == want[..., 1]).mean() >= 0.99
    assert (got[..., 2] == want[..., 2]).mean() >= 0.99


@pytest.mark.parametrize("az,el", [(8, 2), (16, 8)])
def test_raeivv_map_matches_jax(az, el):
    from rald_tpu.dsp.rae import as_static_layout

    tp, jp = _params(tdsp, azimuth_fftsize=az, elevation_fftsize=el), \
        _params(jdsp, azimuth_fftsize=az, elevation_fftsize=el)
    frames = np.stack([tdsp.rae.complex_to_iq(_adc(6 + i)) for i in range(3)])
    want = np.asarray(j_raeivv_map_batch(jnp.asarray(frames), jp, as_static_layout(TXL),
                                         as_static_layout(RXL)))
    got = tdsp.rae.raeivv_map_batch(_t(frames), tp, TXL, RXL).numpy()
    assert got.shape == (3, 64, az, el, 3)
    _rae_close(got, want)
    # one frame alone is its batch row
    np.testing.assert_array_equal(tdsp.raeivv_map(_t(frames[1]), tp, TXL, RXL).numpy(), got[1])
    # the cropped 5 % range bins: zero power, argmax at the first doppler bin
    _, vbins, _, _ = tdsp.get_bins(32, 64, az, el, tp)
    assert (got[:, :3, ..., 1] == np.float32(vbins[0])).all()
    assert (got[:, :3, ..., 2] == 0).all()


def test_get_bins_quirk_indexes_range_sized_velocity_bins():
    """``raeivv_map`` takes its velocity bins from ``get_bins(nv, nr, ...)``
    (doppler size in the range slot, radar_preprocessing.py:45): at range
    64 / doppler 32 they are the 64 bins of a 64-chirp grid, not the 32 of
    the doppler axis."""
    tp = _params(tdsp)
    got = tdsp.raeivv_map(_t(tdsp.rae.complex_to_iq(_adc(9))), tp, TXL, RXL).numpy()
    quirk = tdsp.get_bins(32, 64, 8, 2, tp)[1].astype(np.float32)
    fixed = tdsp.get_bins(64, 32, 8, 2, tp)[1].astype(np.float32)
    assert len(quirk) == 64 and len(fixed) == 32
    vel = np.unique(got[..., 1])
    assert np.isin(vel, quirk).all()
    assert not np.isin(vel, fixed).all()


def test_weibull_quantiles_match_jax():
    rng = np.random.default_rng(1)
    for n in [1, 2, 5, 17, 64]:
        vals = rng.normal(size=(4, n)).astype(np.float32)
        for q in [0.3, 0.75, 0.9]:
            np.testing.assert_allclose(tdsp.weibull_quantile(_t(vals), q).numpy(),
                                       np.asarray(jdsp.weibull_quantile(jnp.asarray(vals), q)),
                                       rtol=1e-5, atol=0)
    vals = rng.normal(size=(8, 20)).astype(np.float32)
    mask = rng.random((8, 20)) > 0.4
    mask[0] = False  # empty window -> +inf
    got = tdsp.masked_weibull_quantile(_t(vals), _t(mask), 0.75).numpy()
    want = np.asarray(jdsp.masked_weibull_quantile(jnp.asarray(vals), jnp.asarray(mask), 0.75))
    assert got[0] == np.inf
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_os_cfar_matches_jax():
    rng = np.random.default_rng(2)
    s = rng.exponential(size=100).astype(np.float32)
    s[20], s[70] = 100.0, 80.0
    got = tdsp.os_cfar(_t(s), ws=16, ngc=2, tos=6).numpy()
    np.testing.assert_array_equal(got, np.asarray(jdsp.os_cfar(jnp.asarray(s), ws=16, ngc=2, tos=6)))
    assert got[20] == 1


def test_nq_cfar_2d_matches_jax():
    rng = np.random.default_rng(3)
    s = rng.exponential(size=(24, 20)).astype(np.float32)
    s[5, 5], s[15, 12] = 500.0, 300.0
    got_m, got_s = tdsp.nq_cfar_2d(_t(s), ws=4, ngc=1, quantile=0.75, tos=8)
    want_m, want_s = jdsp.nq_cfar_2d(jnp.asarray(s), ws=4, ngc=1, quantile=0.75, tos=8)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-5, atol=0)
    assert got_m[5, 5] == 1


def test_mask_real_2d_matches_jax():
    rng = np.random.default_rng(4)
    p = rng.exponential(size=(2, 3, 12, 16)).astype(np.float32)
    p[0, 1, 4, 8] = 400.0
    kw = dict(doppler_fftsize=12, range_fftsize=16, azimuth_fftsize=3, elevation_fftsize=2)
    got_m, got_d = tdsp.mask_real_2d(_t(p), _params(tdsp, **kw), ws=3, ngc=1, quantile=0.75, tos=2)
    want_m, want_d = jdsp.mask_real_2d(jnp.asarray(p), _params(jdsp, **kw), ws=3, ngc=1,
                                       quantile=0.75, tos=2)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=1e-5, atol=0)
    assert got_m[0, 1, 8] == 1


@pytest.mark.parametrize("weights,total", [
    (np.random.default_rng(7).random(16).astype(np.float32), 1000),
    (np.r_[np.random.default_rng(8).random(9), 0.0, 0.0].astype(np.float32), 8e5),
    (np.zeros(7, np.float32), 10),  # all-zero weights: the even split, 3 slots one more
    (np.zeros(4, np.float32), 8),   # all-zero weights, no remainder
], ids=["random", "zero-slices", "all-zero", "all-zero-even"])
def test_weighted_allocation_is_bitwise_jax(weights, total):
    total = int(total)
    got = tdsp.weighted_allocation(_t(weights), total)
    want = np.asarray(jdsp.weighted_allocation(jnp.asarray(weights), total))
    assert got.dtype == torch.int32 and int(got.sum()) == total
    np.testing.assert_array_equal(got.numpy(), want)


def test_budgeted_topk_is_bitwise_jax():
    """With an all-zero slice (the cropped range bins) and tied values: the
    stable descending sort keeps the cell order within ties."""
    rng = np.random.default_rng(8)
    cube = rng.random((6, 8, 4)).astype(np.float32)
    cube[0] = 0.0
    cube[3, :2] = 0.5
    budgets = np.array([7, 10, 3, 12, 0, 18], np.int32)
    got_p, got_v = tdsp.budgeted_topk(_t(cube), _t(budgets), 50)
    want_p, want_v = jdsp.budgeted_topk(jnp.asarray(cube), jnp.asarray(budgets), 50)
    assert got_p.dtype == torch.int32 and got_p.shape == (50, 3)
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def test_rae_interpo_matches_jax():
    rng = np.random.default_rng(9)
    x = (30 * rng.random((2, 16, 8, 4))).astype(np.float32)
    got = tdsp.rae_interpo(_t(x), 32, 32, 16).numpy()
    want = np.asarray(jdsp.rae_interpo(jnp.asarray(x), 32, 32, 16))
    assert got.shape == (2, 32, 32, 16)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_cube_idx2coord_is_bitwise_jax():
    rng = np.random.default_rng(10)
    idx = np.stack([rng.integers(0, n, 200) for n in (32, 16, 8)], axis=1).astype(np.int32)
    for deg in (False, True):
        got = tdsp.cube_idx2coord(_t(idx), 32, 16, 8, 15.86, return_in_degrees=deg)
        want = jdsp.cube_idx2coord(idx, 32, 16, 8, 15.86, return_in_degrees=deg)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _cfar_parity(cube: np.ndarray, tgt, total: int, t_dev="cpu"):
    """Budgets and selected cells of the port (on ``t_dev``) and of JAX for
    one intensity cube: (budgets equal?, shared share of cells)."""
    from rald_tpu.dsp.cfar_points import weighted_allocation as j_alloc

    up_t = tdsp.rae_interpo(_t(cube).to(t_dev), *tgt)
    b_t = tdsp.weighted_allocation(up_t.sum(dim=(1, 2)) / up_t.sum(), total).cpu().numpy()
    up_j = jdsp.rae_interpo(jnp.asarray(cube), *tgt)
    b_j = np.asarray(j_alloc(up_j.sum(axis=(1, 2)) / up_j.sum(), total))
    got, _ = tdsp.cfar_points_from_cube(_t(cube).to(t_dev), *tgt, total, 15.86)
    want, _ = jdsp.cfar_points_from_cube(jnp.asarray(cube), *tgt, total, 15.86)
    got, want = got.cpu().numpy(), np.asarray(want)
    assert got.shape == want.shape == (total, 3) and got.dtype == np.float32
    return np.array_equal(b_t, b_j), (got == want).all(axis=1).mean()


def test_cfar_points_from_cube_matches_jax():
    # gamma intensities as the dB channel has them, zeros in the cropped bins
    rng = np.random.default_rng(11)
    cube = rng.gamma(2.0, 4.0, size=(32, 16, 8)).astype(np.float32)
    cube[:2] = 0.0
    same_budgets, shared = _cfar_parity(cube, (64, 64, 32), 20000)
    assert same_budgets and shared >= 0.999


@pytest.mark.gpu
def test_cuda_raeivv_map_batch_matches_cpu(cuda):
    """The product chirp (3, 4, 128, 128) at batch 8 on the card against the
    CPU: the bars of the JAX comparison."""
    params = tdsp.RadarParams.from_yaml(f"{REPO_CFG}/1843_coloradar_test_set.yml")
    rng = np.random.default_rng(12)
    frames = rng.integers(-200, 200, size=(8, 3, 4, 128, 128, 2)).astype(np.float32)
    cpu = tdsp.rae.raeivv_map_batch(_t(frames), params, TXL, RXL).numpy()
    card = tdsp.rae.raeivv_map_batch(_t(frames).to(cuda), params, TXL, RXL).cpu().numpy()
    _rae_close(card, cpu)


@pytest.mark.gpu
def test_cuda_cfar_points_match_cpu(cuda):
    rng = np.random.default_rng(13)
    cube = rng.gamma(2.0, 4.0, size=(128, 32, 16)).astype(np.float32)
    cpu, _ = tdsp.cfar_points_from_cube(_t(cube), 256, 256, 128, 800000, 15.86)
    card, _ = tdsp.cfar_points_from_cube(_t(cube).to(cuda), 256, 256, 128, 800000, 15.86)
    assert (card.cpu().numpy() == cpu.numpy()).all(axis=1).mean() >= 0.999


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `python -m pytest -m gpu` on the card")
    return torch.device("cuda")
