"""The port's array models (``coherent_rtlsdr_tpu_torch/models``) on the CPU:
each function against its JAX counterpart on the same seeded numpy inputs,
then the port's own versions of tests/test_models.py and
tests/test_localize.py's known-direction cases.

Bars, port against the JAX package (both float32 / complex64):
  * geometry and steering: atol 1e-5 (phases up to ~30 rad in float32);
  * covariance: rtol 1e-5, with atol 1e-5 of the largest entry (an entry
    that cancels to near zero has no relative precision in either package);
  * noise projector En En^H: atol 1e-5 (eigenvectors themselves are fixed
    only up to a phase, and within the noise eigenspace only the span);
  * Bartlett: rtol 1e-4; MVDR: rtol 1e-3;
  * MUSIC (and co-array / near-field MUSIC): the same argmax, and within
    0.1 dB where the reference lies within 30 dB of its peak;
  * ESPRIT / root-MUSIC DOAs: within 1e-4 rad;
  * ``ml_localize``: the same grid point.
Inputs that pick a signal subspace carry plane-wave sources at >= 10 dB
SNR, so eigenvalue K and K+1 are well apart.
"""

import numpy as np
import pytest
import torch

from coherent_rtlsdr_tpu.models import beamform as jbf
from coherent_rtlsdr_tpu.models import coarray as jco
from coherent_rtlsdr_tpu.models import geometry as jgeo
from coherent_rtlsdr_tpu.models import localize as jloc
from coherent_rtlsdr_tpu_torch.models import beamform as tbf
from coherent_rtlsdr_tpu_torch.models import coarray as tco
from coherent_rtlsdr_tpu_torch.models import geometry as tgeo
from coherent_rtlsdr_tpu_torch.models import localize as tloc

CPU = "cpu"
GEOM_ATOL = 1e-5
COV_RTOL = 1e-5
PROJ_ATOL = 1e-5
BARTLETT_RTOL = 1e-4
MVDR_RTOL = 1e-3
MUSIC_DB = 0.1
MUSIC_WITHIN_DB = 30.0
DOA_ATOL = 1e-4

ARRAYS = {
    "ula8": jgeo.ula_positions(8, 0.5),
    "ura3x2": jgeo.ura_positions(3, 2, 0.5),
    "ura7x3": jgeo.ura_positions(7, 3, 0.5),   # the published 7x3 URA
}


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _plane_waves(seed, positions, uvs, snr_db=20.0, n_snap=256):
    """[N, T] complex64: unit-power sources from directions ``uvs`` [K, 2]
    plus complex noise ``snr_db`` below, from a seeded numpy generator."""
    rng = np.random.default_rng(seed)
    uvs = np.asarray(uvs, np.float64)
    A = np.exp(2j * np.pi * positions.astype(np.float64) @ uvs.T)          # [N, K]
    S = (rng.standard_normal((len(uvs), n_snap))
         + 1j * rng.standard_normal((len(uvs), n_snap))) / np.sqrt(2)
    noise = (rng.standard_normal((len(positions), n_snap))
             + 1j * rng.standard_normal((len(positions), n_snap))) / np.sqrt(2)
    return (A @ S + noise * 10 ** (-snr_db / 20)).astype(np.complex64)


def _nearfield_snapshots(seed, positions, xyz, snr_db=30.0, n_snap=256):
    p3 = np.concatenate([positions, np.zeros((len(positions), 1))], axis=-1)
    d = np.linalg.norm(np.asarray(xyz, np.float64)[None] - p3, axis=-1)
    a = np.exp(-2j * np.pi * (d - d[0]))
    rng = np.random.default_rng(seed)
    s = (rng.standard_normal(n_snap) + 1j * rng.standard_normal(n_snap)) / np.sqrt(2)
    noise = (rng.standard_normal((len(positions), n_snap))
             + 1j * rng.standard_normal((len(positions), n_snap))) / np.sqrt(2)
    return (a[:, None] * s[None] + noise * 10 ** (-snr_db / 20)).astype(np.complex64)


def assert_music_close(got, want):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert got.shape == want.shape
    assert got.argmax() == want.argmax()
    near = want >= want.max() * 10 ** (-MUSIC_WITHIN_DB / 10)
    err_db = np.abs(10 * np.log10(got[near]) - 10 * np.log10(want[near]))
    assert err_db.max() <= MUSIC_DB, err_db.max()


def assert_cov_close(got, want):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=COV_RTOL,
                               atol=COV_RTOL * np.abs(want).max())


def _peak_uv(P, ax):
    i = int(np.argmax(P))
    g = P.shape[0]
    return float(ax[i % g]), float(ax[i // g])


# ---------------------------------------------------------------------------
# Port against the JAX package, function by function.


class TestGeometryParity:
    @pytest.mark.parametrize("n_points,extent", [(11, 1.0), (32, 1.0), (24, 0.6)])
    def test_uv_grid(self, n_points, extent):
        ju, jax_ax = jgeo.uv_grid(n_points, extent)
        tu, t_ax = tgeo.uv_grid(n_points, extent, device=CPU)
        assert tu.dtype == torch.float32 and tu.shape == (n_points ** 2, 2)
        np.testing.assert_allclose(_np(tu), np.asarray(ju), atol=GEOM_ATOL)
        np.testing.assert_allclose(_np(t_ax), np.asarray(jax_ax), atol=GEOM_ATOL)

    @pytest.mark.parametrize("array", sorted(ARRAYS))
    def test_steering_vectors(self, array):
        pos = ARRAYS[array]
        uv, _ = jgeo.uv_grid(32)
        want = np.array(jgeo.steering_vectors(pos, uv))
        got = tgeo.steering_vectors(pos, np.asarray(uv), device=CPU)
        assert got.dtype == torch.complex64 and got.shape == want.shape
        np.testing.assert_allclose(_np(got), want, atol=GEOM_ATOL)

    def test_nearfield_steering_vectors(self):
        pos = ARRAYS["ura7x3"]
        xyz = np.array(jloc.make_xyz_grid((0.0, 3.0), (0.0, 1.0), (2.0, 6.0), (8, 4, 6)))
        want = np.array(jgeo.nearfield_steering_vectors(pos, xyz))
        got = tgeo.nearfield_steering_vectors(pos, torch.from_numpy(xyz))
        assert got.dtype == torch.complex64
        np.testing.assert_allclose(_np(got), want, atol=GEOM_ATOL)

    def test_positions_are_the_same_arrays(self):
        for args in ((8, 0.5), (5, 0.25)):
            np.testing.assert_array_equal(tgeo.ula_positions(*args), jgeo.ula_positions(*args))
        for args in ((7, 3, 0.5), (2, 4, 0.3)):
            np.testing.assert_array_equal(tgeo.ura_positions(*args), jgeo.ura_positions(*args))
        np.testing.assert_array_equal(tco.virtual_ura((5, 3), 0.5), jco.virtual_ura((5, 3), 0.5))

    def test_default_device_is_the_card(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present: the default runs there")
        with pytest.raises(RuntimeError, match="card"):
            tgeo.uv_grid(8)
        with pytest.raises(RuntimeError, match="card"):
            tbf.sample_covariance(np.zeros((2, 4), np.complex64))
        with pytest.raises(RuntimeError, match="card"):
            tloc.make_xyz_grid((0, 1), (0, 1), (0, 1), (2, 2, 2))


class TestBeamformParity:
    @pytest.mark.parametrize("subtract_mean", [True, False])
    @pytest.mark.parametrize("array", ["ula8", "ura7x3"])
    def test_sample_covariance(self, array, subtract_mean):
        X = _plane_waves(1, ARRAYS[array], [[0.3, -0.2]], n_snap=512)
        want = jbf.sample_covariance(X, subtract_mean=subtract_mean)
        got = tbf.sample_covariance(torch.from_numpy(X), subtract_mean=subtract_mean)
        assert got.dtype == torch.complex64
        assert_cov_close(got, want)

    @pytest.mark.parametrize("n_sources", [1, 2])
    @pytest.mark.parametrize("array", sorted(ARRAYS))
    def test_noise_projector(self, array, n_sources):
        X = _plane_waves(2, ARRAYS[array], [[0.4, 0.1], [-0.35, -0.3]][:n_sources])
        R = np.array(jbf.sample_covariance(X))
        jEn = np.array(jbf._noise_subspace(R, n_sources))
        tEn = _np(tbf._noise_subspace(torch.from_numpy(R), n_sources))
        assert tEn.shape == jEn.shape
        np.testing.assert_allclose(tEn @ tEn.conj().T, jEn @ jEn.conj().T, atol=PROJ_ATOL)

    def _inputs(self, array, n_sources, seed=3):
        pos = ARRAYS[array]
        uvs = [[0.25, 0.0], [-0.45, 0.3]][:n_sources]
        X = _plane_waves(seed, pos, uvs)
        R = np.array(jbf.sample_covariance(X))
        uv, _ = jgeo.uv_grid(32)
        A = np.array(jgeo.steering_vectors(pos, uv))
        return R, A

    @pytest.mark.parametrize("n_sources", [1, 2])
    @pytest.mark.parametrize("array", sorted(ARRAYS))
    def test_music_spectrum(self, array, n_sources):
        R, A = self._inputs(array, n_sources)
        assert_music_close(tbf.music_spectrum(torch.from_numpy(R), torch.from_numpy(A), n_sources),
                           jbf.music_spectrum(R, A, n_sources))

    @pytest.mark.parametrize("array", sorted(ARRAYS))
    def test_bartlett_spectrum(self, array):
        R, A = self._inputs(array, 2)
        np.testing.assert_allclose(
            _np(tbf.bartlett_spectrum(torch.from_numpy(R), torch.from_numpy(A))),
            np.array(jbf.bartlett_spectrum(R, A)), rtol=BARTLETT_RTOL)

    @pytest.mark.parametrize("diag_load", [1e-3, 1e-1])
    @pytest.mark.parametrize("array", sorted(ARRAYS))
    def test_mvdr_spectrum(self, array, diag_load):
        R, A = self._inputs(array, 2)
        np.testing.assert_allclose(
            _np(tbf.mvdr_spectrum(torch.from_numpy(R), torch.from_numpy(A), diag_load)),
            np.array(jbf.mvdr_spectrum(R, A, diag_load)), rtol=MVDR_RTOL)

    @pytest.mark.parametrize("array,n_points", [("ura3x2", 24), ("ura7x3", 32)])
    def test_music_heatmap(self, array, n_points):
        pos = ARRAYS[array]
        X = _plane_waves(4, pos, [[0.3, -0.2]])
        want = jbf.music_heatmap(X, pos, n_sources=1, n_points=n_points)
        got = tbf.music_heatmap(torch.from_numpy(X), pos, n_sources=1, n_points=n_points)
        assert got.shape == (n_points, n_points)
        assert_music_close(got, want)

    @pytest.mark.parametrize("estimator", ["esprit_doa", "root_music_doa"])
    @pytest.mark.parametrize("thetas_deg,n", [([12.5], 8), ([-20.0, 35.0], 8), ([10.0, 16.0], 12)])
    def test_gridless_doa(self, estimator, thetas_deg, n):
        pos = jgeo.ula_positions(n, 0.5)
        uvs = [[np.sin(np.radians(t)), 0.0] for t in thetas_deg]
        X = _plane_waves(5, pos, uvs, snr_db=25.0, n_snap=512)
        Rj = jbf.sample_covariance(X, subtract_mean=False)
        Rt = tbf.sample_covariance(torch.from_numpy(X), subtract_mean=False)
        k = len(thetas_deg)
        want = getattr(jbf, estimator)(Rj, k)
        got = getattr(tbf, estimator)(Rt, k)
        np.testing.assert_allclose(got, want, atol=DOA_ATOL)
        # an array in, the same answer
        np.testing.assert_array_equal(getattr(tbf, estimator)(Rt.numpy(), k), got)

    @pytest.mark.parametrize("estimator", ["esprit_doa", "root_music_doa"])
    def test_gridless_rejects_bad_source_count(self, estimator):
        R = np.eye(4, dtype=np.complex64)
        for k in (0, 4):
            with pytest.raises(ValueError):
                getattr(jbf, estimator)(R, k)
            with pytest.raises(ValueError):
                getattr(tbf, estimator)(torch.from_numpy(R), k)


class TestCoarrayParity:
    SPARSE = np.array([[0, 0], [1, 0], [4, 0], [6, 0]])
    PLANAR = np.array([[0, 0], [1, 0], [3, 0], [0, 1], [3, 2], [2, 2]])

    @pytest.mark.parametrize("name", ["SPARSE", "PLANAR"])
    def test_difference_coarray_and_lag_map(self, name):
        p = getattr(self, name)
        np.testing.assert_array_equal(tco.difference_coarray(p), jco.difference_coarray(p))
        for t, j in zip(tco._lag_index_map(p), jco._lag_index_map(p)):
            np.testing.assert_array_equal(t, j)

    @pytest.mark.parametrize("name,box", [("SPARSE", (7, 1)), ("PLANAR", (4, 3))])
    def test_covariance_lags_and_augmented(self, name, box):
        p = getattr(self, name)
        pos = p.astype(np.float32) * 0.5
        X = _plane_waves(6, pos, [[0.3, 0.1], [-0.5, 0.2]], n_snap=512)
        R = np.array(jbf.sample_covariance(X))
        jr, jlags = jco.coarray_covariance_lags(R, p)
        tr, tlags = tco.coarray_covariance_lags(torch.from_numpy(R), p)
        np.testing.assert_array_equal(tlags, jlags)
        assert_cov_close(tr, jr)
        if name == "PLANAR":
            with pytest.raises(ValueError, match="missing lag"):
                jco.augmented_covariance(R, p, box)
            with pytest.raises(ValueError, match="missing lag"):
                tco.augmented_covariance(torch.from_numpy(R), p, box)
            box = (2, 1)
        assert_cov_close(tco.augmented_covariance(torch.from_numpy(R), p, box),
                         jco.augmented_covariance(R, p, box))

    def test_missing_lag_raises(self):
        sparse = np.array([[0, 0], [4, 0]])
        R = np.eye(2, dtype=np.complex64)
        with pytest.raises(ValueError, match="missing lag") as jerr:
            jco.augmented_covariance(R, sparse, box=(4, 1))
        with pytest.raises(ValueError, match="missing lag") as terr:
            tco.augmented_covariance(torch.from_numpy(R), sparse, box=(4, 1))
        assert str(terr.value) == str(jerr.value)

    def test_coarray_music_spectrum(self):
        p = self.SPARSE
        us = np.array([-0.6, -0.1, 0.35, 0.7])
        X = _plane_waves(7, p.astype(np.float32) * 0.5, np.stack([us, 0 * us], -1), n_snap=512)
        R = np.array(jbf.sample_covariance(X))
        uv, _ = jgeo.uv_grid(32)
        assert_music_close(
            tco.coarray_music_spectrum(torch.from_numpy(R), p, (7, 1), np.asarray(uv), 4),
            jco.coarray_music_spectrum(R, p, (7, 1), uv, 4))

    def test_lag_sums_are_run_to_run_equal(self):
        """The pair-to-lag product adds in one fixed order."""
        p = self.PLANAR
        X = _plane_waves(8, p.astype(np.float32) * 0.5, [[0.2, 0.4]])
        R = tbf.sample_covariance(torch.from_numpy(X))
        a, _ = tco.coarray_covariance_lags(R, p)
        b, _ = tco.coarray_covariance_lags(R, p)
        assert torch.equal(a, b)


class TestLocalizeParity:
    POS = ARRAYS["ura7x3"]
    TRUE = np.array([1.5, 0.5, 4.0], np.float32)

    @pytest.mark.parametrize("n", [(16, 6, 17), (5, 3, 4)])
    def test_make_xyz_grid(self, n):
        want = np.array(jloc.make_xyz_grid((0.0, 3.0), (0.0, 1.0), (2.0, 6.0), n))
        got = tloc.make_xyz_grid((0.0, 3.0), (0.0, 1.0), (2.0, 6.0), n, device=CPU)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(_np(got), want, atol=GEOM_ATOL)

    def _grid(self):
        return np.array(jloc.make_xyz_grid((0.0, 3.0), (0.0, 1.0), (2.0, 6.0), (16, 6, 17)))

    def test_nearfield_music(self):
        X = _nearfield_snapshots(0, self.POS, self.TRUE)
        grid = self._grid()
        assert_music_close(tloc.nearfield_music(torch.from_numpy(X), self.POS, grid),
                           jloc.nearfield_music(X, self.POS, grid))

    def test_ml_localize_same_grid_point(self):
        X = _nearfield_snapshots(1, self.POS, self.TRUE)
        grid = self._grid()
        jxyz, jspec = jloc.ml_localize(X, self.POS, grid)
        txyz, tspec = tloc.ml_localize(torch.from_numpy(X), self.POS, torch.from_numpy(grid))
        assert int(torch.argmax(tspec)) == int(np.argmax(np.asarray(jspec)))
        np.testing.assert_array_equal(_np(txyz), np.asarray(jxyz))
        np.testing.assert_allclose(_np(tspec), np.asarray(jspec), rtol=BARTLETT_RTOL)

    def test_ml_localize_tie_takes_the_first_index(self):
        """The emitter on a grid point that the grid holds twice: both
        packages take the first of the tied maxima."""
        grid = self._grid()
        k = int(np.argmin(np.abs(grid - self.TRUE).sum(-1)))
        dup = np.concatenate([grid[:k + 1], grid[k:k + 1], grid[k + 1:]])
        X = _nearfield_snapshots(2, self.POS, grid[k])
        jxyz, jspec = jloc.ml_localize(X, self.POS, dup)
        txyz, tspec = tloc.ml_localize(torch.from_numpy(X), self.POS, torch.from_numpy(dup))
        tspec = _np(tspec)
        assert tspec[k] == tspec[k + 1] == tspec.max()
        assert int(np.argmax(np.asarray(jspec))) == k
        np.testing.assert_array_equal(_np(txyz), dup[k])
        np.testing.assert_array_equal(np.asarray(jxyz), dup[k])


# ---------------------------------------------------------------------------
# The port's own known-direction cases (after tests/test_models.py and
# tests/test_localize.py).


class TestMusicKnownDirections:
    def test_single_source_peak(self):
        pos = ARRAYS["ura7x3"]
        X = _plane_waves(0, pos, [[0.3, -0.2]])
        P = _np(tbf.music_heatmap(torch.from_numpy(X), pos, n_sources=1, n_points=101))
        _, ax = tgeo.uv_grid(101, device=CPU)
        u, v = _peak_uv(P, _np(ax))
        assert abs(u - 0.3) < 0.03 and abs(v + 0.2) < 0.03

    def test_two_sources_resolved(self):
        pos = ARRAYS["ura7x3"]
        true_uv = np.array([[0.4, 0.1], [-0.35, -0.3]])
        X = _plane_waves(1, pos, true_uv, n_snap=512)
        uv, _ = tgeo.uv_grid(101, device=CPU)
        A = tgeo.steering_vectors(pos, uv)
        R = tbf.sample_covariance(torch.from_numpy(X))
        P = _np(tbf.music_spectrum(R, A, n_sources=2)).reshape(101, 101)
        med = np.median(P)
        for u, v in true_uv:
            iu = int(round((u + 1) / 2 * 100))
            iv = int(round((v + 1) / 2 * 100))
            local = P[max(iv - 1, 0): iv + 2, max(iu - 1, 0): iu + 2].max()
            assert local / med > 100.0

    @pytest.mark.parametrize("method", ["bartlett_spectrum", "mvdr_spectrum"])
    def test_bartlett_and_mvdr_peak(self, method):
        pos = ARRAYS["ula8"]
        X = _plane_waves(2, pos, [[0.25, 0.0]])
        uv, ax = tgeo.uv_grid(201, device=CPU)
        A = tgeo.steering_vectors(pos, uv)
        R = tbf.sample_covariance(torch.from_numpy(X))
        P = _np(getattr(tbf, method)(R, A)).reshape(201, 201)
        u_pk = float(_np(ax)[int(np.argmax(P.mean(axis=0)))])
        assert abs(u_pk - 0.25) < 0.03


class TestCoarrayKnownDirections:
    def test_difference_coarray_of_ula(self):
        lags = tco.difference_coarray(np.array([[0, 0], [1, 0], [4, 0]]))
        assert sorted(int(l[0]) for l in lags) == [-4, -3, -1, 0, 1, 3, 4]

    def test_augmented_covariance_structure(self):
        """Augmented covariance from a sparse array equals the full-array
        covariance for an ideal (noise-free, single-source) field."""
        sparse = np.array([[0, 0], [1, 0], [3, 0], [4, 0]])
        u = 0.22
        phase = lambda d: np.exp(2j * np.pi * 0.5 * u * d)
        R = torch.tensor([[phase(xi - xj) for (xj, _) in sparse] for (xi, _) in sparse],
                         dtype=torch.complex64)
        Raug = tco.augmented_covariance(R, sparse, box=(5, 1))
        expect = np.array([[phase(a - b) for b in range(5)] for a in range(5)], np.complex64)
        np.testing.assert_allclose(_np(Raug), expect, atol=1e-5)

    def test_coarray_music_resolves_more_sources_than_sensors(self):
        """A 4-sensor minimum-redundancy array {0,1,4,6} spans a 7-element
        virtual ULA; co-array MUSIC resolves FIVE uncorrelated sources."""
        sparse = np.array([[0, 0], [1, 0], [4, 0], [6, 0]])
        us = np.array([-0.72, -0.35, 0.0, 0.38, 0.7])
        rng = np.random.default_rng(0)
        T = 4000
        S = (rng.normal(size=(5, T)) + 1j * rng.normal(size=(5, T))) / np.sqrt(2)
        A = np.exp(2j * np.pi * 0.5 * sparse[:, :1] * us[None, :])
        X = A @ S + 0.03 * (rng.normal(size=(4, T)) + 1j * rng.normal(size=(4, T)))
        R = torch.from_numpy(((X @ X.conj().T) / T).astype(np.complex64))
        grid = 241
        uv, ax = tgeo.uv_grid(grid, device=CPU)
        P = _np(tco.coarray_music_spectrum(R, sparse, (7, 1), uv, 5, spacing=0.5))
        u_profile = P.reshape(grid, grid).max(axis=0)
        axv = _np(ax)
        for u_true in us:
            window = (axv > u_true - 0.08) & (axv < u_true + 0.08)
            outside = ~((axv > u_true - 0.15) & (axv < u_true + 0.15))
            assert u_profile[window].max() > 3.0 * np.median(u_profile[outside]), u_true
            u_pk = axv[window][int(np.argmax(u_profile[window]))]
            assert abs(u_pk - u_true) < 0.05, (u_pk, u_true)


class TestGridlessKnownDirections:
    def _ula_snapshots(self, thetas_deg, N=8, T=400, snr_db=20.0, seed=0):
        pos = tgeo.ula_positions(N, 0.5)
        uvs = [[np.sin(np.radians(t)), 0.0] for t in thetas_deg]
        return torch.from_numpy(_plane_waves(seed, pos, uvs, snr_db, T))

    @pytest.mark.parametrize("estimator", ["esprit_doa", "root_music_doa"])
    def test_recovers_angles(self, estimator):
        R = tbf.sample_covariance(self._ula_snapshots([-20.0, 35.0]), subtract_mean=False)
        est = np.degrees(getattr(tbf, estimator)(R, n_sources=2))
        np.testing.assert_allclose(est, [-20.0, 35.0], atol=1.0)

    @pytest.mark.parametrize("estimator", ["esprit_doa", "root_music_doa"])
    def test_close_sources_resolved(self, estimator):
        X = self._ula_snapshots([10.0, 16.0], N=12, T=800, snr_db=25.0, seed=3)
        R = tbf.sample_covariance(X, subtract_mean=False)
        np.testing.assert_allclose(np.degrees(getattr(tbf, estimator)(R, 2)), [10.0, 16.0],
                                   atol=1.5)

    @pytest.mark.parametrize("estimator", ["esprit_doa", "root_music_doa"])
    def test_single_source(self, estimator):
        R = tbf.sample_covariance(self._ula_snapshots([12.5], seed=5), subtract_mean=False)
        assert abs(np.degrees(getattr(tbf, estimator)(R, 1))[0] - 12.5) < 0.5


class TestNearFieldKnownEmitter:
    POS = ARRAYS["ura7x3"]
    TRUE = np.array([1.5, 0.5, 4.0], np.float32)

    def _grid(self):
        return tloc.make_xyz_grid((0.0, 3.0), (0.0, 1.0), (2.0, 6.0), (16, 6, 17), device=CPU)

    def _check(self, xyz):
        err = np.abs(_np(xyz) - self.TRUE)
        # bearing to a grid step; range from wavefront curvature, 3 z-steps
        assert err[0] <= 0.21 and err[1] <= 0.21 and err[2] <= 0.76, xyz

    def test_ml_localize_finds_emitter(self):
        X = torch.from_numpy(_nearfield_snapshots(3, self.POS, self.TRUE))
        xyz_hat, _ = tloc.ml_localize(X, self.POS, self._grid())
        self._check(xyz_hat)

    def test_nearfield_music_peak(self):
        X = torch.from_numpy(_nearfield_snapshots(4, self.POS, self.TRUE))
        grid = self._grid()
        P = tloc.nearfield_music(X, self.POS, grid, n_sources=1)
        self._check(grid[int(torch.argmax(P))])
