"""Kinetic-energy spectra vs the NumPy oracle, plus sharded-FFT equivalence."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import fava_tpu
from fava_tpu.mesh import FlashUniform
from fava_tpu.parallel import make_device_mesh, pfft3, use_mesh, volume_sharding
from tests.oracles.spectra import ke_spectra_oracle


@pytest.fixture(scope="module")
def uniform_mesh(tmp_path_factory):
    from fava_tpu.io import synthetic

    path = tmp_path_factory.mktemp("spec") / "rt_hdf5_uniform_0001"
    synthetic.make_uniform_file(path, ncells=(16, 16, 16), seed=5)
    mesh = FlashUniform(path)
    mesh.load()
    return mesh


def test_spectra_match_oracle(uniform_mesh):
    spec = uniform_mesh.kinetic_energy_spectra()

    dens = np.asarray(uniform_mesh.data("dens"), dtype=np.float64)
    vels = [np.asarray(uniform_mesh.data(f"vel{a}"), dtype=np.float64) for a in "xyz"]
    ref = ke_spectra_oracle(dens, vels, federrath_transpose=False)

    np.testing.assert_allclose(spec["k"], ref["k"])
    for key in ("total", "longitudinal", "transverse"):
        np.testing.assert_allclose(spec[key], ref[key], rtol=1e-9, atol=1e-18, err_msg=key)


def test_spectra_total_positive_and_finite(uniform_mesh):
    spec = uniform_mesh.kinetic_energy_spectra()
    assert np.isfinite(spec["total"]).all()
    assert (spec["total"][1:] >= 0).all()
    # k=0 bin gets zero integral factor.
    assert spec["total"][0] == 0.0


def test_pfft3_matches_fftn(eight_device_mesh):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((16, 16, 16))
    sharding = volume_sharding(eight_device_mesh, axis=0, ndim=3)
    xs = jax.device_put(x, sharding)
    got = np.asarray(jax.jit(lambda a: pfft3(a, mesh=eight_device_mesh))(xs))
    ref = np.fft.fftn(x)
    np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-9)


def test_spectra_sharded_matches_unsharded(uniform_mesh, eight_device_mesh):
    spec_single = uniform_mesh.kinetic_energy_spectra()
    with use_mesh(eight_device_mesh):
        # Re-put data sharded and recompute.
        dens = jax.device_put(
            np.asarray(uniform_mesh.data("dens")), volume_sharding(eight_device_mesh, 0, 3)
        )
        vels = [
            jax.device_put(
                np.asarray(uniform_mesh.data(f"vel{a}")), volume_sharding(eight_device_mesh, 0, 3)
            )
            for a in "xyz"
        ]
        from fava_tpu.ops.spectra import kinetic_energy_spectra

        spec_sharded = kinetic_energy_spectra(dens, vels, mesh=eight_device_mesh)

    for key in ("total", "longitudinal", "transverse"):
        np.testing.assert_allclose(
            spec_sharded[key], spec_single[key], rtol=1e-9, atol=1e-18, err_msg=key
        )


@pytest.mark.parametrize("nz", [8, 9, 12])
def test_rfft_shell_binning_matches_full_grid(nz):
    """Hermitian-weighted half-spectrum binning == full-grid binning,
    including odd trailing extents (no Nyquist plane: weight 2 there)."""
    from fava_tpu.ops.spectra import shell_bin_rfft
    from tests.oracles.spectra import shell_sums_oracle

    rng = np.random.default_rng(2)
    shape = (8, 8, nz)
    ntot = np.prod(shape)
    dens = rng.random(shape) + 0.5
    vels = [rng.standard_normal(shape) for _ in range(3)]
    sd = np.sqrt(dens)

    def wn(n):
        k = np.arange(n)
        return np.where(k <= (n - 1) // 2, k, k - n).astype(np.float64)

    kx = wn(shape[0])[:, None, None]
    ky = wn(shape[1])[None, :, None]

    def powers(ffts, kz):
        k_abs = np.sqrt(kx**2 + ky**2 + kz**2)
        total = 0.5 * sum(np.abs(f) ** 2 for f in ffts)
        longi = (
            np.abs((kx * ffts[0] + ky * ffts[1] + kz * ffts[2]) / np.maximum(k_abs, 1e-99)) ** 2
        )
        return total, longi, total - longi

    nbins = max(shape) // 2 - 1
    full = [np.fft.fftn(sd * v) / ntot for v in vels]
    t, l, tr = powers(full, wn(nz)[None, None, :])
    c_full, s_full = shell_sums_oracle([t, l, tr], nbins)

    from fava_tpu.ops.spectra import rfft_power_volumes

    half = [jnp.asarray(np.fft.rfftn(sd * v) / ntot) for v in vels]
    t, l, tr, _ = rfft_power_volumes(half, shape)
    c_half, s_half = shell_bin_rfft((t, l, tr), nbins, shape[0], nz)

    np.testing.assert_allclose(np.asarray(c_half), np.asarray(c_full))
    np.testing.assert_allclose(np.asarray(s_half), np.asarray(s_full), rtol=1e-12, atol=1e-20)


def test_reference_transpose_quirk_documented():
    """The reference's stray .T changes results; our kernel matches the
    correct projection, not the quirk (deviation documented in ops.spectra)."""
    rng = np.random.default_rng(1)
    dens = rng.random((8, 8, 8)) + 0.5
    vels = [rng.standard_normal((8, 8, 8)) for _ in range(3)]
    correct = ke_spectra_oracle(dens, vels, federrath_transpose=False)
    quirk = ke_spectra_oracle(dens, vels, federrath_transpose=True)
    # total is unaffected; longitudinal differs.
    np.testing.assert_allclose(correct["total"], quirk["total"])
    assert not np.allclose(correct["longitudinal"], quirk["longitudinal"])



def test_scalar_spectrum_matches_numpy_oracle(uniform_file):
    """Scalar-field power spectrum (beyond reference): forward-norm
    FFT power, mean per shell with the scipy binning convention, and
    the same integral factor as the KE spectra."""
    import scipy.stats

    from fava_tpu.mesh import FlashUniform

    mesh = FlashUniform(uniform_file)
    mesh.load()
    out = mesh.scalar_spectra("dens")["dens"]

    d = np.asarray(mesh.data("dens"))
    if d.ndim == 4:
        d = d[0]
    n = d.shape[0]
    fw = np.fft.fftn(d, norm="forward")
    p = np.abs(fw) ** 2

    def wn(m):
        k = np.arange(m)
        return np.where(k <= (m - 1) // 2, k, k - m).astype(float)

    k_abs = np.sqrt(
        wn(n)[:, None, None] ** 2 + wn(n)[None, :, None] ** 2 + wn(n)[None, None, :] ** 2
    )
    bins = np.arange(n // 2) - 0.5
    mean, _, _ = scipy.stats.binned_statistic(k_abs.ravel(), p.ravel(), "mean", bins=bins)
    k = np.arange(n // 2 - 1, dtype=float)
    expected = mean * k**2 * (2.0 * np.pi * 2)

    np.testing.assert_allclose(out["power"], expected, rtol=1e-9, atol=1e-20)
    np.testing.assert_array_equal(out["k"], k)


def test_scalar_spectrum_sharded_matches_unsharded(uniform_file_32, eight_device_mesh):
    """Under an active mesh the scalar spectrum must take the sharded
    pencil-FFT path (not the single-chip Pallas path, which cannot
    consume mesh-sharded inputs) and match the unsharded result."""
    from fava_tpu.mesh import FlashUniform
    from fava_tpu.parallel import use_mesh

    mesh0 = FlashUniform(uniform_file_32)
    mesh0.load()
    ref = mesh0.scalar_spectra("dens")["dens"]

    with use_mesh(eight_device_mesh):
        mesh1 = FlashUniform(uniform_file_32)
        mesh1.load()
        assert len(mesh1.data("dens").sharding.device_set) == 8
        got = mesh1.scalar_spectra("dens")["dens"]

    np.testing.assert_allclose(got["power"], ref["power"], rtol=1e-9, atol=1e-20)


def test_scalar_spectra_registered_on_model(uniform_file):
    import fava_tpu

    m = fava_tpu.FLASH(uniform_file.parent)
    m.load(file_type="uni")
    out = m.scalar_spectra("flam")
    assert set(out["flam"].keys()) == {"k", "power"}
    assert np.isfinite(out["flam"]["power"][1:]).all()
