"""Auto/cross correlation time-series drivers."""

import numpy as np
import pytest

import fava_tpu
from fava_tpu.io import synthetic


@pytest.fixture()
def series_dir(tmp_path):
    # Three identical plt snapshots (static field) at different times.
    for i, t in enumerate([0.0, 0.1, 0.2], start=1):
        synthetic.make_amr_file(
            tmp_path / f"rt_hdf5_plt_cnt_{i:04d}", ncells=(4, 4, 4), nblks=(2, 2, 2), time=t
        )
    # Particle snapshots with time-varying data (distinct seeds, same tag set).
    for i, t in enumerate([0.0, 0.1, 0.2], start=1):
        synthetic.make_particle_file(
            tmp_path / f"rt_hdf5_part_{i:04d}", nparticles=32, time=t, seed=100 + i
        )
    return tmp_path


def test_eulerian_autocorrelation_static_field(series_dir):
    m = fava_tpu.FLASH(series_dir)
    times, results = m.eulerian_autocorrelation(nsamples=20, fields=["dens"], seed=1)
    np.testing.assert_allclose(times, [0.0, 0.1, 0.2])
    # Static field: correlation stays exactly 1.
    np.testing.assert_allclose(results["dens"], 1.0, rtol=1e-12)


def test_lagrangian_autocorrelation(series_dir):
    m = fava_tpu.FLASH(series_dir)
    times, results = m.lagrangian_autocorrelation(nsamples=8, fields=["velx"])
    # Perfect self-correlation at t=0; bounded by 1 afterwards.
    np.testing.assert_allclose(results["velx"][0], 1.0, rtol=1e-12)
    assert (np.abs(results["velx"]) <= 1.0 + 1e-12).all()


def test_cross_correlation_formulas(series_dir):
    m = fava_tpu.FLASH(series_dir)
    # Pick tags that exist.
    m.load(file_type="prt")
    tags = np.sort(m.particles.data["tag"])
    rho = m.cross_correlation(
        "velx",
        "vely",
        sample_points=tags[:4],
        poi_idx=int(tags[5]),
        lagrangian_tracking=True,
        tag_field="tag",
    )
    assert rho.shape == (4,)

    # Direct oracle over the series: load each file, gather by tag.
    nfiles = 3
    samp = np.zeros((nfiles, 4))
    temp = np.zeros((nfiles, 1))
    for i in range(nfiles):
        m.load(file_index=i, file_type="prt")
        samp[i] = m.particles.select_by_tags(tags[:4])["velx"]
        temp[i] = m.particles.select_by_tags(tags[5:6])["vely"]
    smean = samp[:-1].mean(axis=0)
    tmean = temp[1:].mean()
    sstd = samp[:-1].std(axis=0)
    tstd = temp[1:].std()
    Rts = np.sum(temp[1:] * samp[:-1], axis=0) / float(nfiles - 1)
    expected = (Rts - smean * tmean) / (sstd * tstd)
    np.testing.assert_allclose(rho, expected, rtol=1e-12)


def test_cross_correlation_requires_tracking_mode(series_dir):
    m = fava_tpu.FLASH(series_dir)
    assert m.cross_correlation("velx", "vely", np.array([1.0]), 2) is None


def test_cross_correlation_missing_tag_errors(series_dir):
    m = fava_tpu.FLASH(series_dir)
    m.load(file_type="prt")
    tags = np.sort(m.particles.data["tag"])
    absent = int(tags.max()) + 1000
    with pytest.raises(ValueError, match="not found"):
        m.cross_correlation(
            "velx",
            "vely",
            sample_points=tags[:2],
            poi_idx=absent,
            lagrangian_tracking=True,
            tag_field="tag",
        )


def test_cross_correlation_custom_tag_field(tmp_path):
    """Row tracking must follow the named tag field even when tables are
    permuted differently per file and the field is NOT literally 'tag'
    (the loader's sort-by-tag only applies to that exact column name)."""
    from fava_tpu.io import flash_file

    nglob = 16
    times = [0.0, 0.1, 0.2]
    rng = np.random.default_rng(0)
    base = np.arange(1, nglob + 1, dtype=np.float64)
    for i, t in enumerate(times, start=1):
        ptag = rng.permutation(base)
        flash_file.write_particle_file(
            tmp_path / f"rt_hdf5_part_{i:04d}",
            int_scalars={"dimensionality": 3, "globalnumparticles": nglob},
            real_scalars={"time": float(t), "dt": 1e-3, "dtold": 1e-3},
            particles={"ptag": ptag, "velx": 2 * ptag + 10 * t, "vely": 3 * ptag - t},
        )
    m = fava_tpu.FLASH(tmp_path)
    sample_tags = base[:4]
    rho = m.cross_correlation(
        "velx",
        "vely",
        sample_points=sample_tags,
        poi_idx=3.0,
        lagrangian_tracking=True,
        tag_field="ptag",
    )
    # Oracle straight from the analytic field-of-tag definitions.
    nfiles = len(times)
    samp = np.stack([2 * sample_tags + 10 * t for t in times])
    temp = np.array([[3 * 3.0 - t] for t in times])
    smean, tmean = samp[:-1].mean(axis=0), temp[1:].mean()
    sstd, tstd = samp[:-1].std(axis=0), temp[1:].std()
    Rts = np.sum(temp[1:] * samp[:-1], axis=0) / float(nfiles - 1)
    expected = (Rts - smean * tmean) / (sstd * tstd)
    np.testing.assert_allclose(rho, expected, rtol=1e-12)


def test_eulerian_autocorrelation_translating_mode(tmp_path):
    """Single-mode advected field dens(x,t) = 2 + cos(2pi(x - U t)):
    the decorrelation curve is pinned by the known translation — a
    NONZERO closed form, not the static rho = 1 identity. The exact oracle evaluates the mode at the same sampled
    cells; the continuum closed form (4 + cos(2pi U t)/2)/4.5 bounds
    the Monte-Carlo sampling error."""
    n, U, k = 16, 0.3, 2.0 * np.pi
    times = [0.0, 0.5, 1.0, 1.5]
    xc = (np.arange(n) + 0.5) / n
    X = np.broadcast_to(xc[:, None, None], (n, n, n))
    for i, t in enumerate(times, start=1):
        synthetic.make_uniform_file(
            tmp_path / f"rt_hdf5_uniform_{i:04d}",
            ncells=(n, n, n),
            field_data={"dens": 2.0 + np.cos(k * (X - U * t))},
            time=t,
        )

    m = fava_tpu.FLASH(tmp_path)
    got_times, results = m.eulerian_autocorrelation(
        nsamples=300, fields=["dens"], seed=3, file_type="uni"
    )
    np.testing.assert_allclose(got_times, times)

    # Exact oracle: same deterministic sample points, same nearest-cell
    # snap, field values from the analytic translation.
    from fava_tpu.analysis.auto_correlations import _sample_grid_points

    m2 = fava_tpu.FLASH(tmp_path)
    m2.load(file_index=0, fields=["dens"], file_type="uni")
    points = _sample_grid_points(m2.mesh, 300, np.random.default_rng(3))
    ix = np.clip(np.floor(points[:, 0] * n).astype(int), 0, n - 1)

    def f(t):
        return 2.0 + np.cos(k * (xc[ix] - U * t))

    f0 = f(0.0)
    expected = np.array(
        [np.sum(f0 * f(t)) / (np.linalg.norm(f0) * np.linalg.norm(f(t))) for t in times]
    )
    # FLASH files store fields as f32: the f64 analytic oracle matches
    # to the input-rounding floor, not exactly
    np.testing.assert_allclose(results["dens"], expected, rtol=1e-6)
    assert expected[-1] < 0.85  # genuinely decorrelates (not the identity)

    # Continuum closed form within Monte-Carlo error of 300 samples.
    cont = (4.0 + 0.5 * np.cos(k * U * np.asarray(times))) / 4.5
    assert np.max(np.abs(results["dens"] - cont)) < 0.05


def test_cross_correlation_window_honored(tmp_path):
    """ibeg/iend select the correlated time window: the reference
    accepts both kwargs but loops over every file and mis-centers the
    midpoint (reference cross_correlation.py:52-90) — here the result
    over [ibeg, iend) must equal the full analysis of just that window."""
    from fava_tpu.io import flash_file

    nglob = 12
    times = [0.0, 0.1, 0.2, 0.3, 0.4]
    rng = np.random.default_rng(7)
    base = np.arange(1, nglob + 1, dtype=np.float64)
    vals = rng.normal(size=(len(times), nglob))
    for i, t in enumerate(times, start=1):
        perm = rng.permutation(nglob)
        flash_file.write_particle_file(
            tmp_path / f"rt_hdf5_part_{i:04d}",
            int_scalars={"dimensionality": 3, "globalnumparticles": nglob},
            real_scalars={"time": float(t), "dt": 1e-3, "dtold": 1e-3},
            particles={
                "tag": base[perm],
                "velx": vals[i - 1][perm],
                "vely": (vals[i - 1] ** 2)[perm],
            },
        )
    m = fava_tpu.FLASH(tmp_path)
    sample_tags = base[:3]
    kw = dict(lagrangian_tracking=True, tag_field="tag")
    rho = m.cross_correlation("velx", "vely", sample_tags, 5.0, ibeg=1, iend=4, **kw)

    # Oracle: the same Naka et al. formulas over ONLY files 1..3.
    samp = vals[1:4][:, :3]
    temp = (vals[1:4][:, 4] ** 2)[:, None]
    smean, tmean = samp[:-1].mean(axis=0), temp[1:].mean()
    sstd, tstd = samp[:-1].std(axis=0), temp[1:].std()
    Rts = np.sum(temp[1:] * samp[:-1], axis=0) / float(3 - 1)
    expected = (Rts - smean * tmean) / (sstd * tstd)
    np.testing.assert_allclose(rho, expected, rtol=1e-12)

    with pytest.raises(ValueError, match="invalid series window"):
        m.cross_correlation("velx", "vely", sample_tags, 5.0, ibeg=3, iend=9, **kw)
    with pytest.raises(ValueError, match="at least 2"):
        m.cross_correlation("velx", "vely", sample_tags, 5.0, ibeg=2, iend=3, **kw)


def test_eulerian_autocorrelation_bad_file_is_nan_not_zero(tmp_path, caplog):
    """A corrupt file mid-series yields NaN slots + a logger warning —
    in-band (t=0, corr=0) samples silently corrupted decay fits."""
    import logging

    for i, t in enumerate([0.0, 0.1, 0.2], start=1):
        synthetic.make_uniform_file(
            tmp_path / f"rt_hdf5_uniform_{i:04d}", ncells=(8, 8, 8), seed=9, time=t
        )
    (tmp_path / "rt_hdf5_uniform_0002").write_bytes(b"garbage, not hdf5")

    m = fava_tpu.FLASH(tmp_path)
    with caplog.at_level(logging.WARNING, logger="fava_tpu.analysis.auto_correlations"):
        times, results = m.eulerian_autocorrelation(
            nsamples=16, fields=["dens"], seed=0, file_type="uni"
        )
    assert np.isnan(times[1]) and np.isnan(results["dens"][1])
    assert np.isfinite(times[[0, 2]]).all() and np.isfinite(results["dens"][[0, 2]]).all()
    np.testing.assert_allclose(results["dens"][[0, 2]], 1.0, rtol=1e-12)  # static field
    assert any("skipping bad file" in r.message for r in caplog.records)


def test_particle_series_indices_follow_file_type(tmp_path):
    """chk_prt draws indices from the CHK catalog (checkpoints carry the
    particle table); an unknown type gets a named error."""
    from fava_tpu.analysis._catalogs import particle_series_indices

    for i in (1, 2, 3):
        synthetic.make_particle_file(tmp_path / f"rt_hdf5_part_{i:04d}", nparticles=8)
    synthetic.make_amr_file(tmp_path / "rt_hdf5_chk_0001", ncells=(4, 4, 4), nblks=(1, 1, 1))
    m = fava_tpu.FLASH(tmp_path)
    assert particle_series_indices(m, "prt") == [0, 1, 2]
    assert particle_series_indices(m, "chk_prt") == [0]
    assert particle_series_indices(m, "plt_prt", [2]) == [2]
    with pytest.raises(ValueError, match="particle-series"):
        particle_series_indices(m, "uni")
