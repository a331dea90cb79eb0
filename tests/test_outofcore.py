"""Streamed (out-of-core) analysis vs the in-core flagship step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fava_tpu.flagship import uniform_analysis_step
from fava_tpu.ops.outofcore import streamed_uniform_analysis


def test_streamed_matches_incore_step():
    rng = np.random.default_rng(21)
    n = 32
    fields = {"dens": 1.0 + 0.4 * rng.random((n, n, n))}
    for a in "xyz":
        fields[f"vel{a}"] = rng.standard_normal((n, n, n))

    def loader(name, x0, x1):
        return fields[name][x0:x1]

    got = streamed_uniform_analysis(
        loader, (n, n, n), slab_rows=8, chunk_rows=16, dtype=jnp.float64
    )

    ref = jax.jit(lambda *f: uniform_analysis_step(*f, mesh=None))(
        jnp.asarray(fields["dens"]),
        *(jnp.asarray(fields[f"vel{a}"]) for a in "xyz"),
    )
    for key in got:
        r = np.asarray(ref[key], dtype=np.float64)
        g = np.asarray(got[key], dtype=np.float64)
        assert g.shape == r.shape, key
        scale = max(np.abs(r).max(), 1e-30)
        np.testing.assert_allclose(g / scale, r / scale, rtol=0, atol=1e-9, err_msg=key)


def test_mesh_flagship_analysis_incore_vs_streamed(tmp_path):
    """The public flagship_analysis must give identical results whether
    the volume is device-resident or streamed from the HDF5 file."""
    import fava_tpu
    from fava_tpu.io import synthetic

    path = tmp_path / "rt_hdf5_uniform_0001"
    synthetic.make_uniform_file(path, ncells=(16, 16, 16), seed=9)
    m = fava_tpu.FLASH(tmp_path)
    m.load(file_type="uni")

    incore = m.flagship_analysis(streamed=False)
    streamed = m.flagship_analysis(streamed=True, slab_rows=4, chunk_rows=8)
    assert set(incore) == set(streamed)
    for key in incore:
        r = np.asarray(incore[key], dtype=np.float64)
        g = np.asarray(streamed[key], dtype=np.float64)
        scale = max(np.abs(r).max(), 1e-30)
        np.testing.assert_allclose(g / scale, r / scale, rtol=0, atol=1e-9, err_msg=key)


def test_streamed_chunk_binning_equals_whole():
    """Chunked shell binning must sum to the unchunked result."""
    from fava_tpu.ops.spectra import shell_bin_rfft

    rng = np.random.default_rng(5)
    nx, ny, nz = 16, 16, 16
    nzr = nz // 2 + 1
    total = jnp.asarray(np.abs(rng.standard_normal((nx, ny, nzr))))
    longi = 0.6 * total
    trans = total - longi
    nbins = nx // 2 - 1

    c_ref, s_ref = shell_bin_rfft((total, longi, trans), nbins, nx, nz)

    c_acc = jnp.zeros(nbins, dtype=total.dtype)
    s_acc = jnp.zeros((3, nbins), dtype=total.dtype)
    for kx0 in range(0, nx, 4):
        rows = slice(kx0, kx0 + 4)
        c, s = shell_bin_rfft(
            (total[rows], longi[rows], trans[rows]), nbins, nx, nz, jnp.asarray(kx0)
        )
        c_acc = c_acc + c
        s_acc = s_acc + s
    np.testing.assert_allclose(np.asarray(c_acc), np.asarray(c_ref))
    np.testing.assert_allclose(np.asarray(s_acc), np.asarray(s_ref), rtol=1e-12, atol=1e-18)


def test_series_step_matches_per_snapshot():
    """series_analysis_step (one-dispatch lax.scan batch) must equal the
    per-snapshot step for every snapshot in the batch."""
    import jax.numpy as jnp

    from fava_tpu.flagship import make_example_fields, series_analysis_step

    snaps = [make_example_fields(n=16, seed=s) for s in (0, 5)]
    batched = [jnp.stack([snap[i] for snap in snaps]) for i in range(4)]
    out = series_analysis_step(*batched)
    for s, snap in enumerate(snaps):
        ref = uniform_analysis_step(*snap, mesh=None)
        for key, val in ref.items():
            np.testing.assert_allclose(
                np.asarray(out[key][s]), np.asarray(val), rtol=1e-12, atol=1e-12
            )


def test_streamed_summary_matches_incore():
    from fava_tpu.ops import velocity as vel_ops
    from fava_tpu.ops.outofcore import streamed_turbulence_summary

    rng = np.random.default_rng(31)
    n = 32
    fields = {
        "dens": 1.0 + 0.4 * rng.random((n, n, n)),
        "pres": 2.0 + rng.random((n, n, n)),
        "gamc": 1.3 + 0.2 * rng.random((n, n, n)),
    }
    for a in "xyz":
        fields[f"vel{a}"] = rng.standard_normal((n, n, n))

    def loader(name, x0, x1):
        return fields[name][x0:x1]

    lengths = (1.0, 0.75, 0.5)
    got = streamed_turbulence_summary(
        loader,
        (n, n, n),
        slab_rows=8,
        chunk_rows=16,
        dtype=jnp.float64,
        lengths=lengths,
        with_mach=True,
    )
    ref = vel_ops.turbulence_summary(
        *(jnp.asarray(fields[f"vel{a}"]) for a in "xyz"),
        dens=jnp.asarray(fields["dens"]),
        pres=jnp.asarray(fields["pres"]),
        gamma=jnp.asarray(fields["gamc"]),
        lengths=lengths,
    )
    assert set(got) == set(ref)
    for key, r in ref.items():
        np.testing.assert_allclose(got[key], r, rtol=1e-9, err_msg=key)


def test_streamed_summary_gamc_fallback_and_no_mach():
    from fava_tpu.ops import velocity as vel_ops
    from fava_tpu.ops.outofcore import streamed_turbulence_summary

    rng = np.random.default_rng(32)
    n = 16
    fields = {"dens": 1.0 + 0.4 * rng.random((n, n, n)), "pres": 2.0 + rng.random((n, n, n))}
    for a in "xyz":
        fields[f"vel{a}"] = rng.standard_normal((n, n, n))

    def loader(name, x0, x1):
        if name not in fields:
            raise KeyError(name)  # no gamc on file -> scalar gamma fallback
        return fields[name][x0:x1]

    got = streamed_turbulence_summary(
        loader, (n, n, n), slab_rows=4, chunk_rows=8, dtype=jnp.float64,
        gamma=1.4, with_mach=True,
    )
    ref = vel_ops.turbulence_summary(
        *(jnp.asarray(fields[f"vel{a}"]) for a in "xyz"),
        dens=jnp.asarray(fields["dens"]),
        pres=jnp.asarray(fields["pres"]),
        gamma=1.4,
    )
    for key, r in ref.items():
        np.testing.assert_allclose(got[key], r, rtol=1e-9, err_msg=key)

    got2 = streamed_turbulence_summary(
        loader, (n, n, n), slab_rows=4, chunk_rows=8, dtype=jnp.float64
    )
    ref2 = vel_ops.turbulence_summary(
        *(jnp.asarray(fields[f"vel{a}"]) for a in "xyz"),
        dens=jnp.asarray(fields["dens"]),
    )
    assert set(got2) == set(ref2)
    for key, r in ref2.items():
        np.testing.assert_allclose(got2[key], r, rtol=1e-9, err_msg=key)


def test_mesh_summary_incore_vs_streamed(tmp_path):
    import fava_tpu
    from fava_tpu.io import synthetic

    path = tmp_path / "rt_hdf5_uniform_0001"
    synthetic.make_uniform_file(path, ncells=(16, 16, 16), seed=10)
    m = fava_tpu.FLASH(tmp_path)
    m.load(file_type="uni")
    incore = m.turbulence_summary()
    streamed = m.turbulence_summary(streamed=True, slab_rows=4, chunk_rows=8)
    assert set(incore) == set(streamed)
    for key, r in incore.items():
        np.testing.assert_allclose(streamed[key], r, rtol=1e-9, err_msg=key)


def test_streamed_velocity_correlations_match_incore(tmp_path):
    from fava_tpu.ops import twopoint as tp_ops
    from fava_tpu.ops.outofcore import streamed_velocity_correlations

    rng = np.random.default_rng(33)
    n = 32
    fields = {"dens": 1.0 + 0.4 * rng.random((n, n, n))}
    for a in "xyz":
        fields[f"vel{a}"] = rng.standard_normal((n, n, n))

    def loader(name, x0, x1):
        return fields[name][x0:x1]

    lengths = (1.0, 0.75, 0.5)
    got = streamed_velocity_correlations(
        loader, (n, n, n), slab_rows=8, chunk_rows=16, dtype=jnp.float64, lengths=lengths
    )
    ref = tp_ops.velocity_correlations(
        *(jnp.asarray(fields[f"vel{a}"]) for a in "xyz"), lengths=lengths
    )
    assert set(got) == set(ref)
    for key, r in ref.items():
        np.testing.assert_allclose(got[key], r, rtol=1e-8, atol=1e-10, err_msg=key)

    # mesh-level streamed path vs in-core
    import fava_tpu
    from fava_tpu.io import synthetic

    path = tmp_path / "rt_hdf5_uniform_0001"
    synthetic.make_uniform_file(path, ncells=(16, 16, 16), seed=11)
    m = fava_tpu.FLASH(tmp_path)
    m.load(file_type="uni")
    incore = m.velocity_correlations()
    streamed = m.velocity_correlations(streamed=True, slab_rows=4, chunk_rows=8)
    for key, r in incore.items():
        np.testing.assert_allclose(streamed[key], r, rtol=1e-8, atol=1e-10, err_msg=key)


def test_streamed_velocity_correlations_mean_flow():
    # Strong mean flow: the corner (k=0) power dominates the marginals;
    # the mean removal must cancel against the SAME transformed data
    # (a host-recomputed (sum v)^2 catastrophically cancels in f32).
    from fava_tpu.ops import twopoint as tp_ops
    from fava_tpu.ops.outofcore import streamed_velocity_correlations

    rng = np.random.default_rng(34)
    n = 16
    fields = {"velx": 10.0 + rng.standard_normal((n, n, n))}
    for a in "yz":
        fields[f"vel{a}"] = rng.standard_normal((n, n, n)) - 5.0

    def loader(name, x0, x1):
        return fields[name][x0:x1]

    got = streamed_velocity_correlations(
        loader, (n, n, n), slab_rows=4, chunk_rows=8, dtype=jnp.float64
    )
    ref = tp_ops.velocity_correlations(*(jnp.asarray(fields[f"vel{a}"]) for a in "xyz"))
    for key, r in ref.items():
        np.testing.assert_allclose(got[key], r, rtol=1e-8, atol=1e-10, err_msg=key)


def test_streamed_two_point_lines_match_incore(tmp_path):
    from fava_tpu.ops import twopoint as tp_ops
    from fava_tpu.ops.outofcore import streamed_two_point_lines

    rng = np.random.default_rng(35)
    n = 32
    f = 2.0 + rng.standard_normal((n, n, n))  # nonzero mean

    def loader(name, x0, x1):
        assert name == "dens"
        return f[x0:x1]

    lengths = (1.0, 0.75, 0.5)
    got = streamed_two_point_lines(
        loader, (n, n, n), "dens", slab_rows=8, chunk_rows=16,
        dtype=jnp.float64, lengths=lengths,
    )
    ref = tp_ops.two_point_correlation(jnp.asarray(f), lengths=lengths)
    np.testing.assert_allclose(got["variance"], ref["variance"], rtol=1e-9)
    for ax in "xyz":
        np.testing.assert_allclose(got[f"R_{ax}"], ref[f"R_{ax}"], rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(
            got[f"integral_scale_{ax}"], ref[f"integral_scale_{ax}"], rtol=1e-8
        )
    assert "R_shell" not in got  # needs the full correlation volume

    # mesh hook
    import fava_tpu
    from fava_tpu.io import synthetic

    path = tmp_path / "rt_hdf5_uniform_0001"
    synthetic.make_uniform_file(path, ncells=(16, 16, 16), seed=12)
    m = fava_tpu.FLASH(tmp_path)
    m.load(file_type="uni")
    incore = m.two_point_correlation(field="dens")
    streamed = m.two_point_correlation(field="dens", streamed=True, slab_rows=4, chunk_rows=8)
    np.testing.assert_allclose(streamed["R_x"], incore["R_x"], rtol=1e-8, atol=1e-10)

    # kwargs the streamed path cannot honor must raise, not vanish (ADVICE r3)
    with pytest.raises(TypeError, match="nbins"):
        m.two_point_correlation(field="dens", streamed=True, nbins=32)

    # ... and streaming knobs without streamed=True must raise too — a
    # user asking for the bf16 wire must not silently get the in-core run
    for call in (
        lambda: m.two_point_correlation(field="dens", wire_dtype=jnp.bfloat16),
        lambda: m.mesh.velocity_correlations(prefetch_depth=4),
        lambda: m.mesh.turbulence_summary(slab_rows=4),
        lambda: m.mesh.flagship_analysis(streamed=False, wire_dtype=jnp.bfloat16),
    ):
        with pytest.raises(TypeError, match="streamed"):
            call()


def test_streamed_bf16_wire_approximates_incore():
    """wire_dtype=bfloat16 halves host-to-device bytes; results must match the
    in-core step to bf16 input-rounding accuracy (opt-in trade)."""
    rng = np.random.default_rng(31)
    n = 16
    fields = {"dens": 1.0 + 0.4 * rng.random((n, n, n))}
    for a in "xyz":
        fields[f"vel{a}"] = rng.standard_normal((n, n, n))

    def loader(name, x0, x1):
        return fields[name][x0:x1]

    ref = uniform_analysis_step(*[jnp.asarray(fields[k]) for k in ("dens", "velx", "vely", "velz")], mesh=None)
    got = streamed_uniform_analysis(
        loader, (n, n, n), slab_rows=4, chunk_rows=8, dtype=jnp.float64, wire_dtype=jnp.bfloat16
    )
    for key in ("mean_dens", "reynolds_stress", "spectra_total"):
        scale = float(np.max(np.abs(np.asarray(ref[key])))) or 1.0
        err = float(np.max(np.abs(got[key] - np.asarray(ref[key])))) / scale
        assert err < 2e-2, (key, err)  # bf16 has ~3 decimal digits
        assert err > 0.0, (key, "bf16 wire should not be bit-identical")


def test_slab_stream_order_and_prefetch():
    """Slabs must arrive in x order whatever the worker timing."""
    import time

    from fava_tpu.ops.outofcore import _slab_stream

    calls = []

    def loader(name, x0, x1):
        if x0 == 0:
            time.sleep(0.05)  # first slab slowest: later slabs finish first
        calls.append((name, x0))
        return np.full((x1 - x0, 4, 4), float(x0))

    seen = []
    for x0, (slab,) in _slab_stream(loader, ("dens",), 16, 4, jnp.float64, depth=3):
        seen.append(x0)
        np.testing.assert_array_equal(np.asarray(slab), float(x0))
    assert seen == [0, 4, 8, 12]
    assert {c[1] for c in calls} == {0, 4, 8, 12}


def test_streamed_gradient_stats_match_incore(tmp_path):
    from fava_tpu.ops.gradients import velocity_gradient_statistics
    from fava_tpu.ops.outofcore import streamed_gradient_stats

    rng = np.random.default_rng(33)
    n = 16
    # a mean flow + shear stresses the per-slab centering + Chan combine
    y = (np.arange(n) + 0.5) / n
    fields = {
        "velx": 5.0 + 2.0 * np.sin(2 * np.pi * y)[None, :, None] + 0.3 * rng.standard_normal((n, n, n)),
        "vely": rng.standard_normal((n, n, n)),
        "velz": -3.0 + rng.standard_normal((n, n, n)),
    }

    def loader(name, x0, x1):
        return fields[name][x0:x1]

    got = streamed_gradient_stats(
        loader, (n, n, n), slab_rows=4, dtype=jnp.float64, lengths=(2.0, 1.0, 1.0)
    )
    ref = velocity_gradient_statistics(
        *(jnp.asarray(fields[f"vel{a}"]) for a in "xyz"), lengths=(2.0, 1.0, 1.0)
    )
    assert set(got) == set(ref)
    for k, r in ref.items():
        np.testing.assert_allclose(got[k], r, rtol=1e-10, atol=1e-12, err_msg=k)


def test_streamed_gradient_stats_single_slab_and_halo_wrap():
    # slab_rows == nx: the halo rows wrap onto the slab itself.
    from fava_tpu.ops.gradients import velocity_gradient_statistics
    from fava_tpu.ops.outofcore import streamed_gradient_stats

    rng = np.random.default_rng(34)
    n = 8
    fields = {f"vel{a}": rng.standard_normal((n, n, n)) for a in "xyz"}

    def loader(name, x0, x1):
        return fields[name][x0:x1]

    got = streamed_gradient_stats(loader, (n, n, n), slab_rows=n, dtype=jnp.float64)
    ref = velocity_gradient_statistics(*(jnp.asarray(fields[f"vel{a}"]) for a in "xyz"))
    for k, r in ref.items():
        np.testing.assert_allclose(got[k], r, rtol=1e-10, atol=1e-12, err_msg=k)


def test_mesh_gradient_stats_incore_vs_streamed(tmp_path):
    import fava_tpu
    from fava_tpu.io import synthetic

    path = tmp_path / "rt_hdf5_uniform_0001"
    synthetic.make_uniform_file(path, ncells=(16, 16, 16), seed=51)
    m = fava_tpu.FLASH(tmp_path)
    m.load(file_type="uni")
    ref = m.velocity_gradient_statistics()
    got = m.velocity_gradient_statistics(streamed=True, slab_rows=4)
    for k, r in ref.items():
        np.testing.assert_allclose(got[k], r, rtol=1e-9, atol=1e-11, err_msg=k)
    # knobs without streamed=True must raise, and interior is in-core-only
    with pytest.raises(TypeError, match="streamed"):
        m.velocity_gradient_statistics(slab_rows=4)
    with pytest.raises(ValueError, match="periodic-only"):
        m.velocity_gradient_statistics(streamed=True, boundary="interior")


def test_slab_stream_depth_clamped_and_early_exit():
    """prefetch_depth <= 0 must clamp to 1 (0 primed an empty window ->
    pop from empty list; -1 double-loaded slabs via a negative priming
    slice), each slab must load exactly once, and closing the stream
    early must release its prefetch window without hanging."""
    from fava_tpu.ops import outofcore as oc

    calls = []

    def loader(name, x0, x1):
        calls.append(x0)
        return np.zeros((x1 - x0, 4, 4), np.float32)

    for depth in (0, -1, 1, 3):
        calls.clear()
        out = list(oc._slab_stream(loader, ("dens",), 8, 4, jnp.float32, depth=depth))
        assert [x0 for x0, _ in out] == [0, 4], depth
        assert sorted(calls) == [0, 4], depth  # exactly once each

    gen = oc._slab_stream(loader, ("dens",), 16, 4, jnp.float32, depth=2)
    next(gen)
    gen.close()  # finally-block cancels/clears the window


def test_snapshot_prefetcher_early_exit(tmp_path):
    """Breaking out of a SnapshotPrefetcher iteration must cancel the
    remaining window (not read every leftover snapshot) and exit
    cleanly."""
    import fava_tpu
    from fava_tpu.io import synthetic
    from fava_tpu.io.ingest import SnapshotPrefetcher

    paths = []
    for i in range(1, 5):
        p = tmp_path / f"rt_hdf5_uniform_{i:04d}"
        synthetic.make_uniform_file(p, ncells=(8, 8, 8), seed=60 + i)
        paths.append(p)

    it = iter(SnapshotPrefetcher(paths, ["dens"], depth=2))
    snap = next(it)
    assert snap.fields["dens"].shape[-1] == 8
    it.close()
