"""Mesh-level multi-device integration: sharded load + analyses."""

import jax
import numpy as np
import pytest

import fava_tpu
from fava_tpu.mesh import FlashUniform
from fava_tpu.parallel import get_mesh, make_device_mesh, use_mesh


def test_use_mesh_context(eight_device_mesh):
    assert get_mesh() is None
    with use_mesh(eight_device_mesh):
        assert get_mesh() is eight_device_mesh
    assert get_mesh() is None


def test_sharded_uniform_load_and_spectra(uniform_file_32, eight_device_mesh):
    # Unsharded reference.
    mesh0 = FlashUniform(uniform_file_32)
    mesh0.load()
    spec0 = mesh0.kinetic_energy_spectra()

    with use_mesh(eight_device_mesh):
        mesh1 = FlashUniform(uniform_file_32)
        mesh1.load()
        d = mesh1.data("dens")
        # Field is slab-sharded over the 8 CPU devices.
        assert len(d.sharding.device_set) == 8
        spec1 = mesh1.kinetic_energy_spectra()

    for key in ("total", "longitudinal", "transverse"):
        np.testing.assert_allclose(spec1[key], spec0[key], rtol=1e-9, atol=1e-18, err_msg=key)


def test_sharded_profiles_match(uniform_file_32, eight_device_mesh):
    mesh0 = FlashUniform(uniform_file_32)
    mesh0.load()
    _, stress0, means0 = mesh0.reynolds_stress()

    with use_mesh(eight_device_mesh):
        mesh1 = FlashUniform(uniform_file_32)
        mesh1.load()
        _, stress1, means1 = mesh1.reynolds_stress()

    for key in stress0:
        np.testing.assert_allclose(stress1[key], stress0[key], rtol=1e-9, err_msg=key)
    for key in means0:
        np.testing.assert_allclose(means1[key], means0[key], rtol=1e-10, err_msg=key)


def test_sharded_amr_reynolds_match(amr_file, eight_device_mesh):
    from fava_tpu.mesh import FLASH as FlashAMR

    mesh0 = FlashAMR(amr_file)
    mesh0.load()
    _, stress0, means0 = mesh0.reynolds_stress()

    with use_mesh(eight_device_mesh):
        mesh1 = FlashAMR(amr_file)
        mesh1.load()
        _, stress1, means1 = mesh1.reynolds_stress()

    for key in stress0:
        np.testing.assert_allclose(stress1[key], stress0[key], rtol=1e-9, err_msg=key)


def test_sharded_fractal_and_structfn_match(uniform_file_32, eight_device_mesh):
    mesh0 = FlashUniform(uniform_file_32)
    mesh0.load()
    fd0 = mesh0.fractal_dimension(field="flam", contours=0.5)
    sf0 = mesh0.structure_functions(num_seps=4, num_points=64, sep_bounds=(0.1, 0.4), seed=2)

    with use_mesh(eight_device_mesh):
        mesh1 = FlashUniform(uniform_file_32)
        mesh1.load()
        fd1 = mesh1.fractal_dimension(field="flam", contours=0.5)
        sf1 = mesh1.structure_functions(num_seps=4, num_points=64, sep_bounds=(0.1, 0.4), seed=2)

    np.testing.assert_allclose(
        fd1["flam"]["0.5"]["average fractal dimension"],
        fd0["flam"]["0.5"]["average fractal dimension"],
    )
    np.testing.assert_allclose(sf1["longitudinal"]["2"], sf0["longitudinal"]["2"], rtol=1e-12)


def test_sharded_favre_match(uniform_file_32, eight_device_mesh):
    mesh0 = FlashUniform(uniform_file_32)
    mesh0.load()
    out0 = mesh0.favre_profiles()

    with use_mesh(eight_device_mesh):
        mesh1 = FlashUniform(uniform_file_32)
        mesh1.load()
        out1 = mesh1.favre_profiles()

    np.testing.assert_allclose(out1["mean_dens"], out0["mean_dens"], rtol=1e-10)
    for a in "xyz":
        np.testing.assert_allclose(
            out1["favre_rms"][f"vel{a}"], out0["favre_rms"][f"vel{a}"], rtol=1e-9
        )


@pytest.fixture(scope="session")
def pod_mesh():
    from fava_tpu.parallel import make_device_mesh

    return make_device_mesh((2, 4), ("snap", "space"))


def test_pod_series_driver_matches_per_snapshot(tmp_path, pod_mesh):
    """flagship_series under a snap x space pod mesh (the PRODUCTION
    config #5 path: sharded prefetch -> on-device stack -> one-shard_map
    series step, incl. a padded short final batch) must equal the
    per-snapshot single-chip analysis."""
    from fava_tpu.io import synthetic

    for i in (1, 2, 3):
        synthetic.make_uniform_file(
            tmp_path / f"rt_hdf5_uniform_000{i}", ncells=(16, 16, 16), seed=20 + i
        )
    m = fava_tpu.FLASH(tmp_path)

    with use_mesh(pod_mesh):
        series = m.flagship_series(batch=2)
    assert series["times"].shape == (3,)

    for j in (0, 1, 2):
        m.load(file_type="uni", file_index=j)
        single = m.flagship_analysis()
        for key, val in single.items():
            np.testing.assert_allclose(
                series[key][j], np.asarray(val), rtol=1e-9, atol=1e-12, err_msg=key
            )


def test_pod_series_auto_batch_multiple_of_snap(tmp_path, pod_mesh):
    """batch=0 sizing on a pod must produce a snap-divisible batch and
    still cover every snapshot exactly once."""
    from fava_tpu.io import synthetic

    for i in (1, 2, 3):
        synthetic.make_uniform_file(
            tmp_path / f"rt_hdf5_uniform_000{i}", ncells=(16, 16, 16), seed=30 + i
        )
    m = fava_tpu.FLASH(tmp_path)
    with use_mesh(pod_mesh):
        series = m.flagship_series()  # auto batch
    assert series["times"].shape == (3,)
    assert series["spectra_total"].shape[0] == 3


def test_pod_amr_profiles_shard_blocks_over_all_axes(amr_file, pod_mesh):
    """AMR Reynolds stress under a snap x space pod mesh: block stacks
    shard over ALL 8 devices (no snap-row replication) and results
    equal the unsharded computation."""
    from fava_tpu.mesh import FLASH as FlashAMR
    from fava_tpu.parallel import runtime as prt

    mesh0 = FlashAMR(amr_file)
    mesh0.load()
    _, stress0, means0 = mesh0.reynolds_stress()

    with use_mesh(pod_mesh):
        s = prt.block_sharding(ndim=4)
        assert len(s.mesh.devices.ravel()) == 8
        mesh1 = FlashAMR(amr_file)
        mesh1.load()
        _, stress1, means1 = mesh1.reynolds_stress()

    for key in stress0:
        np.testing.assert_allclose(stress1[key], stress0[key], rtol=1e-9, err_msg=key)
    for key in means0:
        np.testing.assert_allclose(means1[key], means0[key], rtol=1e-10, err_msg=key)


def test_pod_series_nondivisible_falls_back(tmp_path, pod_mesh, caplog):
    """Volume extents that don't divide the space axis must drop to the
    single-chip series scan with a warning, not die in shard_map."""
    import logging

    from fava_tpu.io import synthetic

    for i in (1, 2):
        synthetic.make_uniform_file(
            tmp_path / f"rt_hdf5_uniform_000{i}", ncells=(10, 10, 10), seed=50 + i
        )
    m = fava_tpu.FLASH(tmp_path)
    ref = m.flagship_series()

    with caplog.at_level(logging.WARNING, logger="fava_tpu.analysis.time_series"):
        with use_mesh(pod_mesh):
            got = m.flagship_series()
    assert any("falling back" in r.message for r in caplog.records)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-12, atol=1e-15, err_msg=k)


def test_pod_full_series_pipeline_config5(tmp_path, pod_mesh):
    """BASELINE config #5 in miniature: one data directory holding a
    plt + uniform + particle series, analyzed end-to-end under the
    snap x space pod mesh — AMR Favre profiles (block-sharded over all
    axes), flagship uniform series (snap x space batches), and
    particle statistics — with outputs matching the unsharded runs."""
    from fava_tpu.io import synthetic

    for i, t in enumerate([0.0, 0.1], start=1):
        synthetic.make_amr_file(
            tmp_path / f"rt_hdf5_plt_cnt_{i:04d}",
            ncells=(4, 4, 4),
            nblks=(2, 2, 2),
            refine={0: 2},
            time=t,
        )
        synthetic.make_uniform_file(
            tmp_path / f"rt_hdf5_uniform_{i:04d}", ncells=(16, 16, 16), seed=40 + i
        )
        synthetic.make_particle_file(tmp_path / f"rt_hdf5_part_{i:04d}", nparticles=64, seed=i)

    m = fava_tpu.FLASH(tmp_path)
    ref_favre = m.favre_series(file_type="plt")
    ref_flag = m.flagship_series()
    ref_part = m.particle_series(fields=["velx"])

    with use_mesh(pod_mesh):
        m2 = fava_tpu.FLASH(tmp_path)
        got_favre = m2.favre_series(file_type="plt")
        got_flag = m2.flagship_series()
        got_part = m2.particle_series(fields=["velx"])

    for k in ref_favre:
        np.testing.assert_allclose(got_favre[k], ref_favre[k], rtol=1e-9, err_msg=k)
    for k in ref_flag:
        np.testing.assert_allclose(got_flag[k], ref_flag[k], rtol=1e-9, atol=1e-12, err_msg=k)
    for k in ref_part:
        np.testing.assert_allclose(got_part[k], ref_part[k], rtol=1e-12, err_msg=k)


def test_ingest_prefetch_lands_sharded(tmp_path, pod_mesh):
    """SnapshotPrefetcher with the runtime ingest callback must deliver
    volumes already split over ALL mesh devices (one host crossing),
    and leave non-divisible shapes unsharded."""
    from fava_tpu.io import synthetic
    from fava_tpu.io.ingest import SnapshotPrefetcher
    from fava_tpu.parallel import runtime as prt

    p16 = synthetic.make_uniform_file(
        tmp_path / "rt_hdf5_uniform_0001", ncells=(16, 16, 16), seed=5
    )
    # 12 is divisible by space (4) but not by the full device count (8):
    # the single-block volume rule must decline it.
    p12 = synthetic.make_uniform_file(
        tmp_path / "rt_hdf5_uniform_0002", ncells=(12, 12, 12), seed=6
    )

    fn = prt.ingest_sharding_fn(pod_mesh)
    snaps = list(SnapshotPrefetcher([p16, p12], ["dens", "velx"], sharding=fn))
    for name in ("dens", "velx"):
        assert len(snaps[0].fields[name].sharding.device_set) == 8, name
        assert len(snaps[1].fields[name].sharding.device_set) == 1, name


def test_ingest_prefetch_block_stacks_sharded(amr_file, eight_device_mesh):
    from fava_tpu.io.ingest import SnapshotPrefetcher
    from fava_tpu.parallel import runtime as prt

    fn = prt.ingest_sharding_fn(eight_device_mesh)
    (snap,) = list(SnapshotPrefetcher([amr_file], ["dens"], sharding=fn))
    nb = snap.fields["dens"].shape[0]
    expect = 8 if nb % 8 == 0 else 1
    assert len(snap.fields["dens"].sharding.device_set) == expect


@pytest.mark.parametrize("n", [32, 48])
def test_pod_series_step_scatter_binning_matches(pod_mesh, n):
    """The pod series step (shard_map scatter binning per k-slab) must
    match the unsharded flagship step for every snapshot."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from fava_tpu import flagship

    fields = flagship.make_example_fields(n=n, dtype=jnp.float64)
    ref = flagship.jitted_analysis_step(None)(*fields)

    batch_sharding = NamedSharding(pod_mesh, P("snap", "space", None, None))
    stacked = [jax.device_put(jnp.stack([f, f]), batch_sharding) for f in fields]
    out = flagship.jitted_sharded_series_step(pod_mesh)(*stacked)
    out = {k: np.asarray(v) for k, v in out.items()}
    for key, want in ref.items():
        for i in (0, 1):
            np.testing.assert_allclose(
                out[key][i], np.asarray(want), rtol=1e-8, atol=1e-12, err_msg=key
            )


@pytest.mark.parametrize("mesh_shape", [(8,), (4,)])
def test_sharded_spectra_scatter_binning_matches(uniform_file_32, mesh_shape):
    """The shard_map spectra (local FFTs, all_to_all, local scatter
    binning, psum) must match the unsharded spectra."""
    from fava_tpu.mesh.flash_uniform import FlashUniform

    uni = FlashUniform(uniform_file_32)
    uni.load()
    ref = uni.kinetic_energy_spectra()  # unsharded (no mesh in context)

    with use_mesh(make_device_mesh(mesh_shape, ("space",))):
        uni2 = FlashUniform(uniform_file_32)
        uni2.load()
        got = uni2.kinetic_energy_spectra()
    for key in ("total", "longitudinal", "transverse"):
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-8, atol=1e-12, err_msg=key)


def test_example_field_batch_matches_per_seed_fields():
    """make_example_field_batch synthesizes the (S, n, n, n) stacks in
    one jit (no per-snapshot copies — the stack-of-snapshots path
    transiently doubles the input footprint); snapshot i must reproduce
    make_example_fields(seed=i) to f32 trig rounding (the seed is a
    traced scalar there vs a constant-folded f64 phase)."""
    from fava_tpu import flagship

    batch = flagship.make_example_field_batch(3, n=16)
    assert all(b.shape == (3, 16, 16, 16) for b in batch)
    for i in range(3):
        single = flagship.make_example_fields(n=16, seed=i)
        for k in range(4):
            np.testing.assert_allclose(
                np.asarray(batch[k][i]), np.asarray(single[k]), atol=2e-5
            )


def test_make_device_mesh_too_many_devices():
    """A mesh larger than the device count raises a named error, not
    numpy's cryptic reshape failure from the silent truncation."""
    with pytest.raises(ValueError, match="needs 16 devices"):
        make_device_mesh((2, 8), ("snap", "space"))
