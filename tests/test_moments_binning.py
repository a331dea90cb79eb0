"""Profile row moments and shell binning (the plain XLA paths) against
f64 NumPy oracles, plus the float32 accuracy of the flagship step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fava_tpu.ops import profiles
from fava_tpu.ops.spectra import rfft_shell_counts, shell_bin_rfft
from tests.oracles.spectra import shell_sums_oracle

PAIRS = [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]


def _fields(n=16, seed=0, dtype=jnp.float32):
    key = jax.random.PRNGKey(seed)
    d = 1.0 + 0.3 * jax.random.uniform(key, (n, n, n), dtype=dtype)
    vs = [jax.random.normal(k, (n, n, n), dtype=dtype) for k in jax.random.split(key, 3)]
    return d, vs


def _stack_oracle(d, vs, mu):
    """f64 (raw (7,nB,nx), centered (9,nB,nx)) per-(block,row) sums."""
    rows = lambda a: a.sum(axis=(2, 3))
    raw = np.stack([rows(d)] + [rows(v) for v in vs] + [rows(d * v) for v in vs])
    cv = [v - m[..., None, None] for v, m in zip(vs, mu)]
    cen = np.stack([rows(d * cv[i] * cv[j]) for i, j in PAIRS] + [rows(d * c) for c in cv])
    return raw, cen


@pytest.mark.parametrize(
    "shape",
    [(1, 16, 16, 16), (1, 12, 12, 12), (6, 8, 16, 16), (2, 5, 7, 9)],
    ids=["volume16", "unaligned12", "blockstack", "odd"],
)
def test_row_moments_match_oracle(shape):
    """Raw and centered per-(block, row) moments vs f64 NumPy, on a
    single volume, an unaligned extent, a block stack and odd extents."""
    rng = np.random.default_rng(sum(shape))
    d = 1.0 + 0.3 * rng.random(shape)
    vs = [rng.standard_normal(shape) + m for m in (3.0, -2.0, 1.0)]
    mu = np.stack([v.mean(axis=(2, 3)) for v in vs])
    raw_ref, cen_ref = _stack_oracle(d, vs, mu)
    fields = tuple(jnp.asarray(a) for a in (d, *vs))
    raw = np.asarray(profiles.row_moments(fields, raxis=0, nvel=3))
    cen = np.asarray(profiles.centered_row_moments(fields, jnp.asarray(mu), raxis=0, nvel=3))
    assert raw.shape == (7,) + shape[:2] and cen.shape == (9,) + shape[:2]
    np.testing.assert_allclose(raw, raw_ref, rtol=1e-12, atol=1e-10)
    np.testing.assert_allclose(cen, cen_ref, rtol=1e-12, atol=1e-10)


def _half_power_case(shape, seed):
    """(full-grid powers, rfft half powers) of two real random fields."""
    rng = np.random.default_rng(seed)
    reals = [rng.standard_normal(shape) for _ in range(2)]
    full = [np.abs(np.fft.fftn(r)) ** 2 for r in reals]
    half = [np.abs(np.fft.rfftn(r)) ** 2 for r in reals]
    return full, half


@pytest.mark.parametrize(
    "shape,nbins,chunk",
    [
        ((16, 16, 16), 7, None),  # even extents: Nyquist planes on every axis
        ((8, 8, 300), 149, None),  # more than 128 bins
        ((16, 16, 9), 7, None),  # odd z: no Nyquist plane
        ((8, 16, 9), 7, None),
        ((16, 8, 8), 7, None),
        ((7, 7, 7), 2, None),  # odd extents everywhere
        ((32, 16, 16), 15, None),
        ((16, 126, 16), 62, None),
        ((16, 16, 400), 199, None),
        ((8, 16, 512), 255, None),  # long z
        ((4, 256, 16), 127, 2),  # x-chunks of 2 rows, kx0 = 0, 2
        ((16, 32, 16), 15, 3),  # ragged x-chunks (3 rows), kx0 wraps the sign
    ],
)
def test_shell_bin_rfft_matches_full_grid_oracle(shape, nbins, chunk):
    """Hermitian-weighted half-spectrum binning (whole volume, or summed
    over x-chunks with their kx0 offsets) equals f64 full-grid binning."""
    full, half = _half_power_case(shape, seed=sum(shape) + nbins)
    c_ref, s_ref = shell_sums_oracle(full, nbins)
    nx = shape[0]
    step = chunk or nx
    counts = np.zeros(nbins)
    sums = np.zeros((2, nbins))
    for kx0 in range(0, nx, step):
        rows = slice(kx0, kx0 + step)
        c, s = shell_bin_rfft(
            tuple(jnp.asarray(h[rows]) for h in half), nbins, nx, shape[2], jnp.asarray(kx0)
        )
        counts += np.asarray(c)
        sums += np.asarray(s)
    np.testing.assert_allclose(counts, c_ref)
    np.testing.assert_allclose(sums, s_ref, rtol=1e-10, atol=1e-8)


def test_shell_bin_rfft_single_channel():
    """One power volume bins alone (the scalar-spectrum layout)."""
    full, half = _half_power_case((16, 16, 9), seed=8)
    c_ref, s_ref = shell_sums_oracle(full[:1], 7)
    c, s = shell_bin_rfft((jnp.asarray(half[0]),), 7, 16, 9)
    assert np.asarray(s).shape == (1, 7)
    np.testing.assert_allclose(np.asarray(c), c_ref)
    np.testing.assert_allclose(np.asarray(s), s_ref, rtol=1e-10, atol=1e-8)


def test_shell_bin_rfft_two_traces():
    """The binning traced into two different jits gives the same counts
    (no value cached from the first trace leaks into the second)."""
    nx = ny = nz = 16
    rng = np.random.default_rng(3)
    total = jnp.asarray(np.abs(rng.standard_normal((nx, ny, nz // 2 + 1))))

    @jax.jit
    def f1(t):
        return shell_bin_rfft((t,), 7, nx, nz)[0]

    @jax.jit
    def f2(t):
        return shell_bin_rfft((t,), 7, nx, nz)[0] * 2.0

    np.testing.assert_allclose(np.asarray(f2(total)), 2.0 * np.asarray(f1(total)))


def test_centered_moments_consistent_with_expansion():
    """Centered covariances must equal the algebraic expansion (float64)."""
    d, vs = _fields(8, seed=4, dtype=jnp.float64)
    means = jnp.stack([jnp.mean(v, axis=(1, 2)) for v in vs])
    fields = tuple(a[None] for a in (d, *vs))
    cen = np.asarray(profiles.centered_row_moments(fields, means[:, None, :], raxis=0, nvel=3))[:, 0]
    mom = np.asarray(profiles.row_moments(fields, raxis=0, nvel=3))[:, 0]
    dn, vn = np.asarray(d), [np.asarray(v) for v in vs]
    m = np.asarray(means)
    for p, (i, j) in enumerate(PAIRS):
        dvivj = (dn * vn[i] * vn[j]).sum(axis=(1, 2))
        expansion = dvivj - m[j] * mom[4 + i] - m[i] * mom[4 + j] + m[i] * m[j] * mom[0]
        np.testing.assert_allclose(cen[p], expansion, rtol=1e-9, atol=1e-12)


def test_amr_reynolds_stress_float32_accuracy():
    """The general (multi-block) profile path must hold float32 accuracy
    in the large-mean/small-fluctuation regime via the centered pass."""
    from fava_tpu.ops import profiles as profile_ops

    rng = np.random.default_rng(11)
    nb, nx, ny, nz = 2, 8, 16, 16
    mean_v = [10.0, -8.0, 6.0]
    dens = (1.0 + 0.1 * rng.random((nb, nx, ny, nz))).astype(np.float32).astype(np.float64)
    vels = [
        (mv + 1e-2 * rng.standard_normal((nb, nx, ny, nz))).astype(np.float32).astype(np.float64)
        for mv in mean_v
    ]

    geom = profile_ops.ProfileGeometry(
        block_bounds=np.array(
            [[[0.0, 1.0], [0.0, 1.0], [0.0, 1.0]], [[1.0, 2.0], [0.0, 1.0], [0.0, 1.0]]]
        ),
        refine_level=np.array([1, 1]),
        blocklist=np.array([0, 1]),
        domain_bounds=np.array([[0.0, 2.0], [0.0, 1.0], [0.0, 1.0]]),
        ncells_vec=np.array([nx, ny, nz]),
        nblks_vec=np.array([2, 1, 1]),
        ndim=3,
        raxis=0,
    )

    # f64 oracle: per fine bin (= block row here), centered covariances.
    rows = np.concatenate([dens[0], dens[1]], axis=0)  # (16, ny, nz) along x
    vrows = [np.concatenate([v[0], v[1]], axis=0) for v in vels]
    layer = ny * nz
    means = [v.sum(axis=(1, 2)) / layer for v in vrows]
    pairs = [(i, j) for i in range(3) for j in range(i, 3)]
    expected = {}
    for i, j in pairs:
        cvi = vrows[i] - means[i][:, None, None]
        cvj = vrows[j] - means[j][:, None, None]
        expected[f"R{'xyz'[i]}{'xyz'[j]}"] = (rows * cvi * cvj).sum(axis=(1, 2)) / layer

    prev_x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        data = {"dens": jnp.asarray(dens, dtype=jnp.float32)}
        for a, v in zip("xyz", vels):
            data[f"vel{a}"] = jnp.asarray(v, dtype=jnp.float32)
        _, stress, _ = profile_ops.reynolds_stress(data, geom)
    finally:
        jax.config.update("jax_enable_x64", prev_x64)

    scale = max(np.abs(v).max() for v in expected.values())
    for key_, exp in expected.items():
        err = np.abs(stress[key_] - exp).max() / scale
        assert err < 5e-5, (key_, err)


def test_flagship_float32_produces_no_nans():
    """Regression: the k=0 guard epsilon must not underflow in float32
    (1e-99 -> 0.0 -> 0/0 NaN poisoning every shell via the mask multiply)."""
    from fava_tpu.flagship import make_example_fields, uniform_analysis_step

    fields = make_example_fields(n=16, dtype=jnp.float32)
    out = jax.jit(lambda *f: uniform_analysis_step(*f, mesh=None))(*fields)
    for key in ("spectra_total", "spectra_longitudinal", "spectra_transverse"):
        assert not np.isnan(np.asarray(out[key])).any(), key


def test_flagship_sharded_branch_float32_accuracy(eight_device_mesh):
    """The sharded branch must use the centered two-pass: in float32,
    small fluctuations on large mean velocities make the one-pass
    algebraic expansion cancel catastrophically (>1e-2 relative here),
    while centering keeps profiles at ~1e-5 of the f64 oracle."""
    from fava_tpu.flagship import uniform_analysis_step
    from fava_tpu.parallel import volume_sharding

    rng = np.random.default_rng(7)
    n = 16
    layer = n * n
    mean_v = [10.0, -8.0, 6.0]
    # Quantize inputs to f32 up front so the oracle and the device see
    # identical values and only algorithmic error is measured.
    dens = (1.0 + 0.1 * rng.random((n, n, n))).astype(np.float32).astype(np.float64)
    vels = [
        (mv + 1e-2 * rng.standard_normal((n, n, n))).astype(np.float32).astype(np.float64)
        for mv in mean_v
    ]

    pairs = [(i, j) for i in range(3) for j in range(i, 3)]
    means = [v.sum(axis=(1, 2)) / layer for v in vels]
    cv = [v - m[:, None, None] for v, m in zip(vels, means)]
    expected = np.stack(
        [(dens * cv[i] * cv[j]).sum(axis=(1, 2)) / layer for i, j in pairs]
    )

    # Show the one-pass expansion really does lose float32 accuracy here.
    d32 = dens.astype(np.float32)
    v32 = [v.astype(np.float32) for v in vels]
    m32 = [v.sum(axis=(1, 2), dtype=np.float32) / layer for v in v32]
    dv32 = [(d32 * v).sum(axis=(1, 2), dtype=np.float32) for v in v32]
    d_row32 = d32.sum(axis=(1, 2), dtype=np.float32)
    onepass = np.stack(
        [
            (
                (d32 * v32[i] * v32[j]).sum(axis=(1, 2), dtype=np.float32)
                - m32[j] * dv32[i]
                - m32[i] * dv32[j]
                + m32[i] * m32[j] * d_row32
            )
            / layer
            for (i, j) in pairs
        ]
    )
    # Errors are normalized by the profile scale (cross terms of
    # independent fluctuations are ~0, making pointwise relative error
    # meaningless there).
    scale = np.abs(expected).max()
    err_onepass = np.abs(onepass - expected).max() / scale
    assert err_onepass > 1e-3  # the regime is genuinely cancellation-prone

    prev_x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        sharding = volume_sharding(eight_device_mesh, 0, 3)
        dd = jax.device_put(jnp.asarray(dens, dtype=jnp.float32), sharding)
        vv = [jax.device_put(jnp.asarray(v, dtype=jnp.float32), sharding) for v in vels]
        out = jax.jit(lambda *f: uniform_analysis_step(*f, mesh=eight_device_mesh))(dd, *vv)
        got = np.asarray(out["reynolds_stress"], dtype=np.float64)
        favre_rms = np.asarray(out["favre_rms"], dtype=np.float64)
    finally:
        jax.config.update("jax_enable_x64", prev_x64)

    err = np.abs(got - expected).max() / scale
    assert err < 5e-5, (err, err_onepass)
    # Favre RMS is sqrt(variance): same cancellation regime, same bar.
    fmean = [(dens * v).sum(axis=(1, 2)) / dens.sum(axis=(1, 2)) for v in vels]
    exp_rms = np.stack(
        [
            np.sqrt((dens * (v - f[:, None, None]) ** 2).sum(axis=(1, 2)) / dens.sum(axis=(1, 2)))
            for v, f in zip(vels, fmean)
        ]
    )
    rel_rms = np.abs(favre_rms - exp_rms) / np.maximum(np.abs(exp_rms), 1e-30)
    assert rel_rms.max() < 5e-4, rel_rms.max()


def test_favre_mean_conditioned_for_zero_mean_velocities():
    """favre_mean must be computed as mu + c1/sum(d): the raw sum(d*v)
    cancels for near-zero-mean velocities and loses ~3e-2 (scaled) in
    f32."""
    from fava_tpu.flagship import uniform_analysis_step

    rng = np.random.default_rng(3)
    n = 16
    dens = (1.0 + 0.5 * rng.random((n, n, n))).astype(np.float32).astype(np.float64)
    vels = [rng.standard_normal((n, n, n)).astype(np.float32).astype(np.float64) for _ in range(3)]

    d_row = dens.sum(axis=(1, 2))
    exp = np.stack([(dens * v).sum(axis=(1, 2)) / d_row for v in vels])
    scale = max(np.abs(v).max() for v in vels)

    prev_x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        out = jax.jit(lambda *f: uniform_analysis_step(*f, mesh=None))(
            jnp.asarray(dens, dtype=jnp.float32),
            *(jnp.asarray(v, dtype=jnp.float32) for v in vels),
        )
        got = np.asarray(out["favre_mean"], dtype=np.float64)
    finally:
        jax.config.update("jax_enable_x64", prev_x64)

    err = np.abs(got - exp).max() / scale
    assert err < 2e-6, err


def test_flagship_step_consistent_with_mesh_path():
    """mesh=None (the fused single-device step) must agree with the
    sharded-math path run on a single device."""
    from fava_tpu.flagship import uniform_analysis_step
    from fava_tpu.parallel import make_device_mesh

    key = jax.random.PRNGKey(2)
    n = 16
    d = 1.0 + 0.3 * jax.random.uniform(key, (n, n, n))
    vs = [jax.random.normal(k, (n, n, n)) for k in jax.random.split(key, 3)]

    a = jax.jit(lambda *f: uniform_analysis_step(*f, mesh=None))(d, *vs)
    mesh1 = make_device_mesh((1,), ("space",))
    b = jax.jit(lambda *f: uniform_analysis_step(*f, mesh=mesh1))(d, *vs)
    for key_ in ("spectra_total", "spectra_counts", "reynolds_stress", "favre_rms"):
        np.testing.assert_allclose(
            np.asarray(a[key_]), np.asarray(b[key_]), rtol=1e-9, atol=1e-15, err_msg=key_
        )


def test_rfft_shell_counts_odd_extents():
    """Regression: static shell counts must match the dynamic
    accumulation for ODD x/y extents (no Nyquist self-conjugate row)."""
    for shape in [(6, 5, 6), (5, 6, 7), (7, 7, 7), (8, 8, 8)]:
        nx, ny, nz = shape
        nzr = nz // 2 + 1
        nbins = max(shape) // 2 - 1
        t = jnp.ones((nx, ny, nzr))
        c_dyn, _ = shell_bin_rfft((t,), nbins, nx, nz)
        c_stat = rfft_shell_counts(shape, nbins, "float64")
        np.testing.assert_allclose(np.asarray(c_dyn), c_stat, err_msg=str(shape))
