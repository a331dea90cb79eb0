"""Spectral velocity diagnostics vs the full-grid NumPy oracle.

The device path works on the z-rfft half spectrum (jnp.fft); the oracle is an independent full-grid np.fft
implementation — exact agreement (f64 CPU) checks both the transforms
and the Nyquist/Hermitian conventions.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from fava_tpu.ops import velocity as vel_ops
from tests.oracles import velocity as oracle


def _fields(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape) for _ in range(3)]


@pytest.mark.parametrize("shape", [(16, 16, 16), (16, 12, 8), (8, 8, 9)])
def test_helmholtz_matches_oracle_and_sums_exactly(shape):
    vels = _fields(shape, 1)
    out = vel_ops.helmholtz_decompose(*[jnp.asarray(v) for v in vels])
    sol_ref, comp_ref = oracle.helmholtz_oracle(vels)
    for i, name in enumerate(("velx", "vely", "velz")):
        np.testing.assert_allclose(
            np.asarray(out["compressive"][name]), comp_ref[i], rtol=1e-9, atol=1e-10
        )
        np.testing.assert_allclose(
            np.asarray(out["solenoidal"][name]), sol_ref[i], rtol=1e-9, atol=1e-10
        )
        np.testing.assert_allclose(
            np.asarray(out["solenoidal"][name]) + np.asarray(out["compressive"][name]),
            vels[i],
            rtol=1e-12,
            atol=1e-12,
        )


def test_helmholtz_parts_are_curl_and_divergence_free():
    shape = (16, 16, 16)
    vels = _fields(shape, 2)
    out = vel_ops.helmholtz_decompose(*[jnp.asarray(v) for v in vels])
    comp = [np.asarray(out["compressive"][n]) for n in ("velx", "vely", "velz")]
    sol = [np.asarray(out["solenoidal"][n]) for n in ("velx", "vely", "velz")]
    # Divergence of the solenoidal part vanishes (spectral check).
    assert np.max(np.abs(oracle.dilatation_oracle(sol))) < 1e-10
    # Curl of the compressive part vanishes.
    for c in oracle.vorticity_oracle(comp):
        assert np.max(np.abs(c)) < 1e-10


def test_helmholtz_pure_modes():
    # A single solenoidal mode passes through untouched; a pure gradient
    # field is classified compressive (mean removed to solenoidal).
    n = 16
    x = np.arange(n) / n
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    sol_field = [np.sin(2 * np.pi * Y), np.zeros_like(X), np.zeros_like(X)]  # div-free
    phi_grad = [np.sin(2 * np.pi * X), np.zeros_like(X), np.zeros_like(X)]  # = d/dx phi
    out = vel_ops.helmholtz_decompose(*[jnp.asarray(v) for v in sol_field])
    for name in ("velx", "vely", "velz"):
        assert np.max(np.abs(np.asarray(out["compressive"][name]))) < 1e-12
    out = vel_ops.helmholtz_decompose(*[jnp.asarray(v) for v in phi_grad])
    np.testing.assert_allclose(
        np.asarray(out["compressive"]["velx"]), phi_grad[0], rtol=1e-9, atol=1e-12
    )


@pytest.mark.parametrize("shape", [(16, 16, 16), (16, 12, 8)])
@pytest.mark.parametrize("lengths", [None, (1.0, 2.0, 0.5)])
def test_vorticity_and_dilatation_match_oracle(shape, lengths):
    vels = _fields(shape, 3)
    got = vel_ops.vorticity(*[jnp.asarray(v) for v in vels], lengths=lengths)
    ref = oracle.vorticity_oracle(vels, lengths)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(np.asarray(g), r, rtol=1e-9, atol=1e-9)
    got_d = vel_ops.dilatation(*[jnp.asarray(v) for v in vels], lengths=lengths)
    np.testing.assert_allclose(
        np.asarray(got_d), oracle.dilatation_oracle(vels, lengths), rtol=1e-9, atol=1e-9
    )


def test_dilatation_of_solenoidal_field_is_zero():
    n = 16
    x = np.arange(n) / n
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    # v = curl of a potential -> exactly divergence-free
    vels = [
        np.sin(2 * np.pi * Y) + np.cos(2 * np.pi * Z),
        np.sin(2 * np.pi * Z),
        np.cos(2 * np.pi * X),
    ]
    d = np.asarray(vel_ops.dilatation(*[jnp.asarray(v) for v in vels]))
    assert np.max(np.abs(d)) < 1e-12


@pytest.mark.parametrize("shape", [(16, 16, 16), (16, 12, 8), (8, 8, 9)])
def test_enstrophy_spectrum_matches_oracle(shape):
    vels = _fields(shape, 4)
    got = vel_ops.enstrophy_spectrum(*[jnp.asarray(v) for v in vels])
    ref = oracle.enstrophy_spectrum_oracle(vels)
    np.testing.assert_allclose(got["k"], ref["k"])
    np.testing.assert_allclose(got["power"], ref["power"], rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("lengths", [None, (2.0, 1.0, 1.5)])
def test_helicity_spectrum_matches_oracle(lengths):
    vels = _fields((16, 12, 8), 5)
    got = vel_ops.helicity_spectrum(*[jnp.asarray(v) for v in vels], lengths=lengths)
    ref = oracle.helicity_spectrum_oracle(vels, lengths)
    np.testing.assert_allclose(got["power"], ref["power"], rtol=1e-9, atol=1e-12)
    # Helicity is signed: a generic random field must produce both signs.
    finite = got["power"][np.isfinite(got["power"])]
    assert (finite > 0).any() and (finite < 0).any()


@pytest.mark.parametrize("shape", [(16, 16, 16), (16, 12, 8)])
@pytest.mark.parametrize("lengths", [None, (2.0, 1.0, 1.5)])
@pytest.mark.parametrize("dealias", [False, True])
def test_transfer_spectrum_matches_oracle(shape, lengths, dealias):
    vels = _fields(shape, 6)
    got = vel_ops.transfer_spectrum(
        *[jnp.asarray(v) for v in vels], lengths=lengths, dealias=dealias
    )
    ref = oracle.transfer_spectrum_oracle(vels, lengths, dealias=dealias)
    np.testing.assert_allclose(got["k"], ref["k"])
    np.testing.assert_allclose(got["transfer"], ref["transfer"], rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(got["flux"], ref["flux"], rtol=1e-9, atol=1e-11)


def _band_limited_solenoidal(n=16, kmax=2.0, seed=5):
    """Random solenoidal field with modes only inside |k| <= kmax:
    alias-free products, no shells beyond the binning range, and ACTIVE
    triads (e.g. (1,0,0)+(0,1,0)=(1,1,0) all in support) — unlike
    Taylor-Green, whose t=0 advection term is disjoint from the
    velocity support and transfers nothing instantaneously."""
    rng = np.random.default_rng(seed)
    k1 = np.fft.fftfreq(n, 1.0 / n)
    KX, KY, KZ = np.meshgrid(k1, k1, k1, indexing="ij")
    k2 = KX**2 + KY**2 + KZ**2
    mask = np.sqrt(k2) <= kmax
    vh = [np.fft.fftn(rng.standard_normal((n, n, n))) * mask for _ in range(3)]
    div = (KX * vh[0] + KY * vh[1] + KZ * vh[2]) / np.maximum(k2, 1e-300)
    vh = [w - k * div for w, k in zip(vh, (KX, KY, KZ))]
    return [np.fft.ifftn(w).real for w in vh]


def test_transfer_conserves_energy_for_band_limited_solenoidal_flow():
    """Band-limited (|k| <= 2) solenoidal field on n=16: products reach
    |k| <= 4 — no aliasing, no truncated shells — so the
    conservative-form transfer must sum to ZERO (the nonlinear term
    only redistributes energy). The discrete spectral identities make
    this exact to f64 roundoff, not just truncation error — and the
    per-shell transfer is genuinely NONZERO, so the zero sum is a
    cancellation, not an absence."""
    vels = _band_limited_solenoidal()
    out = vel_ops.transfer_spectrum(*[jnp.asarray(v) for v in vels])
    tmax = np.abs(out["transfer"]).max()
    assert tmax > 1e-6  # real inter-shell exchange
    assert abs(out["transfer"].sum()) < 1e-12 * tmax
    # Flux telescopes: the final cumulative flux is the (zero) total.
    assert abs(out["flux"][-1]) < 1e-12 * tmax
    np.testing.assert_allclose(out["flux"], -np.cumsum(out["transfer"]), rtol=1e-12)


def test_transfer_dealiased_conserves_for_full_spectrum_solenoidal_field():
    """A solenoidal field with energy at ALL wavenumbers (not band
    limited): dealias=True must (a) remove the aliased triads and
    (b) extend the shell range over the kept corner modes
    (|k| up to ~0.577 n > n/2 - 1.5) — dropping them would fake a flux
    sink of order max|T| at high k. With both, Σ T(k) = 0 to roundoff."""
    n = 16
    vels = _band_limited_solenoidal(n=n, kmax=100.0, seed=9)  # full spectrum
    out = vel_ops.transfer_spectrum(*[jnp.asarray(v) for v in vels], dealias=True)
    from fava_tpu.ops.velocity import dealiased_nbins

    assert out["transfer"].shape == (dealiased_nbins((n, n, n)),)
    tmax = np.abs(out["transfer"]).max()
    assert tmax > 1e-6
    assert abs(out["transfer"].sum()) < 1e-11 * tmax
    assert abs(out["flux"][-1]) < 1e-11 * tmax


def test_transfer_of_beltrami_flow_vanishes_shell_by_shell():
    """ABC flow: omega = v, so (u.grad)u = grad(|u|^2/2) - u x omega is
    a PURE gradient — its projection onto the solenoidal v-hat vanishes
    for every k, making T(k) = 0 shell by shell (not just in sum)."""
    n = 16
    x = 2 * np.pi * np.arange(n) / n
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    vels = [
        np.sin(Z) + np.cos(Y),
        np.sin(X) + np.cos(Z),
        np.sin(Y) + np.cos(X),
    ]
    out = vel_ops.transfer_spectrum(*[jnp.asarray(v) for v in vels])
    assert np.abs(out["transfer"]).max() < 1e-13
    assert np.abs(out["flux"]).max() < 1e-13


def test_transfer_2d_matches_oracle_and_conserves():
    rng = np.random.default_rng(33)
    vels = [rng.standard_normal((16, 12)) for _ in range(2)]
    got = vel_ops.transfer_spectrum(*[jnp.asarray(v) for v in vels], dealias=True)
    ref = oracle.transfer_spectrum_oracle(vels, dealias=True)
    np.testing.assert_allclose(got["transfer"], ref["transfer"], rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(got["flux"], ref["flux"], rtol=1e-9, atol=1e-11)

    # 2D Taylor-Green: band-limited solenoidal -> zero total transfer.
    n = 16
    x = 2 * np.pi * np.arange(n) / n
    X, Y = np.meshgrid(x, x, indexing="ij")
    tg = [np.cos(X) * np.sin(Y), -np.sin(X) * np.cos(Y)]
    out = vel_ops.transfer_spectrum(*[jnp.asarray(v) for v in tg])
    assert abs(out["transfer"].sum()) < 1e-13


def test_beltrami_field_maximal_helicity():
    # ABC (Beltrami) flow on the 2*pi box: curl v = v, so shell by
    # shell H(k) = Re(v̂*.v̂) = |v̂|² = 2 * (0.5 |ω̂|²) — the helicity
    # spectrum is exactly twice the enstrophy spectrum.
    n = 16
    x = 2 * np.pi * np.arange(n) / n
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    A = B = C = 1.0
    vels = [
        A * np.sin(Z) + C * np.cos(Y),
        B * np.sin(X) + A * np.cos(Z),
        C * np.sin(Y) + B * np.cos(X),
    ]
    hel = vel_ops.helicity_spectrum(*[jnp.asarray(v) for v in vels])
    ens = vel_ops.enstrophy_spectrum(*[jnp.asarray(v) for v in vels])
    mask = np.isfinite(hel["power"]) & (ens["power"] > 1e-20)
    np.testing.assert_allclose(hel["power"][mask], 2.0 * ens["power"][mask], rtol=1e-9)


def test_mesh_methods_and_registration(uniform_file):
    """Mesh-level wrappers pass the PHYSICAL domain lengths and are
    registered as model analyses."""
    import fava_tpu
    from fava_tpu.mesh import FlashUniform

    mesh = FlashUniform(uniform_file)
    mesh.load()
    lengths = mesh._domain_lengths()
    vels = [np.asarray(mesh.data(f"vel{a}")) for a in "xyz"]
    vels = [v[0] if v.ndim == 4 else v for v in vels]

    out = mesh.helmholtz_decomposition()
    sol_ref, comp_ref = oracle.helmholtz_oracle(vels, lengths)
    for i, name in enumerate(("velx", "vely", "velz")):
        np.testing.assert_allclose(out["compressive"][name], comp_ref[i], rtol=1e-9, atol=1e-10)

    vort = mesh.vorticity()
    vort_ref = oracle.vorticity_oracle(vels, lengths)
    np.testing.assert_allclose(vort["vorty"], vort_ref[1], rtol=1e-9, atol=1e-9)

    dil = mesh.dilatation()["dilatation"]
    np.testing.assert_allclose(dil, oracle.dilatation_oracle(vels, lengths), rtol=1e-9, atol=1e-9)

    ens = mesh.enstrophy_spectra()
    np.testing.assert_allclose(
        ens["power"], oracle.enstrophy_spectrum_oracle(vels, lengths)["power"], rtol=1e-9
    )
    hel = mesh.helicity_spectra()
    np.testing.assert_allclose(
        hel["power"], oracle.helicity_spectrum_oracle(vels, lengths)["power"], rtol=1e-9, atol=1e-12
    )

    tr = mesh.transfer_spectra()
    tr_ref = oracle.transfer_spectrum_oracle(vels, lengths)
    np.testing.assert_allclose(tr["transfer"], tr_ref["transfer"], rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(tr["flux"], tr_ref["flux"], rtol=1e-9, atol=1e-11)

    # Registered on the model (analysis registry).
    m = fava_tpu.FLASH(uniform_file.parent)
    m.load(file_type="uni")
    out2 = m.enstrophy_spectra()
    np.testing.assert_allclose(out2["power"], ens["power"], rtol=1e-12, atol=1e-30)
    for name in (
        "helmholtz_decomposition",
        "vorticity",
        "dilatation",
        "helicity_spectra",
        "transfer_spectra",
    ):
        assert hasattr(m, name)


@pytest.mark.parametrize("shape", [(16, 16), (16, 12), (8, 9)])
def test_2d_diagnostics_match_oracle(shape):
    rng = np.random.default_rng(31)
    vels = [rng.standard_normal(shape) for _ in range(2)]
    jv = [jnp.asarray(v) for v in vels]

    out = vel_ops.helmholtz_decompose(*jv)
    sol_ref, comp_ref = oracle.helmholtz_oracle(vels)
    for i, name in enumerate(("velx", "vely")):
        np.testing.assert_allclose(
            np.asarray(out["compressive"][name]), comp_ref[i], rtol=1e-9, atol=1e-10
        )
    assert set(out["solenoidal"]) == {"velx", "vely"}

    w = vel_ops.vorticity(*jv, lengths=(2.0, 3.0))
    ref_w = oracle.vorticity_2d_oracle(vels, (2.0, 3.0))
    np.testing.assert_allclose(np.asarray(w), ref_w, rtol=1e-9, atol=1e-9)

    d = vel_ops.dilatation(*jv)
    np.testing.assert_allclose(
        np.asarray(d), oracle.dilatation_oracle(vels), rtol=1e-9, atol=1e-9
    )

    ens = vel_ops.enstrophy_spectrum(*jv)
    ref = oracle.enstrophy_spectrum_2d_oracle(vels)
    np.testing.assert_allclose(ens["power"], ref["power"], rtol=1e-9, atol=1e-12)


def test_2d_component_count_validation():
    v2 = jnp.zeros((8, 8))
    v3 = jnp.zeros((8, 8, 8))
    with pytest.raises(ValueError):
        vel_ops.helmholtz_decompose(v2, v2, v2)  # 2D arrays, 3 components
    with pytest.raises(ValueError):
        vel_ops.vorticity(v3, v3)  # 3D arrays, 2 components
    with pytest.raises(ValueError):
        vel_ops.helicity_spectrum(v2, v2, v2)  # helicity vanishes in 2D


def test_diagnostics_sharded_inputs_match_unsharded(uniform_file_32, eight_device_mesh):
    """Under an active device mesh the uniform volumes arrive
    slab-sharded; the diagnostics run the same jitted programs and
    GSPMD must partition them without changing the numbers."""
    from fava_tpu.mesh import FlashUniform
    from fava_tpu.parallel import use_mesh

    mesh0 = FlashUniform(uniform_file_32)
    mesh0.load()
    ref_ens = mesh0.enstrophy_spectra()
    ref_hel = mesh0.helicity_spectra()
    ref_hd = mesh0.helmholtz_decomposition()
    ref_tr = mesh0.transfer_spectra()

    with use_mesh(eight_device_mesh):
        mesh1 = FlashUniform(uniform_file_32)
        mesh1.load()
        assert len(mesh1.data("velx").sharding.device_set) == 8
        got_ens = mesh1.enstrophy_spectra()
        got_hel = mesh1.helicity_spectra()
        got_hd = mesh1.helmholtz_decomposition()
        got_tr = mesh1.transfer_spectra()

    np.testing.assert_allclose(got_ens["power"], ref_ens["power"], rtol=1e-9, atol=1e-20)
    np.testing.assert_allclose(got_tr["transfer"], ref_tr["transfer"], rtol=1e-9, atol=1e-14)
    np.testing.assert_allclose(got_hel["power"], ref_hel["power"], rtol=1e-9, atol=1e-20)
    for part in ("solenoidal", "compressive"):
        for name in ("velx", "vely", "velz"):
            np.testing.assert_allclose(
                got_hd[part][name], ref_hd[part][name], rtol=1e-9, atol=1e-12
            )


def test_shape_validation():
    v2 = jnp.zeros((8, 8))
    with pytest.raises(ValueError):
        vel_ops.helmholtz_decompose(v2, v2, v2)
    with pytest.raises(ValueError):
        vel_ops.vorticity(v2, v2, v2)
    with pytest.raises(ValueError):
        vel_ops.enstrophy_spectrum(v2, v2, v2)
    v3 = jnp.zeros((4, 4, 4))
    with pytest.raises(ValueError):
        vel_ops.dilatation(v3, v3, v3, lengths=(1.0, 2.0))
    # Broadcast-compatible component mismatch (e.g. an unsqueezed
    # quasi-2D velz) must fail fast, not silently broadcast.
    with pytest.raises(ValueError, match="component 2"):
        vel_ops.helmholtz_decompose(v3, v3, jnp.zeros((4, 4, 1)))
    # Per-cell gamma must match the volumes (scalars are fine).
    ones = jnp.ones((4, 4, 4))
    with pytest.raises(ValueError, match="gamma shape"):
        vel_ops.turbulence_summary(
            v3, v3, v3, dens=ones, pres=ones, gamma=jnp.ones((4, 4, 1))
        )


def test_turbulence_summary_scalar_gamma_not_materialized():
    # A scalar gamma stays 0-d into the jit (no n^3 broadcast on
    # device) and matches the oracle's scalar-gamma result.
    rng = np.random.default_rng(47)
    shape = (8, 8, 8)
    vels = [rng.standard_normal(shape) for _ in range(3)]
    dens = 1.5 + 0.4 * rng.random(shape)
    pres = 2.0 + rng.random(shape)
    got = vel_ops.turbulence_summary(
        *[jnp.asarray(v) for v in vels],
        dens=jnp.asarray(dens),
        pres=jnp.asarray(pres),
        gamma=1.4,
    )
    ref = oracle.turbulence_summary_oracle(vels, dens, pres, 1.4)
    for name in ("mach_rms", "mach_max", "sound_speed_mean"):
        np.testing.assert_allclose(got[name], ref[name], rtol=1e-9, err_msg=name)


@pytest.mark.parametrize("shape", [(16, 16, 16), (16, 12, 8)])
@pytest.mark.parametrize("weighted", [False, True])
def test_decomposed_spectra_match_oracle_and_sum_exactly(shape, weighted):
    rng = np.random.default_rng(41)
    vels = [rng.standard_normal(shape) for _ in range(3)]
    dens = 1.5 + 0.4 * rng.random(shape) if weighted else None
    got = vel_ops.decomposed_ke_spectra(
        *[jnp.asarray(v) for v in vels],
        dens=None if dens is None else jnp.asarray(dens),
    )
    ref = oracle.decomposed_ke_spectra_oracle(vels, dens)
    for name in ("total", "solenoidal", "compressive"):
        np.testing.assert_allclose(got[name], ref[name], rtol=1e-9, atol=1e-12)
    # Pointwise-orthogonal split: exact shell-by-shell budget.
    np.testing.assert_allclose(
        got["total"], got["solenoidal"] + got["compressive"], rtol=1e-12, atol=1e-14
    )


def test_decomposed_spectra_consistent_with_helmholtz_fields():
    # Binning the spectra of helmholtz_decompose's OUTPUT fields must
    # reproduce the k-space-projected record (same k=0/Nyquist rules).
    shape = (16, 16, 16)
    rng = np.random.default_rng(42)
    vels = [rng.standard_normal(shape) for _ in range(3)]
    got = vel_ops.decomposed_ke_spectra(*[jnp.asarray(v) for v in vels])
    hd = vel_ops.helmholtz_decompose(*[jnp.asarray(v) for v in vels])
    names = ("velx", "vely", "velz")
    sol = [np.asarray(hd["solenoidal"][n]) for n in names]
    comp = [np.asarray(hd["compressive"][n]) for n in names]
    ref_sol = oracle.decomposed_ke_spectra_oracle(sol, None)["total"]
    ref_comp = oracle.decomposed_ke_spectra_oracle(comp, None)["total"]
    np.testing.assert_allclose(got["solenoidal"], ref_sol, rtol=1e-9, atol=1e-13)
    np.testing.assert_allclose(got["compressive"], ref_comp, rtol=1e-9, atol=1e-13)


def test_decomposed_spectra_pure_modes():
    # A divergence-free mode is all-solenoidal; a gradient mode is
    # all-compressive (beyond k = 0).
    n = 16
    x = np.arange(n) / n
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    z = np.zeros_like(X)
    sol_field = [np.sin(2 * np.pi * Y), z, z]
    grad_field = [np.sin(4 * np.pi * X), z, z]
    out = vel_ops.decomposed_ke_spectra(*[jnp.asarray(v) for v in sol_field])
    assert np.nanmax(out["compressive"]) < 1e-14
    assert np.nansum(out["solenoidal"]) > 0
    out = vel_ops.decomposed_ke_spectra(*[jnp.asarray(v) for v in grad_field])
    assert np.nanmax(out["solenoidal"]) < 1e-14
    assert np.nansum(out["compressive"]) > 0


def test_decomposed_spectra_2d_and_validation():
    shape = (16, 12)
    rng = np.random.default_rng(43)
    vels = [rng.standard_normal(shape) for _ in range(2)]
    got = vel_ops.decomposed_ke_spectra(*[jnp.asarray(v) for v in vels])
    ref = oracle.decomposed_ke_spectra_oracle(vels, None)
    for name in ("total", "solenoidal", "compressive"):
        np.testing.assert_allclose(got[name], ref[name], rtol=1e-9, atol=1e-13)
    with pytest.raises(ValueError, match="dens shape"):
        vel_ops.decomposed_ke_spectra(
            *[jnp.asarray(v) for v in vels], dens=jnp.zeros((4, 4))
        )


def test_decomposed_spectra_mesh_and_registration(uniform_file):
    import fava_tpu
    from fava_tpu.mesh import FlashUniform

    mesh = FlashUniform(uniform_file)
    mesh.load()
    vels = [np.asarray(mesh.data(f"vel{a}")) for a in "xyz"]
    vels = [v[0] if v.ndim == 4 else v for v in vels]
    dens = np.asarray(mesh.data("dens"))
    dens = dens[0] if dens.ndim == 4 else dens
    got = mesh.decomposed_kinetic_energy_spectra(weighted=True)
    ref = oracle.decomposed_ke_spectra_oracle(vels, dens, mesh._domain_lengths())
    np.testing.assert_allclose(got["solenoidal"], ref["solenoidal"], rtol=1e-9)
    m = fava_tpu.FLASH(uniform_file.parent)
    m.load(file_type="uni")
    assert hasattr(m, "decomposed_kinetic_energy_spectra")
    got2 = m.decomposed_kinetic_energy_spectra()
    np.testing.assert_allclose(
        got2["total"], oracle.decomposed_ke_spectra_oracle(vels, None, mesh._domain_lengths())["total"], rtol=1e-9
    )


@pytest.mark.parametrize("shape,nd", [((16, 12, 8), 3), ((16, 12), 2)])
def test_anisotropic_spectra_match_oracle_every_axis(shape, nd):
    rng = np.random.default_rng(44)
    vels = [rng.standard_normal(shape) for _ in range(nd)]
    for axis in range(nd):
        got = vel_ops.anisotropic_ke_spectra(
            *[jnp.asarray(v) for v in vels], axis=axis
        )
        ref = oracle.anisotropic_ke_spectra_oracle(vels, axis=axis)
        for name in (
            "par_total", "par_axial", "par_transverse",
            "perp_total", "perp_axial", "perp_transverse",
        ):
            np.testing.assert_allclose(
                got[name], ref[name], rtol=1e-9, atol=1e-13, err_msg=f"axis {axis} {name}"
            )
        # Energy-exact: both records sum to the Parseval total.
        ke = 0.5 * sum(np.mean(v**2) for v in vels)
        np.testing.assert_allclose(np.sum(got["par_total"]), ke, rtol=1e-10)
        np.testing.assert_allclose(np.sum(got["perp_total"]), ke, rtol=1e-10)
        np.testing.assert_allclose(
            got["par_total"], got["par_axial"] + got["par_transverse"], rtol=1e-12
        )


def test_anisotropic_spectra_pure_modes_and_validation():
    # A single k_x mode of vely: all its parallel power sits in the
    # k_par=2 bin and the transverse record; perpendicular power sits
    # entirely at k_perp=0 (no perpendicular variation).
    n = 16
    x = np.arange(n) / n
    X = np.meshgrid(x, x, x, indexing="ij")[0]
    z = np.zeros((n, n, n))
    out = vel_ops.anisotropic_ke_spectra(
        jnp.asarray(z), jnp.asarray(np.sin(4 * np.pi * X)), jnp.asarray(z), axis=0
    )
    assert np.argmax(out["par_total"]) == 2
    np.testing.assert_allclose(np.sum(out["par_axial"]), 0.0, atol=1e-15)
    np.testing.assert_allclose(out["par_total"][2], 0.25, rtol=1e-12)  # 0.5*<sin^2>
    assert np.argmax(out["perp_total"]) == 0
    np.testing.assert_allclose(np.sum(out["perp_total"][1:]), 0.0, atol=1e-15)
    with pytest.raises(ValueError, match="axis"):
        vel_ops.anisotropic_ke_spectra(jnp.asarray(z), jnp.asarray(z), jnp.asarray(z), axis=3)


def test_anisotropic_spectra_mesh_and_registration(uniform_file):
    import fava_tpu
    from fava_tpu.mesh import FlashUniform

    mesh = FlashUniform(uniform_file)
    mesh.load()
    vels = [np.asarray(mesh.data(f"vel{a}")) for a in "xyz"]
    vels = [v[0] if v.ndim == 4 else v for v in vels]
    got = mesh.anisotropic_kinetic_energy_spectra(axis=1)
    ref = oracle.anisotropic_ke_spectra_oracle(vels, axis=1)
    np.testing.assert_allclose(got["perp_total"], ref["perp_total"], rtol=1e-9)
    m = fava_tpu.FLASH(uniform_file.parent)
    m.load(file_type="uni")
    got2 = m.anisotropic_kinetic_energy_spectra()
    np.testing.assert_allclose(
        got2["par_total"], oracle.anisotropic_ke_spectra_oracle(vels, axis=0)["par_total"], rtol=1e-9
    )


def test_turbulence_summary_single_mode_identities():
    # u = sin(2*pi*k0*y) x-hat on the unit box: every output has a
    # closed form.
    n, k0 = 32, 3
    y = np.arange(n) / n
    Y = np.meshgrid(y, y, y, indexing="ij")[1]
    vx, z = np.sin(2 * np.pi * k0 * Y), np.zeros((n, n, n))
    out = vel_ops.turbulence_summary(
        jnp.asarray(vx), jnp.asarray(z), jnp.asarray(z), lengths=(1.0, 1.0, 1.0)
    )
    kp = 2 * np.pi * k0
    np.testing.assert_allclose(out["u_rms"], np.sqrt(0.5), rtol=1e-12)
    np.testing.assert_allclose(out["integral_scale"], (3 * np.pi / 4) / kp, rtol=1e-12)
    np.testing.assert_allclose(out["taylor_scale"], np.sqrt(5.0) / kp, rtol=1e-12)
    np.testing.assert_allclose(out["compressive_fraction"], 0.0, atol=1e-14)
    np.testing.assert_allclose(out["vorticity_rms"], kp * np.sqrt(0.5), rtol=1e-12)
    np.testing.assert_allclose(out["dilatation_rms"], 0.0, atol=1e-12)
    # The same mode along its own direction is fully compressive.
    X = np.meshgrid(y, y, y, indexing="ij")[0]
    out2 = vel_ops.turbulence_summary(
        jnp.asarray(np.sin(2 * np.pi * k0 * X)), jnp.asarray(z), jnp.asarray(z)
    )
    np.testing.assert_allclose(out2["compressive_fraction"], 1.0, rtol=1e-12)
    np.testing.assert_allclose(out2["vorticity_rms"], 0.0, atol=1e-12)


@pytest.mark.parametrize("shape,nd", [((16, 12, 8), 3), ((16, 12), 2)])
def test_turbulence_summary_matches_oracle(shape, nd):
    rng = np.random.default_rng(46)
    vels = [rng.standard_normal(shape) for _ in range(nd)]
    dens = 1.5 + 0.4 * rng.random(shape)
    pres = 2.0 + rng.random(shape)
    gamc = 1.3 + 0.2 * rng.random(shape)
    got = vel_ops.turbulence_summary(
        *[jnp.asarray(v) for v in vels],
        dens=jnp.asarray(dens),
        pres=jnp.asarray(pres),
        gamma=jnp.asarray(gamc),
        lengths=tuple(0.5 * (i + 1) for i in range(nd)),
    )
    ref = oracle.turbulence_summary_oracle(
        vels, dens, pres, gamc, lengths=tuple(0.5 * (i + 1) for i in range(nd))
    )
    assert set(got) == set(ref)
    for name, val in ref.items():
        np.testing.assert_allclose(got[name], val, rtol=1e-9, err_msg=name)


def test_turbulence_summary_validation():
    v = jnp.zeros((8, 8, 8))
    with pytest.raises(ValueError, match="BOTH pres and dens"):
        vel_ops.turbulence_summary(v, v, v, pres=v)
    with pytest.raises(ValueError, match="dens shape"):
        vel_ops.turbulence_summary(v, v, v, dens=jnp.zeros((4, 4, 4)))


def test_turbulence_summary_mesh_and_registration(tmp_path):
    import fava_tpu
    from fava_tpu.io import synthetic
    from fava_tpu.mesh import FlashUniform

    path = synthetic.make_uniform_file(
        tmp_path / "rt_hdf5_uniform_0001",
        ncells=(16, 16, 16),
        fields=("dens", "velx", "vely", "velz", "pres", "gamc"),
        seed=3,
    )
    mesh = FlashUniform(path)
    mesh.load()
    got = mesh.turbulence_summary()
    assert "mach_rms" in got and got["mach_rms"] > 0
    grab = lambda n: (lambda v: v[0] if v.ndim == 4 else v)(np.asarray(mesh.data(n)))
    ref = oracle.turbulence_summary_oracle(
        [grab(f"vel{a}") for a in "xyz"],
        grab("dens"),
        grab("pres"),
        grab("gamc"),
        lengths=mesh._domain_lengths(),
    )
    for name, val in ref.items():
        np.testing.assert_allclose(got[name], val, rtol=1e-9, err_msg=name)
    m = fava_tpu.FLASH(tmp_path)
    m.load(file_type="uni")
    assert hasattr(m, "turbulence_summary")
    out = m.turbulence_summary()
    np.testing.assert_allclose(out["taylor_scale"], ref["taylor_scale"], rtol=1e-9)
