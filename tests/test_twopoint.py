"""Spatial two-point correlations: brute-force roll oracles and
closed-form single-mode identities (beyond the reference)."""

import jax.numpy as jnp
import numpy as np
import pytest

from fava_tpu.ops import twopoint as tp


def _brute_line(g, axis):
    gm = g.astype(np.float64) - g.astype(np.float64).mean()
    return np.array(
        [np.mean(gm * np.roll(gm, -r, axis=axis)) for r in range(g.shape[axis])]
    )


@pytest.mark.parametrize("shape", [(16, 12, 8), (16, 12)])
def test_scalar_lines_match_brute_force(shape):
    rng = np.random.default_rng(5)
    f = rng.standard_normal(shape)
    got = tp.two_point_correlation(jnp.asarray(f))
    for a, ax in enumerate("xyz"[: len(shape)]):
        n = shape[a]
        ref = _brute_line(f, a)[: n // 2 + 1]
        np.testing.assert_allclose(
            got[f"R_{ax}"] * got["variance"], ref, rtol=1e-9, atol=1e-12
        )
    np.testing.assert_allclose(got["variance"], np.var(f), rtol=1e-10)
    np.testing.assert_allclose(got["R_shell"][0], 1.0, rtol=1e-10)


def test_shell_average_matches_brute_force():
    rng = np.random.default_rng(6)
    shape = (8, 8, 8)
    f = rng.standard_normal(shape)
    fm = f - f.mean()
    R = np.zeros(shape)
    for i in range(8):
        for j in range(8):
            for k in range(8):
                R[i, j, k] = np.mean(
                    fm * np.roll(np.roll(np.roll(fm, -i, 0), -j, 1), -k, 2)
                )
    d = np.minimum(np.arange(8), 8 - np.arange(8)).astype(np.float64)
    r_abs = np.sqrt(
        d[:, None, None] ** 2 + d[None, :, None] ** 2 + d[None, None, :] ** 2
    )
    nb = 4
    idx = np.clip(np.floor(r_abs + 0.5).astype(int), 0, nb - 1)
    mask = r_abs <= nb - 0.5
    ref = np.array([R[mask & (idx == b)].mean() for b in range(nb)])
    got = tp.two_point_correlation(jnp.asarray(f), nbins=nb)
    np.testing.assert_allclose(got["R_shell"] * got["variance"], ref, rtol=1e-9)


def test_single_mode_closed_form():
    # f = cos(2*pi*k0*x/n): R(r)/R(0) = cos(2*pi*k0*r/n) exactly and
    # the integral scale (to the first zero crossing) is L/(2*pi*k0).
    n, k0 = 64, 3
    x = np.arange(n) / n
    f = np.broadcast_to(np.cos(2 * np.pi * k0 * x)[:, None, None], (n, n, n)).copy()
    got = tp.two_point_correlation(jnp.asarray(f))
    np.testing.assert_allclose(
        got["R_x"], np.cos(2 * np.pi * k0 * np.arange(n // 2 + 1) / n), rtol=1e-8, atol=1e-10
    )
    assert abs(got["integral_scale_x"] - 1.0 / (2 * np.pi * k0)) < 2e-3
    # f does not vary along y: shifting along y changes nothing, so
    # the normalized y-line correlation is identically 1
    np.testing.assert_allclose(got["R_y"], 1.0, rtol=1e-8)


@pytest.mark.parametrize("shape", [(16, 12, 8), (16, 12)])
def test_velocity_correlations_match_brute_force(shape):
    nd = len(shape)
    rng = np.random.default_rng(7)
    vels = [rng.standard_normal(shape) for _ in range(nd)]
    got = tp.velocity_correlations(
        *[jnp.asarray(v) for v in vels], lengths=tuple(0.5 * (i + 1) for i in range(nd))
    )
    for a, ax in enumerate("xyz"[:nd]):
        half = shape[a] // 2 + 1
        fl = _brute_line(vels[a], a)
        np.testing.assert_allclose(
            got[f"f_{ax}"], (fl / fl[0])[:half], rtol=1e-9, atol=1e-12
        )
        gs = [_brute_line(vels[i], a) for i in range(nd) if i != a]
        gn = np.mean([(g / g[0])[:half] for g in gs], axis=0)
        np.testing.assert_allclose(got[f"g_{ax}"], gn, rtol=1e-9, atol=1e-12)
        dx = 0.5 * (a + 1) / shape[a]
        np.testing.assert_allclose(got[f"r_{ax}"][1], dx, rtol=1e-12)
        assert np.isfinite(got[f"L11_{ax}"])
        # raw (unnormalized) line value at r = 0 is the component
        # variance (packed comp-major/axis-minor: one host fetch)
        raw = np.asarray(tp._velocity_corr_fn(shape)(*[jnp.asarray(v) for v in vels]))
        halves = [n // 2 + 1 for n in shape]
        start = a * sum(halves) + sum(halves[:a])
        np.testing.assert_allclose(raw[start], np.var(vels[a]), rtol=1e-9)
        np.testing.assert_allclose(
            got[f"isotropy_ratio_{ax}"], got[f"L11_{ax}"] / (2 * got[f"L22_{ax}"])
        )


def test_integral_scale_helper():
    # R/R0 = 1 - r: crosses zero at r=1 -> integral_0^1 (1-r) dr = 1/2
    # (trapezoid to the last positive sample + interpolated triangle).
    line = np.array([1.0, 0.5, 0.0, -0.5])
    np.testing.assert_allclose(tp._integral_scale(line, 0.5), 0.5)
    # all-positive: trapezoid over the half box
    line2 = np.array([2.0, 1.0, 1.0])
    np.testing.assert_allclose(tp._integral_scale(line2, 1.0), 0.75 + 0.5)
    # degenerate zero-variance line -> nan, not a crash
    assert np.isnan(tp._integral_scale(np.array([0.0, 0.0]), 1.0))


def test_validation_errors():
    with pytest.raises(ValueError, match="2D or 3D"):
        tp.two_point_correlation(jnp.zeros(8))
    with pytest.raises(ValueError, match="lengths"):
        tp.two_point_correlation(jnp.zeros((8, 8)), lengths=(1.0,))
    v = jnp.zeros((8, 8, 8))
    with pytest.raises(ValueError, match="components"):
        tp.velocity_correlations(v, v)
    with pytest.raises(ValueError, match="component 1"):
        tp.velocity_correlations(v, jnp.zeros((8, 8, 1)), v)


def test_mesh_methods_and_registration(uniform_file):
    import fava_tpu
    from fava_tpu.mesh import FlashUniform

    mesh = FlashUniform(uniform_file)
    mesh.load()
    got = mesh.two_point_correlation(field="dens")
    dens = np.asarray(mesh.data("dens"), dtype=np.float64)
    ref = _brute_line(dens, 0)
    np.testing.assert_allclose(
        got["R_x"] * got["variance"], ref[: dens.shape[0] // 2 + 1], rtol=1e-9, atol=1e-12
    )
    vc = mesh.velocity_correlations()
    vx = np.asarray(mesh.data("velx"), dtype=np.float64)
    fl = _brute_line(vx, 0)
    np.testing.assert_allclose(
        vc["f_x"], (fl / fl[0])[: vx.shape[0] // 2 + 1], rtol=1e-9, atol=1e-12
    )

    m = fava_tpu.FLASH(uniform_file.parent)
    m.load(file_type="uni")
    assert hasattr(m, "two_point_correlation")
    assert hasattr(m, "velocity_correlations")
    out = m.two_point_correlation(field="dens", nbins=4)
    assert out["R_shell"].size == 4


def test_sharded_inputs_match_unsharded(uniform_file_32, eight_device_mesh):
    """Slab-sharded volumes under an active device mesh: GSPMD must
    partition the round-3 analysis jits without changing the numbers."""
    from fava_tpu.mesh import FlashUniform
    from fava_tpu.parallel import use_mesh

    mesh0 = FlashUniform(uniform_file_32)
    mesh0.load()
    ref_tp = mesh0.two_point_correlation(field="dens")
    ref_vc = mesh0.velocity_correlations()
    ref_dp = mesh0.density_pdf(nbins=16)
    ref_pm = mesh0.projection(field="dens", axis=0, weight="dens")

    with use_mesh(eight_device_mesh):
        mesh1 = FlashUniform(uniform_file_32)
        mesh1.load()
        assert len(mesh1.data("dens").sharding.device_set) == 8
        got_tp = mesh1.two_point_correlation(field="dens")
        got_vc = mesh1.velocity_correlations()
        got_dp = mesh1.density_pdf(nbins=16)
        got_pm = mesh1.projection(field="dens", axis=0, weight="dens")

    np.testing.assert_allclose(got_tp["R_shell"], ref_tp["R_shell"], rtol=1e-9)
    np.testing.assert_allclose(got_tp["R_x"], ref_tp["R_x"], rtol=1e-9, atol=1e-12)
    for ax in "xyz":
        np.testing.assert_allclose(got_vc[f"f_{ax}"], ref_vc[f"f_{ax}"], rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got_dp["sigma_s"], ref_dp["sigma_s"], rtol=1e-9)
    np.testing.assert_allclose(got_dp["counts"], ref_dp["counts"], rtol=1e-9)
    np.testing.assert_allclose(got_pm["map"], ref_pm["map"], rtol=1e-9)


def test_amr_model_gets_clear_error(amr_file):
    """Spatial correlations on an AMR snapshot must point at from_amr,
    not die with a bare AttributeError (ADVICE r3)."""
    import fava_tpu

    m = fava_tpu.FLASH(amr_file.parent)
    m.load(file_type="plt")
    with pytest.raises(AttributeError, match="from_amr"):
        m.two_point_correlation(field="dens")
    with pytest.raises(AttributeError, match="from_amr"):
        m.velocity_correlations()


def test_registered_correlations_unloaded_model_message():
    import fava_tpu

    m = fava_tpu.FLASH(".")
    with pytest.raises(AttributeError, match="load"):
        m.two_point_correlation()
