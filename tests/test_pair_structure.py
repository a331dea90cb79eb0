"""Particle-pair structure functions: same-draw NumPy oracle and a
uniform-shear closed form (beyond the reference)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fava_tpu.ops.structure import pair_bin_edges, pair_indices, pair_structure_functions


def _oracle(pos, vel, lo, hi, nbins, orders, num_pairs, seed, lengths=None):
    """f64 NumPy on the SAME device PRNG draws, binning r^2 against the
    SAME squared f64 edges the device compares against (two-float)."""
    n = pos.shape[0]
    idx = np.asarray(pair_indices(seed, num_pairs, n))
    dr = pos[idx[1]].astype(np.float64) - pos[idx[0]].astype(np.float64)
    if lengths is not None:
        L = np.asarray(lengths, dtype=np.float64)
        dr = dr - L * np.round(dr / L)
    r2 = (dr**2).sum(axis=-1)
    r = np.sqrt(r2)
    dv = vel[idx[1]] - vel[idx[0]]
    dl = np.abs((dv * dr).sum(axis=-1) / np.maximum(r, 1e-30))
    dt = np.sqrt(np.maximum((dv**2).sum(axis=-1) - dl**2, 0.0))
    e2 = pair_bin_edges(lo, hi, nbins, log_bins=True) ** 2
    bidx = (r2[:, None] >= e2[None, 1:nbins]).sum(axis=1)
    mask = (r2 >= e2[0]) & (r2 <= e2[nbins])
    out = {"longitudinal": {}, "transverse": {}}
    counts = np.bincount(bidx[mask], minlength=nbins)[:nbins].astype(np.float64)
    out["counts"] = counts
    safe = np.maximum(counts, 1)
    out["separations"] = np.where(
        counts > 0, np.bincount(bidx[mask], weights=r[mask], minlength=nbins)[:nbins] / safe, np.nan
    )
    for o in range(1, orders + 1):
        sl = np.bincount(bidx[mask], weights=dl[mask] ** o, minlength=nbins)[:nbins]
        st = np.bincount(bidx[mask], weights=dt[mask] ** o, minlength=nbins)[:nbins]
        out["longitudinal"][f"{o}"] = np.where(counts > 0, sl / safe, np.nan)
        out["transverse"][f"{o}"] = np.where(counts > 0, st / safe, np.nan)
    return out


@pytest.mark.parametrize("periodic", [False, True])
def test_matches_same_draw_oracle(periodic):
    rng = np.random.default_rng(51)
    n = 512
    pos = rng.random((n, 3))
    vel = rng.standard_normal((n, 3))
    lengths = (1.0, 1.0, 1.0) if periodic else None
    got = pair_structure_functions(
        pos, vel, num_pairs=4096, nbins=8, sep_bounds=(0.05, 0.5),
        orders=4, lengths=lengths, seed=3,
    )
    ref = _oracle(pos, vel, 0.05, 0.5, 8, 4, 4096, 3, lengths)
    np.testing.assert_allclose(got["counts"], ref["counts"])
    np.testing.assert_allclose(got["separations"], ref["separations"], rtol=1e-9)
    for o in ("1", "2", "3", "4"):
        np.testing.assert_allclose(
            got["longitudinal"][o], ref["longitudinal"][o], rtol=1e-9, err_msg=o
        )
        np.testing.assert_allclose(
            got["transverse"][o], ref["transverse"][o], rtol=1e-8, atol=1e-12, err_msg=o
        )


@pytest.mark.parametrize("periodic", [False, True])
def test_f32_counts_exactly_match_f64_oracle(periodic):
    """The two-float binning contract: with FLOAT32 inputs (the device
    production dtype) bin membership must still match the f64 oracle
    exactly — single-f32 distances measurably flip pairs across edges
    at this pair count (1.1e-4 scaled)."""
    rng = np.random.default_rng(61)
    n = 4096
    pos32 = rng.random((n, 3), dtype=np.float32)
    vel32 = rng.standard_normal((n, 3)).astype(np.float32)
    lengths = (1.0, 1.0, 1.0) if periodic else None
    got = pair_structure_functions(
        jnp.asarray(pos32), jnp.asarray(vel32),
        num_pairs=65536, nbins=8, sep_bounds=(0.05, 0.5),
        orders=2, lengths=lengths, seed=7,
    )
    ref = _oracle(
        pos32.astype(np.float64), vel32.astype(np.float64),
        0.05, 0.5, 8, 2, 65536, 7, lengths,
    )
    np.testing.assert_array_equal(got["counts"], ref["counts"])
    np.testing.assert_allclose(got["longitudinal"]["2"], ref["longitudinal"]["2"], rtol=2e-5)


def test_uniform_expansion_closed_form():
    # Hubble-like flow v = H x: du_L = H * r exactly and the transverse
    # increment vanishes, so S_p^L(r) = (H r)^p bin by bin.
    rng = np.random.default_rng(52)
    n, H = 1024, 2.5
    pos = rng.random((n, 3))
    vel = H * pos
    got = pair_structure_functions(
        pos, vel, num_pairs=8192, nbins=6, sep_bounds=(0.1, 0.8), orders=2, seed=1
    )
    fin = got["counts"] > 0
    np.testing.assert_allclose(
        got["longitudinal"]["1"][fin],
        H * np.asarray(got["separations"])[fin],
        rtol=1e-6,
    )
    np.testing.assert_allclose(got["transverse"]["2"][fin], 0.0, atol=1e-12)


def test_validation_and_mesh(particle_file):
    import fava_tpu

    with pytest.raises(ValueError, match="matching"):
        pair_structure_functions(np.ones((8, 3)), np.ones((8, 2)))
    with pytest.raises(ValueError, match="sep_bounds"):
        pair_structure_functions(np.ones((8, 3)), np.ones((8, 3)), sep_bounds=(0.5, 0.1))

    m = fava_tpu.FLASH(particle_file.parent)
    m.load(file_type="prt")
    out = m.particle_structure_functions(num_pairs=2048, nbins=6, orders=3)
    assert set(out["longitudinal"]) == {"1", "2", "3"}
    assert np.isfinite(out["separations"][out["counts"] > 0]).all()

    m2 = fava_tpu.FLASH(particle_file.parent)
    with pytest.raises(AttributeError, match="prt"):
        m2.particle_structure_functions()
