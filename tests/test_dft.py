"""Transforms: the jnp.fft wrappers of the in-core paths and the dense
DFT matrices of the streamed path, vs numpy FFTs (float64 on CPU)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fava_tpu.ops import dft
from fava_tpu.ops.velocity import _irfft3, _rfft3

SHAPES = [(8, 8, 8), (16, 12, 8), (8, 8, 9), (4, 16, 6)]


@pytest.mark.parametrize("shape", SHAPES)
def test_rfft3_matches_numpy(shape):
    x = np.random.default_rng(3).standard_normal(shape)
    got = np.asarray(_rfft3(jnp.asarray(x)))
    ref = np.fft.rfftn(x)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("shape", SHAPES)
def test_irfft3_roundtrip_and_numpy(shape):
    """Unnormalized forward -> inverse round-trips (numpy semantics:
    the inverse carries 1/N), odd trailing extents included."""
    x = np.random.default_rng(11).standard_normal(shape)
    spec = np.fft.rfftn(x)
    got = np.asarray(_irfft3(jnp.asarray(spec), shape[-1]))
    ref = np.fft.irfftn(spec, s=shape, axes=(0, 1, 2))
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(got, x, rtol=1e-10, atol=1e-10)


def test_rdft_mats_match_rfft():
    """The real-to-halfcomplex matrices reproduce np.fft.rfft on z."""
    x = np.random.default_rng(7).standard_normal((6, 10, 9))
    cr, ci = dft._rdft_mats(9, "float64")
    re = np.einsum("xyz,zk->xyk", x, cr)
    im = np.einsum("xyz,zk->xyk", x, ci)
    np.testing.assert_allclose(re + 1j * im, np.fft.rfft(x, axis=-1), rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("spec,axis", [("ab,xbz->xaz", 1), ("kx,xyz->kyz", 0)])
def test_planar_complex_matmul_matches_fft(spec, axis):
    """The streamed path's planar complex DFT (both einsum spellings it
    uses) equals np.fft.fft along that axis."""
    rng = np.random.default_rng(19)
    xc = rng.standard_normal((6, 10, 5)) + 1j * rng.standard_normal((6, 10, 5))
    d = dft._dft_mat(xc.shape[axis], "float64")
    re, im = dft.planar_complex_matmul(
        spec, jnp.asarray(d.real), jnp.asarray(d.imag), jnp.asarray(xc.real), jnp.asarray(xc.imag)
    )
    got = np.asarray(re) + 1j * np.asarray(im)
    np.testing.assert_allclose(got, np.fft.fft(xc, axis=axis), rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize(
    "env,expected",
    [
        (None, jax.lax.Precision.HIGHEST),
        ("high", jax.lax.Precision.HIGH),
        ("bogus", ValueError),
    ],
)
def test_dft_precision_setting(monkeypatch, env, expected):
    """FAVA_DFT_PRECISION picks the einsum precision at import; the
    default is HIGHEST (true f32 on the GPU, not TF32)."""
    if env is None:
        monkeypatch.delenv("FAVA_DFT_PRECISION", raising=False)
    else:
        monkeypatch.setenv("FAVA_DFT_PRECISION", env)
    try:
        if expected is ValueError:
            with pytest.raises(ValueError, match="FAVA_DFT_PRECISION"):
                importlib.reload(dft)
        else:
            assert importlib.reload(dft).PRECISION == expected
    finally:
        monkeypatch.delenv("FAVA_DFT_PRECISION", raising=False)
        importlib.reload(dft)
