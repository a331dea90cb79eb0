"""Real-space two-point correlation functions (Wiener-Khinchin).

R(r) = <f'(x) f'(x+r)> on the periodic box, computed spectrally:
the autocorrelation is the inverse transform of the power spectrum,
so the FFTs do all the heavy lifting.
Beyond the reference, which has no spatial correlation analysis (its
auto_correlations are TIME correlations at sampled points,
fava/analysis/auto_correlations.py); these are the classic
Karman-Howarth longitudinal/transverse curves and the scalar
two-point correlation with integral length scales.

Axis-line extraction never materializes the correlation volume for the
velocity case: the line R(r e_a) is the 1D inverse transform of the
power MARGINAL summed over the other axes (the phase only involves
k_a), and the Hermitian-weighted half-grid plane sum equals the
full-spectrum marginal once every other axis is fully summed. The
scalar case does one irfftn because the shell-averaged R(|r|) needs
the full volume.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from fava_tpu.utils import accum_dtype


def _hermitian_weights_np(n_last: int) -> np.ndarray:
    j = np.arange(n_last // 2 + 1)
    self_conj = j == 0
    if n_last % 2 == 0:
        self_conj = self_conj | (j == n_last // 2)
    return np.where(self_conj, 1.0, 2.0)


def _power_marginal(p: jax.Array, full_shape: Tuple[int, ...], axis: int) -> jax.Array:
    """Full-spectrum power marginal along ``axis`` from the half-grid
    power volume ``p`` (trailing axis halved), as rfft-layout
    coefficients of the axis line (length n_axis//2 + 1)."""
    nd = len(full_shape)
    adt = accum_dtype()
    hw = jnp.asarray(_hermitian_weights_np(full_shape[-1]), dtype=adt)
    hw = hw.reshape((1,) * (nd - 1) + (-1,))
    if axis == nd - 1:
        # trailing axis: sum the leading axes, keep the half grid as-is
        # (the 1D irfft applies the conjugate-pair weighting itself)
        return jnp.sum(p.astype(adt), axis=tuple(range(nd - 1)))
    others = tuple(a for a in range(nd) if a != axis)
    m_half = jnp.sum(p.astype(adt) * hw, axis=others)  # signed k_axis
    # The weight-2 half-grid sum at +k counts the conjugate modes that
    # live at -k (mirror is (-kx,-ky,-kz)): S(k) + S(-k) = 2 M(k), so
    # the true (even) marginal is the symmetrization.
    m_full = 0.5 * (m_half + jnp.roll(jnp.flip(m_half), 1))
    n = full_shape[axis]
    return jnp.concatenate([m_full[: n // 2], m_full[n // 2 : n // 2 + 1]])


@lru_cache(maxsize=16)
def _scalar_corr_fn(shape: Tuple[int, ...], nbins: int):
    ndim = len(shape)
    ntot = int(np.prod(shape))

    @jax.jit
    def core(f):
        adt = accum_dtype()
        fm = f - jnp.mean(f.astype(adt)).astype(f.dtype)
        p = jnp.abs(jnp.fft.rfftn(fm)) ** 2
        corr = jnp.fft.irfftn(p, s=shape) / ntot
        var = corr.reshape(-1)[0]
        lines = []
        for a, n in enumerate(shape):
            sel = tuple(slice(None) if i == a else 0 for i in range(ndim))
            lines.append(corr[sel][: n // 2 + 1])
        # Shell-average over |r| with wraparound min(j, n - j) — the
        # SAME geometry as k-shell binning, and R(r) = R(-r) (real
        # field), so Hermitian-weighted binning of the trailing-axis
        # HALF volume is exactly the full-volume shell mean, at half
        # the binning work of a full-volume scatter.
        from fava_tpu.ops.velocity import _bin_rfft_stats

        counts, sums = _bin_rfft_stats(
            corr[..., : shape[-1] // 2 + 1].astype(adt), shape, nbins
        )
        # ONE packed vector -> one host fetch
        return jnp.concatenate(
            [var.reshape(1).astype(adt), counts, sums]
            + [ln.astype(adt) for ln in lines]
        )

    return core


def _unpack_scalar_corr(packed: np.ndarray, shape, nbins: int):
    var = float(packed[0])
    counts = packed[1 : 1 + nbins]
    sums = packed[1 + nbins : 1 + 2 * nbins]
    lines = []
    off = 1 + 2 * nbins
    for n in shape:
        m = n // 2 + 1
        lines.append(packed[off : off + m])
        off += m
    return var, lines, counts, sums


@lru_cache(maxsize=16)
def _velocity_corr_fn(shape: Tuple[int, ...]):
    nd = len(shape)
    ntot = int(np.prod(shape))

    @jax.jit
    def core(*vels):
        adt = accum_dtype()
        lines = []  # [comp][axis] -> half line of <u_i'(x) u_i'(x + r e_a)>
        for v in vels:
            vm = v - jnp.mean(v.astype(adt)).astype(v.dtype)
            p = jnp.abs(jnp.fft.rfftn(vm)) ** 2
            per_axis = []
            for a, n in enumerate(shape):
                marg = _power_marginal(p, shape, a)
                # irfft carries 1/n; the unnormalized transforms carry
                # 1/ntot^2 — so scale by n/ntot^2 for the raw
                # <u'(x) u'(x+r)> value (line[0] == component variance)
                per_axis.append(
                    jnp.fft.irfft(marg, n=n)[: n // 2 + 1] * (float(n) / float(ntot) ** 2)
                )
            lines.append(per_axis)
        # one packed vector -> one host fetch (comp-major, axis-minor)
        return jnp.concatenate([ln.astype(adt) for per in lines for ln in per])

    return core


def _integral_scale(line: np.ndarray, dx: float) -> float:
    """integral_0^rzc R(r)/R(0) dr — trapezoid to the first zero
    crossing (linearly interpolated), or the half box if R stays
    positive (standard periodic-box convention)."""
    r0 = line[0]
    if not np.isfinite(r0) or r0 <= 0:
        return float("nan")
    rho = line / r0
    neg = np.nonzero(rho <= 0)[0]
    if neg.size == 0:
        return float(np.trapezoid(rho, dx=dx))
    j = int(neg[0])
    if j == 0:
        return 0.0
    area = float(np.trapezoid(rho[: j], dx=dx))
    # triangle from the last positive sample to the interpolated zero
    frac = rho[j - 1] / (rho[j - 1] - rho[j])
    return area + 0.5 * rho[j - 1] * frac * dx


def _check_volume(f, lengths, what: str):
    shape = tuple(int(s) for s in f.shape)
    nd = len(shape)
    if nd not in (2, 3):
        raise ValueError(f"{what} requires a 2D or 3D volume, got {nd}D")
    if lengths is not None and len(lengths) != nd:
        raise ValueError(f"lengths must have {nd} entries, got {len(lengths)}")
    return shape, nd


def two_point_correlation(
    field: jax.Array,
    lengths: Optional[Sequence[float]] = None,
    nbins: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """Scalar two-point autocorrelation R(r) = <f'(x) f'(x+r)> / var f.

    Returns the shell-averaged isotropic curve (``r_shell`` in CELL
    units — shell radii mix axes, so physical units only make sense
    for cubic cells) plus per-axis line correlations ``R_<ax>`` over
    physical separations ``r_<ax>`` (box ``lengths``; unit box default)
    and their integral length scales ``integral_scale_<ax>``
    (trapezoid to the first zero crossing). ``variance`` is <f'^2>.
    One jit: rfftn -> |.|^2 -> irfftn + shell/line extraction.
    """
    shape, nd = _check_volume(field, lengths, "two_point_correlation")
    if nbins is None:
        nbins = max(min(shape) // 2, 1)
    packed = np.asarray(_scalar_corr_fn(shape, int(nbins))(field), dtype=np.float64)
    var, lines, counts, sums = _unpack_scalar_corr(packed, shape, int(nbins))
    scale = var if var > 0 else 1.0
    out: Dict[str, np.ndarray] = {
        "variance": var,
        "r_shell": np.arange(nbins, dtype=np.float64),
        "R_shell": np.where(counts > 0, sums / np.maximum(counts, 1), np.nan) / scale,
    }
    ls = tuple(float(L) for L in lengths) if lengths is not None else (1.0,) * nd
    for a, ax in enumerate("xyz"[:nd]):
        dx = ls[a] / shape[a]
        line = np.asarray(lines[a], dtype=np.float64)
        out[f"r_{ax}"] = np.arange(line.size, dtype=np.float64) * dx
        out[f"R_{ax}"] = line / scale
        out[f"integral_scale_{ax}"] = _integral_scale(line, dx)
    return out


def velocity_correlations(
    velx: jax.Array,
    vely: jax.Array,
    velz: Optional[jax.Array] = None,
    lengths: Optional[Sequence[float]] = None,
) -> Dict[str, np.ndarray]:
    """Karman-Howarth longitudinal f(r) and transverse g(r) velocity
    correlations along each axis, with integral scales.

    For each axis a: ``f_<ax>`` is the normalized line correlation of
    the axis-parallel component u_a along a (longitudinal), ``g_<ax>``
    the mean of the perpendicular components' line correlations along
    a (transverse); ``L11_<ax>`` / ``L22_<ax>`` their integral scales
    and ``isotropy_ratio_<ax>`` = L11 / (2 L22) — exactly 1 for
    isotropic incompressible turbulence (von Karman-Howarth), so the
    deviation is an anisotropy/compressibility diagnostic. No inverse
    volume transforms: lines come from 1D inverses of the power
    marginals (module docstring).
    """
    vels = (velx, vely) if velz is None else (velx, vely, velz)
    shape, nd = _check_volume(vels[0], lengths, "velocity_correlations")
    if len(vels) != nd:
        raise ValueError(
            f"velocity_correlations: {nd}D flow needs {nd} components, got {len(vels)}"
        )
    for i, v in enumerate(vels[1:], start=1):
        if tuple(int(s) for s in v.shape) != shape:
            raise ValueError(
                f"velocity component {i} shape {tuple(v.shape)} does not match {shape}"
            )
    packed = np.asarray(_velocity_corr_fn(shape)(*vels), dtype=np.float64)
    lines = []
    off = 0
    for _ in range(nd):
        per_axis = []
        for n in shape:
            m = n // 2 + 1
            per_axis.append(packed[off : off + m])
            off += m
        lines.append(per_axis)
    return assemble_karman_howarth(lines, shape, lengths)


def assemble_karman_howarth(lines, shape, lengths) -> Dict[str, np.ndarray]:
    """lines[comp][axis] (raw half line correlations) -> the public
    f/g/L11/L22/isotropy record. The normalization conventions here
    are load-bearing for the documented exact equality between the
    in-core and streamed (ops/outofcore.py) paths — one definition."""
    nd = len(shape)
    ls = tuple(float(L) for L in lengths) if lengths is not None else (1.0,) * nd
    out: Dict[str, np.ndarray] = {}
    for a, ax in enumerate("xyz"[:nd]):
        dx = ls[a] / shape[a]
        f_line = np.asarray(lines[a][a], dtype=np.float64)
        f0 = f_line[0] if f_line[0] > 0 else 1.0
        g_lines = [
            np.asarray(lines[i][a], dtype=np.float64) for i in range(nd) if i != a
        ]
        g0s = [g[0] if g[0] > 0 else 1.0 for g in g_lines]
        g_norm = np.mean([g / g0 for g, g0 in zip(g_lines, g0s)], axis=0)
        out[f"r_{ax}"] = np.arange(f_line.size, dtype=np.float64) * dx
        out[f"f_{ax}"] = f_line / f0
        out[f"g_{ax}"] = g_norm
        out[f"L11_{ax}"] = _integral_scale(f_line, dx)
        l22 = _integral_scale(g_norm, dx)
        out[f"L22_{ax}"] = l22
        out[f"isotropy_ratio_{ax}"] = (
            out[f"L11_{ax}"] / (2.0 * l22) if l22 and np.isfinite(l22) else float("nan")
        )
    return out
