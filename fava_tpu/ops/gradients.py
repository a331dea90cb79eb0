"""Real-space velocity-gradient statistics (finite-difference moments).

Beyond the reference (which has no gradient diagnostics at all;
fava/mesh/FLASH/FlashUniform.py stops at spectra): the classical
small-scale/intermittency report built from the full velocity-gradient
tensor g_ij = du_i/dx_j — longitudinal derivative skewness (the
vortex-stretching benchmark, ~ -0.5 in developed turbulence),
derivative flatness (intermittency), pseudo-dissipation <|grad u|^2>,
finite-difference enstrophy/dilatation mean squares, and the
longitudinal Taylor microscale lambda_f = sqrt(<u'^2>/<(du/dx)^2>).

Third and fourth gradient moments are PHASE information — they cannot
be recovered from any energy spectrum — so this complements the
spectral suite (ops/velocity.py) rather than duplicating it (whose
``taylor_scale`` is the energy-spectrum moment definition; the two
agree on isotropic fields up to the finite-difference transfer
function but are distinct estimators).

Design notes:

* Gradients are 2nd-order central differences via ``jnp.roll`` —
  cheap shifts XLA fuses straight into the moment reductions; no
  gradient volume is ever materialized in device memory. A spectral
  derivative would cost six extra transforms for no statistical
  benefit at these orders.
* ONE jitted program returns ONE packed vector of CENTRAL moment
  means: one host fetch, not one per scalar.
* Moments are centered ON DEVICE in two passes (means first, then
  (g - <g>)^p), the same discipline as the flagship profiles: the
  one-pass raw-moment expansion m2 - m1^2 cancels catastrophically in
  float32 whenever a gradient carries a large mean (uniform shear,
  Hubble-flow tests, windowed non-periodic extracts).

Conventions match the spectral module: ``lengths=None`` means the
2*pi-periodic unit box (dx = 2*pi/n per axis), else dx_j = L_j/n_j —
so FD and spectral derivatives of the same field share units.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from fava_tpu.utils import accum_dtype
from fava_tpu.ops.velocity import _check_vels

_BOUNDARIES = ("periodic", "interior")

# Rotation cross-term pairs per dimensionality: cov(g_ab, g_ba) with
# (a, b) ordered as the vorticity components — 3D: omega_x uses
# (2, 1), omega_y (0, 2), omega_z (1, 0); 2D: omega_z only.
_ROT_PAIRS = {3: ((2, 1), (0, 2), (1, 0)), 2: ((1, 0),)}
# Divergence cross terms cov(g_ii, g_jj), i < j.
_DIV_PAIRS = {3: ((0, 1), (0, 2), (1, 2)), 2: ((0, 1),)}


def _spacings(shape: Tuple[int, ...], lengths) -> Tuple[float, ...]:
    if lengths is None:
        return tuple(2.0 * np.pi / n for n in shape)
    return tuple(float(L) / n for L, n in zip(lengths, shape))


def packed_names(nd: int) -> Tuple[str, ...]:
    """Entry order of the packed device vector (CENTRAL volume means)."""
    names = []
    for i in range(nd):
        for j in range(nd):
            names += [f"g{i}{j}_mean"] + [f"g{i}{j}_c{p}" for p in (2, 3, 4)]
    names += [f"rot_cov_g{a}{b}_g{b}{a}" for a, b in _ROT_PAIRS[nd]]
    names += [f"div_cov_g{i}{i}_g{j}{j}" for i, j in _DIV_PAIRS[nd]]
    for i in range(nd):
        names += [f"u{i}_mean", f"u{i}_var"]
    return tuple(names)


@lru_cache(maxsize=16)
def _gradient_stats_fn(shape: Tuple[int, ...], spacings, boundary: str):
    nd = len(shape)
    adt = accum_dtype()
    interior = boundary == "interior"

    def run(*vels):
        def grad(i, j):
            # du_i/dx_j, 2nd-order central difference on the periodic
            # wrap; identical subexpressions across the two passes and
            # the cross terms are CSE'd by XLA, so nothing is read or
            # shifted twice.
            u = vels[i]
            d = (jnp.roll(u, -1, axis=j) - jnp.roll(u, 1, axis=j)) / (
                jnp.asarray(2.0 * spacings[j], dtype=u.dtype)
            )
            if interior:
                # Central differences are boundary-free on the common
                # interior; one shared region keeps every moment (incl.
                # the cross terms) averaged over the SAME cells.
                d = d[tuple(slice(1, -1) for _ in range(nd))]
            return d.astype(adt)

        def vmean(x):
            return jnp.mean(x)

        gmean = {(i, j): vmean(grad(i, j)) for i in range(nd) for j in range(nd)}

        def fluct(i, j):
            return grad(i, j) - gmean[(i, j)]

        acc = []
        for i in range(nd):
            for j in range(nd):
                f = fluct(i, j)
                f2 = f * f
                acc += [gmean[(i, j)], vmean(f2), vmean(f2 * f), vmean(f2 * f2)]
        for a, b in _ROT_PAIRS[nd]:
            acc.append(vmean(fluct(a, b) * fluct(b, a)))
        for i, j in _DIV_PAIRS[nd]:
            acc.append(vmean(fluct(i, i) * fluct(j, j)))
        for i in range(nd):
            u = vels[i]
            if interior:
                u = u[tuple(slice(1, -1) for _ in range(nd))]
            ua = u.astype(adt)
            um = vmean(ua)
            acc += [um, vmean((ua - um) ** 2)]
        return jnp.stack(acc)

    return jax.jit(run)


def gradient_stats_device(
    vels: Sequence[jax.Array],
    lengths: Optional[Sequence[float]] = None,
    boundary: str = "periodic",
) -> Tuple[jax.Array, Tuple[str, ...]]:
    """Packed central gradient-moment vector on device (no host fetch).

    Series drivers stack these and fetch once; see
    :func:`assemble_gradient_stats` for the layout -> report step.
    """
    shape, key = _check_vels(vels, lengths, "velocity_gradient_statistics")
    if boundary not in _BOUNDARIES:
        raise ValueError(f"boundary must be one of {_BOUNDARIES}, got {boundary!r}")
    if boundary == "interior" and min(shape) < 3:
        raise ValueError("interior gradients need at least 3 cells per axis")
    fn = _gradient_stats_fn(shape, _spacings(shape, key), boundary)
    return fn(*vels), packed_names(len(shape))


def assemble_gradient_stats(vec: np.ndarray, nd: int) -> Dict[str, np.ndarray | float]:
    """Packed central means -> the gradient-statistics report (float64)."""
    v = np.asarray(vec, dtype=np.float64)
    k = 0
    m1 = np.empty((nd, nd))
    c2 = np.empty((nd, nd))
    c3 = np.empty((nd, nd))
    c4 = np.empty((nd, nd))
    for i in range(nd):
        for j in range(nd):
            m1[i, j], c2[i, j], c3[i, j], c4[i, j] = v[k : k + 4]
            k += 4
    rot = {p: v[k + n] for n, p in enumerate(_ROT_PAIRS[nd])}
    k += len(_ROT_PAIRS[nd])
    div = {p: v[k + n] for n, p in enumerate(_DIV_PAIRS[nd])}
    k += len(_DIV_PAIRS[nd])
    u_mean = np.array([v[k + 2 * i] for i in range(nd)])
    u_var = np.array([v[k + 2 * i + 1] for i in range(nd)])

    def ratio(num, den):
        return np.where(den > 0.0, num / np.maximum(den, 1e-300), 0.0)

    skew = ratio(c3, c2**1.5)
    flat = ratio(c4, c2**2)
    long_skew = np.diagonal(skew).copy()
    long_flat = np.diagonal(flat).copy()
    off = ~np.eye(nd, dtype=bool)

    # Fluctuation enstrophy: each vorticity component is g_ab - g_ba.
    enstrophy = sum(
        c2[a, b] + c2[b, a] - 2.0 * rot[(a, b)] for a, b in _ROT_PAIRS[nd]
    )
    # Fluctuation <(div u')^2> = sum_i c2_ii + 2 sum_{i<j} cov(g_ii, g_jj).
    dilatation_msq = float(np.sum(np.diagonal(c2))) + 2.0 * sum(
        div[p] for p in _DIV_PAIRS[nd]
    )
    taylor = np.sqrt(ratio(u_var, np.diagonal(c2)))

    return {
        "gradient_mean": m1,
        "gradient_moment2": c2,
        "gradient_moment3": c3,
        "gradient_moment4": c4,
        "longitudinal_skewness": long_skew,
        "derivative_skewness": float(long_skew.mean()),
        "longitudinal_flatness": long_flat,
        "derivative_flatness": float(long_flat.mean()),
        "transverse_flatness": float(flat[off].mean()) if nd > 1 else 0.0,
        "pseudo_dissipation": float(np.sum(c2)),
        "enstrophy": float(enstrophy),
        "dilatation_msq": float(dilatation_msq),
        "velocity_mean": u_mean,
        "velocity_variance": u_var,
        "taylor_microscale": taylor,
        "taylor_microscale_mean": float(taylor.mean()),
    }


def velocity_gradient_statistics(
    velx: jax.Array,
    vely: jax.Array,
    velz: Optional[jax.Array] = None,
    lengths: Optional[Sequence[float]] = None,
    boundary: str = "periodic",
) -> Dict[str, np.ndarray | float]:
    """Velocity-gradient tensor statistics in one device pass.

    Central-difference g_ij = du_i/dx_j fluctuation moments up to
    fourth order plus the cross covariances closing <|omega'|^2> and
    <(div u')^2>, packed into one vector (single fetch). Returns, all
    float64 host-side:

    * ``gradient_mean`` / ``gradient_moment{2,3,4}`` — (nd, nd) mean
      and central-moment tables of g_ij;
    * ``longitudinal_skewness``/``_flatness`` (per axis, the diagonal
      g_ii) and their means ``derivative_skewness``/``_flatness`` — the
      classical intermittency benchmarks (skewness ~ -0.5, flatness
      rising with Reynolds number in developed turbulence);
    * ``transverse_flatness`` — mean flatness of the off-diagonal
      gradients;
    * ``pseudo_dissipation`` <|grad u'|^2> (multiply by the viscosity
      for the incompressible dissipation rate), ``enstrophy``
      <|omega'|^2>, ``dilatation_msq`` <(div u')^2> — all from the
      SAME finite-difference operator and the same fluctuation fields;
    * ``taylor_microscale`` lambda_f,i = sqrt(<u_i'^2>/<(du_i/dx_i)'^2>)
      per axis and its mean;
    * ``velocity_mean`` / ``velocity_variance`` per component.

    All moments are about the volume means (fluctuation statistics;
    mean-flow/mean-shear contributions live in ``gradient_mean`` and
    ``velocity_mean``). ``boundary="periodic"`` wraps (matching every
    spectral analysis here); ``"interior"`` restricts all averages to
    the common interior (for windowed/non-periodic uniform extracts,
    e.g. the pipeline's flame windows). Reference: no counterpart
    (gradient statistics absent from ebrooker/FAVA).
    """
    vels = (velx, vely) if velz is None else (velx, vely, velz)
    vec, _ = gradient_stats_device(vels, lengths=lengths, boundary=boundary)
    return assemble_gradient_stats(np.asarray(vec), len(vels))


# --- velocity-gradient invariant (Q-R) joint PDFs -----------------------


@lru_cache(maxsize=16)
def _invariant_fields_fn(shape: Tuple[int, ...], spacings, boundary: str):
    """Per-cell characteristic-polynomial invariants of the raw
    velocity-gradient tensor A_ij = du_i/dx_j (lambda^3 + P lambda^2 +
    Q lambda + R = 0):

        P = -tr(A)          (= -dilatation; 0 for incompressible flow)
        Q = (P^2 - tr(A^2)) / 2
        R = -det(A)

    — the full compressible definitions, which reduce to the classical
    incompressible Q-R pair when div u = 0. Also returns the
    normalization scalar Q_w = <omega^2>/4 (the rotation-rate
    invariant scale the Q-R literature plots against). Volumes stay in
    the compute dtype (f32 on an accelerator); only the Q_w reduction widens.
    """
    interior = boundary == "interior"
    nd = len(shape)

    def run(vx, vy, vz):
        vels = (vx, vy, vz)

        def grad(i, j):
            u = vels[i]
            d = (jnp.roll(u, -1, axis=j) - jnp.roll(u, 1, axis=j)) / (
                jnp.asarray(2.0 * spacings[j], dtype=u.dtype)
            )
            if interior:
                d = d[tuple(slice(1, -1) for _ in range(nd))]
            return d

        g = [[grad(i, j) for j in range(3)] for i in range(3)]
        trA = g[0][0] + g[1][1] + g[2][2]
        trA2 = sum(g[i][j] * g[j][i] for i in range(3) for j in range(3))
        P = -trA
        Q = 0.5 * (P * P - trA2)
        det = (
            g[0][0] * (g[1][1] * g[2][2] - g[1][2] * g[2][1])
            - g[0][1] * (g[1][0] * g[2][2] - g[1][2] * g[2][0])
            + g[0][2] * (g[1][0] * g[2][1] - g[1][1] * g[2][0])
        )
        R = -det
        w2 = (
            (g[2][1] - g[1][2]) ** 2
            + (g[0][2] - g[2][0]) ** 2
            + (g[1][0] - g[0][1]) ** 2
        )
        qw = jnp.mean(w2.astype(accum_dtype())) / 4.0
        return Q, R, qw

    return jax.jit(run)


def invariant_pdf_edges(qw, qr_range: float, nbx: int, nby: int):
    """Traced (Q, R) bin edges scaled by Q_w: Q/Q_w and R/Q_w^1.5 over
    [-qr_range, qr_range]."""
    from fava_tpu.ops.volume import _edges_traced

    adt = accum_dtype()
    # Clamp must keep qs**1.5 NORMAL in f32: 1e-30**1.5 = 1e-45 is
    # subnormal and flushed to zero by accelerators, which would
    # collapse the R edges (and the histogram) for near-quiescent
    # fields. 1e-20**1.5 = 1e-30 stays normal.
    qs = jnp.maximum(qw, jnp.asarray(1e-20, dtype=adt))
    r = jnp.asarray(qr_range, dtype=adt)
    rs = qs * jnp.sqrt(qs)
    return _edges_traced(-r * qs, r * qs, nbx), _edges_traced(-r * rs, r * rs, nby)


@lru_cache(maxsize=16)
def _invariant_pdf_fn(
    shape: Tuple[int, ...],
    spacings,
    boundary: str,
    nbx: int,
    nby: int,
    qr_range: float,
):
    """ONE fused program for the Q-R joint PDF: gradients -> invariants
    -> Q_w reduction -> Q_w-scaled bin edges (traced) -> exact joint
    histogram, plus Q_w bitcast into a trailing int32 row so the whole
    result is ONE packed fetch. The unfused form paid two dispatches
    and two host round trips just to move Q_w to the host and back as
    histogram ranges."""
    from fava_tpu.ops.volume import _hist2d_fn

    fields = _invariant_fields_fn(shape, spacings, boundary)

    @jax.jit
    def run(vx, vy, vz):
        Q, R, qw = fields(vx, vy, vz)
        xe, ye = invariant_pdf_edges(qw, qr_range, nbx, nby)
        counts = _hist2d_fn(nbx, nby, counting=True)(Q, R, Q, xe, ye)
        # Pack Q_w's raw bits (1 int32 word at f32 accum, 2 at f64)
        # into one trailing row: counts + scale in a single fetch.
        bits = jax.lax.bitcast_convert_type(qw[None], jnp.int32).ravel()
        tail = jnp.zeros((1, nby), dtype=jnp.int32).at[0, : bits.shape[0]].set(bits)
        return jnp.concatenate([counts, tail])

    return run


def gradient_invariant_pdfs(
    velx: jax.Array,
    vely: jax.Array,
    velz: jax.Array,
    lengths: Optional[Sequence[float]] = None,
    nbins: Tuple[int, int] | int = (100, 100),
    qr_range: float = 8.0,
    boundary: str = "periodic",
) -> Dict[str, np.ndarray | float]:
    """Joint PDF of the velocity-gradient invariants (Q, R) — the
    Chong-Perry-Cantwell topology map whose teardrop shape classifies
    local flow structure (vortex stretching/compression, biaxial
    strain). 3D only. Beyond the reference (no gradient diagnostics).

    Invariants use the FULL compressible characteristic-polynomial
    definitions (see :func:`_invariant_fields_fn`), binned over the
    literature's normalized axes Q/Q_w in [-qr_range, qr_range] and
    R/Q_w^{3/2} likewise, with Q_w = <omega^2>/4 from the same
    finite-difference pass. Everything runs as ONE fused program —
    gradients, invariants, the Q_w reduction, the Q_w-scaled bin edges
    (traced, never fetched), and the exact joint histogram, with Q_w
    bitcast into the
    int32 result so one packed fetch returns it all. Returns:

    * ``q_edges`` / ``r_edges`` — bin edges in NORMALIZED units;
    * ``counts`` — exact np.histogram2d-semantics counts (cells beyond
      ``qr_range`` are dropped, like histogram2d out-of-range values);
    * ``pdf`` — density over the normalized axes (integrates to
      ``inside_fraction``);
    * ``q_w`` — the normalization scale; ``inside_fraction`` — the
      fraction of cells inside the plotted range.
    """
    vels = (velx, vely, velz)
    shape, key = _check_vels(vels, lengths, "gradient_invariant_pdfs")
    if len(shape) != 3:
        raise ValueError("gradient invariants need a 3D velocity field (3x3 tensor)")
    if boundary not in _BOUNDARIES:
        raise ValueError(f"boundary must be one of {_BOUNDARIES}, got {boundary!r}")
    if boundary == "interior" and min(shape) < 3:
        raise ValueError("interior gradients need at least 3 cells per axis")
    if isinstance(nbins, int):
        nbins = (nbins, nbins)
    nbx, nby = int(nbins[0]), int(nbins[1])
    if min(nbx, nby) < 2:
        raise ValueError(f"gradient_invariant_pdfs needs nbins >= 2 per axis, got {nbins}")
    r = float(qr_range)
    fn = _invariant_pdf_fn(shape, _spacings(shape, key), boundary, nbx, nby, r)
    packed = np.asarray(fn(*vels))  # (nbx + 1, nby) int32, one fetch
    counts = packed[:nbx].astype(np.float64)
    adt = np.dtype(accum_dtype())
    nwords = adt.itemsize // 4
    qw = float(packed[nbx, :nwords].view(adt)[0])
    # Edges are REPORTED in normalized units, where they are the exact
    # linspace the device scaled by Q_w (Q/Q_w in [-r, r], R/Q_w^1.5).
    q_edges = np.linspace(-r, r, nbx + 1)
    r_edges = np.linspace(-r, r, nby + 1)
    ntot = float(np.prod([s - 2 for s in shape] if boundary == "interior" else shape))
    areas = np.diff(q_edges)[:, None] * np.diff(r_edges)[None, :]
    return {
        "q_edges": q_edges,
        "r_edges": r_edges,
        "counts": counts,
        "pdf": counts / (ntot * areas),
        "q_w": qw,
        "inside_fraction": float(counts.sum() / ntot),
    }
