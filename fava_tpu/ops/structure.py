"""Velocity structure functions (orders 1-10) on a uniform grid.

JAX redesign of the reference implementation
(reference: fava/mesh/FLASH/FlashUniform.py:306-447). The reference
loops over separations per MPI rank, drawing NumPy-random point pairs
into shared windows; here all (order, separation, point) samples are
drawn with a counter-based Threefry PRNG (utils/prng.py: one stream
layout the f64 oracles reproduce draw for draw) and evaluated in one
fused jitted program — fresh
samples per order, matching the reference's structure (its sampling
loop sits inside the order loop). Stream layout: order ``o`` uses
streams ``(o-1)*3 + {0,1,2}`` for (position, phi, theta).

Semantics preserved exactly:
 * isotropic direction sampling via (phi, acos) angles,
 * periodic wrap of the second point (modulo == the reference's
   repeated domain-width shifts),
 * nearest-cell lookup by floor((p - lo)/dx),
 * longitudinal component |dv . rhat| with rhat from the *wrapped*
   separation vector, transverse = |dv - |dv.rhat| rhat|.

The increment PDFs (velocity_increment_pdfs) deliberately deviate on
the last point: they decompose against the PRE-wrap draw direction
(the minimal-image separation) — the wrapped convention is kept only
where reference parity demands it.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from fava_tpu.utils import accum_dtype
from fava_tpu.utils import prng
from fava_tpu.utils import twofloat as tf


def _draw_increments(
    vels,
    separations,
    domain_lo,
    domain_width,
    cell_size,
    seed,
    base,
    *,
    num_seps: int,
    num_points: int,
    ndim: int,
    vol_shape,
    anisotropic: bool,
):
    """One (num_seps, num_points) pair draw from streams base..base+2:
    random first endpoints, isotropic separation directions, periodic
    wrap, nearest-cell velocity gathers. Returns ``(dv, rhat, dirhat)``
    — the raw velocity-increment vectors, the *wrapped* separation unit
    vectors (reference-parity convention, FlashUniform.py:418-427), and
    the *pre-wrap* draw-direction unit vectors (the minimal-image
    separation: every component of ``sep * direction`` is bounded by
    ``sep <= width/2``, whereas the wrapped ``p2 - p1`` can approach a
    full domain width when the endpoint wrapped). Shared (trace-level)
    by the structure functions and the increment PDFs so both see
    bit-identical draws for a given stream base."""
    shape = (num_seps, num_points)
    dt = domain_lo.dtype

    p1 = domain_lo + prng.uniform(seed, base, shape + (ndim,), dt) * domain_width

    phi = 2.0 * jnp.pi * prng.uniform(seed, base + 1, shape, dt)
    theta = jnp.arccos(2.0 * prng.uniform(seed, base + 2, shape, dt) - 1.0)
    sep = separations[:, None]
    direction = jnp.stack(
        [
            jnp.sin(theta) * jnp.cos(phi),
            jnp.sin(theta) * jnp.sin(phi),
            jnp.cos(theta),
        ],
        axis=-1,
    )[..., :ndim]
    p2 = p1 + sep[..., None] * direction
    # Periodic wrap (reference: FlashUniform.py:375-393).
    p2 = domain_lo + jnp.mod(p2 - domain_lo, domain_width)

    def cell_index(p):
        idx = jnp.floor((p - domain_lo) / cell_size).astype(jnp.int32)
        return jnp.clip(idx, 0, jnp.asarray(vol_shape[:ndim], dtype=jnp.int32) - 1)

    i1 = cell_index(p1)
    i2 = cell_index(p2)

    ncells = int(np.prod(vol_shape[:ndim]))

    def sample(vol, idx):
        # Flat int32 gather where it fits (cheaper index math than
        # the tuple-index gather). Tuple gather handles 2D data and
        # volumes beyond int32 flattening (~1290^3 cells).
        if ndim == 3 and ncells < 2**31:
            flat = (
                idx[..., 0] * vol_shape[1] + idx[..., 1]
            ) * vol_shape[2] + idx[..., 2]
            return vol.reshape(-1)[flat]
        return vol[tuple(idx[..., a] for a in range(ndim))]

    dv = jnp.stack([sample(v, i2) - sample(v, i1) for v in vels], axis=-1)

    sep_vec = p2 - p1
    if anisotropic:
        rhat = jnp.zeros_like(sep_vec).at[..., 0].set(1.0)
        dirhat = rhat
    else:
        rhat = sep_vec / jnp.sqrt(jnp.sum(sep_vec**2, axis=-1, keepdims=True))
        # Pre-wrap direction: exactly unit in 3D; in 2D the truncated
        # 3-sphere draw has norm sin(theta), so renormalize (guarding
        # the measure-zero sin(theta) == 0 draw).
        norm = jnp.sqrt(jnp.sum(direction**2, axis=-1, keepdims=True))
        dirhat = direction / jnp.where(norm > 0, norm, jnp.ones_like(norm))
    return dv, rhat, dirhat


@lru_cache(maxsize=16)
def _build_vsf_fn(
    num_seps: int,
    num_points: int,
    ndim: int,
    anisotropic: bool,
    vol_shape,
    resample_per_order: bool = True,
):
    @jax.jit
    def run(vels, separations, domain_lo, domain_width, cell_size, seed_hi, seed_lo):
        seed = (seed_hi, seed_lo)  # full 64-bit key through uint32 args

        def increments(base):
            dv, rhat, _ = _draw_increments(
                vels,
                separations,
                domain_lo,
                domain_width,
                cell_size,
                seed,
                base,
                num_seps=num_seps,
                num_points=num_points,
                ndim=ndim,
                vol_shape=vol_shape,
                anisotropic=anisotropic,
            )
            long_comp = jnp.abs(jnp.sum(dv * rhat, axis=-1))
            long_dvel = long_comp[..., None] * rhat
            trans_comp = jnp.sqrt(jnp.sum((dv - long_dvel) ** 2, axis=-1))
            return long_comp, trans_comp

        if resample_per_order:
            # Reference structure: its sampling loop sits INSIDE the
            # order loop, so each order sees fresh pairs (reference:
            # FlashUniform.py:348-416). Costs 10x the gather work.
            def one_order(order):
                base = (order.astype(jnp.uint32) - 1) * 3
                long_comp, trans_comp = increments(base)

                def vsf(comp):
                    # (num_seps,): mean over points of comp^order.
                    powed = comp ** order.astype(comp.dtype)
                    return jnp.sum(powed.astype(accum_dtype()), axis=-1) / float(num_points)

                return vsf(long_comp), vsf(trans_comp)

            orders = jnp.arange(1, 11)
            return jax.vmap(one_order)(orders)

        # Shared-sample estimator: ONE pair draw (streams 0-2 — the
        # same draw order 1 sees in resample mode) feeds every order,
        # like pair_structure_functions. The volume gathers dominate
        # the device time, so this is ~an-order-of-magnitude cheaper
        # with the same per-order estimator variance (orders
        # become correlated across p, which no downstream use here
        # cares about).
        long_comp, trans_comp = increments(jnp.uint32(0))
        adt = accum_dtype()

        def vsf_all(comp):
            out = []
            powed = jnp.ones_like(comp)
            for _ in range(10):
                powed = powed * comp
                out.append(jnp.sum(powed.astype(adt), axis=-1) / float(num_points))
            return jnp.stack(out)

        return vsf_all(long_comp), vsf_all(trans_comp)

    return run


def structure_functions(
    vels: Sequence[jax.Array],
    *,
    domain_bounds: np.ndarray,
    num_seps: int = 100,
    num_points: int = 10000,
    sep_bounds: Optional[Sequence[float]] = None,
    log_scale: bool = True,
    anisotropic: bool = False,
    seed: int = 0,
    resample_per_order: bool = True,
) -> Dict[str, Dict[str, np.ndarray] | np.ndarray]:
    """Longitudinal/transverse velocity structure functions, orders 1-10.

    ``sep_bounds`` defaults to (smallest cell size, half the narrowest
    domain width) — the resolvable separation range. (The reference's
    default, (0, 1), crashes its own geomspace; SURVEY.md flags it as a
    latent bug not to replicate: reference FlashUniform.py:310-320.)

    ``resample_per_order=True`` (default) mirrors the reference's loop
    nesting — fresh random pairs for every order (reference:
    FlashUniform.py:348, sampling inside ``for order in range(1, 11)``).
    ``False`` draws ONE pair set and evaluates all ten orders on it —
    the estimator pair_structure_functions already uses. The random
    volume gathers dominate the device time, so the shared-sample mode
    does ~10x fewer of them with the same per-order variance; order 1 is bit-identical between modes (the
    shared draw IS order 1's stream).
    """
    ndim = len(vels)
    vol_shape = tuple(int(s) for s in vels[0].shape)

    domain_bounds = np.asarray(domain_bounds, dtype=np.float64)
    lo = domain_bounds[:ndim, 0]
    width = domain_bounds[:ndim, 1] - domain_bounds[:ndim, 0]
    cell_size = width / np.asarray(vol_shape[:ndim], dtype=np.float64)

    if sep_bounds is None:
        sep_bounds = (float(cell_size.min()), float(width.min()) / 2.0)
    if log_scale and sep_bounds[0] <= 0.0:
        raise ValueError(
            f"sep_bounds lower bound must be positive with log_scale=True, got {sep_bounds[0]}"
        )
    if log_scale:
        separations = np.geomspace(sep_bounds[0], sep_bounds[1], num_seps)
    else:
        separations = np.linspace(sep_bounds[0], sep_bounds[1], num_seps)

    fn = _build_vsf_fn(
        int(num_seps), int(num_points), ndim, bool(anisotropic), vol_shape,
        bool(resample_per_order),
    )
    dt = vels[0].dtype
    long_v, trans_v = fn(
        tuple(jnp.asarray(v) for v in vels),
        jnp.asarray(separations, dtype=dt),
        jnp.asarray(lo, dtype=dt),
        jnp.asarray(width, dtype=dt),
        jnp.asarray(cell_size, dtype=dt),
        *(jnp.asarray(w) for w in prng._key(int(seed))),
    )
    long_v = np.asarray(long_v, dtype=np.float64)
    trans_v = np.asarray(trans_v, dtype=np.float64)

    vsfs: Dict[str, Dict[str, np.ndarray] | np.ndarray] = {"transverse": {}, "longitudinal": {}}
    for o in range(1, 11):
        vsfs["longitudinal"][f"{o}"] = long_v[o - 1]
        vsfs["transverse"][f"{o}"] = trans_v[o - 1]
    vsfs["separations"] = separations
    return vsfs


# Increment-PDF sampling owns stream base 1<<17: structure-function
# orders use streams 0..29 and the particle pair sampler uses 1<<16, so
# the three analyses never reuse Threefry words under a shared seed.
_INC_STREAM = 1 << 17


@lru_cache(maxsize=16)
def _inc_pdf_fn(num_seps: int, num_points: int, ndim: int, nbins: int, vol_shape, anisotropic: bool):
    from fava_tpu.ops.volume import _interval_hist

    @jax.jit
    def run(vels, separations, domain_lo, domain_width, cell_size, edges, seed_hi, seed_lo):
        seed = (seed_hi, seed_lo)  # full 64-bit key through uint32 args
        # rhat here is the PRE-WRAP draw direction (minimal image): the
        # wrapped p2 - p1 vector the structure functions use (parity
        # with FlashUniform.py:418-427) is non-minimal-image whenever
        # the second endpoint wrapped — at the default width/2 maximum
        # separation that contaminates the signed longitudinal /
        # transverse decomposition for roughly half the draws. The
        # increment PDFs have no parity constraint, so they decompose
        # against the exact draw direction instead.
        dv, _, rhat = _draw_increments(
            vels,
            separations,
            domain_lo,
            domain_width,
            cell_size,
            seed,
            jnp.uint32(_INC_STREAM),
            num_seps=num_seps,
            num_points=num_points,
            ndim=ndim,
            vol_shape=vol_shape,
            anisotropic=anisotropic,
        )
        # SIGNED projections (the structure functions take magnitudes;
        # the PDFs need the sign — negative-tail asymmetry of the
        # longitudinal increments IS the energy cascade).
        dl = jnp.sum(dv * rhat, axis=-1)
        if ndim == 2:
            that = jnp.stack([-rhat[..., 1], rhat[..., 0]], axis=-1)
        else:
            # One deterministic transverse direction: cross(a, rhat)
            # with a = z-hat away from the pole, x-hat near it (the
            # isotropic-turbulence transverse PDF is invariant to the
            # choice of direction in the plane perpendicular to r).
            xhat = jnp.zeros((3,), dtype=rhat.dtype).at[0].set(1.0)
            zhat = jnp.zeros((3,), dtype=rhat.dtype).at[2].set(1.0)
            polar = jnp.abs(rhat[..., 2:3]) > 0.9
            a = jnp.where(polar, xhat, zhat)
            that = jnp.cross(a, rhat)
            that = that / jnp.sqrt(jnp.sum(that**2, axis=-1, keepdims=True))
        dt_ = jnp.sum(dv * that, axis=-1)

        adt = accum_dtype()

        def stats_and_counts(x):
            xa = x.astype(adt)
            mean = jnp.mean(xa, axis=1)
            c = xa - mean[:, None]  # two-pass centering (f32-safe)
            m2 = jnp.mean(c * c, axis=1)
            m3 = jnp.mean(c * c * c, axis=1)
            m4 = jnp.mean((c * c) ** 2, axis=1)
            std = jnp.sqrt(m2)
            safe = jnp.where(std > 0, std, jnp.ones_like(std))
            z = c / safe[:, None]
            counts = jax.vmap(
                lambda row: _interval_hist(row, None, edges, nbins, counting=True)
            )(z)
            s2 = jnp.where(m2 > 0, m2, jnp.ones_like(m2))
            nan = jnp.asarray(jnp.nan, dtype=adt)
            skew = jnp.where(m2 > 0, m3 / (s2 * jnp.sqrt(s2)), nan)
            flat = jnp.where(m2 > 0, m4 / (s2 * s2), nan)
            # counts <= num_points < 2^24 stay exact through the adt cast
            return jnp.concatenate(
                [counts.astype(adt).T, jnp.stack([mean, std, skew, flat])]
            )

        # one packed fetch: [long block; trans block], each (nbins+4, num_seps)
        return jnp.concatenate([stats_and_counts(dl), stats_and_counts(dt_)])

    return run


def velocity_increment_pdfs(
    vels: Sequence[jax.Array],
    *,
    domain_bounds: np.ndarray,
    num_seps: int = 8,
    num_points: int = 65536,
    sep_bounds: Optional[Sequence[float]] = None,
    log_scale: bool = True,
    nbins: int = 101,
    nsigma: float = 10.0,
    anisotropic: bool = False,
    seed: int = 0,
) -> Dict[str, Dict[str, np.ndarray] | np.ndarray]:
    """PDFs of signed velocity increments at a handful of separations.

    The distributions whose moments are the structure functions — and
    the classic intermittency picture the raw moments compress away:
    near-Gaussian increment PDFs at integral-scale separations grow
    fat stretched-exponential tails as r drops toward the dissipative
    range, and the longitudinal PDF skews negative (the cascade).
    Beyond the reference, which computes only the unsigned moments
    (fava/mesh/FLASH/FlashUniform.py:306-447).

    Sampling reuses the structure-function pair machinery
    (:func:`_draw_increments`) on a dedicated Threefry stream base
    (``1 << 17``) — same isotropic-direction draw, periodic wrap, and
    nearest-cell gathers — but keeps the SIGN of the longitudinal
    projection dv.rhat and of one deterministic transverse component
    dv.that (that ⊥ rhat), with rhat the PRE-wrap draw direction (the
    minimal-image separation; the structure functions' wrapped p2-p1
    convention is reference parity, but it mis-decomposes any pair
    whose endpoint wrapped). Per separation, increments are centered and
    normalized by their own standard deviation on device, then counted
    into ``nbins`` equal bins spanning ``[-nsigma, +nsigma]`` standard
    deviations (np.histogram semantics; out-of-range samples are
    dropped, so counts may sum below ``num_points``). Everything comes
    back in ONE packed fetch (counts + mean/std/skewness/flatness per
    separation and component).

    Returns ``{"separations", "edges" (normalized units, nbins+1),
    "longitudinal": {"counts" (num_seps, nbins), "mean", "std",
    "skewness", "flatness"}, "transverse": {...}}``. A constant field
    gives std 0: all counts land in the center bin and
    skewness/flatness are NaN.
    """
    ndim = len(vels)
    vol_shape = tuple(int(s) for s in vels[0].shape)
    if not 0 < int(num_points) < 2**24:
        raise ValueError(
            f"num_points must be in (0, 2^24) so packed f32 counts stay "
            f"integer-exact, got {num_points}"
        )
    if nbins < 1:
        raise ValueError(f"nbins must be positive, got {nbins}")
    if not nsigma > 0:
        raise ValueError(f"nsigma must be positive, got {nsigma}")

    domain_bounds = np.asarray(domain_bounds, dtype=np.float64)
    lo = domain_bounds[:ndim, 0]
    width = domain_bounds[:ndim, 1] - domain_bounds[:ndim, 0]
    cell_size = width / np.asarray(vol_shape[:ndim], dtype=np.float64)

    if sep_bounds is None:
        sep_bounds = (float(cell_size.min()), float(width.min()) / 2.0)
    if log_scale and sep_bounds[0] <= 0.0:
        raise ValueError(
            f"sep_bounds lower bound must be positive with log_scale=True, got {sep_bounds[0]}"
        )
    if log_scale:
        separations = np.geomspace(sep_bounds[0], sep_bounds[1], num_seps)
    else:
        separations = np.linspace(sep_bounds[0], sep_bounds[1], num_seps)

    edges = np.linspace(-float(nsigma), float(nsigma), int(nbins) + 1)

    fn = _inc_pdf_fn(
        int(num_seps), int(num_points), ndim, int(nbins), vol_shape, bool(anisotropic)
    )
    dt = vels[0].dtype
    packed = np.asarray(
        fn(
            tuple(jnp.asarray(v) for v in vels),
            jnp.asarray(separations, dtype=dt),
            jnp.asarray(lo, dtype=dt),
            jnp.asarray(width, dtype=dt),
            jnp.asarray(cell_size, dtype=dt),
            jnp.asarray(edges, dtype=accum_dtype()),
            *(jnp.asarray(w) for w in prng._key(int(seed))),
        ),
        dtype=np.float64,
    )
    rows = int(nbins) + 4
    out: Dict[str, Dict[str, np.ndarray] | np.ndarray] = {
        "separations": separations,
        "edges": edges,
    }
    for i, comp in enumerate(("longitudinal", "transverse")):
        block = packed[i * rows : (i + 1) * rows]
        out[comp] = {
            "counts": block[: int(nbins)].T,
            "mean": block[int(nbins)],
            "std": block[int(nbins) + 1],
            "skewness": block[int(nbins) + 2],
            "flatness": block[int(nbins) + 3],
        }
    return out


def she_leveque(orders) -> np.ndarray:
    """She-Leveque (1994) model exponents zeta_p = p/9 + 2(1-(2/3)^(p/3)).

    The standard intermittency benchmark for the ESS exponents below
    (zeta_3 = 1 exactly in the model, matching the ESS normalization):

    >>> she_leveque([3]).round(12)
    array([1.])
    >>> she_leveque([1, 2]).round(4)
    array([0.364 , 0.6959])
    """
    p = np.asarray(orders, dtype=np.float64)
    return p / 9.0 + 2.0 * (1.0 - (2.0 / 3.0) ** (p / 3.0))


def _log_slope(x: np.ndarray, y: np.ndarray):
    """Least-squares slope of y vs x with its standard error (NaN when
    fewer than 3 usable points)."""
    good = np.isfinite(x) & np.isfinite(y)
    n = int(good.sum())
    if n < 3:
        return np.nan, np.nan
    xg, yg = x[good], y[good]
    (slope, icpt), cov = np.polyfit(xg, yg, 1, cov=True)
    return float(slope), float(np.sqrt(cov[0, 0]))


def scaling_exponents(
    vsfs: Dict,
    *,
    reference_order: int = 3,
    fit_range: Optional[Sequence[float]] = None,
    ess: bool = True,
) -> Dict[str, Dict[str, np.ndarray] | np.ndarray]:
    """Structure-function scaling exponents zeta_p, plain or ESS.

    Post-processes a :func:`structure_functions` result (host-side
    NumPy: the fits touch <= num_seps points per order — no device
    work to speed up). ``ess=True`` applies Extended Self-Similarity
    (Benzi et al. 1993): zeta_p is the log-log slope of S_p against
    the REFERENCE-order structure function S_ref instead of the
    separation r, which cancels the common non-power-law prefactor and
    extends the usable scaling range far below the inertial range —
    the standard way intermittency exponents are actually measured.
    With K41 normalization zeta_ref = 1 at ``reference_order=3``, so
    ESS exponents compare directly to :func:`she_leveque`.

    ``fit_range`` restricts the fit to separations in [rmin, rmax]
    (default: all). Non-positive S_p samples are excluded from the log
    fit. Returns ``{"orders", "longitudinal": {"zeta", "zeta_err"},
    "transverse": {...}, "ess", "reference_order"}`` with per-order
    1-sigma fit errors. Beyond the reference (which computes raw
    structure functions only, fava/mesh/FLASH/FlashUniform.py:306-447).
    """
    seps = np.asarray(vsfs["separations"], dtype=np.float64)
    sel = np.ones(seps.shape, dtype=bool)
    if fit_range is not None:
        rmin, rmax = float(fit_range[0]), float(fit_range[1])
        sel = (seps >= rmin) & (seps <= rmax)
        if sel.sum() < 3:
            raise ValueError(
                f"fit_range {fit_range} keeps {int(sel.sum())} of {seps.size} "
                "separations; need at least 3 for a slope fit"
            )

    orders = sorted(int(o) for o in vsfs["longitudinal"])
    if ess and reference_order not in orders:
        raise ValueError(
            f"reference_order {reference_order} not among computed orders {orders}"
        )

    out: Dict[str, Dict[str, np.ndarray] | np.ndarray] = {
        "orders": np.asarray(orders, dtype=np.float64),
        "ess": bool(ess),
        "reference_order": int(reference_order) if ess else None,
    }
    with np.errstate(divide="ignore", invalid="ignore"):
        for comp in ("longitudinal", "transverse"):
            if ess:
                ref = np.asarray(vsfs[comp][str(reference_order)], dtype=np.float64)
                x = np.log(np.where(ref > 0, ref, np.nan))[sel]
            else:
                x = np.log(seps)[sel]
            zetas, errs = [], []
            for o in orders:
                sp = np.asarray(vsfs[comp][str(o)], dtype=np.float64)
                y = np.log(np.where(sp > 0, sp, np.nan))[sel]
                z, e = _log_slope(x, y)
                zetas.append(z)
                errs.append(e)
            out[comp] = {
                "zeta": np.asarray(zetas),
                "zeta_err": np.asarray(errs),
            }
    return out


# Pair sampling draws from a dedicated stream far outside the
# structure-function stream range (orders 1-10 use streams 0..29), so
# the two analyses never reuse Threefry words under a shared seed.
_PAIR_STREAM = 1 << 16


def pair_bin_edges(lo: float, hi: float, nbins: int, log_bins: bool) -> np.ndarray:
    """The f64 separation-bin edges (nbins+1,) shared by the device
    kernel (as squared two-float splits) and the same-draw oracles."""
    if log_bins:
        return np.geomspace(float(lo), float(hi), nbins + 1)
    return np.linspace(float(lo), float(hi), nbins + 1)


def pair_indices(seed, num_pairs: int, n: int):
    """The pair-sampling index draw: ONE (2, num_pairs) block from
    stream ``_PAIR_STREAM`` of ``seed`` (row 0 = first endpoints, row 1
    = second), exposed so same-draw oracles (tests, scripts/validate.py)
    reproduce it."""
    return prng.randint(seed, _PAIR_STREAM, (2, int(num_pairs)), int(n))


@lru_cache(maxsize=16)
def _pair_vsf_fn(num_pairs: int, nbins: int, ndim: int, norders: int, periodic: bool):
    @jax.jit
    def run(pos, vel, e2h, e2l, lengths, seed_hi, seed_lo):
        seed = (seed_hi, seed_lo)  # full 64-bit key through uint32 args
        adt = accum_dtype()
        n = pos.shape[0]
        idx = pair_indices(seed, num_pairs, n)

        # Two-float pair separations: binning decisions must match the
        # f64 oracle, and one f32 rounding (2^-24 relative) flips a
        # pair across a bin edge (measured 1.1e-4 scaled count error
        # at 65536 pairs). The (hi, lo) pair carries the separation
        # exactly; edges arrive as (e2h, e2l) splits of the SQUARED
        # f64 edges, so every comparison is an exact double-word
        # compare (r monotone <-> r^2, no sqrt in the decision path).
        d = tf.two_diff(pos[idx[1]], pos[idx[0]])
        if periodic:
            # Minimum image with the round() decided on the EXACT
            # separation: correct the f32 round(dh/L) wherever the
            # true value sits on the other side of the half-cell
            # boundary (exact two-float compares against (q +- 0.5) L).
            q = jnp.round(d[0] / lengths)
            inc = tf.ge(d, tf.two_prod(q + 0.5, lengths))
            dec = tf.lt(d, tf.two_prod(q - 0.5, lengths))
            q = q + inc.astype(q.dtype) - dec.astype(q.dtype)
            d = tf.sub(d, tf.two_prod(q, lengths))
        sq = tf.square(d)
        r2 = (sq[0][..., 0], sq[1][..., 0])
        for a in range(1, ndim):
            r2 = tf.add(r2, (sq[0][..., a], sq[1][..., a]))

        dr = d[0]  # correctly-rounded separation vector for projections
        r = jnp.sqrt(jnp.maximum(r2[0], 0.0))
        dv = vel[idx[1]] - vel[idx[0]]
        rsafe = jnp.maximum(r, jnp.asarray(1e-30, r.dtype))
        dl = jnp.abs(jnp.sum(dv * dr, axis=-1) / rsafe)
        dt2 = jnp.maximum(jnp.sum(dv * dv, axis=-1) - dl * dl, 0.0)
        dt = jnp.sqrt(dt2)

        # bin k covers [e_k, e_{k+1}); the top edge is inclusive (its
        # hits land in bin nbins-1 via the mask + count of inner edges).
        inner = (e2h[None, 1:nbins], e2l[None, 1:nbins])
        ge_inner = tf.ge((r2[0][:, None], r2[1][:, None]), inner)
        bidx = jnp.sum(ge_inner, axis=1, dtype=jnp.int32)
        mask = tf.ge(r2, (e2h[0], e2l[0])) & tf.le(r2, (e2h[nbins], e2l[nbins]))
        # also drops i == j pairs when lo > 0
        w = mask.astype(adt)
        counts = jnp.zeros(nbins, dtype=adt).at[bidx].add(w)
        sums = []
        pl = jnp.ones_like(dl).astype(adt)
        pt = jnp.ones_like(dt).astype(adt)
        for _ in range(norders):
            pl = pl * dl.astype(adt)
            pt = pt * dt.astype(adt)
            sums.append(jnp.zeros(nbins, dtype=adt).at[bidx].add(jnp.where(mask, pl, 0)))
            sums.append(jnp.zeros(nbins, dtype=adt).at[bidx].add(jnp.where(mask, pt, 0)))
        safe = jnp.maximum(counts, 1)
        means = jnp.stack(sums) / safe
        # one packed fetch: [counts, mean bin radius, means (2*norders, nbins)]
        rsum = jnp.zeros(nbins, dtype=adt).at[bidx].add(jnp.where(mask, r.astype(adt), 0))
        return jnp.concatenate([counts[None], (rsum / safe)[None], means])

    return run


def pair_structure_functions(
    positions,
    velocities,
    *,
    num_pairs: int = 200000,
    nbins: int = 24,
    sep_bounds: Optional[Sequence[float]] = None,
    orders: int = 10,
    lengths: Optional[Sequence[float]] = None,
    log_bins: bool = True,
    seed: int = 0,
) -> Dict[str, Dict[str, np.ndarray] | np.ndarray]:
    """Structure functions from PARTICLE pairs (no grid interpolation).

    Samples ``num_pairs`` random tracer pairs (counter-based PRNG —
    deterministic like the grid sampler above), projects the velocity
    increments onto the pair separation (longitudinal |du_L|, transverse
    magnitude), and bins by separation into ``nbins`` log bins over
    ``sep_bounds``. With ``lengths`` the separations use the periodic
    minimum image. Bin membership is decided in two-float (double-f32)
    arithmetic against the squared f64 edges (utils/twofloat.py), so
    counts match the f64 oracle exactly despite f32 device compute —
    single-f32 distances measurably flip pairs across edges (1.1e-4
    scaled count error at 65536 pairs). Output convention matches the grid
    ``structure_functions``: {"longitudinal": {"1".."orders"},
    "transverse": {...}, "separations" (per-bin MEAN pair distance),
    "counts"}. Beyond the reference, whose particle module only loads
    and sorts tables (fava/mesh/FLASH/FlashParticles.py).
    """
    pos = jnp.asarray(positions)
    vel = jnp.asarray(velocities)
    if pos.ndim != 2 or vel.shape != pos.shape:
        raise ValueError(
            f"positions/velocities must be matching (N, ndim) tables, got "
            f"{tuple(pos.shape)} / {tuple(vel.shape)}"
        )
    n, ndim = int(pos.shape[0]), int(pos.shape[1])
    if n < 2:
        raise ValueError("need at least 2 particles")
    if sep_bounds is None:
        # resolvable range from the data: percentile-free default —
        # the box diagonal over ~N^(1/ndim) (mean spacing) to half box
        span = np.asarray(jnp.max(pos, axis=0) - jnp.min(pos, axis=0), dtype=np.float64)
        hi = float(np.min(span[span > 0])) / 2.0 if np.any(span > 0) else 1.0
        lo = hi / max(n ** (1.0 / ndim), 2.0)
        sep_bounds = (lo, hi)
    lo, hi = (float(s) for s in sep_bounds)
    if not 0 < lo < hi:
        raise ValueError(f"sep_bounds must satisfy 0 < lo < hi, got ({lo}, {hi})")
    periodic = lengths is not None
    L = (
        jnp.asarray([float(x) for x in lengths], dtype=pos.dtype)
        if periodic
        else jnp.ones(ndim, dtype=pos.dtype)
    )
    edges = pair_bin_edges(lo, hi, int(nbins), bool(log_bins))
    e2h, e2l = tf.split_f64(edges**2, np.dtype(pos.dtype))
    fn = _pair_vsf_fn(int(num_pairs), int(nbins), ndim, int(orders), periodic)
    packed = np.asarray(
        fn(
            pos,
            vel,
            jnp.asarray(e2h),
            jnp.asarray(e2l),
            L,
            *(jnp.asarray(w) for w in prng._key(int(seed))),
        ),
        dtype=np.float64,
    )
    counts, rmean = packed[0], packed[1]
    out: Dict[str, Dict[str, np.ndarray] | np.ndarray] = {
        "counts": counts,
        "separations": np.where(counts > 0, rmean, np.nan),
        "longitudinal": {},
        "transverse": {},
    }
    for o in range(1, int(orders) + 1):
        out["longitudinal"][f"{o}"] = np.where(counts > 0, packed[2 * o], np.nan)
        out["transverse"][f"{o}"] = np.where(counts > 0, packed[2 * o + 1], np.nan)
    return out
