"""Volume-wise reductions, mass sums, and PDFs.

These fill in the API surface the reference *declares but never
implements* — ``volume_average``, ``volume_integration``, ``pdf1d``,
``pdf2d``, ``mass_sum`` are registered analysis wrappers with no mesh
backing (SURVEY §2 "declared-but-absent"); ``mass_fraction`` exists
only on FlashUniform (reference: fava/mesh/FLASH/FlashUniform.py:449-458).
All are AMR-aware: cells are weighted by their refinement-level volume.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from fava_tpu.utils import accum_dtype
from fava_tpu.utils import twofloat as tf


@jax.jit
def _block_sums(data: jax.Array) -> jax.Array:
    return jnp.sum(data.astype(accum_dtype()), axis=tuple(range(1, data.ndim)))


def volume_integration(
    data: jax.Array, cell_volumes: np.ndarray, blocklist: Optional[np.ndarray] = None
) -> float:
    """integral(field dV) = sum over leaf blocks of blocksum * cell_volume."""
    if blocklist is not None:
        data = jnp.take(data, jnp.asarray(blocklist), axis=0)
    if data.ndim == 3:  # single uniform block
        data = data[None]
    sums = _block_sums(data)
    return float(jnp.sum(sums * jnp.asarray(cell_volumes, dtype=sums.dtype)))


def volume_average(
    data: jax.Array,
    cell_volumes: np.ndarray,
    domain_volume: float,
    blocklist: Optional[np.ndarray] = None,
) -> float:
    return volume_integration(data, cell_volumes, blocklist) / float(domain_volume)


@lru_cache(maxsize=16)
def _mass_sums_fn(nmasks: int):
    """ONE program: total + per-mask mass sums in a single packed
    fetch, instead of one dispatch and one host round trip per mask
    (3-4 masks in the reference's flam/rpv1-style runs)."""

    @jax.jit
    def run(dens, cell_volumes, masks):
        mass = dens.astype(accum_dtype()) * cell_volumes.astype(accum_dtype())
        sums = [jnp.sum(mass)]
        for m in masks:
            sums.append(jnp.sum(jnp.where(m, mass, 0)))
        return jnp.stack(sums)

    return run


def mass_sum(
    dens: jax.Array,
    cell_volume,
    masks: Optional[Dict[str, jax.Array]] = None,
) -> Dict[str, float]:
    """Total mass plus per-mask masses (reference mass_fraction semantics).

    ``cell_volume`` is a scalar (uniform grids) or a per-leading-axis
    broadcastable array (AMR per-block volumes).
    """
    masks = masks or {}
    names = list(masks.keys())
    vec = np.asarray(
        _mass_sums_fn(len(names))(
            dens, jnp.asarray(cell_volume), tuple(jnp.asarray(masks[n]) for n in names)
        ),
        dtype=np.float64,
    )
    out = {"total": float(vec[0])}
    out.update({n: float(vec[1 + i]) for i, n in enumerate(names)})
    return out


@jax.jit
def _minmax_fn(values):
    return jnp.stack([jnp.min(values), jnp.max(values)])


@jax.jit
def _minmax2_fn(xv, yv):
    # both ranges in ONE packed fetch
    return jnp.stack([jnp.min(xv), jnp.max(xv), jnp.min(yv), jnp.max(yv)])


_HIST_CHUNK = 16


def _interval_hist(v, w, edges, nbins: int, counting: bool = False):
    """Weighted histogram by chunked INTERVAL sums (in-trace helper).

    counts[b] = sum of w where edges[b] <= v < edges[b+1] (last bin
    closed at edges[-1]), scanned over edge-pair chunks — np.histogram
    semantics against the exact edge values passed in. Three deliberate
    properties vs the alternatives:

    * no differenced cumulatives: diff of ~1e8-scale f32 cumulative
      sums quantizes sparse tail bins to ulp(total) (can go negative);
    * ``counting=True`` (unit weights) sums the mask in int32 — EXACT
      counts to 2^31 per bin, so every unweighted
      caller takes the counting path. Returns one int array.

    The weighted path returns a DOUBLE-WORD pair ``(hi, lo)`` per bin
    from :func:`fava_tpu.utils.twofloat.blocked_sum_dd`: a plain f32
    accumulator silently stops absorbing w-sized increments once a bin
    sum passes 2^24 * w (a concentrated weighted bin at 512^3); the
    blocked double-word sum carries an
    N-independent ~6e-5 worst-case / ~1e-7 measured relative bound.
    Callers pack BOTH words into the fetch and combine in f64 on host.
    """
    nch = -(-nbins // _HIST_CHUNK)
    pad = nch * _HIST_CHUNK - nbins
    lower = jnp.concatenate([edges[:-1], jnp.full((pad,), jnp.inf, dtype=edges.dtype)])
    upper = jnp.concatenate([edges[1:], jnp.full((pad,), jnp.inf, dtype=edges.dtype)])

    def step(_, lu):
        lo_e, hi_e = lu
        m = (v[None, :] >= lo_e[:, None]) & (v[None, :] < hi_e[:, None])
        if counting:
            return None, jnp.sum(m.astype(jnp.int32), axis=1)
        hi, lo = tf.blocked_sum_dd(jnp.where(m, w[None, :], 0), axis=1)
        return None, jnp.stack([hi, lo])

    _, counts = jax.lax.scan(
        step, None, (lower.reshape(nch, _HIST_CHUNK), upper.reshape(nch, _HIST_CHUNK))
    )
    last = v == edges[-1]
    if counting:
        counts = counts.ravel()[:nbins]
        closure = jnp.sum(last.astype(jnp.int32))
        return counts.at[-1].add(closure)
    hi = counts[:, 0, :].ravel()[:nbins]
    lo = counts[:, 1, :].ravel()[:nbins]
    chi, clo = tf.blocked_sum_dd(jnp.where(last, w, 0))
    lhi, llo = tf.add((hi[-1], lo[-1]), (chi, clo))
    return hi.at[-1].set(lhi), lo.at[-1].set(llo)


@lru_cache(maxsize=16)
def _hist1d_fn(nbins: int, counting: bool = False):
    @jax.jit
    def hist(values, weights, edges):
        adt = accum_dtype()
        if counting:
            return _interval_hist(
                values.ravel().astype(adt), None, edges, nbins, counting=True
            )
        # (2, nbins): double-word rows — fetch both, combine in f64
        hi, lo = _interval_hist(
            values.ravel().astype(adt), weights.ravel().astype(adt), edges, nbins
        )
        return jnp.stack([hi, lo])

    return hist


_HIST2D_CHUNK = 1 << 21


def _interval_onehot(v, edges, nbins: int, dtype):
    """(n, nbins) one-hot interval-membership matrix of ``v`` against
    exact ``edges`` (np.histogram semantics: half-open bins, last
    closed). Contracting two of these over the sample axis IS the
    joint histogram."""
    m = (v[:, None] >= edges[None, :-1]) & (v[:, None] < edges[None, 1:])
    m = m.at[:, -1].set(m[:, -1] | (v == edges[-1]))
    return m.astype(dtype)


def _interval_index(v, edges, nbins: int):
    """Bin index of ``v`` against exact ``edges`` with np.histogram
    semantics (half-open bins, last closed); -1 outside the range."""
    i = jnp.searchsorted(edges, v, side="right") - 1
    i = jnp.where(v == edges[-1], nbins - 1, i)
    return jnp.where((i >= 0) & (i < nbins), i, -1)


def _edges_traced(lo, hi, nbins: int):
    """In-trace np.linspace twin: ``lo + k * ((hi - lo) / nbins)`` with
    the endpoint pinned to ``hi`` — bit-identical to np.linspace in the
    same dtype (np.linspace computes exactly this chain), so the f64
    CPU oracles keep exact np.histogram parity with traced edges."""
    k = jnp.arange(nbins + 1, dtype=lo.dtype)
    return (lo + k * ((hi - lo) / nbins)).at[-1].set(hi)


@lru_cache(maxsize=16)
def _pdf1d_auto_fn(nbins: int):
    """Fused auto-range counting pdf1d (see :func:`_pdf2d_auto_fn`):
    one dispatch, ranges bitcast into the int32 counts vector."""

    @jax.jit
    def run(values):
        adt = accum_dtype()
        v = values.ravel().astype(adt)
        lo = jnp.min(v)
        hi = jnp.max(v)
        hi = jnp.where(hi <= lo, lo + 1.0, hi)
        edges = _edges_traced(lo, hi, nbins)
        # pin int32: under x64 the interval sums promote to int64 and
        # concatenation would sign-extend the bitcast words
        counts = _interval_hist(v, None, edges, nbins, counting=True).astype(jnp.int32)
        bits = jax.lax.bitcast_convert_type(jnp.stack([lo, hi]), jnp.int32).ravel()
        return jnp.concatenate([counts, bits])

    return run


@lru_cache(maxsize=16)
def _pdf2d_auto_fn(nbx: int, nby: int):
    """Fused auto-range counting pdf2d: min/max reductions, traced
    linspace edges, and the exact joint histogram in ONE program, with
    the four range scalars bitcast into a trailing int32 row — one
    dispatch and one packed fetch where the unfused form paid two
    round trips (min/max fetch, then the histogram call)."""
    @jax.jit
    def run(xv, yv):
        adt = accum_dtype()
        x = xv.ravel()
        y = yv.ravel()
        xlo = jnp.min(x).astype(adt)
        xhi = jnp.max(x).astype(adt)
        ylo = jnp.min(y).astype(adt)
        yhi = jnp.max(y).astype(adt)
        # degenerate (constant-field) guard, same as the host path
        xhi = jnp.where(xhi <= xlo, xlo + 1.0, xhi)
        yhi = jnp.where(yhi <= ylo, ylo + 1.0, yhi)
        xe = _edges_traced(xlo, xhi, nbx)
        ye = _edges_traced(ylo, yhi, nby)
        counts = _hist2d_fn(nbx, nby, counting=True)(xv, yv, xv, xe, ye)
        bits = jax.lax.bitcast_convert_type(
            jnp.stack([xlo, xhi, ylo, yhi]), jnp.int32
        ).ravel()
        tail = jnp.zeros((1, nby), dtype=jnp.int32).at[0, : bits.shape[0]].set(bits)
        return jnp.concatenate([counts, tail])

    return run


@lru_cache(maxsize=16)
def _hist2d_fn(nbx: int, nby: int, counting: bool = False):
    """Joint histogram, chunked over the samples (2^21 per chunk).

    ``counting=True`` scatter-adds each sample into its flat (ix, iy)
    bin (found by comparing against the exact edges; out-of-range
    samples land in a dropped extra bin) and accumulates int32 counts:
    EXACT to 2^31 per bin. The weighted path contracts interval
    one-hots of x (scaled by w) and y over the sample axis (f32,
    HIGHEST-precision dot, whose blocked sums stay accurate on a
    concentrated bin where sequential f32 scatter-adds of a constant w
    drift by ~2% over one chunk) and accumulates ACROSS chunks in
    double-word (hi, lo), so no bin stalls at 2^24 * w. Weighted
    returns (2, nbx, nby): hi and lo planes, f64-combined on fetch.
    At 512^3 the count scatter measured 1.7x faster than the one-hot
    contraction on an H100 80GB HBM3 at 400 W (PERF.md).
    """

    @jax.jit
    def hist(xv, yv, weights, xedges, yedges):
        adt = accum_dtype()
        x = xv.ravel().astype(adt)
        y = yv.ravel().astype(adt)
        n = x.shape[0]
        c = min(_HIST2D_CHUNK, n)
        npad = (-n) % c
        if npad:
            fill = jnp.full((npad,), jnp.inf, dtype=adt)  # lands in no bin
            x = jnp.concatenate([x, fill])
            y = jnp.concatenate([y, fill])
        xs = x.reshape(-1, c)
        ys = y.reshape(-1, c)
        if counting:
            ws = jnp.zeros((xs.shape[0], 1), dtype=adt)  # unused
        else:
            w = weights.ravel().astype(adt)
            if npad:
                w = jnp.concatenate([w, jnp.zeros((npad,), dtype=adt)])
            ws = w.reshape(-1, c)

        def step(acc, xyw):
            xc, yc, wc = xyw
            if counting:
                ix = _interval_index(xc, xedges, nbx)
                iy = _interval_index(yc, yedges, nby)
                flat = jnp.where((ix >= 0) & (iy >= 0), ix * nby + iy, nbx * nby)
                h = jnp.zeros(nbx * nby + 1, jnp.int32).at[flat].add(1)
                return acc + h[:-1].reshape(nbx, nby), None
            a = _interval_onehot(xc, xedges, nbx, adt) * wc[:, None]
            b = _interval_onehot(yc, yedges, nby, adt)
            dims = (((0,), (0,)), ((), ()))  # contract the sample axis
            h = jax.lax.dot_general(a, b, dims, precision=jax.lax.Precision.HIGHEST)
            # double-word accumulate: 2Sum keeps the cross-chunk sum
            # error O(eps^2) regardless of the number of chunks
            hi, lo = tf.add((acc[0], acc[1]), (h, jnp.zeros_like(h)))
            return jnp.stack([hi, lo]), None

        if counting:
            init = jnp.zeros((nbx, nby), dtype=jnp.int32)
        else:
            init = jnp.zeros((2, nbx, nby), dtype=adt)
        acc, _ = jax.lax.scan(step, init, (xs, ys, ws))
        return acc

    return hist


def _cell_weights(shape, cell_volumes: Optional[np.ndarray], dens: Optional[jax.Array]) -> jax.Array:
    """Per-cell weights: volume (AMR-aware) and optionally mass (x dens)."""
    if cell_volumes is None:
        w = jnp.ones(shape, dtype=accum_dtype())
    else:
        cv = jnp.asarray(cell_volumes, dtype=accum_dtype())
        w = jnp.broadcast_to(cv.reshape((-1,) + (1,) * (len(shape) - 1)), shape)
    if dens is not None:
        w = w * dens.astype(accum_dtype())
    return w


def pdf1d(
    values: jax.Array,
    *,
    nbins: int = 100,
    vrange: Optional[Tuple[float, float]] = None,
    weights: Optional[jax.Array] = None,
    density: bool = True,
) -> Dict[str, np.ndarray]:
    """Weighted 1D PDF of a field (declared-but-absent in the reference).

    Unweighted counts are accumulated in int32 (exact to 2^31 per bin,
    i.e. beyond 1024^3 volumes); weighted sums are double-word (hi, lo)
    blocked sums combined in f64 on fetch — N-independent ~6e-5
    worst-case / ~1e-7 measured relative bound (no 2^24 f32 stall; see
    ``utils.twofloat.blocked_sum_dd``).
    """
    if weights is not None and tuple(weights.shape) != tuple(values.shape):
        # Same guard as density_pdf/binned_statistic: equal SIZES would
        # ravel-broadcast cleanly and silently pair each sample with
        # another cell's weight.
        raise ValueError(
            f"weights shape {tuple(weights.shape)} does not match values shape {tuple(values.shape)}"
        )
    if vrange is None:
        if values.size == 0:
            raise ValueError("pdf1d cannot auto-range an empty array; pass vrange")
        if weights is None:
            # Fused auto-range: min/max, traced linspace edges, and the
            # int32 counting histogram in ONE dispatch; the range
            # scalars ride the counts fetch as bitcast words.
            packed = np.asarray(_pdf1d_auto_fn(int(nbins))(values))
            adt = np.dtype(accum_dtype())
            nw = adt.itemsize // 4
            counts = packed[:nbins].astype(np.float64)
            lo, hi = (float(s) for s in packed[nbins : nbins + 2 * nw].view(adt))
            edges = np.linspace(lo, hi, nbins + 1)
            out = counts
            if density:
                total = counts.sum()
                widths = np.diff(edges)
                out = counts / (total * widths) if total > 0 else counts
            return {
                "edges": edges,
                "centers": 0.5 * (edges[1:] + edges[:-1]),
                "pdf": out,
                "counts": counts,
            }
        mm = np.asarray(_minmax_fn(values), dtype=np.float64)  # one fetch
        vrange = (float(mm[0]), float(mm[1]))
    lo, hi = float(vrange[0]), float(vrange[1])
    if hi <= lo:
        hi = lo + 1.0
    counting = weights is None
    w = weights if weights is not None else values  # ignored when counting
    edges = np.linspace(lo, hi, nbins + 1)
    counts = np.asarray(
        _hist1d_fn(int(nbins), counting)(values, w, jnp.asarray(edges, dtype=accum_dtype())),
        dtype=np.float64,
    )
    if not counting:
        counts = counts[0] + counts[1]  # double-word rows -> f64 sums
    out = counts
    if density:
        total = counts.sum()
        widths = np.diff(edges)
        out = counts / (total * widths) if total > 0 else counts
    return {"edges": edges, "centers": 0.5 * (edges[1:] + edges[:-1]), "pdf": out, "counts": counts}


def pdf2d(
    xvalues: jax.Array,
    yvalues: jax.Array,
    *,
    nbins: Tuple[int, int] = (100, 100),
    xrange: Optional[Tuple[float, float]] = None,
    yrange: Optional[Tuple[float, float]] = None,
    weights: Optional[jax.Array] = None,
    density: bool = True,
) -> Dict[str, np.ndarray]:
    """Weighted joint PDF of two fields (declared-but-absent in the
    reference: fava/analysis/pdf2d.py:6 registers a wrapper with no
    mesh implementation). np.histogram2d bin semantics against
    host-exact linspace edges; unweighted counts are int32-exact to
    2^31 per bin; weighted sums accumulate in double-word (hi, lo)
    across chunks and are f64-combined on fetch (N-independent bound —
    no f32 2^24 stall)."""
    if tuple(yvalues.shape) != tuple(xvalues.shape):
        raise ValueError(
            f"yvalues shape {tuple(yvalues.shape)} does not match xvalues shape {tuple(xvalues.shape)}"
        )
    if weights is not None and tuple(weights.shape) != tuple(xvalues.shape):
        raise ValueError(
            f"weights shape {tuple(weights.shape)} does not match xvalues shape {tuple(xvalues.shape)}"
        )
    if xvalues.size == 0 and (xrange is None or yrange is None):
        raise ValueError("pdf2d cannot auto-range empty arrays; pass xrange/yrange")
    if isinstance(nbins, int):
        nbins = (nbins, nbins)
    nwords = 4 * np.dtype(accum_dtype()).itemsize // 4
    if (
        xrange is None
        and yrange is None
        and weights is None
        and xvalues.size > 0
        and int(nbins[1]) >= nwords
    ):
        # Fused auto-range: ranges, traced edges, and the histogram in
        # one dispatch; the range scalars ride the counts fetch.
        nbx, nby = int(nbins[0]), int(nbins[1])
        fn = _pdf2d_auto_fn(nbx, nby)
        packed = np.asarray(fn(xvalues, yvalues))
        counts = packed[:nbx].astype(np.float64)
        scal = packed[nbx, :nwords].view(np.dtype(accum_dtype()))
        xlo, xhi, ylo, yhi = (float(s) for s in scal)
        # Reported edges: the f64 linspace of the exact device range
        # scalars (the device binned against the accum-dtype edges —
        # identical at f64; at f32 they differ by edge-value rounding
        # only, the documented pdf2d bin-edge class).
        xedges = np.linspace(xlo, xhi, nbx + 1)
        yedges = np.linspace(ylo, yhi, nby + 1)
        out = counts
        if density:
            total = counts.sum()
            area = np.outer(np.diff(xedges), np.diff(yedges))
            out = counts / (total * area) if total > 0 else counts
        return {"xedges": xedges, "yedges": yedges, "pdf": out, "counts": counts}
    if xrange is None and yrange is None:
        mm = np.asarray(_minmax2_fn(xvalues, yvalues), dtype=np.float64)
        xrange = (float(mm[0]), float(mm[1]))
        yrange = (float(mm[2]), float(mm[3]))
    elif xrange is None:
        mm = np.asarray(_minmax_fn(xvalues), dtype=np.float64)
        xrange = (float(mm[0]), float(mm[1]))
    elif yrange is None:
        mm = np.asarray(_minmax_fn(yvalues), dtype=np.float64)
        yrange = (float(mm[0]), float(mm[1]))
    xlo, xhi = map(float, xrange)
    ylo, yhi = map(float, yrange)
    if xhi <= xlo:
        xhi = xlo + 1.0
    if yhi <= ylo:
        yhi = ylo + 1.0
    counting = weights is None
    w = weights if weights is not None else xvalues  # ignored when counting
    xedges = np.linspace(xlo, xhi, nbins[0] + 1)
    yedges = np.linspace(ylo, yhi, nbins[1] + 1)
    if xvalues.size == 0:
        # np.histogram2d([], [], range=...) semantics: all-zero counts
        # (the device path assumes at least one data chunk).
        counts = np.zeros((int(nbins[0]), int(nbins[1])), dtype=np.float64)
    else:
        adt = accum_dtype()
        counts = np.asarray(
            _hist2d_fn(int(nbins[0]), int(nbins[1]), counting)(
                xvalues, yvalues, w, jnp.asarray(xedges, dtype=adt), jnp.asarray(yedges, dtype=adt)
            ),
            dtype=np.float64,
        )
        if not counting:
            counts = counts[0] + counts[1]  # double-word planes -> f64
    out = counts
    if density:
        total = counts.sum()
        area = np.outer(np.diff(xedges), np.diff(yedges))
        out = counts / (total * area) if total > 0 else counts
    return {"xedges": xedges, "yedges": yedges, "pdf": out, "counts": counts}


@lru_cache(maxsize=16)
def _density_pdf_fn(nbins: int, fixed_range: bool, counting: bool = False):
    @jax.jit
    def core(rho, w, lo_in, hi_in):
        adt = accum_dtype()
        r = rho.ravel().astype(adt)
        wv = w.ravel().astype(adt)
        wsum = jnp.sum(wv)
        rho_mean = jnp.sum(wv * r) / wsum
        s = jnp.log(r / rho_mean)
        mu = jnp.sum(wv * s) / wsum
        d = s - mu
        m2 = jnp.sum(wv * d * d) / wsum
        m3 = jnp.sum(wv * d * d * d) / wsum
        m4 = jnp.sum(wv * d * d * d * d) / wsum
        sigma = jnp.sqrt(m2)
        if fixed_range:
            lo, hi = lo_in, hi_in
        else:
            # nsigma window around the measured moments (lo_in = nsigma)
            lo = mu - lo_in * sigma
            hi = mu + lo_in * sigma
        hi = jnp.where(hi > lo, hi, lo + 1.0)  # constant field: sigma = 0
        # in-trace edges (the range is data-dependent here); the
        # scatter-free interval histogram is shared with pdf1d.
        # _edges_traced is the bit-identical np.linspace twin — a
        # different edge formula binned samples against edges that
        # disagreed (by an ulp, and at the unpinned endpoint) with the
        # np.linspace edges reported to the caller.
        edges = _edges_traced(lo.astype(adt), hi.astype(adt), nbins)
        stats = jnp.stack([rho_mean, mu, sigma, m3, m4, lo, hi]).astype(adt)
        # one packed vector -> one host fetch
        if counting:
            # int32-exact counts survive the f32 packing as a hi/lo
            # split: both words < 2^24, so the packed f32 vector (and
            # the host f64 reassembly) is bit-exact to 2^31 per bin
            ci = _interval_hist(s, None, edges, nbins, counting=True)
            return jnp.concatenate(
                [stats, (ci >> 12).astype(adt), (ci & 0xFFF).astype(adt)]
            )
        # weighted: double-word (hi, lo) bin rows, combined in f64 on host
        whi, wlo = _interval_hist(s, wv, edges, nbins)
        return jnp.concatenate([stats, whi, wlo])

    return core


def density_pdf(
    dens: jax.Array,
    *,
    weights: Optional[jax.Array] = None,
    nbins: int = 200,
    srange: Optional[Tuple[float, float]] = None,
    nsigma: float = 5.0,
    mach: Optional[float] = None,
) -> Dict[str, np.ndarray]:
    """Lognormality diagnostics of the density field (beyond the
    reference, which has no density-PDF analysis at all — its ``pdf1d``
    wrapper is declared-but-absent, fava/analysis/__init__.py).

    Works on the log-density contrast ``s = ln(rho / <rho>)`` with
    ``<rho>`` the (optionally weighted) mean — the variable in which
    isothermal supersonic turbulence is lognormal (Vazquez-Semadeni
    1994; Federrath et al. 2008). One jit dispatch computes the
    weighted PDF of ``s`` over ``srange`` (default: ``mean_s`` ±
    ``nsigma * sigma_s``, measured in the same pass) AND the exact
    weighted moments on device — the returned ``mean_s`` / ``sigma_s``
    / ``skewness`` / ``excess_kurtosis`` come from full-volume sums,
    not from the binned histogram. Extras:

    * ``lognormal_residual`` — ``|mean_s + sigma_s^2 / 2|``: exactly 0
      for a lognormal (mass conservation pins the mean of a lognormal
      ``s``-PDF at ``-sigma^2/2``); deviation measures non-lognormality
      (intermittency, shocks, self-gravity).
    * ``b_parameter`` (when the rms Mach number ``mach`` is given) —
      the turbulence driving parameter from the standard variance
      relation ``sigma_s^2 = ln(1 + b^2 M^2)``: ~1/3 solenoidal,
      ~1 compressive driving.

    ``weights``: per-cell volume (AMR) or mass weights; None = uniform
    (volume-weighted s-PDF on a uniform grid).
    """
    if nbins < 1:
        raise ValueError(f"nbins must be >= 1, got {nbins}")
    counting = weights is None
    w = weights if weights is not None else jnp.ones_like(dens)
    if tuple(w.shape) != tuple(dens.shape):
        raise ValueError(
            f"weights shape {tuple(w.shape)} does not match dens shape {tuple(dens.shape)}"
        )
    fixed = srange is not None
    if fixed:
        slo, shi = (float(s) for s in srange)
        # validate user input HERE: the in-trace hi > lo guard exists
        # for the auto-range sigma = 0 (constant field) case and must
        # not silently rewrite an invalid fixed range (ADVICE r3)
        if not shi > slo:
            raise ValueError(f"srange must satisfy lo < hi, got ({slo}, {shi})")
        lo_in, hi_in = slo, shi
    else:
        lo_in, hi_in = float(nsigma), 0.0
    packed = np.asarray(
        _density_pdf_fn(int(nbins), fixed, counting)(dens, w, lo_in, hi_in),
        dtype=np.float64,
    )
    rho_mean, mu, sigma, m3, m4, lo, hi = packed[:7].tolist()
    if counting:
        counts = packed[7 : 7 + nbins] * 4096.0 + packed[7 + nbins :]
    else:
        counts = packed[7 : 7 + nbins] + packed[7 + nbins :]  # hi + lo in f64
    edges = np.linspace(lo, hi, nbins + 1)
    widths = np.diff(edges)
    total = counts.sum()
    pdf = counts / (total * widths) if total > 0 else counts
    out = {
        "edges": edges,
        "centers": 0.5 * (edges[1:] + edges[:-1]),
        "pdf": pdf,
        "counts": counts,
        "rho_mean": rho_mean,
        "mean_s": mu,
        "sigma_s": sigma,
        "skewness": m3 / sigma**3 if sigma > 0 else 0.0,
        "excess_kurtosis": m4 / sigma**4 - 3.0 if sigma > 0 else 0.0,
        "lognormal_residual": abs(mu + 0.5 * sigma**2),
    }
    if mach is not None:
        m = float(mach)
        if m <= 0:
            raise ValueError(f"mach must be positive, got {m}")
        out["b_parameter"] = float(np.sqrt(np.expm1(sigma**2)) / m)
    return out


@lru_cache(maxsize=16)
def _binned_stat_fn(nbins: int, auto_range: bool, weighted: bool = False):
    """Fused conditional-statistics program: per x-bin count / sum(y) /
    sum(y^2) in ONE dispatch and one packed fetch. y is centered by its
    GLOBAL (weighted) mean on device before the bin sums (the one-pass
    per-bin variance then cancels against (bin mean - global mean), not
    against the full mean — the same f32 discipline as the centered
    moment passes; see ops/gradients.py design notes). Raw counts ride
    the packed accum-dtype vector as the density_pdf hi/lo word split
    (both words < 2^24 — exact through f32 to 2^31 per bin); the bin
    sums (sy, syy, and the weighted weight sums) are double-word
    (hi, lo) blocked sums — both words packed, combined in f64 on the
    host (N-independent error bound; see twofloat.blocked_sum_dd)."""

    @jax.jit
    def core(xv, yv, wv, lo_in, hi_in):
        adt = accum_dtype()
        x = xv.ravel().astype(adt)
        y = yv.ravel().astype(adt)
        if auto_range:
            lo = jnp.min(x)
            hi = jnp.max(x)
            hi = jnp.where(hi > lo, hi, lo + 1.0)
        else:
            lo = jnp.asarray(lo_in, dtype=adt)
            hi = jnp.asarray(hi_in, dtype=adt)
        edges = _edges_traced(lo, hi, nbins)
        ci = _interval_hist(x, None, edges, nbins, counting=True)
        if weighted:
            w = wv.ravel().astype(adt)
            ymean = jnp.sum(w * y) / jnp.sum(w)
            yc = y - ymean
            sw = _interval_hist(x, w, edges, nbins)
            sy = _interval_hist(x, w * yc, edges, nbins)
            syy = _interval_hist(x, w * yc * yc, edges, nbins)
        else:
            ymean = jnp.mean(y)
            yc = y - ymean
            sw = None
            sy = _interval_hist(x, yc, edges, nbins)
            syy = _interval_hist(x, yc * yc, edges, nbins)
        scal = jnp.stack([lo, hi, ymean])
        # each bin sum is a double-word (hi, lo) pair: pack hi row then
        # lo row so the host recovers f64-class sums from one fetch
        parts = [scal, (ci >> 12).astype(adt), (ci & 0xFFF).astype(adt), *sy, *syy]
        if weighted:
            parts.extend(sw)
        return jnp.concatenate(parts)

    return core


def binned_statistic(
    xvalues: jax.Array,
    yvalues: jax.Array,
    *,
    nbins: int = 100,
    vrange: Optional[Tuple[float, float]] = None,
    weights: Optional[jax.Array] = None,
) -> Dict[str, np.ndarray]:
    """Conditional bin statistics of ``y`` given ``x`` — a device-side
    scipy.stats.binned_statistic (count + mean + std in one pass; the
    reference leans on scipy's binned_statistic for its shell binning,
    fava/mesh/FLASH/FlashUniform.py:260-304, and offers users no
    general conditional-statistics call). np.histogram bin semantics
    (half-open bins, last closed, out-of-range samples dropped), edges
    from ``vrange`` or the measured x min/max — either way the ranges,
    bin sums, and the histogram fuse into ONE dispatch and one packed
    fetch.

    Returns ``edges``, ``centers``, ``counts`` (exact raw sample
    counts), ``mean`` and ``std`` per bin (population std; NaN for
    empty bins). With ``weights`` (AMR cell volumes, mass), mean/std
    become the weighted conditional statistics and ``weight_sums``
    (double-word bin sums, f64-combined on fetch) is added. Typical
    use: mean temperature
    conditioned on density, <Q|R> conditional profiles, dissipation
    conditioned on local Mach.
    """
    if nbins < 1:
        raise ValueError(f"nbins must be >= 1, got {nbins}")
    if xvalues.size == 0:
        raise ValueError("binned_statistic needs at least one sample")
    if tuple(xvalues.shape) != tuple(yvalues.shape):
        raise ValueError(
            f"x shape {tuple(xvalues.shape)} does not match y shape {tuple(yvalues.shape)}"
        )
    weighted = weights is not None
    if weighted and tuple(weights.shape) != tuple(xvalues.shape):
        raise ValueError(
            f"weights shape {tuple(weights.shape)} does not match x shape {tuple(xvalues.shape)}"
        )
    auto = vrange is None
    if auto:
        lo_in = hi_in = 0.0
    else:
        lo_in, hi_in = (float(v) for v in vrange)
        if not hi_in > lo_in:
            raise ValueError(f"vrange must satisfy lo < hi, got ({lo_in}, {hi_in})")
    w_in = weights if weighted else xvalues  # ignored when unweighted
    packed = np.asarray(
        _binned_stat_fn(int(nbins), auto, weighted)(xvalues, yvalues, w_in, lo_in, hi_in),
        dtype=np.float64,
    )
    lo, hi, ymean = packed[:3].tolist()
    counts = packed[3 : 3 + nbins] * 4096.0 + packed[3 + nbins : 3 + 2 * nbins]

    def dd_row(k: int) -> np.ndarray:
        # k-th double-word block after the count rows: hi row + lo row
        base = 3 + 2 * nbins + 2 * k * nbins
        return packed[base : base + nbins] + packed[base + nbins : base + 2 * nbins]

    sy = dd_row(0)
    syy = dd_row(1)
    norm = dd_row(2) if weighted else counts
    edges = np.linspace(lo, hi, nbins + 1)
    with np.errstate(invalid="ignore", divide="ignore"):
        mean_c = sy / norm
        var = syy / norm - mean_c**2
        mean = np.where(counts > 0, ymean + mean_c, np.nan)
        std = np.where(counts > 0, np.sqrt(np.maximum(var, 0.0)), np.nan)
    out = {
        "edges": edges,
        "centers": 0.5 * (edges[1:] + edges[:-1]),
        "counts": counts,
        "mean": mean,
        "std": std,
    }
    if weighted:
        out["weight_sums"] = norm
    return out
