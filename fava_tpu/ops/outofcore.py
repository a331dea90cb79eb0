"""Out-of-core flagship analysis for volumes exceeding one device's memory.

A 2048^3 float32 snapshot needs 4 x 34 GB of fields plus FFT
temporaries — more than one 80 GB device holds. The multi-device
answer is the sharded flagship (slab sharding + sharded FFT), but a
single device can still run the FULL spectra + profile suite by
streaming:

Stage A (one pass over x-slabs, host -> device):
  upload (dens, velx, vely, velz) slabs; per velocity component compute
  w = sqrt(dens) * v and apply the z (real) and y (complex) DFTs — both
  LOCAL to an x-slab — writing into three device-resident zy-spectra
  buffers (complex64, the dominant memory cost: 3 x nx*ny*(nz/2+1)*8 B).
  The same slab visit computes the profile row moments: on a uniform
  volume every x-row is one profile bin, entirely inside its slab, so
  the raw AND centered moments finish in this single pass.

Stage B (kx-chunked, device-only):
  the x-axis DFT couples slabs but is a matmul over x — apply it one
  kx-chunk at a time (einsum with a (chunk, nx) DFT matrix slice), form
  the spectral powers, and shell-bin each chunk as it is produced
  (scatter-add with the chunk's kx offset).
  Peak extra memory is one chunk (~chunk/nx of a full volume).

The result dict matches flagship.uniform_analysis_step exactly (same
keys, same math; validated in tests/test_outofcore.py). Reference being
replaced at this scale: redundant full-volume np.fft.fftn per rank,
fava/mesh/FLASH/FlashUniform.py:268.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Callable, Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from fava_tpu.ops import dft
from fava_tpu.ops.profiles import centered_row_moments, row_moments
from fava_tpu.ops.spectra import rfft_power_volumes, rfft_shell_counts, shell_bin_rfft
from fava_tpu.utils import accum_dtype

# field_slab(name, x0, x1) -> np.ndarray of shape (x1-x0, ny, nz)
SlabLoader = Callable[[str, int, int], np.ndarray]

FIELDS = ("dens", "velx", "vely", "velz")


def _slab_stream(
    field_slab: SlabLoader,
    names,
    nx: int,
    slab_rows: int,
    dtype,
    *,
    depth: int = 2,
    wire_dtype=None,
):
    """Double-buffered slab iterator: yields ``(x0, [device slabs])``
    in x order while ``depth`` background workers read and device_put
    the NEXT slabs under the current slab's compute (the same overlap
    io/ingest.SnapshotPrefetcher gives whole snapshots: a synchronous
    loop serializes HDF5 read -> host-to-device transfer -> compute).
    Reference contrast: synchronous root-reads,
    fava/mesh/FLASH/_flash.py:306-341.

    ``wire_dtype`` (e.g. ``jnp.bfloat16``) casts on host and widens to
    ``dtype`` on device — halving host-to-device bytes, at the cost of
    bf16 rounding of the raw fields (opt-in).

    Peak memory holds ``depth + 1`` slab sets on device — size
    ``slab_rows`` accordingly near the device memory ceiling.
    """
    import concurrent.futures as cf

    wd = None if wire_dtype is None else jnp.dtype(wire_dtype)

    def load(x0: int):
        out = []
        for name in names:
            host = np.asarray(field_slab(name, x0, x0 + slab_rows))
            if wd is not None and host.dtype != wd:
                host = host.astype(wd)
            dev = jax.device_put(host)
            if dev.dtype != jnp.dtype(dtype):
                dev = dev.astype(dtype)  # widen on device (async)
            out.append(dev)
        return out

    # Clamp like io/ingest.SnapshotPrefetcher: depth <= 0 would prime
    # an empty/negative-sliced window (pop from empty list at 0;
    # duplicate slab loads at -1) — 1 is the minimum that still
    # overlaps the next read with the current compute.
    depth = max(1, int(depth))
    starts = list(range(0, nx, slab_rows))
    with cf.ThreadPoolExecutor(max_workers=depth) as pool:
        pending = [pool.submit(load, x0) for x0 in starts[:depth]]
        nxt = depth
        try:
            for x0 in starts:
                fut = pending.pop(0)
                if nxt < len(starts):
                    pending.append(pool.submit(load, starts[nxt]))
                    nxt += 1
                yield x0, fut.result()
        finally:
            # If the consumer raises (e.g. device OOM mid-stage), cancel
            # the prefetch window: otherwise the suspended generator's
            # pending futures keep device_put-ing slabs into an
            # already-exhausted device memory and pin their buffers through the
            # caller's recovery (the traceback-pins-buffers class).
            for fut in pending:
                fut.cancel()
            pending.clear()


def _zy_buffers(ncomp: int, shape: Tuple[int, int, int], dtype):
    """Planar (re, im) zy-spectra accumulation buffers, one pair per
    component — the layout every streamed entry point feeds stage A
    (planar rationale in :func:`_stage_a_comp_fn`)."""
    nx, ny, nz = shape
    nzr = nz // 2 + 1
    return [
        (jnp.zeros((nx, ny, nzr), dtype=dtype), jnp.zeros((nx, ny, nzr), dtype=dtype))
        for _ in range(ncomp)
    ]


def _dft_chunks(dmat: np.ndarray, chunk_rows: int):
    """Yield ``(kx0, dxr, dxi)`` row-chunks of a (possibly normalized)
    x-DFT matrix as device-ready planar f32 constants — the kx-chunk
    iteration every streamed stage B shares."""
    for kx0 in range(0, dmat.shape[0], chunk_rows):
        yield (
            kx0,
            jnp.asarray(dmat[kx0 : kx0 + chunk_rows].real.copy()),
            jnp.asarray(dmat[kx0 : kx0 + chunk_rows].imag.copy()),
        )


def _corr_marginals(bufs, shape: Tuple[int, int, int], chunk_rows: int, dtype):
    """Accumulate per-component power marginals over kx chunks.

    Runs :func:`_corr_chunk_fn` chunk by chunk and returns
    ``(mx, my, mz, corners)`` where ``mx[c]`` is the list of x-marginal
    chunks, ``my[c]``/``mz[c]`` the summed y/z marginals, and
    ``corners[c]`` the k=0 power of component ``c`` (grabbed from the
    first chunk). Shared by streamed_velocity_correlations (3
    components) and streamed_two_point_lines (1)."""
    nx = shape[0]
    chunk_fn = _corr_chunk_fn(shape, dft.PRECISION)
    dmat = dft._dft_mat(nx, jnp.dtype(dtype).name)  # unnormalized
    nc = len(bufs)
    mx = [[] for _ in range(nc)]
    my = [None] * nc
    mz = [None] * nc
    corners = [None] * nc
    for kx0, dxr, dxi in _dft_chunks(dmat, chunk_rows):
        outs = chunk_fn(bufs, dxr, dxi)
        for c, (rx, ry, rz, pc) in enumerate(outs):
            mx[c].append(rx)
            my[c] = ry if my[c] is None else my[c] + ry
            mz[c] = rz if mz[c] is None else mz[c] + rz
            if kx0 == 0:
                corners[c] = pc
    return mx, my, mz, corners


def _axis_lines_from_marginals(mx_chunks, my, mz, corner_dev, shape: Tuple[int, int, int]):
    """Host finalization of one component's per-axis correlation lines.

    Assembles the f64 marginals from the device chunks, subtracts the
    k=0 corner (each marginal double-counts it; see
    ops/twopoint._power_marginal — the numpy twin of this pipeline),
    folds the SIGNED x and y axes to rfft layout (even part), inverse
    transforms, and applies the n/ntot^2 normalization. Returns the
    three half-axis lines [R_x, R_y, R_z]."""
    nx, ny, nz = shape
    ntot = nx * ny * nz
    corner = float(np.asarray(corner_dev, dtype=np.float64))
    marg_x = np.concatenate([np.asarray(r, dtype=np.float64) for r in mx_chunks])
    marg_y = np.array(my, dtype=np.float64)
    marg_z = np.array(mz, dtype=np.float64)
    marg_x[0] -= corner
    marg_y[0] -= corner
    marg_z[0] -= corner

    def fold_signed(m, n):
        return (0.5 * (m + np.roll(m[::-1], 1)))[: n // 2 + 1]

    margs = (fold_signed(marg_x, nx), fold_signed(marg_y, ny), marg_z)
    return [
        np.fft.irfft(marg, n=n)[: n // 2 + 1] * (n / float(ntot) ** 2)
        for marg, n in zip(margs, (nx, ny, nz))
    ]


def _check_divisible(nx: int, slab_rows: int, chunk_rows: int) -> None:
    # an assert would vanish under python -O and surface later as an
    # opaque XLA broadcast error from the short final chunk
    if nx % slab_rows != 0 or nx % chunk_rows != 0:
        raise ValueError(
            f"slab_rows ({slab_rows}) and chunk_rows ({chunk_rows}) must divide "
            f"nx ({nx}); the mesh wrappers round to the nearest divisor"
        )


@lru_cache(maxsize=8)
def _stage_a_comp_fn(full_shape: Tuple[int, int, int], precision=None, weighted: bool = True):
    """One component's slab transform + buffer update (donated).

    Split per component so only ONE buffer's einsum temporaries are
    live at a time (a fused 3-buffer program holds ~3.7 GB of HLO temps
    at 1024^3). The zy spectra are stored PLANAR (separate re/im f32
    buffers): XLA materializes full-size real/imag extraction temps
    when matmul-contracting a complex64 array.

    ``weighted`` transforms the flagship's sqrt(rho)-weighted variable;
    the streamed turbulence summary transforms the RAW velocities.
    """
    nx, ny, nz = full_shape
    precision = dft.PRECISION if precision is None else precision

    def run(buf_re, buf_im, d_slab, v, i0):
        rdt = d_slab.dtype.name
        cr, ci = (jnp.asarray(m) for m in dft._rdft_mats(nz, rdt))
        dy = dft._dft_mat(ny, rdt)
        dyr = jnp.asarray(dy.real.copy())
        dyi = jnp.asarray(dy.imag.copy())
        w = jnp.sqrt(d_slab) * v if weighted else v
        zre = jnp.einsum("xyz,zk->xyk", w, cr, precision=precision)
        zim = jnp.einsum("xyz,zk->xyk", w, ci, precision=precision)
        # Complex y-DFT as real matmuls (keeps everything planar).
        yre, yim = dft.planar_complex_matmul(
            "ab,xbz->xaz", dyr, dyi, zre, zim, precision=precision
        )
        zero = jnp.zeros((), dtype=i0.dtype)
        return (
            jax.lax.dynamic_update_slice(buf_re, yre, (i0, zero, zero)),
            jax.lax.dynamic_update_slice(buf_im, yim, (i0, zero, zero)),
        )

    return jax.jit(run, donate_argnums=(0, 1))


@lru_cache(maxsize=8)
def _stage_a_moments_fn(full_shape: Tuple[int, int, int]):
    nx, ny, nz = full_shape

    def run(d_slab, vx, vy, vz):
        # Profile moments: each x-row is a whole profile bin.
        fields = (d_slab[None], vx[None], vy[None], vz[None])
        raw = row_moments(fields, raxis=0, nvel=3)[:, 0, :]
        means = (raw[1:4].astype(accum_dtype()) / (ny * nz)).astype(d_slab.dtype)
        cen = centered_row_moments(fields, means[:, None, :], raxis=0, nvel=3)[:, 0, :]
        return raw, cen

    return jax.jit(run)


@lru_cache(maxsize=8)
def _stage_b_fn(full_shape: Tuple[int, int, int], chunk: int, nbins: int, precision=None):
    nx, ny, nz = full_shape
    precision = dft.PRECISION if precision is None else precision

    def run(bufs, dxr, dxi, kx0, acc_sums):
        # dxr/dxi: (chunk, nx) real/imag DFT rows, pre-scaled by 1/ntot.
        # Planar real matmuls per component; complex only at chunk size.
        ws = []
        for b_re, b_im in bufs:
            wre, wim = dft.planar_complex_matmul(
                "kx,xyz->kyz", dxr, dxi, b_re, b_im, precision=precision
            )
            ws.append(jax.lax.complex(wre, wim))
        jxg = kx0 + jnp.arange(chunk)
        kxv = jnp.where(jxg <= (nx - 1) // 2, jxg, jxg - nx).astype(ws[0].real.dtype)
        total, longi, trans, _ = rfft_power_volumes(
            ws, full_shape, jx=jxg, kx=kxv
        )
        # Values only: chunk counts sum to a pure shape function,
        # substituted from the static table by the caller.
        _, sums = shell_bin_rfft((total, longi, trans), nbins, nx, nz, kx0)
        return acc_sums + sums

    return jax.jit(run)


def streamed_uniform_analysis(
    field_slab: SlabLoader,
    shape: Tuple[int, int, int],
    *,
    slab_rows: int = 64,
    chunk_rows: int = 128,
    dtype=jnp.float32,
    wire_dtype=None,
    prefetch_depth: int = 2,
) -> Dict[str, np.ndarray]:
    """Full spectra + Reynolds/Favre profile suite, streamed from host.

    Matches flagship.uniform_analysis_step's output dict for volumes
    that cannot be device-resident. ``slab_rows``/``chunk_rows`` must
    divide nx. Slab ingest is double-buffered (``prefetch_depth``
    background read+transfer workers); ``wire_dtype=jnp.bfloat16``
    halves host-to-device bytes (opt-in, see _slab_stream).
    """
    nx, ny, nz = (int(s) for s in shape)
    _check_divisible(nx, slab_rows, chunk_rows)
    nzr = nz // 2 + 1
    nbins = max(shape) // 2 - 1
    adt = accum_dtype()

    bufs = _zy_buffers(3, (nx, ny, nz), dtype)
    # Builders are lru_cached (keyed on shape + the precision knob) so a
    # streamed SERIES retraces nothing per snapshot — a fresh jit per
    # call re-embedded the (ny, ny) DFT matrices into every trace.
    stage_a = _stage_a_comp_fn((nx, ny, nz), dft.PRECISION)
    stage_a_moments = _stage_a_moments_fn((nx, ny, nz))

    raws = []
    cens = []
    for x0, slabs in _slab_stream(
        field_slab, FIELDS, nx, slab_rows, dtype, depth=prefetch_depth, wire_dtype=wire_dtype
    ):
        i0 = jnp.asarray(x0, dtype=jnp.int32)
        for c in range(3):
            bufs[c] = stage_a(*bufs[c], slabs[0], slabs[1 + c], i0)
        raw, cen = stage_a_moments(*slabs)
        raws.append(raw)
        cens.append(cen)

    raw = jnp.concatenate([r.astype(adt) for r in raws], axis=-1)  # (7, nx)
    cen = jnp.concatenate([c.astype(adt) for c in cens], axis=-1)  # (9, nx)

    # --- Stage B: kx-chunked x-DFT + powers + binning -----------------
    stage_b = _stage_b_fn((nx, ny, nz), chunk_rows, nbins, dft.PRECISION)
    dmat = dft._dft_mat(nx, jnp.dtype(dtype).name) / (nx * ny * nz)
    sums = jnp.zeros((3, nbins), dtype=adt)
    for kx0, dxr, dxi in _dft_chunks(dmat, chunk_rows):
        sums = stage_b(bufs, dxr, dxi, jnp.asarray(kx0, dtype=jnp.int32), sums)
    # Counts are a pure shape function (see rfft_shell_counts).
    counts = jnp.asarray(rfft_shell_counts((nx, ny, nz), nbins, str(jnp.dtype(adt))))

    # --- Assemble the flagship output dict ----------------------------
    from fava_tpu.ops.profiles import assemble_profile_stats

    layer = jnp.asarray(ny * nz, dtype=adt)
    d_row = raw[0]
    mean_d = d_row / layer
    means = raw[1:4] / layer  # slab means ARE the bin means (rows = bins)
    stress, favre_mean, favre_rms = assemble_profile_stats(
        d_row, means, cen[6:9], cen[:6], layer
    )

    out = {
        "spectra_counts": counts,
        "spectra_total": sums[0],
        "spectra_longitudinal": sums[1],
        "spectra_transverse": sums[2],
        "mean_dens": mean_d,
        "reynolds_stress": stress,
        "favre_mean": favre_mean,
        "favre_rms": favre_rms,
        "total_mass": jnp.sum(d_row),
    }
    return {k: np.asarray(v) for k, v in out.items()}


@lru_cache(maxsize=8)
def _summary_slab_fn(full_shape: Tuple[int, int, int], has_mach: bool):
    """Per-slab real-space accumulators for the streamed summary:
    [sum u^2, sum rho u^2, sum rho, sum log rho, sum (log rho)^2]
    (+ [sum M^2, max M^2, sum c_s] with mach inputs). The log-density
    moments are SHIFT-invariant (sigma_s^2 = Var[log rho]; mean_s =
    E[log rho] - log E[rho]), so one pass suffices even though
    s = log(rho/<rho>) references the global mean."""

    def run(d, vx, vy, vz, *mach_args):
        adt = accum_dtype()
        u2 = vx.astype(adt) ** 2 + vy.astype(adt) ** 2 + vz.astype(adt) ** 2
        da = d.astype(adt)
        ld = jnp.log(da)
        acc = [
            jnp.sum(u2),
            jnp.sum(da * u2),
            jnp.sum(da),
            jnp.sum(ld),
            jnp.sum(ld * ld),
        ]
        if has_mach:
            pres, gamma = mach_args
            cs2 = gamma.astype(adt) * pres.astype(adt) / da
            m2 = u2 / cs2
            acc += [jnp.sum(m2), jnp.max(m2), jnp.sum(jnp.sqrt(cs2))]
        return jnp.stack(acc)

    return jax.jit(run)


@lru_cache(maxsize=8)
def _summary_chunk_fn(full_shape: Tuple[int, int, int], chunk: int, lengths, precision=None):
    """Per-kx-chunk spectral accumulators for the streamed summary:
    [e_sum, mean_e, m_inv, m_2, comp_e, dil_sum, ens_sum] — the exact
    Hermitian sums of ops/velocity._turbulence_summary_fn, accumulated
    chunk by chunk (same math, same k conventions)."""
    from fava_tpu.ops.velocity import _hermitian_weights, _k_grids

    nx, ny, nz = full_shape
    precision = dft.PRECISION if precision is None else precision

    def run(bufs, dxr, dxi, kxv, kx0, acc):
        adt = accum_dtype()
        ws = []
        for b_re, b_im in bufs:
            wre, wim = dft.planar_complex_matmul(
                "kx,xyz->kyz", dxr, dxi, b_re, b_im, precision=precision
            )
            ws.append(jax.lax.complex(wre, wim))
        rdt = ws[0].real.dtype
        # ky/kz: static grids of the (ny, nz) trailing axes; kx arrives
        # per chunk (zero-Nyquist, physical) as a traced vector.
        _, kyg, kzg = _k_grids(full_shape, rdt, lengths, zero_nyquist=True)
        kx = kxv.astype(rdt).reshape(-1, 1, 1)
        ky = kyg.reshape(1, -1, 1)
        kz = kzg.reshape(1, 1, -1)
        ks = (kx, ky, kz)
        k2 = kx * kx + ky * ky + kz * kz
        hw = _hermitian_weights(full_shape, adt)

        e_mode = sum((0.5 * jnp.abs(w) ** 2).astype(adt) for w in ws) * hw
        e_sum = jnp.sum(e_mode)
        kmag = jnp.sqrt(k2).astype(adt)
        inv_k = jnp.where(kmag > 0, 1.0 / jnp.maximum(kmag, 1e-30), 0.0)
        m_inv = jnp.sum(e_mode * inv_k)
        m_2 = jnp.sum(e_mode * k2.astype(adt))
        # the k = (0,0,0) mean-flow mode, identified by grid INDEX —
        # the zero-Nyquist convention also zeroes the k VALUES at the
        # Nyquist indices, so a value mask would overcount (hw at the
        # corner is 1)
        jx = kx0 + jnp.arange(chunk).reshape(-1, 1, 1)
        jy = jnp.arange(ny).reshape(1, -1, 1)
        jz = jnp.arange(nz // 2 + 1).reshape(1, 1, -1)
        corner = ((jx == 0) & (jy == 0) & (jz == 0)).astype(adt)
        mean_e = jnp.sum(e_mode * corner)

        div = sum(k * w for k, w in zip(ks, ws))
        div2 = (jnp.abs(div) ** 2).astype(adt) * hw
        comp_e = jnp.sum(0.5 * div2 / jnp.maximum(k2.astype(adt), 1e-30))
        dil_sum = jnp.sum(div2)  # div_amp2 * k^2 == |sum k w|^2

        wx, wy, wz = ws
        curls = (ky * wz - kz * wy, kz * wx - kx * wz, kx * wy - ky * wx)
        ens_sum = sum(jnp.sum((jnp.abs(c) ** 2).astype(adt) * hw) for c in curls)

        return acc + jnp.stack([e_sum, mean_e, m_inv, m_2, comp_e, dil_sum, ens_sum])

    return jax.jit(run)


def streamed_turbulence_summary(
    field_slab: SlabLoader,
    shape: Tuple[int, int, int],
    *,
    slab_rows: int = 64,
    chunk_rows: int = 128,
    dtype=jnp.float32,
    gamma=5.0 / 3.0,
    lengths=None,
    with_mach: bool = False,
    wire_dtype=None,
    prefetch_depth: int = 2,
) -> Dict[str, float]:
    """Out-of-core twin of ops/velocity.turbulence_summary.

    Streams x-slabs from host exactly like streamed_uniform_analysis
    (same two-stage plan, RAW-velocity zy buffers) and accumulates the
    summary's Hermitian spectral moments kx-chunk by kx-chunk — the
    full scalar turbulence report for volumes beyond one device's
    memory. ``with_mach`` additionally streams
    ``pres``/``gamc`` slabs for the Mach statistics (``gamma`` is the
    fallback ratio when the loader raises KeyError for gamc). Output
    keys and math match turbulence_summary exactly
    (tests/test_outofcore.py).
    """
    nx, ny, nz = (int(s) for s in shape)
    _check_divisible(nx, slab_rows, chunk_rows)
    nzr = nz // 2 + 1
    adt = accum_dtype()
    ntot = nx * ny * nz
    lengths_key = None if lengths is None else tuple(float(L) for L in lengths)

    bufs = _zy_buffers(3, (nx, ny, nz), dtype)
    stage_a = _stage_a_comp_fn((nx, ny, nz), dft.PRECISION, weighted=False)
    slab_stats = _summary_slab_fn((nx, ny, nz), with_mach)

    names = FIELDS
    has_gamc = False
    if with_mach:
        names = names + ("pres",)
        try:  # probe ONCE: a per-slab try inside threads would race
            field_slab("gamc", 0, min(1, nx))
            has_gamc = True
            names = names + ("gamc",)
        except KeyError:
            pass

    real_accs = []  # device-resident per-slab stat vectors, ONE fetch
    for x0, slabs in _slab_stream(
        field_slab, names, nx, slab_rows, dtype, depth=prefetch_depth, wire_dtype=wire_dtype
    ):
        i0 = jnp.asarray(x0, dtype=jnp.int32)
        for c in range(3):
            bufs[c] = stage_a(*bufs[c], slabs[0], slabs[1 + c], i0)
        extra = []
        if with_mach:
            g = slabs[5] if has_gamc else jnp.asarray(gamma, dtype=dtype)
            extra = [slabs[4], g]
        real_accs.append(slab_stats(*slabs[:4], *extra))
    per_slab = np.asarray(jnp.stack(real_accs), dtype=np.float64)
    real = per_slab.sum(axis=0)
    if with_mach:
        max_m2 = float(per_slab[:, 6].max())  # max does not sum across slabs

    # --- spectral moments, kx-chunk by kx-chunk ------------------------
    from fava_tpu.ops.velocity import _phys_factors

    fx = _phys_factors(lengths_key, 3)[0]
    j = np.arange(nx)
    kx_all = (np.where(j <= (nx - 1) // 2, j, j - nx) * fx).astype(np.float64)
    if nx % 2 == 0:
        kx_all[nx // 2] = 0.0  # zero-Nyquist derivative convention

    chunk_fn = _summary_chunk_fn((nx, ny, nz), chunk_rows, lengths_key, dft.PRECISION)
    dmat = dft._dft_mat(nx, jnp.dtype(dtype).name) / ntot
    acc = jnp.zeros(7, dtype=adt)
    for kx0, dxr, dxi in _dft_chunks(dmat, chunk_rows):
        kxv = jnp.asarray(kx_all[kx0 : kx0 + chunk_rows], dtype=dtype)
        acc = chunk_fn(bufs, dxr, dxi, kxv, jnp.asarray(kx0, dtype=jnp.int32), acc)
    e_sum, mean_e, m_inv, m_2, comp_e, dil_sum, ens_sum = (
        np.asarray(acc, dtype=np.float64).tolist()
    )

    # --- assemble (identical formulas to _turbulence_summary_fn) ------
    sum_u2, sum_du2, sum_d, sum_ld, sum_ld2 = real[:5]
    out = {
        "u_rms": float(np.sqrt(sum_u2 / ntot)),
        "kinetic_energy": float(0.5 * sum_u2 / ntot),
        "kinetic_energy_density": float(0.5 * sum_du2 / ntot),
    }
    mu_ld = sum_ld / ntot
    out["mean_s"] = float(mu_ld - np.log(sum_d / ntot))
    out["sigma_s"] = float(np.sqrt(max(sum_ld2 / ntot - mu_ld**2, 0.0)))
    if with_mach:
        out["mach_rms"] = float(np.sqrt(real[5] / ntot))
        out["mach_max"] = float(np.sqrt(max_m2))
        out["sound_speed_mean"] = float(real[7] / ntot)
    e_fluct = e_sum - mean_e
    out["integral_scale"] = float((3.0 * np.pi / 4.0) * m_inv / max(e_fluct, 1e-30))
    out["taylor_scale"] = float(np.sqrt(5.0 * e_fluct / max(m_2, 1e-30)))
    out["compressive_fraction"] = float(comp_e / max(e_sum, 1e-30))
    out["solenoidal_fraction"] = 1.0 - out["compressive_fraction"]
    out["dilatation_rms"] = float(np.sqrt(dil_sum))
    out["vorticity_rms"] = float(np.sqrt(ens_sum))
    return out


@lru_cache(maxsize=8)
def _corr_chunk_fn(full_shape: Tuple[int, int, int], precision=None):
    """Per-kx-chunk power-marginal accumulators for the streamed
    velocity correlations: for each component's chunk spectrum returns
    (mx_rows (chunk,), my (ny,), mz (nz//2+1,), corner) — the
    Hermitian-weighted plane sums whose 1D inverse transforms are the
    axis line correlations (ops/twopoint.py module docstring; the
    trailing-axis marginal stays half-layout, irfft applies the pair
    weights itself). ``corner`` is this chunk's row-0 p[0, 0, 0] —
    only meaningful for the kx0 = 0 chunk, where it is the SAME
    f32 value embedded in the marginals, so the caller's mean removal
    cancels bit-exactly (a host-recomputed (sum v)^2 differs by the
    DFT's emulation error and catastrophically cancels for mean
    flows)."""
    from fava_tpu.ops.velocity import _hermitian_weights

    nx, ny, nz = full_shape
    precision = dft.PRECISION if precision is None else precision

    def run(bufs, dxr, dxi):
        adt = accum_dtype()
        hw = _hermitian_weights(full_shape, adt)
        outs = []
        for b_re, b_im in bufs:
            wre, wim = dft.planar_complex_matmul(
                "kx,xyz->kyz", dxr, dxi, b_re, b_im, precision=precision
            )
            p = (wre.astype(adt) ** 2 + wim.astype(adt) ** 2)
            ph = p * hw
            outs.append(
                (
                    jnp.sum(ph, axis=(1, 2)),  # x marginal rows (signed kx)
                    jnp.sum(ph, axis=(0, 2)),  # y marginal
                    jnp.sum(p, axis=(0, 1)),  # z half-marginal (no hw)
                    p[0, 0, 0],  # hw there is 1
                )
            )
        return tuple(outs)

    return jax.jit(run)


def streamed_velocity_correlations(
    field_slab: SlabLoader,
    shape: Tuple[int, int, int],
    *,
    slab_rows: int = 64,
    chunk_rows: int = 128,
    dtype=jnp.float32,
    lengths=None,
    wire_dtype=None,
    prefetch_depth: int = 2,
) -> Dict[str, np.ndarray]:
    """Out-of-core twin of ops/twopoint.velocity_correlations.

    Same streamed two-stage plan as the summary: raw-velocity zy
    buffers (dens is never read — the correlations are unweighted),
    then per-kx-chunk POWER MARGINALS (plane sums) — the axis line
    correlations are 1D inverse transforms of those tiny marginals, so
    no correlation volume (and no inverse volume transform) ever
    exists. Component means are removed exactly by subtracting the
    k = 0 corner power taken from the SAME transformed data (mean
    removal only changes the k = 0 mode; the corner is the identical
    f32 value embedded in the marginals, so the subtraction cancels
    bit-exactly even for strong mean flows). Outputs match
    velocity_correlations (tests/test_outofcore.py).
    """
    from fava_tpu.ops.twopoint import assemble_karman_howarth

    nx, ny, nz = (int(s) for s in shape)
    _check_divisible(nx, slab_rows, chunk_rows)

    bufs = _zy_buffers(3, (nx, ny, nz), dtype)
    stage_a = _stage_a_comp_fn((nx, ny, nz), dft.PRECISION, weighted=False)

    # weighted=False never touches the density operand: pass the
    # component itself so the dens volume is never read/transferred
    # (~4.3 GB of host-to-device traffic at 1024^3 for discarded data)
    for x0, slabs in _slab_stream(
        field_slab,
        ("velx", "vely", "velz"),
        nx,
        slab_rows,
        dtype,
        depth=prefetch_depth,
        wire_dtype=wire_dtype,
    ):
        i0 = jnp.asarray(x0, dtype=jnp.int32)
        for c in range(3):
            bufs[c] = stage_a(*bufs[c], slabs[c], slabs[c], i0)

    mx, my, mz, corners = _corr_marginals(bufs, (nx, ny, nz), chunk_rows, dtype)
    lines = [
        _axis_lines_from_marginals(mx[c], my[c], mz[c], corners[c], (nx, ny, nz))
        for c in range(3)
    ]  # [comp][axis]
    return assemble_karman_howarth(lines, (nx, ny, nz), lengths)


def streamed_two_point_lines(
    field_slab: SlabLoader,
    shape: Tuple[int, int, int],
    field: str = "dens",
    *,
    slab_rows: int = 64,
    chunk_rows: int = 128,
    dtype=jnp.float32,
    lengths=None,
    wire_dtype=None,
    prefetch_depth: int = 2,
) -> Dict[str, np.ndarray]:
    """Out-of-core axis-line two-point correlation of one scalar field.

    The line subset of ops/twopoint.two_point_correlation for
    beyond-device-memory volumes, via the same per-kx-chunk power marginals as
    streamed_velocity_correlations (one component). The shell-averaged
    R(|r|) curve is NOT produced — it needs the full correlation
    volume, which is exactly what streaming avoids; the per-axis lines
    and integral scales (and ``variance`` = R(0)) match the in-core
    analysis (tests/test_outofcore.py).
    """
    from fava_tpu.ops.twopoint import _integral_scale

    nx, ny, nz = (int(s) for s in shape)
    _check_divisible(nx, slab_rows, chunk_rows)

    bufs = _zy_buffers(1, (nx, ny, nz), dtype)
    stage_a = _stage_a_comp_fn((nx, ny, nz), dft.PRECISION, weighted=False)
    for x0, (slab,) in _slab_stream(
        field_slab, (field,), nx, slab_rows, dtype, depth=prefetch_depth, wire_dtype=wire_dtype
    ):
        bufs[0] = stage_a(*bufs[0], slab, slab, jnp.asarray(x0, dtype=jnp.int32))

    mx, my, mz, corners = _corr_marginals(bufs, (nx, ny, nz), chunk_rows, dtype)
    lines = _axis_lines_from_marginals(mx[0], my[0], mz[0], corners[0], (nx, ny, nz))

    ls = tuple(float(L) for L in lengths) if lengths is not None else (1.0,) * 3
    out: Dict[str, np.ndarray] = {}
    var = None
    for a, (line, n, ax) in enumerate(zip(lines, (nx, ny, nz), "xyz")):
        if var is None:
            var = float(line[0])
            out["variance"] = var
        scale = var if var > 0 else 1.0
        dx = ls[a] / n
        out[f"r_{ax}"] = np.arange(line.size, dtype=np.float64) * dx
        out[f"R_{ax}"] = line / scale
        out[f"integral_scale_{ax}"] = _integral_scale(line, dx)
    return out


# --- streamed velocity-gradient statistics ------------------------------


@lru_cache(maxsize=8)
def _gradient_slab_fn(full_shape: Tuple[int, int, int], slab_rows: int, spacings):
    """Per-slab central gradient moments on a halo-extended x-slab.

    Input slabs carry ONE periodic halo row on each side
    ((slab_rows + 2, ny, nz)): x-derivatives are interior central
    differences of the extended slab; y/z derivatives wrap within the
    interior rows (periodic axes untouched by the slab split). Returns
    SLAB-LOCAL statistics — count-weighted means plus sums of centered
    powers/products — which the host combines exactly across slabs with
    the Chan/Pebay parallel-moment formulas (ops/gradients.py packs the
    in-core twin per-volume instead). Per-slab centering keeps the f32
    device sums well conditioned (each slab's mean is close to its own
    data); the cross-slab combination happens in float64 on host.
    """
    from fava_tpu.ops.gradients import _DIV_PAIRS, _ROT_PAIRS

    nx, ny, nz = full_shape
    adt = accum_dtype()

    def run(vx_e, vy_e, vz_e):
        vels_e = (vx_e, vy_e, vz_e)

        def grad(i, j):
            u = vels_e[i]
            if j == 0:
                d = (u[2:] - u[:-2]) / jnp.asarray(2.0 * spacings[0], dtype=u.dtype)
            else:
                ui = u[1:-1]
                d = (jnp.roll(ui, -1, axis=j) - jnp.roll(ui, 1, axis=j)) / jnp.asarray(
                    2.0 * spacings[j], dtype=u.dtype
                )
            return d.astype(adt)

        gmean = {(i, j): jnp.mean(grad(i, j)) for i in range(3) for j in range(3)}

        def fluct(i, j):
            return grad(i, j) - gmean[(i, j)]

        acc = []
        for i in range(3):
            for j in range(3):
                f = fluct(i, j)
                f2 = f * f
                acc += [gmean[(i, j)], jnp.sum(f2), jnp.sum(f2 * f), jnp.sum(f2 * f2)]
        for a, b in _ROT_PAIRS[3]:
            acc.append(jnp.sum(fluct(a, b) * fluct(b, a)))
        for i, j in _DIV_PAIRS[3]:
            acc.append(jnp.sum(fluct(i, i) * fluct(j, j)))
        for c in range(3):
            u = vels_e[c][1:-1].astype(adt)
            um = jnp.mean(u)
            acc += [um, jnp.sum((u - um) ** 2)]
        return jnp.stack(acc)

    return jax.jit(run)


def _chan_combine(n_a, stats_a, n_b, stats_b):
    """Exact pairwise combination of (mean, S2, S3, S4[, ...]) partition
    statistics (Chan et al. 1979 / Pebay 2008), vectorized over entries.

    ``stats`` rows: mean, S2, S3, S4 with S_p = sum (x - mean)^p over
    the partition. Returns the merged row set.
    """
    mA, M2A, M3A, M4A = stats_a
    mB, M2B, M3B, M4B = stats_b
    n = n_a + n_b
    d = mB - mA
    mean = mA + d * (n_b / n)
    M2 = M2A + M2B + d**2 * (n_a * n_b / n)
    M3 = (
        M3A
        + M3B
        + d**3 * (n_a * n_b * (n_a - n_b) / n**2)
        + 3.0 * d * (n_a * M2B - n_b * M2A) / n
    )
    M4 = (
        M4A
        + M4B
        + d**4 * (n_a * n_b * (n_a**2 - n_a * n_b + n_b**2) / n**3)
        + 6.0 * d**2 * (n_a**2 * M2B + n_b**2 * M2A) / n**2
        + 4.0 * d * (n_a * M3B - n_b * M3A) / n
    )
    return mean, M2, M3, M4


def streamed_gradient_stats(
    field_slab: SlabLoader,
    shape: Tuple[int, int, int],
    *,
    slab_rows: int = 64,
    dtype=jnp.float32,
    lengths=None,
    wire_dtype=None,
    prefetch_depth: int = 2,
) -> Dict[str, "np.ndarray | float"]:
    """Out-of-core twin of ops/gradients.velocity_gradient_statistics.

    One pass over halo-extended x-slabs (each slab loads its two
    periodic neighbor rows, so the x central differences need no
    cross-slab state); per-slab central moments on device, exact
    float64 Chan/Pebay combination across slabs on host. Periodic
    boundary only — the "interior" mode serves windowed extracts,
    which fit in core by construction. Output dict matches the in-core
    analysis exactly (tests/test_outofcore.py).
    """
    from fava_tpu.ops.gradients import (
        _DIV_PAIRS,
        _ROT_PAIRS,
        _spacings,
        assemble_gradient_stats,
    )

    nx, ny, nz = (int(s) for s in shape)
    _check_divisible(nx, slab_rows, slab_rows)
    lengths_key = None if lengths is None else tuple(float(L) for L in lengths)
    spacings = _spacings((nx, ny, nz), lengths_key)
    slab_fn = _gradient_slab_fn((nx, ny, nz), slab_rows, spacings)

    def halo_loader(name: str, x0: int, x1: int) -> np.ndarray:
        lo = np.asarray(field_slab(name, (x0 - 1) % nx, (x0 - 1) % nx + 1))
        mid = np.asarray(field_slab(name, x0, x1))
        hi = np.asarray(field_slab(name, x1 % nx, x1 % nx + 1))
        return np.concatenate([lo, mid, hi], axis=0)

    vel_names = ("velx", "vely", "velz")
    accs = []  # device-resident per-slab stat vectors, ONE stacked fetch
    for _x0, slabs in _slab_stream(
        halo_loader, vel_names, nx, slab_rows, dtype,
        depth=prefetch_depth, wire_dtype=wire_dtype,
    ):
        accs.append(slab_fn(*slabs))
    per_slab = np.asarray(jnp.stack(accs), dtype=np.float64)

    # --- exact cross-slab combination (float64, host) -------------------
    n_slab = float(slab_rows * ny * nz)
    rot_pairs, div_pairs = _ROT_PAIRS[3], _DIV_PAIRS[3]
    n_g = 36  # 9 x [mean, S2, S3, S4]
    n_rot, n_div = len(rot_pairs), len(div_pairs)

    state = None  # (n, means(9,), M2, M3, M4, rot(3,), div(3,), u_mean(3,), u_M2(3,))
    for row in per_slab:
        g = row[:n_g].reshape(9, 4)
        rot = row[n_g : n_g + n_rot]
        div = row[n_g + n_rot : n_g + n_rot + n_div]
        u = row[n_g + n_rot + n_div :].reshape(3, 2)
        b = (n_slab, g[:, 0], g[:, 1], g[:, 2], g[:, 3], rot, div, u[:, 0], u[:, 1])
        if state is None:
            state = b
            continue
        nA = state[0]
        nB = n_slab
        n = nA + nB
        mean, M2, M3, M4 = _chan_combine(
            nA, state[1:5], nB, b[1:5]
        )
        # covariance combine: C = CA + CB + dx*dy*nA*nB/n, with dx/dy
        # the mean gaps of the two constituent gradients
        def gap(i, j):
            return b[1][i * 3 + j] - state[1][i * 3 + j]

        rot_c = np.array(
            [
                state[5][p] + b[5][p] + gap(a, bb) * gap(bb, a) * nA * nB / n
                for p, (a, bb) in enumerate(rot_pairs)
            ]
        )
        div_c = np.array(
            [
                state[6][p] + b[6][p] + gap(i, i) * gap(j, j) * nA * nB / n
                for p, (i, j) in enumerate(div_pairs)
            ]
        )
        du = b[7] - state[7]
        u_mean = state[7] + du * (nB / n)
        u_M2 = state[8] + b[8] + du**2 * (nA * nB / n)
        state = (n, mean, M2, M3, M4, rot_c, div_c, u_mean, u_M2)

    ntot, mean, M2, M3, M4, rot_c, div_c, u_mean, u_M2 = state
    # Re-pack as the in-core layout of central-moment MEANS and reuse
    # the shared assembly (one definition of every derived quantity).
    packed = []
    for k in range(9):
        packed += [mean[k], M2[k] / ntot, M3[k] / ntot, M4[k] / ntot]
    packed += list(rot_c / ntot) + list(div_c / ntot)
    for c in range(3):
        packed += [u_mean[c], u_M2[c] / ntot]
    return assemble_gradient_stats(np.asarray(packed), 3)
