"""Flagship fused analysis step.

One jittable program computing the headline workload of BASELINE.json —
kinetic-energy spectra (total/longitudinal/transverse, shell-binned)
plus Reynolds-stress and Favre profiles along x — on a uniform volume,
in a single pass structure that XLA fuses end-to-end. This is the
function the benchmark times and the multi-chip dryrun shards.

Sharding: the volume is slab-sharded along x over the mesh "space"
axis (pencil FFT via parallel.fft.pfft3 with an all_to_all transpose);
profile/shell reductions partition automatically under jit. A leading
snapshot batch axis may additionally shard over a "snap" axis.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict

import jax
import jax.numpy as jnp
from fava_tpu.utils import accum_dtype


def uniform_analysis_step(
    dens: jax.Array,
    velx: jax.Array,
    vely: jax.Array,
    velz: jax.Array,
    mesh=None,
) -> Dict[str, jax.Array]:
    """Spectra + Reynolds/Favre x-profiles of one uniform snapshot.

    Pure jnp; safe to wrap in jax.jit (mesh is baked in by closure).
    """
    shape = dens.shape
    nx, ny, nz = shape
    nbins = max(shape) // 2 - 1
    ntot = nx * ny * nz
    adt = accum_dtype()
    vels = (velx, vely, velz)

    # --- Spectra -------------------------------------------------------
    if mesh is None:
        # Real input: rfft halves the FFT and binning work; Hermitian
        # weights in the shell binning make results exactly equal to
        # the full-grid computation.
        sqrt_d = jnp.sqrt(dens)
        ffts = [jnp.fft.rfftn(sqrt_d * v) / ntot for v in vels]
        from fava_tpu.ops.spectra import rfft_power_volumes, shell_bin_rfft

        total, longi, trans, _ = rfft_power_volumes(ffts, (nx, ny, nz))
        counts, sums3 = shell_bin_rfft((total, longi, trans), nbins, nx, nz)
    else:
        # One shard_map: local FFTs + all_to_all transpose + local
        # binning + a single psum over the space axis.
        from fava_tpu.ops.spectra import sharded_power_spectra

        counts, sums3 = sharded_power_spectra(dens, vels, mesh, nbins)

    spectra = {
        "counts": counts,
        "total": sums3[0],
        "longitudinal": sums3[1],
        "transverse": sums3[2],
    }

    # --- Profiles along x (uniform grid: rows ARE the fine bins) ------
    layer = jnp.asarray(ny * nz, dtype=adt)
    pairs = [(i, j) for i in range(3) for j in range(i, 3)]

    if mesh is None:
        # Two fused passes: raw first moments, then *centered* second
        # moments about the per-row means — avoids the float32
        # cancellation of the one-pass algebraic expansion (~3e-4 rel
        # observed at 128^3; centered path is ~1e-6).
        from fava_tpu.ops.profiles import centered_row_moments, row_moments

        fields = tuple(a[None] for a in (dens, *vels))
        moments = row_moments(fields, raxis=0, nvel=3)[:, 0].astype(adt)
        d_row = moments[0]
        v_rows = [moments[1 + i] for i in range(3)]

        mean_d = d_row / layer
        means = [vr / layer for vr in v_rows]

        mu = jnp.stack(means)[:, None, :].astype(dens.dtype)
        centered = centered_row_moments(fields, mu, raxis=0, nvel=3)[:, 0].astype(adt)

        # Shared assembly (conditioning rationale documented there).
        from fava_tpu.ops.profiles import assemble_profile_stats

        stress, favre_mean, favre_rms = assemble_profile_stats(
            d_row, jnp.stack(means), centered[6:9], centered[:6], layer
        )
    else:
        # Same centered two-pass as the single-chip branch: the volume
        # is slab-sharded along x, so every row (= profile bin) lives
        # whole on one device and both passes stay collective-free
        # under GSPMD. The one-pass algebraic expansion cancels
        # catastrophically in float32 (~3e-4 relative observed), which
        # is the dtype real pods run in.

        def rows(x):
            return jnp.sum(x.astype(adt), axis=(1, 2))

        d_row = rows(dens)
        v_rows = [rows(v) for v in vels]

        mean_d = d_row / layer
        means = [vr / layer for vr in v_rows]

        cvels = [v - m[:, None, None].astype(v.dtype) for v, m in zip(vels, means)]
        c1 = [rows(dens * cv) for cv in cvels]
        cov = [rows(dens * cvels[i] * cvels[j]) for (i, j) in pairs]

        from fava_tpu.ops.profiles import assemble_profile_stats

        stress, favre_mean, favre_rms = assemble_profile_stats(
            d_row, jnp.stack(means), jnp.stack(c1), jnp.stack(cov), layer
        )

    return {
        **{f"spectra_{k}": v for k, v in spectra.items()},
        "mean_dens": mean_d,
        "reynolds_stress": stress,
        "favre_mean": favre_mean,
        "favre_rms": favre_rms,
        # Sum of the per-row density sums the moment pass already
        # produced — exactly the total mass, without re-reading the
        # 0.5 GB density volume (row-sum-then-sum only reorders the
        # reduction).
        "total_mass": jnp.sum(d_row),
    }


@lru_cache(maxsize=8)
def jitted_analysis_step(mesh=None):
    return jax.jit(lambda d, vx, vy, vz: uniform_analysis_step(d, vx, vy, vz, mesh=mesh))


def series_analysis_step(dens, velx, vely, velz):
    """Flagship step over a leading snapshot axis, in ONE dispatch.

    ``lax.scan`` runs the snapshots sequentially on device, so the
    per-dispatch host round trip is paid once per batch instead of
    once per snapshot, while the working set stays one snapshot wide
    (inputs aside). Outputs gain a leading snap axis.

    Single-chip tool: multi-chip series batching shards a leading snap
    axis over the mesh "snap" axis instead (see __graft_entry__'s
    dryrun, which vmaps the sharded step over snapshots).
    """

    def body(_, args):
        return None, uniform_analysis_step(*args, mesh=None)

    _, out = jax.lax.scan(body, None, (dens, velx, vely, velz))
    return out


@lru_cache(maxsize=1)
def jitted_series_step():
    return jax.jit(series_analysis_step)


def sharded_series_analysis_step(dens, velx, vely, velz, mesh):
    """Flagship step over a snapshot batch on a snap x space pod mesh.

    Inputs are (B, nx, ny, nz) stacked snapshots sharded
    ``P("snap", "space", None, None)``: the batch splits over the
    "snap" axis (snapshot data parallelism) while every volume is
    slab-sharded along x over "space". ONE shard_map over both axes;
    inside, each device row lax.scans its local snapshots so the
    working set stays one snapshot wide, running per snapshot:

      * the local pencil-FFT spectra body (all_to_all + psum over
        "space" only — snap rows never talk to each other;
        ops/spectra.py local_spectra_fn)
      * the centered two-pass profile moments on the local x-slab
        (every profile row lives whole on one device; one tiny
        all_gather over "space" assembles the (nx,) rows)

    This is the production driver for BASELINE config #5 (the
    multi-snapshot pod pipeline) — the thing the reference cannot do
    at all: it recomputes np.fft.fftn per rank on ONE snapshot at a
    time (reference: fava/mesh/FLASH/FlashUniform.py:268). Outputs
    carry a leading snapshot axis, exactly like series_analysis_step.
    """
    from jax.sharding import PartitionSpec as P

    from fava_tpu.ops import spectra as spectra_ops
    from fava_tpu.ops.profiles import VEL_PAIRS, assemble_profile_stats
    from fava_tpu.parallel import runtime as prt

    shape = tuple(int(s) for s in dens.shape[1:])
    nx, ny, nz = shape
    nbins = max(shape) // 2 - 1
    adt = accum_dtype()
    n_space = mesh.shape[prt.SPACE_AXIS]
    spec_local = spectra_ops.local_spectra_fn(shape, nbins, n_space, prt.SPACE_AXIS)
    layer = jnp.asarray(ny * nz, dtype=adt)
    pairs = VEL_PAIRS

    def one_snapshot(_, args):
        d, a, b, c = args  # local (nx/n_space, ny, nz) slabs
        counts, sums3 = spec_local(d, a, b, c)

        def lrows(x):
            return jnp.sum(x.astype(adt), axis=(1, 2))

        def gather(x):
            return jax.lax.all_gather(x, prt.SPACE_AXIS, axis=0, tiled=True)

        # Same centered two-pass as uniform_analysis_step's mesh branch
        # (float32 cancellation rationale there); every row is local.
        vels = (a, b, c)
        d_row_l = lrows(d)
        means_l = [lrows(v) / layer for v in vels]
        cvels = [v - m[:, None, None].astype(v.dtype) for v, m in zip(vels, means_l)]
        c1_l = [lrows(d * cv) for cv in cvels]
        cov_l = [lrows(d * cvels[i] * cvels[j]) for (i, j) in pairs]

        d_row = gather(d_row_l)
        means = jnp.stack([gather(m) for m in means_l])
        c1 = jnp.stack([gather(x) for x in c1_l])
        cov = jnp.stack([gather(x) for x in cov_l])
        stress, favre_mean, favre_rms = assemble_profile_stats(d_row, means, c1, cov, layer)

        out = {
            "spectra_counts": counts,
            "spectra_total": sums3[0],
            "spectra_longitudinal": sums3[1],
            "spectra_transverse": sums3[2],
            "mean_dens": d_row / layer,
            "reynolds_stress": stress,
            "favre_mean": favre_mean,
            "favre_rms": favre_rms,
            # Gathered row sums already hold every cell exactly once.
            "total_mass": jnp.sum(d_row),
        }
        return None, out

    def body(d4, a4, b4, c4):
        _, outs = jax.lax.scan(one_snapshot, None, (d4, a4, b4, c4))
        return outs

    spec = P(prt.SNAP_AXIS, prt.SPACE_AXIS, None, None)
    # check_vma=False: the outputs are psum/all_gather results, hence
    # replicated over "space", but the checker cannot infer that
    # through the lax.scan.
    return jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(spec,) * 4,
        out_specs=P(prt.SNAP_AXIS),
        check_vma=False,
    )(dens, velx, vely, velz)


@lru_cache(maxsize=4)
def jitted_sharded_series_step(mesh):
    return jax.jit(lambda d, a, b, c: sharded_series_analysis_step(d, a, b, c, mesh=mesh))


def _synth_fields(n: int, dtype, s):
    """Deterministic multi-frequency trig mixing: fields a NumPy oracle
    can rebuild without a PRNG. ``s`` (the seed phase) may be a Python
    float or a traced scalar."""
    x = (jnp.arange(n, dtype=dtype) / n)[:, None, None]
    y = (jnp.arange(n, dtype=dtype) / n)[None, :, None]
    z = (jnp.arange(n, dtype=dtype) / n)[None, None, :]
    two_pi = 2.0 * jnp.pi

    def mix(a, b, c, p):
        return (
            jnp.sin(two_pi * (a * x + b * y + c * z) + p + s)
            + 0.5 * jnp.cos(two_pi * (b * x + c * y + a * z) + 2 * p + s)
            + 0.25 * jnp.sin(two_pi * (c * x + a * y + b * z) + 3 * p - s)
        )

    dens = 1.3 + 0.3 * jnp.cos(two_pi * (x + 2 * y - z) + s) * jnp.sin(two_pi * (3 * x - y) - s)
    vels = [mix(3, 7, 2, 0.3), mix(5, 1, 6, 1.1), mix(2, 4, 9, 2.7)]
    return (dens.astype(dtype), *(v.astype(dtype) for v in vels))


@lru_cache(maxsize=4)
def _example_fields_fn(n: int, dtype_name: str, seed: int):
    dtype = jnp.dtype(dtype_name)
    return jax.jit(lambda: _synth_fields(n, dtype, float(seed)))


@lru_cache(maxsize=4)
def _example_batch_fn(nsnap: int, n: int, dtype_name: str):
    dtype = jnp.dtype(dtype_name)

    @jax.jit
    def build():
        seeds = jnp.arange(nsnap, dtype=dtype)
        return jax.vmap(lambda s: _synth_fields(n, dtype, s))(seeds)

    return build


def make_example_fields(n: int = 64, dtype=jnp.float32, seed: int = 0):
    """Deterministic synthetic turbulence-like fields on device."""
    out = _example_fields_fn(int(n), str(jnp.dtype(dtype)), int(seed))()
    return out


def make_example_field_batch(nsnap: int, n: int = 64, dtype=jnp.float32):
    """Stacked example snapshots ``(dens, velx, vely, velz)``, each
    ``(nsnap, n, n, n)``, synthesized directly into the batch buffers
    in ONE jit — no per-snapshot copies are ever materialized, so the
    peak footprint is the batch itself (a stack of separately-built
    snapshots transiently doubles it: 17 GB at batch 4 x 512^3 f32).
    Snapshot ``i`` equals ``make_example_fields(n, dtype, seed=i)`` up
    to f32 ulp-level trig rounding (the seed arrives as a traced
    scalar instead of a constant-folded f64 phase; measured ~7e-6
    max abs on O(1) fields)."""
    return _example_batch_fn(int(nsnap), int(n), str(jnp.dtype(dtype)))()
