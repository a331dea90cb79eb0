"""On-device accuracy record for the flagship step and every analysis.

Runs the f32 flagship step on the accelerator at 128^3 and 256^3 and
compares every output against a float64 NumPy oracle implementing the
reference algorithms (full-grid FFT binning + centered two-pass
profiles), then each public analysis against its oracle. Prints the
max scale-normalized errors as one JSON object (and writes it to
``--out PATH`` when given) — the concrete number behind "bit-for-bit
where required, else documented tolerance" (BASELINE.md north star).
Sections that need HDF5 files are skipped when h5py is not installed.

    python scripts/validate.py [--out PATH] [n ...]
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np
import scipy.fft

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

try:
    import h5py  # noqa: F401

    HAVE_H5PY = True
except ImportError:
    HAVE_H5PY = False


def oracle_step(dens: np.ndarray, vels) -> dict:
    """f64 NumPy flagship oracle: full-grid spectra sums + x-profiles."""
    n = dens.shape[0]
    shape = dens.shape
    ntot = dens.size
    nbins = max(shape) // 2 - 1

    def wn(m):
        k = np.arange(m)
        return np.where(k <= (m - 1) // 2, k, k - m).astype(np.float64)

    kx = wn(shape[0])[:, None, None]
    ky = wn(shape[1])[None, :, None]
    kz = wn(shape[2])[None, None, :]
    k_abs = np.sqrt(kx**2 + ky**2 + kz**2)

    sd = np.sqrt(dens)
    total = np.zeros(shape)
    longi = np.zeros(shape, dtype=np.complex128)
    for k, v in zip((kx, ky, kz), vels):
        f = scipy.fft.fftn(sd * v, norm="forward", workers=-1)  # = np.fft, all cores
        total += 0.5 * np.abs(f) ** 2
        longi += k * f
    longi_p = np.abs(longi / np.maximum(k_abs, 1e-99)) ** 2
    trans = total - longi_p

    idx = np.clip(np.floor(k_abs + 0.5).astype(int), 0, nbins - 1).ravel()
    mask = (k_abs <= nbins - 0.5).ravel()
    counts = np.bincount(idx, weights=mask, minlength=nbins)[:nbins]
    sums = {
        "spectra_total": np.bincount(idx, weights=np.where(mask, total.ravel(), 0), minlength=nbins)[:nbins],
        "spectra_longitudinal": np.bincount(idx, weights=np.where(mask, longi_p.ravel(), 0), minlength=nbins)[:nbins],
        "spectra_transverse": np.bincount(idx, weights=np.where(mask, trans.ravel(), 0), minlength=nbins)[:nbins],
        "spectra_counts": counts,
    }

    layer = shape[1] * shape[2]
    d_row = dens.sum(axis=(1, 2))
    means = [v.sum(axis=(1, 2)) / layer for v in vels]
    pairs = [(i, j) for i in range(3) for j in range(i, 3)]
    cv = [v - m[:, None, None] for v, m in zip(vels, means)]
    stress = np.stack([(dens * cv[i] * cv[j]).sum(axis=(1, 2)) / layer for i, j in pairs])
    fmean = np.stack([(dens * v).sum(axis=(1, 2)) / d_row for v in vels])
    frms = np.stack(
        [
            np.sqrt((dens * (v - f[:, None, None]) ** 2).sum(axis=(1, 2)) / d_row)
            for v, f in zip(vels, fmean)
        ]
    )
    return {
        **sums,
        "mean_dens": d_row / layer,
        "reynolds_stress": stress,
        "favre_mean": fmean,
        "favre_rms": frms,
        "total_mass": np.asarray(dens.sum()),
    }


def main() -> None:
    import argparse

    import jax

    from fava_tpu import utils as futils
    from fava_tpu.flagship import jitted_analysis_step, make_example_fields

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sizes", nargs="*", type=int, default=[128, 256])
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()

    futils.enable_compilation_cache()
    futils.timing.VERBOSE = False

    report = {
        "device": {
            "platform": jax.devices()[0].platform,
            "kind": jax.devices()[0].device_kind,
            "count": len(jax.devices()),
        },
        "compute_dtype": "float32",
        "oracle": "float64 NumPy, reference algorithms (full-grid FFT binning, centered profiles)",
        "error_metric": "max |got - oracle| / max |oracle| per output",
        "sizes": {},
    }
    step = jitted_analysis_step(None)
    for n in args.sizes:
        print(f"== {n}^3 ==", flush=True)
        fields = make_example_fields(n=n)
        t0 = time.perf_counter()
        host = {k: np.asarray(v, dtype=np.float64) for k, v in step(*fields).items()}
        wall = time.perf_counter() - t0
        dens = np.asarray(fields[0], dtype=np.float64)
        vels = [np.asarray(v, dtype=np.float64) for v in fields[1:]]
        errs = flagship_errors(host, oracle_step(dens, vels))
        for key, err in errs.items():
            print(f"  {key}: {err:.3e}", flush=True)
        report["sizes"][str(n)] = {"wall_first_call_s": wall, "max_scaled_error": errs}

    report["analyses"] = validate_analyses()
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(report, indent=2))
    print(json.dumps(report), flush=True)


def flagship_errors(got: dict, ref: dict) -> dict:
    """Max scale-normalized error of each flagship output vs the oracle.

    The synthetic trig fields have integer frequencies, so some oracle
    outputs are analytically ZERO (e.g. favre_mean: row means of
    products of mismatched harmonics) — dividing f32 noise by f64 noise
    is meaningless. Those outputs are scaled by their physical
    fluctuation scale instead (the Favre RMS / the mean density)."""
    floors = {
        "favre_mean": np.abs(ref["favre_rms"]).max(),
        "mean_dens": np.abs(ref["mean_dens"]).max(),
    }
    return {key: scaled_err(got[key], exp, floors.get(key, 0.0)) for key, exp in ref.items()}


def scaled_err(got, exp, floor=0.0):
    got = np.asarray(got, dtype=np.float64)
    exp = np.asarray(exp, dtype=np.float64)
    scale = max(np.abs(exp).max(), floor)
    return float(np.abs(got - exp).max() / scale) if scale > 0 else float(np.abs(got).max())


def validate_structure_functions() -> dict:
    """On-device f32 structure functions vs an f64 oracle fed the SAME
    device PRNG draws (isolates pipeline rounding from sampling noise)."""
    import jax
    import jax.numpy as jnp

    from fava_tpu.flagship import make_example_fields
    from fava_tpu.ops import structure as st

    n, num_seps, num_points, seed = 64, 16, 4096, 3
    sep_bounds = (0.05, 0.45)
    fields = make_example_fields(n=n)
    vels_dev = fields[1:]
    domain = np.array([[0.0, 1.0]] * 3)

    out = st.structure_functions(
        vels_dev,
        domain_bounds=domain,
        num_seps=num_seps,
        num_points=num_points,
        sep_bounds=sep_bounds,
        seed=seed,
    )

    # Reproduce the exact device uniforms (same streams/shape/dtype;
    # utils/prng.py stream layout: order o -> (o-1)*3 + {0,1,2}).
    from fava_tpu.utils import prng

    shape = (num_seps, num_points)
    u1 = np.stack(
        [np.asarray(prng.uniform(seed, (o - 1) * 3, shape + (3,)), dtype=np.float64) for o in range(1, 11)]
    )
    u2 = np.stack(
        [np.asarray(prng.uniform(seed, (o - 1) * 3 + 1, shape), dtype=np.float64) for o in range(1, 11)]
    )
    u3 = np.stack(
        [np.asarray(prng.uniform(seed, (o - 1) * 3 + 2, shape), dtype=np.float64) for o in range(1, 11)]
    )
    vels64 = [np.asarray(v, dtype=np.float64) for v in vels_dev]
    seps = np.geomspace(sep_bounds[0], sep_bounds[1], num_seps)
    lo, width = 0.0, 1.0
    cell = width / n

    errs = {"longitudinal": 0.0, "transverse": 0.0}
    for o in range(1, 11):
        p1 = lo + u1[o - 1] * width
        phi = 2.0 * np.pi * u2[o - 1]
        theta = np.arccos(2.0 * u3[o - 1] - 1.0)
        direction = np.stack(
            [np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi), np.cos(theta)], axis=-1
        )
        p2 = p1 + seps[:, None, None] * direction
        p2 = lo + np.mod(p2 - lo, width)
        i1 = np.clip(np.floor((p1 - lo) / cell).astype(int), 0, n - 1)
        i2 = np.clip(np.floor((p2 - lo) / cell).astype(int), 0, n - 1)
        dv = np.stack(
            [
                v[i2[..., 0], i2[..., 1], i2[..., 2]] - v[i1[..., 0], i1[..., 1], i1[..., 2]]
                for v in vels64
            ],
            axis=-1,
        )
        sep_vec = p2 - p1
        rhat = sep_vec / np.sqrt((sep_vec**2).sum(axis=-1, keepdims=True))
        long_comp = np.abs((dv * rhat).sum(axis=-1))
        trans_comp = np.sqrt(((dv - long_comp[..., None] * rhat) ** 2).sum(axis=-1))
        ref_l = (long_comp**o).sum(axis=-1) / num_points
        ref_t = (trans_comp**o).sum(axis=-1) / num_points
        errs["longitudinal"] = max(errs["longitudinal"], scaled_err(out["longitudinal"][str(o)], ref_l))
        errs["transverse"] = max(errs["transverse"], scaled_err(out["transverse"][str(o)], ref_t))
    return {
        "config": {"n": n, "num_seps": num_seps, "num_points": num_points, "orders": "1-10"},
        "oracle": "f64 NumPy on the SAME device PRNG draws",
        "max_scaled_error": errs,
    }


def validate_analyses() -> dict:
    """On-device error record for every non-flagship public analysis
    (CPU-f64 tests do not imply f32 device correctness)."""
    import tempfile

    import jax.numpy as jnp

    from fava_tpu.flagship import make_example_fields
    from fava_tpu.ops import volume as volume_ops
    from fava_tpu.ops.fractal import fractal_dimension
    from tests.oracles.fractal import fractal_dimension_oracle
    from tests.oracles.regrid import from_amr_oracle

    out: dict = {}

    # --- fractal dimension (deterministic box counting) ---------------
    print("== analyses: fractal dimension ==", flush=True)
    dens = make_example_fields(n=128)[0]
    got = fractal_dimension(dens, contours=1.3)["1.3"]
    ref = fractal_dimension_oracle(np.asarray(dens, dtype=np.float64), 1.3)
    out["fractal_dimension"] = {
        "config": {"n": 128, "contour": 1.3},
        "max_scaled_error": {
            "average_fractal_dimension": scaled_err(
                got["average fractal dimension"], ref["average fractal dimension"]
            ),
            "slope": scaled_err(got["slope"], ref["slope"]),
            "curve_counts": scaled_err(got["curve"], ref["curve"]),
        },
    }

    # --- PDFs (shared explicit range isolates binning rounding) -------
    print("== analyses: pdf1d / pdf2d ==", flush=True)
    d64 = np.asarray(dens, dtype=np.float64)
    vr = (float(d64.min()), float(d64.max()))
    got1 = volume_ops.pdf1d(dens, nbins=64, vrange=vr)
    ref_counts, ref_edges = np.histogram(d64, bins=64, range=vr)
    ref_pdf = ref_counts / (ref_counts.sum() * np.diff(ref_edges))
    velx = make_example_fields(n=128)[1]
    vx64 = np.asarray(velx, dtype=np.float64)
    xr = vr
    yr = (float(vx64.min()), float(vx64.max()))
    got2 = volume_ops.pdf2d(dens, velx, nbins=(32, 32), xrange=xr, yrange=yr)
    ref2_counts, _, _ = np.histogram2d(d64.ravel(), vx64.ravel(), bins=(32, 32), range=[xr, yr])
    # Fused auto-range pdf2d (one dispatch: traced min/max -> traced
    # edges -> kernel; the ranges ride the counts fetch as bitcast
    # words). Oracle bins against the REPORTED edges, so this checks
    # the on-device f32 min/max + edge chain AND the bitcast transport.
    gota = volume_ops.pdf2d(dens, velx, nbins=(32, 32))
    refa_counts, _, _ = np.histogram2d(
        d64.ravel(), vx64.ravel(), bins=[gota["xedges"], gota["yedges"]]
    )
    out["pdf"] = {
        "config": {"n": 128, "nbins1d": 64, "nbins2d": 32},
        "max_scaled_error": {
            "pdf1d_counts": scaled_err(got1["counts"], ref_counts),
            "pdf1d_density": scaled_err(got1["pdf"], ref_pdf),
            "pdf2d_counts": scaled_err(got2["counts"], ref2_counts),
            "pdf2d_auto_counts": scaled_err(gota["counts"], refa_counts),
        },
        "auto_range_all_samples_kept": bool(
            gota["counts"].sum() == d64.size
        ),
    }

    # --- WEIGHTED histograms: double-word (hi, lo) accumulation --------
    # The double-word (hi, lo) accumulation (utils/twofloat) must hold
    # in f32 on the device, where the CPU-f64 tests cannot see it.
    print("== analyses: weighted histograms (double-word) ==", flush=True)
    w = jnp.exp(jnp.sin(7.0 * velx))  # rough positive weights, no jax.random
    w64 = np.exp(np.sin(7.0 * vx64))
    got1w = volume_ops.pdf1d(dens, nbins=64, vrange=vr, weights=w, density=False)
    refw, _ = np.histogram(d64, bins=64, range=vr, weights=w64)
    got2w = volume_ops.pdf2d(
        dens, velx, nbins=(32, 32), xrange=xr, yrange=yr, weights=w, density=False
    )
    ref2w, _, _ = np.histogram2d(
        d64.ravel(), vx64.ravel(), bins=(32, 32), range=[xr, yr], weights=w64.ravel()
    )
    got_bsw = volume_ops.binned_statistic(dens, velx, nbins=64, vrange=vr, weights=w)
    # weighted conditional mean oracle, np.histogram bin semantics
    wsum, _ = np.histogram(d64, bins=64, range=vr, weights=w64)
    wy, _ = np.histogram(d64, bins=64, range=vr, weights=w64 * vx64)
    with np.errstate(invalid="ignore"):
        mean_ref = wy / wsum
    # Concentrated stall regime on the device: 512^3 constant-weight samples
    # all in ONE bin -> true sum 4.0e7 ~ 2.4x the f32 2^24*w absorption
    # stall (a plain f32 accumulator returns ~5.0e6/4.0e7 = 8x low).
    big = make_example_fields(n=512)[0]
    wc = np.float64(np.float32(0.30000001192092896))
    wbig = jnp.full(big.shape, jnp.float32(wc))
    gots = volume_ops.pdf1d(
        big, nbins=4, vrange=(0.0, 1000.0), weights=wbig, density=False
    )
    exact = float(wc) * big.size
    del big, wbig
    out["weighted_histograms"] = {
        "config": {"n": 128, "stall_check_n": 512, "weights": "exp(sin(7 velx)), const 0.3"},
        "max_scaled_error": {
            "pdf1d_weighted": scaled_err(got1w["counts"], refw),
            "pdf2d_weighted_kernel": scaled_err(got2w["counts"], ref2w),
            "binned_statistic_weight_sums": scaled_err(got_bsw["weight_sums"], wsum),
            "binned_statistic_weighted_mean": scaled_err(
                np.nan_to_num(got_bsw["mean"]), np.nan_to_num(mean_ref)
            ),
        },
        "stall_regime_512^3_one_bin": {
            "expected_sum": exact,
            "got_sum": float(gots["counts"][0]),
            "rel_error": abs(float(gots["counts"][0]) / exact - 1.0),
            "f32_stall_would_return": float(np.float32(2**24) * wc),
        },
    }

    # --- AMR mass + regrid round-trip on the device -------------------
    if not HAVE_H5PY:
        print("h5py is not installed: section skipped (needs HDF5 files)", flush=True)
    else:
        print("== analyses: AMR mass_sum + regrid ==", flush=True)
        from fava_tpu.io import synthetic
        from fava_tpu.mesh import FLASH as FlashAMR

        with tempfile.TemporaryDirectory() as td:
            path = Path(td) / "rt_hdf5_plt_cnt_0001"
            synthetic.make_amr_file(path, ncells=(8, 8, 8), nblks=(2, 2, 2), refine={0: 2, 3: 3})
            mesh = FlashAMR(path)
            mesh.load()
            mesh.load_data(["dens", "velx"])

            got_mass = mesh.mass_sum()["total"]
            leaf = np.asarray(mesh.get_blocklist("LEAF"))
            cv = np.asarray(mesh.get_cell_volumes("LEAF"), dtype=np.float64)
            dh = np.asarray(mesh.host_data("dens"), dtype=np.float64)[leaf]
            ref_mass = float((dh.sum(axis=(1, 2, 3)) * cv).sum())
            mass_err = scaled_err(got_mass, ref_mass)

            data = {k: np.asarray(mesh.host_data(k), dtype=np.float64) for k in ("dens", "velx")}
            expected, _total = from_amr_oracle(
                data,
                block_bounds=np.asarray(mesh.block_bounds),
                node_type=np.asarray(mesh.node_type),
                refine_level=np.asarray(mesh.refine_level).astype(int),
                ncells=mesh.nCellsVec,
                nblks=mesh.nBlksVec,
                ndim=3,
                fields=["dens", "velx"],
            )
            # projection BEFORE from_amr (which collapses the mesh in
            # place): exact regrid-then-sum twin of the per-level path.
            got_proj = mesh.projection(field="dens", axis=0)
            dxp = (mesh.xmax - mesh.xmin) / expected["dens"].shape[0]
            proj_err = scaled_err(got_proj["map"], expected["dens"].sum(axis=0) * dxp)
            mesh.from_amr(fields=["dens", "velx"], save_file=False)
            regrid_err = max(
                scaled_err(np.asarray(mesh._data[k]), expected[k]) for k in ("dens", "velx")
            )
        out["mass_sum"] = {"max_scaled_error": mass_err}
        out["regrid_from_amr"] = {
            "config": {"ncells": 8, "nblks": 2, "levels": "1-3"},
            "max_scaled_error": regrid_err,
        }
        out["projection"] = {
            "config": {"ncells": 8, "nblks": 2, "levels": "1-3", "axis": 0},
            "oracle": "regrid-then-sum (exact for piecewise-constant data)",
            "max_scaled_error": proj_err,
        }

    # --- scalar power spectrum -----------------------------------------
    print("== analyses: scalar spectrum ==", flush=True)
    from fava_tpu.ops.spectra import scalar_spectrum

    got_sp = scalar_spectrum(dens)["power"]
    d64 = np.asarray(dens, dtype=np.float64)
    nn = d64.shape[0]
    fw = np.fft.fftn(d64, norm="forward")
    p = np.abs(fw) ** 2

    def wn(m):
        k = np.arange(m)
        return np.where(k <= (m - 1) // 2, k, k - m).astype(np.float64)

    k_abs = np.sqrt(
        wn(nn)[:, None, None] ** 2 + wn(nn)[None, :, None] ** 2 + wn(nn)[None, None, :] ** 2
    )
    nb = nn // 2 - 1
    idx = np.clip(np.floor(k_abs + 0.5).astype(int), 0, nb - 1).ravel()
    mask = (k_abs <= nb - 0.5).ravel()
    counts = np.bincount(idx, weights=mask, minlength=nb)[:nb]
    sums = np.bincount(idx, weights=np.where(mask, p.ravel(), 0), minlength=nb)[:nb]
    kk = np.arange(nb, dtype=np.float64)
    ref_sp = (sums / np.maximum(counts, 1)) * kk**2 * (4.0 * np.pi)
    out["scalar_spectrum"] = {
        "config": {"n": 128, "field": "dens"},
        "max_scaled_error": scaled_err(got_sp[1:], ref_sp[1:]),
    }

    # --- eulerian autocorrelation (device point sampling) ---------------
    if not HAVE_H5PY:
        print("h5py is not installed: section skipped (needs HDF5 files)", flush=True)
    else:
        # A static AMR series must correlate to exactly 1 at every time:
        # the recorded error isolates the device sample_fields gather path.
        # (Lagrangian/cross correlations are host-side NumPy over particle
        # tables — no device math to validate.)
        print("== analyses: eulerian autocorrelation ==", flush=True)
        import fava_tpu

        with tempfile.TemporaryDirectory() as td:
            for i, t in enumerate([0.0, 0.1, 0.2], start=1):
                synthetic.make_amr_file(
                    Path(td) / f"rt_hdf5_plt_cnt_{i:04d}",
                    ncells=(8, 8, 8),
                    nblks=(2, 2, 2),
                    refine={0: 2},
                    time=t,
                )
            model = fava_tpu.FLASH(Path(td))
            _times, res = model.eulerian_autocorrelation(nsamples=64, fields=["dens"], seed=2)
        out["eulerian_autocorrelation"] = {
            "config": {"series": "3 static snapshots", "nsamples": 64},
            "oracle": "static field => rho == 1 exactly",
            "max_scaled_error": float(np.abs(np.asarray(res["dens"]) - 1.0).max()),
            "note": "lagrangian/cross correlations are host-side NumPy (no device math)",
        }

    # --- spectral velocity diagnostics (inverse FFT path) --------------
    # Exercises the inverse FFT on the device: the Helmholtz/vorticity fields are
    # the only analyses with an INVERSE transform in the hot path.
    print("== analyses: velocity diagnostics ==", flush=True)
    from fava_tpu.ops import velocity as vel_ops
    from tests.oracles import velocity as vel_oracle

    fields = make_example_fields(n=128)
    vels_dev = fields[1:]
    vels64 = [np.asarray(v, dtype=np.float64) for v in vels_dev]

    hd = vel_ops.helmholtz_decompose(*vels_dev)
    sol_ref, comp_ref = vel_oracle.helmholtz_oracle(vels64)
    helm_err = max(
        max(
            scaled_err(np.asarray(hd["compressive"][n]), comp_ref[i])
            for i, n in enumerate(("velx", "vely", "velz"))
        ),
        max(
            scaled_err(np.asarray(hd["solenoidal"][n]), sol_ref[i])
            for i, n in enumerate(("velx", "vely", "velz"))
        ),
    )
    vort = vel_ops.vorticity(*vels_dev)
    vort_ref = vel_oracle.vorticity_oracle(vels64)
    vort_err = max(scaled_err(np.asarray(g), r) for g, r in zip(vort, vort_ref))
    dil_err = scaled_err(
        np.asarray(vel_ops.dilatation(*vels_dev)), vel_oracle.dilatation_oracle(vels64)
    )
    ens = vel_ops.enstrophy_spectrum(*vels_dev)["power"]
    ens_ref = vel_oracle.enstrophy_spectrum_oracle(vels64)["power"]

    # Helicity needs a HELICAL validation field: the trig mix is
    # near-helicity-free (measured max|H| ~ 1e-7 vs operand scale ~20),
    # so normalizing by max|H| there measures pure cancellation noise.
    # ABC (Beltrami) backbone (|H(k)| = 2 Z(k), maximal) + the trig mix
    # at 0.1 amplitude to populate more shells.
    import jax.numpy as jnp

    nn = 128
    xs = 2.0 * np.pi * jnp.arange(nn, dtype=jnp.float32) / nn
    X = xs[:, None, None]
    Y = xs[None, :, None]
    Z = xs[None, None, :]
    abc = (
        jnp.sin(Z) + jnp.cos(Y),
        jnp.sin(X) + jnp.cos(Z),
        jnp.sin(Y) + jnp.cos(X),
    )
    vels_h = [a + 0.1 * p for a, p in zip(abc, vels_dev)]
    vels_h64 = [np.asarray(v, dtype=np.float64) for v in vels_h]
    hel = vel_ops.helicity_spectrum(*vels_h)["power"]
    hel_ref = vel_oracle.helicity_spectrum_oracle(vels_h64)["power"]
    fin = np.isfinite(hel_ref)
    fin[:1] = False
    out["velocity_diagnostics"] = {
        "config": {
            "n": 128,
            "oracle": "full-grid np.fft f64 (tests/oracles/velocity.py)",
            "helicity_field": "ABC Beltrami + 0.1x trig mix (the plain trig mix is near-helicity-free)",
        },
        "max_scaled_error": {
            "helmholtz_fields": helm_err,
            "vorticity_fields": vort_err,
            "dilatation_field": dil_err,
            "enstrophy_spectrum": scaled_err(ens[1:], ens_ref[1:]),
            "helicity_spectrum": scaled_err(hel[fin], hel_ref[fin]),
        },
    }

    # --- kinetic-energy transfer spectrum ------------------------------
    # Adds the product-transform path (9 forward + optional 3 inverse
    # FFTs) on the device. Error is measured on a field with ACTIVE
    # triads: Taylor-Green/ABC/the trig mix transfer nothing
    # instantaneously, so scaling an error by their max|T| (~roundoff)
    # just compares f32 noise against f64 noise. A random solenoidal
    # field band-limited to |k| <= 8 has genuinely nonzero T(k), is
    # alias-free, and fits every shell — the scaled error and the
    # zero-sum conservation residual are both meaningful there.
    print("== analyses: transfer spectrum ==", flush=True)
    from tests.test_velocity import _band_limited_solenoidal

    bl = _band_limited_solenoidal(n=nn, kmax=8.0, seed=5)
    bl_dev = [jnp.asarray(v, dtype=jnp.float32) for v in bl]
    tr_bl = vel_ops.transfer_spectrum(*bl_dev)
    tr_bl_ref = vel_oracle.transfer_spectrum_oracle(list(bl))
    # Full-spectrum solenoidal field under dealias=True: exercises the
    # 2/3-rule mask AND the extended shell range (dealiased_nbins) on
    # the device — conservation over the BINNED record must still hold. (The
    # trig-mix field is useless here too: near-zero true transfer.)
    fs = _band_limited_solenoidal(n=nn, kmax=4.0 * nn, seed=11)
    tr_full = vel_ops.transfer_spectrum(
        *[jnp.asarray(v, dtype=jnp.float32) for v in fs], dealias=True
    )
    out["transfer_spectrum"] = {
        "config": {
            "n": 128,
            "error_field": "random solenoidal, |k| <= 8 (active triads)",
            "dealiased_conservation_field": "full-spectrum random solenoidal, dealias=True",
        },
        "max_scaled_error": {
            "transfer": scaled_err(tr_bl["transfer"], tr_bl_ref["transfer"]),
            "flux": scaled_err(tr_bl["flux"], tr_bl_ref["flux"]),
        },
        "conservation_residual": float(
            abs(tr_bl["transfer"].sum()) / max(np.abs(tr_bl["transfer"]).max(), 1e-30)
        ),
        "dealiased_conservation_residual": float(
            abs(tr_full["transfer"].sum()) / max(np.abs(tr_full["transfer"]).max(), 1e-30)
        ),
    }

    # --- filtered (coarse-grained) SGS kinetic-energy flux -------------
    # Exercises the scan-over-cutoffs path (28 inverse FFTs per
    # scale) on the device; the sharp-filter Galerkin identity against the
    # transfer-spectrum flux cross-checks two independent device paths.
    print("== analyses: filtered ke flux ==", flush=True)
    from fava_tpu.ops import coarse_grain as cg_ops
    from tests.oracles import coarse_grain as cg_oracle

    dens_dev = fields[0]
    dens64 = np.asarray(dens_dev, dtype=np.float64)
    pres_dev = 2.0 + 0.5 * jnp.sin(X) * jnp.cos(2.0 * Y) + 0.3 * jnp.cos(Z)
    pres64 = np.asarray(pres_dev, dtype=np.float64)
    bl64 = [np.asarray(v, dtype=np.float64) for v in bl_dev]
    cuts = (4.0, 8.0, 16.0)
    got_cg = cg_ops.filtered_ke_flux(
        *bl_dev, dens=dens_dev, pres=pres_dev, cutoffs=cuts, kernel="gaussian"
    )
    ref_cg = cg_oracle.filtered_ke_flux_oracle(
        bl64, dens64, cuts, kernel="gaussian", pres=pres64
    )
    sharp = cg_ops.filtered_ke_flux(*bl_dev, cutoffs=(5.5,), kernel="sharp")
    galerkin_resid = float(
        abs(sharp["pi_mean"][0] - tr_bl["flux"][5]) / max(abs(tr_bl["flux"][5]), 1e-30)
    )
    out["filtered_ke_flux"] = {
        "config": {
            "n": 128,
            "kernel": "gaussian",
            "cutoffs": list(cuts),
            "field": "random solenoidal |k| <= 8 velocities, trig dens/pres",
        },
        "max_scaled_error": {
            "pi_mean": scaled_err(got_cg["pi_mean"], ref_cg["pi_mean"]),
            "pi_rms": scaled_err(got_cg["pi_rms"], ref_cg["pi_rms"]),
            "baropycnal_mean": scaled_err(
                got_cg["baropycnal_mean"], ref_cg["baropycnal_mean"]
            ),
            "baropycnal_rms": scaled_err(
                got_cg["baropycnal_rms"], ref_cg["baropycnal_rms"]
            ),
        },
        "sharp_galerkin_flux_residual": galerkin_resid,
    }

    # --- decomposed (sol/comp) KE spectra ------------------------------
    # Exercises the in-k-space Helmholtz projection + three shell
    # binnings in one jit; the shell budget total == sol + comp must
    # close at f32 roundoff on the device (it is exact by construction).
    print("== analyses: decomposed + anisotropic spectra ==", flush=True)
    got_dec = vel_ops.decomposed_ke_spectra(*vels_dev, dens=dens_dev)
    ref_dec = vel_oracle.decomposed_ke_spectra_oracle(vels64, dens64)
    budget_resid = float(
        np.nanmax(
            np.abs(got_dec["total"] - got_dec["solenoidal"] - got_dec["compressive"])
        )
        / max(np.nanmax(np.abs(got_dec["total"])), 1e-30)
    )
    out["decomposed_ke_spectra"] = {
        "config": {"n": 128, "weighted": True, "field": "trig mix + dens"},
        "max_scaled_error": {
            # the oracle's _shell_mean already applies the 4*pi*k^2
            # shell compensation — compare records directly
            name: scaled_err(got_dec[name][1:], ref_dec[name][1:])
            for name in ("total", "solenoidal", "compressive")
        },
        "shell_budget_residual": budget_resid,
    }

    # --- anisotropic (axis-resolved) KE spectra ------------------------
    # Exercises the plane/line reductions + fold-matrix and ring-scatter
    # binnings; both records must conserve the Parseval KE total.
    got_an = vel_ops.anisotropic_ke_spectra(*vels_dev, axis=0)
    ref_an = vel_oracle.anisotropic_ke_spectra_oracle(vels64, axis=0)
    ke_tot = 0.5 * sum(float(np.mean(v**2)) for v in vels64)
    out["anisotropic_ke_spectra"] = {
        "config": {"n": 128, "axis": 0, "field": "trig mix"},
        "max_scaled_error": {
            name: scaled_err(got_an[name], ref_an[name])
            for name in ("par_total", "par_axial", "perp_total", "perp_transverse")
        },
        "parseval_residual": {
            "par": float(abs(np.sum(got_an["par_total"]) - ke_tot) / ke_tot),
            "perp": float(abs(np.sum(got_an["perp_total"]) - ke_tot) / ke_tot),
        },
    }

    # --- flame surface density -----------------------------------------
    # Two device checks: (1) the coarea integral vs an f64 np.gradient
    # oracle on the trig dens field (general-field accuracy), (2) the
    # closed-form secant wrinkling factor of a tilted linear front
    # (exactness of the device gradient/reduction chain).
    print("== analyses: flame surface ==", flush=True)
    from fava_tpu.ops.flame import flame_surface

    d = 1.0 / nn
    got_fs = flame_surface(dens_dev, (d, d, d), axis=0)
    g64 = np.gradient(dens64, d, d, d)
    mag64 = np.sqrt(sum(g * g for g in g64))
    ij = (np.arange(nn, dtype=np.float32) + 0.5) * d
    a_t, b_t = 1.0, 0.5
    tilted = jnp.asarray(
        a_t * ij[:, None, None] + b_t * ij[None, :, None] + np.zeros((nn, nn, nn), np.float32)
    )
    got_tilt = flame_surface(tilted, (d, d, d), axis=0)
    out["flame_surface"] = {
        "config": {"n": 128, "field": "trig dens + tilted linear front"},
        "max_scaled_error": {
            "area": scaled_err(got_fs["area"], mag64.sum() * d**3),
            "sigma_profile": scaled_err(got_fs["sigma"], mag64.mean(axis=(1, 2))),
            "max_gradient": scaled_err(got_fs["max_gradient"], mag64.max()),
        },
        "tilted_front_wrinkling_residual": float(
            abs(got_tilt["wrinkling"] - np.hypot(a_t, b_t)) / np.hypot(a_t, b_t)
        ),
    }

    # --- turbulence summary ---------------------------------------------
    # The one-jit scalar report (u_rms/KE/Mach, integral + Taylor
    # spectral scales, Helmholtz energy fractions, vorticity/dilatation
    # rms) vs the full f64 NumPy oracle on the same fields.
    print("== analyses: turbulence summary ==", flush=True)
    gamc_dev = 1.4 + 0.1 * jnp.sin(X) * jnp.cos(Y) * jnp.cos(Z)
    got_ts = vel_ops.turbulence_summary(
        *vels_dev, dens=dens_dev, pres=pres_dev, gamma=gamc_dev
    )
    ref_ts = vel_oracle.turbulence_summary_oracle(
        vels64, dens64, pres64, np.asarray(gamc_dev, dtype=np.float64)
    )
    out["turbulence_summary"] = {
        "config": {"n": 128, "field": "trig mix + dens/pres/gamc"},
        "max_scaled_error": {
            name: scaled_err(got_ts[name], ref_ts[name]) for name in sorted(ref_ts)
        },
    }

    # --- density PDF (lognormality diagnostics) -------------------------
    # Exact weighted moments + histogram on the device vs plain f64 NumPy.
    print("== analyses: density pdf ==", flush=True)
    from fava_tpu.ops.volume import density_pdf

    got_dp = density_pdf(dens_dev, nbins=64, mach=1.5)
    r64 = dens64.ravel()
    s64 = np.log(r64 / r64.mean())
    mu64 = s64.mean()
    sig64 = s64.std()
    ref_counts_dp, _ = np.histogram(
        s64, bins=64, range=(got_dp["edges"][0], got_dp["edges"][-1])
    )
    out["density_pdf"] = {
        "config": {"n": 128, "field": "trig dens", "mach": 1.5},
        "max_scaled_error": {
            "mean_s": scaled_err(got_dp["mean_s"], mu64, floor=abs(sig64)),
            "sigma_s": scaled_err(got_dp["sigma_s"], sig64),
            "skewness": scaled_err(got_dp["skewness"], ((s64 - mu64) ** 3).mean() / sig64**3),
            "b_parameter": scaled_err(
                got_dp["b_parameter"], np.sqrt(np.expm1(sig64**2)) / 1.5
            ),
            "counts": scaled_err(got_dp["counts"], ref_counts_dp),
        },
    }

    # --- spatial two-point correlations ----------------------------------
    # Wiener-Khinchin on the device (forward + inverse FFTs) vs the
    # f64 np.fft twin; the velocity lines additionally exercise the
    # symmetrized power-marginal path (no inverse volume transforms).
    print("== analyses: two-point correlations ==", flush=True)
    from fava_tpu.ops import twopoint as tp_ops

    got_tp = tp_ops.two_point_correlation(dens_dev)
    dm = dens64 - dens64.mean()
    corr64 = np.fft.irfftn(np.abs(np.fft.rfftn(dm)) ** 2, s=dm.shape) / dm.size
    var64 = corr64.flat[0]
    half = nn // 2 + 1
    out["two_point_correlation"] = {
        "config": {"n": 128, "field": "trig dens"},
        "max_scaled_error": {
            "variance": scaled_err(got_tp["variance"], var64),
            "R_x": scaled_err(got_tp["R_x"], corr64[:half, 0, 0] / var64),
            "R_z": scaled_err(got_tp["R_z"], corr64[0, 0, :half] / var64),
        },
    }
    got_vc = tp_ops.velocity_correlations(*vels_dev)
    vc_errs = {}
    for a, ax in enumerate("xyz"):
        vm = vels64[a] - vels64[a].mean()
        c = np.fft.irfftn(np.abs(np.fft.rfftn(vm)) ** 2, s=vm.shape) / vm.size
        line = [c[:half, 0, 0], c[0, :half, 0], c[0, 0, :half]][a]
        vc_errs[f"f_{ax}"] = scaled_err(got_vc[f"f_{ax}"], line / line[0])
    out["velocity_correlations"] = {
        "config": {"n": 128, "field": "trig mix"},
        "max_scaled_error": vc_errs,
    }

    # --- velocity gradient statistics ------------------------------------
    # FD gradient-tensor fluctuation moments (two-pass device centering)
    # vs the f64 NumPy oracle on the same fields.
    print("== analyses: velocity gradient statistics ==", flush=True)
    from fava_tpu.ops import gradients as grad_ops
    from tests.oracles.gradients import gradient_stats_oracle

    got_vg = grad_ops.velocity_gradient_statistics(*vels_dev)
    ref_vg = gradient_stats_oracle(vels64)
    # Scale floors: the synthetic trig mix is built from symmetric
    # sinusoids, so the oracle's THIRD gradient moments (and hence the
    # skewness) are analytically ~zero — divide by the physical scale
    # (c2^{3/2} for m3; 1.0 for the dimensionless skewness) instead of
    # the degenerate max|oracle| (same rationale as the favre_mean
    # floors above).
    m3_floor = float(np.abs(ref_vg["gradient_moment2"]).max() ** 1.5)
    vg_floors = {"gradient_moment3": m3_floor, "derivative_skewness": 1.0}
    out["velocity_gradient_statistics"] = {
        "config": {"n": 128, "field": "trig mix", "boundary": "periodic"},
        "scale_floors": sorted(vg_floors),
        "max_scaled_error": {
            name: scaled_err(got_vg[name], ref_vg[name], floor=vg_floors.get(name, 0.0))
            for name in (
                "gradient_moment2",
                "gradient_moment3",
                "gradient_moment4",
                "derivative_skewness",
                "derivative_flatness",
                "transverse_flatness",
                "pseudo_dissipation",
                "enstrophy",
                "dilatation_msq",
                "taylor_microscale",
            )
        },
    }

    # --- gradient invariant (Q, R) joint PDFs ----------------------------
    # Exact-count check vs f64 NumPy invariants + np.histogram2d at the
    # SAME (f32-derived) ranges: the fused pdf2d kernel must place every
    # cell identically; only f32 rounding of Q/R near bin edges can move
    # counts (report the scaled count error).
    print("== analyses: gradient invariant pdfs ==", flush=True)
    got_qr = grad_ops.gradient_invariant_pdfs(*vels_dev, nbins=(64, 64), qr_range=6.0)
    g64 = [[None] * 3 for _ in range(3)]
    dxs = [2.0 * np.pi / nn] * 3
    for i in range(3):
        for j in range(3):
            g64[i][j] = (
                np.roll(vels64[i], -1, axis=j) - np.roll(vels64[i], 1, axis=j)
            ) / (2.0 * dxs[j])
    P64 = -(g64[0][0] + g64[1][1] + g64[2][2])
    trA2_64 = sum(g64[i][j] * g64[j][i] for i in range(3) for j in range(3))
    Q64 = 0.5 * (P64 * P64 - trA2_64)
    det64 = (
        g64[0][0] * (g64[1][1] * g64[2][2] - g64[1][2] * g64[2][1])
        - g64[0][1] * (g64[1][0] * g64[2][2] - g64[1][2] * g64[2][0])
        + g64[0][2] * (g64[1][0] * g64[2][1] - g64[1][1] * g64[2][0])
    )
    R64 = -det64
    qw_got = got_qr["q_w"]
    ref_qr_counts, _, _ = np.histogram2d(
        Q64.ravel(),
        R64.ravel(),
        bins=(64, 64),
        range=[(-6.0 * qw_got, 6.0 * qw_got), (-6.0 * qw_got**1.5, 6.0 * qw_got**1.5)],
    )
    w2_64 = (
        (g64[2][1] - g64[1][2]) ** 2
        + (g64[0][2] - g64[2][0]) ** 2
        + (g64[1][0] - g64[0][1]) ** 2
    )
    out["gradient_invariant_pdfs"] = {
        "config": {"n": 128, "nbins": 64, "qr_range": 6.0},
        "max_scaled_error": {
            "q_w": scaled_err(qw_got, w2_64.mean() / 4.0),
            "counts": scaled_err(got_qr["counts"], ref_qr_counts),
        },
    }

    # --- conditional bin statistics ---------------------------------------
    # scipy.binned_statistic oracle against the REPORTED edges (same
    # class as the fused auto pdf2d: on-device f32 min/max + traced
    # edges + exact counts + centered one-pass bin variance).
    print("== analyses: binned statistic ==", flush=True)
    import scipy.stats as _sps

    got_bs = volume_ops.binned_statistic(dens, velx, nbins=64)
    bs_ref = {
        stat: _sps.binned_statistic(
            d64.ravel(), vx64.ravel(), statistic=stat, bins=got_bs["edges"]
        ).statistic
        for stat in ("count", "mean", "std")
    }
    occ = got_bs["counts"] > 0  # empty bins are NaN in BOTH by contract
    out["binned_statistic"] = {
        "config": {"n": 128, "nbins": 64},
        "max_scaled_error": {
            "counts": scaled_err(got_bs["counts"], bs_ref["count"]),
            "mean": scaled_err(got_bs["mean"][occ], bs_ref["mean"][occ]),
            "std": scaled_err(got_bs["std"][occ], bs_ref["std"][occ]),
        },
        "all_samples_kept": bool(got_bs["counts"].sum() == d64.size),
        "occupied_bins": int(occ.sum()),
    }

    # --- velocity increment PDFs ------------------------------------------
    # Same-draw oracle: identical Threefry words (fetched at the f32
    # dtype the device path uses) + f64 host geometry/gathers/moments.
    # f32 device geometry can flip a few nearest-cell lookups and bin
    # memberships, so counts carry an O(flips/num_points) residual;
    # moments see O(1/num_points) per flipped gather.
    print("== analyses: velocity increment pdfs ==", flush=True)
    from fava_tpu.ops import structure as struct_ops
    from fava_tpu.utils import prng as _prng

    inc_cfg = dict(num_seps=4, num_points=16384, nbins=31, nsigma=8.0)
    inc_dom = np.array([[0.0, 2.0 * np.pi]] * 3)
    got_inc = struct_ops.velocity_increment_pdfs(
        vels_dev, domain_bounds=inc_dom, sep_bounds=(0.1, 2.0), seed=3, **inc_cfg
    )

    def _inc_oracle():
        ns, npt, nbins, nsig = (
            inc_cfg["num_seps"],
            inc_cfg["num_points"],
            inc_cfg["nbins"],
            inc_cfg["nsigma"],
        )
        shape = np.asarray(vels64[0].shape)
        lo, width = inc_dom[:, 0], inc_dom[:, 1] - inc_dom[:, 0]
        cell = width / shape
        base = struct_ops._INC_STREAM
        seed = 3
        u_pos = np.asarray(
            _prng.uniform(seed, base, (ns, npt, 3), np.float32), dtype=np.float64
        )
        u_phi = np.asarray(_prng.uniform(seed, base + 1, (ns, npt), np.float32), dtype=np.float64)
        u_the = np.asarray(_prng.uniform(seed, base + 2, (ns, npt), np.float32), dtype=np.float64)
        seps = np.asarray(got_inc["separations"], dtype=np.float64)
        p1 = lo + u_pos * width
        phi = 2.0 * np.pi * u_phi
        theta = np.arccos(2.0 * u_the - 1.0)
        dirv = np.stack(
            [np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi), np.cos(theta)],
            axis=-1,
        )
        p2 = p1 + seps[:, None, None] * dirv
        p2 = lo + np.mod(p2 - lo, width)
        ci = lambda p: np.clip(np.floor((p - lo) / cell).astype(np.int64), 0, shape - 1)
        i1, i2 = ci(p1), ci(p2)
        gather = lambda v, ix: v[ix[..., 0], ix[..., 1], ix[..., 2]]
        dv = np.stack([gather(v, i2) - gather(v, i1) for v in vels64], axis=-1)
        sv = p2 - p1
        rhat = sv / np.sqrt(np.sum(sv**2, axis=-1, keepdims=True))
        dl = np.sum(dv * rhat, axis=-1)
        a = np.where(
            np.abs(rhat[..., 2:3]) > 0.9,
            np.array([1.0, 0.0, 0.0]),
            np.array([0.0, 0.0, 1.0]),
        )
        that = np.cross(a, rhat)
        that = that / np.sqrt(np.sum(that**2, axis=-1, keepdims=True))
        dt = np.sum(dv * that, axis=-1)
        edges = np.linspace(-nsig, nsig, nbins + 1)
        out = {}
        for name, x in (("longitudinal", dl), ("transverse", dt)):
            c = x - x.mean(axis=1)[:, None]
            m2 = (c * c).mean(axis=1)
            z = c / np.sqrt(m2)[:, None]
            out[name] = {
                "counts": np.stack([np.histogram(z[s], bins=edges)[0] for s in range(ns)]),
                "std": np.sqrt(m2),
                "skewness": (c**3).mean(axis=1) / m2**1.5,
                "flatness": (c**4).mean(axis=1) / m2**2,
            }
        return out

    ref_inc = _inc_oracle()
    out["velocity_increment_pdfs"] = {
        "config": {"n": 128, "field": "trig mix", **inc_cfg},
        "note": "f32 device geometry flips a few nearest-cell gathers/bin edges vs the f64 oracle",
        "max_scaled_error": {
            f"{comp}_{k}": scaled_err(got_inc[comp][k], ref_inc[comp][k])
            for comp in ("longitudinal", "transverse")
            for k in ("counts", "std", "skewness", "flatness")
        },
    }

    # --- out-of-core twins on the device ---------------------------------
    # The streamed summary/correlations use donated-buffer
    # dynamic_update_slice writes and chunked matmuls whose f32 device
    # behavior the CPU-f64 equality tests cannot certify.
    print("== analyses: streamed (out-of-core) twins ==", flush=True)
    from fava_tpu.ops import twopoint as tp_ops
    from fava_tpu.ops.outofcore import (
        streamed_turbulence_summary,
        streamed_velocity_correlations,
    )

    host_fields = {
        "dens": np.asarray(dens_dev, dtype=np.float32),
        "pres": np.asarray(pres_dev, dtype=np.float32),
        "velx": np.asarray(vels_dev[0], dtype=np.float32),
        "vely": np.asarray(vels_dev[1], dtype=np.float32),
        "velz": np.asarray(vels_dev[2], dtype=np.float32),
    }

    def loader(name, x0, x1):
        if name not in host_fields:
            raise KeyError(name)
        return host_fields[name][x0:x1]

    got_ss = streamed_turbulence_summary(
        loader, (nn, nn, nn), slab_rows=32, chunk_rows=32, with_mach=True, gamma=1.4
    )
    ref_ss = vel_ops.turbulence_summary(
        *vels_dev, dens=dens_dev, pres=pres_dev, gamma=1.4
    )
    got_sc = streamed_velocity_correlations(
        loader, (nn, nn, nn), slab_rows=32, chunk_rows=32
    )
    ref_sc = tp_ops.velocity_correlations(*vels_dev)
    out["streamed_twins"] = {
        "config": {"n": 128, "slab_rows": 32, "chunk_rows": 32},
        "oracle": "the IN-CORE f32 paths on the same device (streaming must not change the numbers)",
        "max_scaled_error": {
            "turbulence_summary": max(
                scaled_err(got_ss[k], ref_ss[k], floor=abs(ref_ss["sigma_s"]))
                for k in ref_ss
            ),
            "velocity_correlations": max(
                scaled_err(got_sc[f"f_{ax}"], ref_sc[f"f_{ax}"]) for ax in "xyz"
            ),
        },
    }

    # --- particle-pair structure functions ------------------------------
    print("== analyses: particle-pair structure functions ==", flush=True)
    from fava_tpu.ops.structure import pair_indices, pair_structure_functions

    prng = np.random.default_rng(61)
    npart = 4096
    # oracle runs on the SAME f32-rounded table the device sees (bin
    # membership near edges would otherwise differ)
    ppos = prng.random((npart, 3)).astype(np.float32).astype(np.float64)
    pvel = prng.standard_normal((npart, 3)).astype(np.float32).astype(np.float64)
    got_ps = pair_structure_functions(
        jnp.asarray(ppos, dtype=jnp.float32),
        jnp.asarray(pvel, dtype=jnp.float32),
        num_pairs=65536,
        nbins=8,
        sep_bounds=(0.05, 0.5),
        orders=4,
        seed=7,
    )
    idxp = np.asarray(pair_indices(7, 65536, npart))
    drp = ppos[idxp[1]] - ppos[idxp[0]]
    r2p = (drp**2).sum(axis=-1)
    rp = np.sqrt(r2p)
    dvp = pvel[idxp[1]] - pvel[idxp[0]]
    dlp = np.abs((dvp * drp).sum(axis=-1) / np.maximum(rp, 1e-30))
    # edge semantics match the device: r^2 compared against the squared
    # f64 edges (two-float on device makes the decisions exact, so the
    # counts row below is expected to be 0.0)
    from fava_tpu.ops.structure import pair_bin_edges

    e2p = pair_bin_edges(0.05, 0.5, 8, log_bins=True) ** 2
    bidxp = (r2p[:, None] >= e2p[None, 1:8]).sum(axis=1)
    maskp = (r2p >= e2p[0]) & (r2p <= e2p[8])
    cnt = np.bincount(bidxp[maskp], minlength=8).astype(np.float64)
    s2 = np.bincount(bidxp[maskp], weights=dlp[maskp] ** 2, minlength=8) / np.maximum(cnt, 1)
    out["particle_structure_functions"] = {
        "config": {"nparticles": npart, "num_pairs": 65536, "nbins": 8, "orders": 4},
        "oracle": "f64 NumPy on the SAME device pair draws",
        "max_scaled_error": {
            "counts": scaled_err(got_ps["counts"], cnt),
            "longitudinal_2": scaled_err(got_ps["longitudinal"]["2"], s2),
        },
    }

    # --- Eulerian autocorrelation (translating single mode) -------------
    if not HAVE_H5PY:
        print("h5py is not installed: section skipped (needs HDF5 files)", flush=True)
    else:
        print("== analyses: eulerian autocorrelation ==", flush=True)
        import tempfile

        import fava_tpu
        from fava_tpu.analysis.auto_correlations import _sample_grid_points
        from fava_tpu.io import synthetic

        n_e, U, kk = 32, 0.3, 2.0 * np.pi
        times_e = [0.0, 0.5, 1.0, 1.5]
        xc = (np.arange(n_e) + 0.5) / n_e
        X = np.broadcast_to(xc[:, None, None], (n_e, n_e, n_e))
        tdir = Path(tempfile.mkdtemp(prefix="fava_euler_"))
        for i, t in enumerate(times_e, start=1):
            synthetic.make_uniform_file(
                tdir / f"rt_hdf5_uniform_{i:04d}",
                ncells=(n_e,) * 3,
                field_data={"dens": 2.0 + np.cos(kk * (X - U * t))},
                time=t,
            )
        m_e = fava_tpu.FLASH(tdir)
        _, res_e = m_e.eulerian_autocorrelation(
            nsamples=500, fields=["dens"], seed=3, file_type="uni"
        )
        m2_e = fava_tpu.FLASH(tdir)
        m2_e.load(file_index=0, fields=["dens"], file_type="uni")
        pts = _sample_grid_points(m2_e.mesh, 500, np.random.default_rng(3))
        ixs = np.clip(np.floor(pts[:, 0] * n_e).astype(int), 0, n_e - 1)

        def mode_at(t):
            return 2.0 + np.cos(kk * (xc[ixs] - U * t))

        f0 = mode_at(0.0)
        exp_rho = np.array(
            [
                np.sum(f0 * mode_at(t)) / (np.linalg.norm(f0) * np.linalg.norm(mode_at(t)))
                for t in times_e
            ]
        )
        out["eulerian_autocorrelation"] = {
            "config": {"n": n_e, "nsamples": 500, "field": "dens = 2 + cos(2pi(x - 0.3 t))"},
            "oracle": "analytic translation evaluated at the SAME sampled cells "
            "(nonzero decorrelation closed form, not the static identity)",
            "expected_rho": [round(float(v), 6) for v in exp_rho],
            "max_abs_error": float(np.max(np.abs(res_e["dens"] - exp_rho))),
        }

    # --- structure functions (same-draw oracle) ------------------------
    print("== analyses: structure functions ==", flush=True)
    out["structure_functions"] = validate_structure_functions()
    return out


if __name__ == "__main__":
    main()
