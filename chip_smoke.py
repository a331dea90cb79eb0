"""Smoke run of the main fava_tpu path on the GPU, at 512^3.

    python chip_smoke.py             # phases 1-6 on one GPU
    python chip_smoke.py --chips 4   # the sharded paths on four GPUs, each vs one GPU

Every phase prints one line: wall times (cold = first call, compile
included; warm = a second call), the device's ``peak_bytes_in_use`` so
far, and each error next to its tolerance. The last line is one JSON
object, ``{"ok": true, "device": {"platform", "kind", "count"}}``.

The script runs on a GPU only: on any other backend it exits non-zero
before printing a result. It catches no phase's exception, so any
failure exits non-zero without the JSON line. Phases that read or
write HDF5 files need h5py; without it, the uniform volumes come from
``fava_tpu.from_arrays``, the streamed path reads host arrays, the AMR
phase runs on in-memory block stacks, and the pipeline phase does not
run (its line says so).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

N = 512
# Spectra / profiles vs the f64 NumPy oracles, max |d| / max |oracle|:
# cuFFT in f32 plus f32 scatter-add in nondeterministic atomic order.
TOL_F32 = 1e-5
# Sharded vs single-card results: only the summation order differs.
# The f32 total_mass is a sum XLA may fuse over every cell, so it moves
# most: 8.6e-6 measured at 32^3 on a 2x2 mesh of CPU devices.
TOL_SHARDED = 1e-5
FIELDS = ("dens", "velx", "vely", "velz", "flam")

try:
    import h5py
except ImportError:
    h5py = None


def _peak() -> str:
    import jax

    stats = jax.devices()[0].memory_stats()
    return f"{stats['peak_bytes_in_use']} B" if stats else "n/a"


def _check(name: str, err: float, tol: float) -> str:
    if not err <= tol:
        raise RuntimeError(f"{name}: error {err:.3e} exceeds tolerance {tol:.0e}")
    return f"{name} {err:.3e} <= {tol:.0e}"


def _timed(fn):
    """(result, seconds) of one call; the result is host data or is
    waited for, so the time covers the device work."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, time.perf_counter() - t0


def _line(phase: str, cold: float, warm: float, *checks: str) -> None:
    parts = [f"cold {cold:.3f} s", f"warm {warm:.3f} s", f"peak {_peak()}", *checks]
    print(f"{phase}: " + ", ".join(parts), flush=True)


def _max_err(got: dict, ref: dict, keys, shared_scale: bool = False) -> float:
    """Largest scale-normalized error over ``keys``. ``shared_scale``
    normalizes every key by the largest oracle magnitude of them all:
    a tensor's cross terms can be ~0, where a per-key relative error
    compares f32 noise with f64 noise."""
    from scripts.validate import scaled_err

    floor = max(np.abs(np.asarray(ref[k])).max() for k in keys) if shared_scale else 0.0
    return max(scaled_err(got[k], ref[k], floor) for k in keys)


# ---------------------------------------------------------------------------
# Phases (each takes the grid size, so the tests run them at 16^3-32^3)


def phase_uniform(n: int, workdir: Path) -> dict:
    """Phase 1: uniform snapshot -> FLASH model -> flagship + KE spectra."""
    import fava_tpu
    from fava_tpu import flagship
    from fava_tpu.io import synthetic
    from scripts.validate import flagship_errors, oracle_step
    from tests.oracles.profiles import reynolds_stress_oracle
    from tests.oracles.spectra import ke_spectra_oracle

    if h5py is not None:
        synthetic.make_uniform_file(
            workdir / "rt_hdf5_uniform_0001", ncells=(n,) * 3, fields=FIELDS, seed=7
        )
        model = fava_tpu.FLASH(workdir)
        model.load(file_type="uni")
        source = "HDF5 file"
    else:
        model = fava_tpu.from_arrays(synthetic.uniform_field_data((n,) * 3, fields=FIELDS, seed=7))
        source = "from_arrays (h5py not installed)"
    mesh = model.mesh
    vols = [mesh.data(name) for name in ("dens", "velx", "vely", "velz")]
    # The oracles see the device's own f32 values, so only algorithmic
    # error is measured.
    host = [np.asarray(v, dtype=np.float64) for v in vols]

    out, cold = _timed(model.flagship_analysis)
    out, warm = _timed(model.flagship_analysis)
    ref = oracle_step(host[0], host[1:])
    errs = flagship_errors(out, ref)
    spec_keys = [k for k in errs if k.startswith("spectra_")]
    prof_keys = [k for k in errs if not k.startswith("spectra_")]

    spectra = model.kinetic_energy_spectra()
    ke_ref = ke_spectra_oracle(host[0], host[1:])
    ke_err = _max_err(spectra, ke_ref, ("total", "longitudinal", "transverse"))

    _, stress, _ = model.reynolds_stress()
    _, stress_ref, _ = reynolds_stress_oracle(
        {"dens": host[0][None], **{f"vel{a}": h[None] for a, h in zip("xyz", host[1:])}},
        block_bounds=np.asarray(mesh.block_bounds),
        refine_level=np.asarray(mesh.refine_level),
        node_type=np.asarray(mesh.node_type),
        domain_bounds=np.asarray(mesh.domain_bounds),
        ncells=np.asarray(mesh.nCellsVec),
        nblks=np.asarray(mesh.nBlksVec),
    )
    rs_err = _max_err(stress, stress_ref, stress_ref, shared_scale=True)

    mem = flagship.jitted_analysis_step(None).lower(*vols).compile().memory_analysis()
    mem_text = (
        f"step memory_analysis: temp {mem.temp_size_in_bytes} B, args "
        f"{mem.argument_size_in_bytes} B, out {mem.output_size_in_bytes} B"
        if mem is not None
        else "step memory_analysis: n/a"
    )
    _line(
        f"phase 1 uniform flagship {n}^3 [{source}]",
        cold,
        warm,
        _check("flagship spectra", max(errs[k] for k in spec_keys), TOL_F32),
        _check("flagship profiles", max(errs[k] for k in prof_keys), TOL_F32),
        _check("kinetic_energy_spectra", ke_err, TOL_F32),
        _check("reynolds_stress", rs_err, TOL_F32),
        mem_text,
    )
    return {"model": model, "vols": vols, "host": host, "flagship": out}


def phase_series(n: int, uniform: dict) -> None:
    """Phase 2: batch-4 series scan; snapshot 0 is phase 1's volume and
    snapshots 1-3 are its x-rolls (same spectra, rolled profiles)."""
    import jax.numpy as jnp

    from fava_tpu import flagship
    from scripts.validate import flagship_errors

    batch = [jnp.stack([jnp.roll(v, k, axis=0) for k in range(4)]) for v in uniform["vols"]]
    step = flagship.jitted_series_step()
    out, cold = _timed(lambda: step(*batch))
    out, warm = _timed(lambda: step(*batch))
    host = {k: np.asarray(v, dtype=np.float64) for k, v in out.items()}
    first = flagship_errors({k: v[0] for k, v in host.items()}, uniform["flagship"])
    spec_keys = ("spectra_total", "spectra_longitudinal", "spectra_transverse")
    rolled = max(
        _max_err({k: host[k][i] for k in spec_keys}, uniform["flagship"], spec_keys)
        for i in range(1, 4)
    )
    del batch
    _line(
        f"phase 2 series scan 4 x {n}^3",
        cold,
        warm,
        f"per snapshot {warm / 4:.4f} s",
        _check("snapshot 0 vs phase 1", max(first.values()), TOL_F32),
        _check("rolled spectra vs phase 1", rolled, TOL_F32),
    )


def phase_streamed(n: int, uniform: dict) -> None:
    """Phase 3: streamed (out-of-core) flagship vs the in-core result."""
    from fava_tpu.mesh.flash_uniform import FlashUniform
    from fava_tpu.ops import dft, outofcore
    from scripts.validate import flagship_errors

    model = uniform["model"]
    if h5py is not None:
        source = "HDF5 slabs"

        def run():
            return model.flagship_analysis(streamed=True)

    else:
        source = "host-array slabs (h5py not installed)"
        host = {
            name: np.asarray(v, dtype=np.float32)
            for name, v in zip(("dens", "velx", "vely", "velz"), uniform["vols"])
        }

        def run():
            return outofcore.streamed_uniform_analysis(
                lambda name, x0, x1: host[name][x0:x1],
                (n, n, n),
                slab_rows=FlashUniform._largest_divisor(n, 64),
                chunk_rows=FlashUniform._largest_divisor(n, 64),
                dtype=np.float32,
            )

    out, cold = _timed(run)
    out, warm = _timed(run)
    errs = flagship_errors({k: np.asarray(v) for k, v in out.items()}, uniform["flagship"])
    _line(
        f"phase 3 streamed flagship {n}^3 [{source}, dense-DFT precision {dft.PRECISION.name}]",
        cold,
        warm,
        _check("streamed vs in-core", max(errs.values()), TOL_F32),
    )


def _amr_inputs(n: int, workdir: Path):
    """Flame-band snapshot 0: (FLASH mesh or None, block stacks, geometry)."""
    import fava_tpu
    from fava_tpu.io import synthetic

    block_cells = min(32, n // 4)
    if h5py is not None:
        data_dir = workdir / "amr"
        synthetic.make_flame_catalog(data_dir, n=n, block_cells=block_cells)
        model = fava_tpu.FLASH(data_dir)
        model.load(file_type="plt")
        mesh = model.mesh
        names = ("dens", "velx", "vely", "velz")
        stacks = {k: np.asarray(mesh.data(k)) for k in names}
        geom = {
            "block_bounds": np.asarray(mesh.block_bounds),
            "node_type": np.asarray(mesh.node_type),
            "refine_level": np.asarray(mesh.refine_level),
            "ncells": np.asarray(mesh.nCellsVec),
            "nblks": np.asarray(mesh.nBlksVec),
            "domain_bounds": np.asarray(mesh.domain_bounds),
        }
        return model, stacks, geom
    from fava_tpu.utils import compute_dtype

    kwargs = synthetic.flame_snapshot_kwargs(n, block_cells, 0.0)
    snap = synthetic.amr_snapshot(**{**kwargs, "fields": ("dens", "velx", "vely", "velz")})
    meta = snap["metadata"]
    stacks = {
        k: snap["fields"][k].astype(compute_dtype()) for k in ("dens", "velx", "vely", "velz")
    }
    box = meta["bounding box"]
    geom = {
        "block_bounds": box,
        "node_type": meta["node type"],
        "refine_level": meta["refine level"],
        "ncells": np.array([block_cells] * 3),
        "nblks": np.array([8, 2, 2]),
        "domain_bounds": np.stack([box[..., 0].min(axis=0), box[..., 1].max(axis=0)], axis=1),
    }
    return None, stacks, geom


def _window(n: int) -> np.ndarray:
    from fava_tpu.io import synthetic

    xf = synthetic.flame_front(0.0)
    hw = synthetic.FLAME_HALF_WIDTH
    return np.array([[xf - hw, xf + hw], [0.0, 1.0], [0.0, 1.0]])


def phase_amr(n: int, workdir: Path) -> None:
    """Phase 4: 4-level flame-band AMR snapshot -> profiles + regrid."""
    import jax

    from fava_tpu.ops import profiles as profile_ops
    from fava_tpu.ops import regrid as regrid_ops
    from tests.oracles.profiles import reynolds_stress_oracle
    from tests.oracles.regrid import from_amr_oracle

    model, stacks, geom = _amr_inputs(n, workdir)
    host64 = {k: v.astype(np.float64) for k, v in stacks.items()}
    _, stress_ref, means_ref = reynolds_stress_oracle(host64, **geom)
    sub = _window(n)
    names = ["dens", "velx"]
    regrid_ref, total = from_amr_oracle(
        {k: stacks[k] for k in names},
        block_bounds=geom["block_bounds"],
        node_type=geom["node_type"],
        refine_level=np.asarray(geom["refine_level"]).astype(int),
        ncells=geom["ncells"],
        nblks=geom["nblks"],
        subdomain_coords=sub,
        fields=names,
    )

    if model is not None:
        source = "plt file"

        def profiles():
            _, stress, _ = model.reynolds_stress()
            favre = model.favre_profiles()
            return stress, favre

        def regrid():
            model.mesh.from_amr(subdomain_coords=sub, fields=names, save_file=False)
            return {k: np.asarray(model.mesh.data(k)) for k in names}

    else:
        source = "in-memory block stacks (h5py not installed)"
        leaf = np.nonzero(np.asarray(geom["node_type"]) == 1)[0]
        pgeom = profile_ops.ProfileGeometry(
            block_bounds=geom["block_bounds"],
            refine_level=np.asarray(geom["refine_level"]),
            blocklist=leaf,
            domain_bounds=geom["domain_bounds"],
            ncells_vec=geom["ncells"],
            nblks_vec=geom["nblks"],
            ndim=3,
            raxis=0,
        )
        dev = {k: jax.device_put(v) for k, v in stacks.items()}
        plan = regrid_ops.RegridPlan(
            block_bounds=geom["block_bounds"],
            node_type=geom["node_type"],
            refine_level=geom["refine_level"],
            ncells_vec=geom["ncells"],
            nblks_vec=geom["nblks"],
            ndim=3,
            subdomain_coords=sub,
        )

        def profiles():
            _, stress, _ = profile_ops.reynolds_stress(dev, pgeom)
            return stress, profile_ops.favre_profiles(dev, pgeom)

        def regrid():
            out = regrid_ops.regrid_fields(plan, {k: dev[k] for k in names}, names)
            return {k: np.asarray(v) for k, v in out.items()}

    (stress, favre), cold = _timed(profiles)
    (stress, favre), warm = _timed(profiles)
    rs_err = _max_err(stress, stress_ref, stress_ref, shared_scale=True)
    dens_err = _max_err({"dens": favre["mean_dens"]}, means_ref, ["dens"])
    favre_finite = all(np.isfinite(np.asarray(v)).all() for v in favre["favre_mean"].values())
    if not favre_finite:
        raise RuntimeError("favre_profiles returned non-finite means")
    got, regrid_s = _timed(regrid)
    exact = all(np.array_equal(got[k], regrid_ref[k]) for k in names)
    if not exact or tuple(got["dens"].shape) != tuple(int(t) for t in total):
        raise RuntimeError(f"regrid to {tuple(total)} is not bit-exact vs the oracle")
    _line(
        f"phase 4 AMR {len(geom['node_type'])} blocks -> {n}^3 window [{source}]",
        cold,
        warm,
        _check("reynolds_stress", rs_err, TOL_F32),
        _check("favre_profiles mean_dens", dens_err, TOL_F32),
        f"regrid {regrid_s:.3f} s bit-exact",
    )


def phase_stage4(n: int, uniform: dict) -> None:
    """Phase 5: the stage-4 analyses whose kernels changed."""
    import jax

    from fava_tpu.ops import gradients as grad_ops
    from fava_tpu.ops.velocity import _check_vels

    model = uniform["model"]
    dens, velx = uniform["host"][0], uniform["host"][1]
    xr = tuple(float(q) for q in np.quantile(dens[::4, ::4, ::4], [0.01, 0.99]))
    yr = tuple(float(q) for q in np.quantile(velx[::4, ::4, ::4], [0.01, 0.99]))

    def pdf2d():
        return model.pdf2d("dens", "velx", nbins=(100, 100), xrange=xr, yrange=yr, density=False)

    got, cold = _timed(pdf2d)
    got, warm = _timed(pdf2d)
    edges = [np.linspace(*r, 101).astype(np.float32).astype(np.float64) for r in (xr, yr)]
    ref, _, _ = np.histogram2d(dens.ravel(), velx.ravel(), bins=edges)
    if not np.array_equal(got["counts"], ref):
        raise RuntimeError(f"pdf2d counts differ in {int((got['counts'] != ref).sum())} bins")

    inv, inv_s = _timed(lambda: model.gradient_invariant_pdfs(nbins=(100, 100)))
    vels = uniform["vols"][1:]
    shape, key = _check_vels(vels, model.mesh._domain_lengths(), "smoke")
    fields = grad_ops._invariant_fields_fn(shape, grad_ops._spacings(shape, key), "periodic")

    @jax.jit
    def qr(vx, vy, vz):
        q, r, qw = fields(vx, vy, vz)
        return (q, r, *grad_ops.invariant_pdf_edges(qw, 8.0, 100, 100))

    q, r, qe, re = (np.asarray(a, dtype=np.float64) for a in qr(*vels))
    inv_ref, _, _ = np.histogram2d(q.ravel(), r.ravel(), bins=(qe, re))
    if not np.array_equal(inv["counts"], inv_ref):
        diff = int(np.abs(inv["counts"] - inv_ref).sum())
        raise RuntimeError(f"gradient_invariant_pdfs counts differ by {diff} samples")

    ran = {
        "pdf1d": lambda: model.pdf1d("dens", nbins=100)["pdf"],
        "fractal_dimension": lambda: model.fractal_dimension("flam", contours=0.5)["flam"]["0.5"][
            "average fractal dimension"
        ],
        "structure_functions": lambda: list(model.structure_functions()["longitudinal"].values()),
        "turbulence_summary": lambda: list(model.turbulence_summary().values()),
    }
    walls = []
    for name, fn in ran.items():
        val, wall = _timed(fn)
        if not np.isfinite(np.asarray(val, dtype=np.float64)).all():
            raise RuntimeError(f"{name} returned non-finite values")
        walls.append(f"{name} {wall:.3f} s")
    _line(
        f"phase 5 stage-4 analyses {n}^3",
        cold,
        warm,
        "pdf2d counts exact vs np.histogram2d",
        f"gradient_invariant_pdfs {inv_s:.3f} s, counts exact",
        *walls,
    )


def phase_pipeline(n: int, workdir: Path) -> None:
    """Phase 6: the 4-stage pipeline CLI in this process (3 snapshots)."""
    from fava_tpu import pipeline
    from fava_tpu.io import synthetic

    if h5py is None:
        print("phase 6 pipeline: not run, h5py is not installed", flush=True)
        return
    data_dir = workdir / "pipe_data"
    out_dir = workdir / "pipe_out"
    run_dir = workdir / "pipe_run"
    run_dir.mkdir()
    synthetic.make_flame_catalog(data_dir, n=n, block_cells=min(32, n // 4))
    settings = {
        "data folder": str(data_dir),
        "output folder": str(out_dir),
        "basename": "rt_hdf5_plt_cnt",
        "dimension": 3,
        "model": "synthetic rtflame",
        "reynolds stress": {"skip": False},
        "extract windows": {"skip": False},
        "flame window": {"half width": synthetic.FLAME_HALF_WIDTH, "transverse": [0.0, 1.0]},
        "fractal dimension": {"skip": False, "settings": {"field": "flam", "contours": 0.5}},
        "kinetic energy spectra": {"skip": False},
        "structure functions": {
            "skip": False,
            "settings": {"num_seps": 100, "num_points": 10000, "sep_bounds": [0.01, 0.45]},
        },
    }
    (run_dir / pipeline.PIPELINE_SETTINGS_NAME).write_text(json.dumps(settings))
    t0 = time.perf_counter()
    if pipeline.main(run_dir) != 0:
        raise RuntimeError("pipeline.main returned non-zero")
    wall = time.perf_counter() - t0
    analysis = sorted(out_dir.glob("*hdf5_analysis_*"))
    windows = sorted(out_dir.glob("*hdf5_uniform_*"))
    keys = set()
    for p in analysis:
        with h5py.File(p, "r") as f:
            keys |= set(f.keys())
    wanted = {"reynolds stresses", "fractal dimension", "structure functions", "kinetic energy spectra"}
    if len(windows) != len(synthetic.FLAME_TIMES) or not wanted <= keys:
        raise RuntimeError(f"pipeline outputs incomplete: {len(windows)} windows, keys {sorted(keys)}")
    if not (run_dir / pipeline.PIPELINE_CHECKPOINT_NAME).is_file():
        raise RuntimeError("pipeline wrote no checkpoint")
    print(
        f"phase 6 pipeline 3 snapshots, {n}^3 windows: cold {wall:.3f} s, peak {_peak()}, "
        f"{len(windows)} windows + {len(analysis)} analysis files + checkpoint",
        flush=True,
    )


def phase_sharded(n: int) -> None:
    """--chips 4: slab-sharded flagship, snap x space series step and
    sharded regrid, each against the same computation on one device."""
    import jax

    import fava_tpu
    from fava_tpu import flagship
    from fava_tpu.io import synthetic
    from fava_tpu.ops import regrid as regrid_ops
    from fava_tpu.parallel import make_device_mesh, use_mesh
    from jax.sharding import NamedSharding, PartitionSpec as P
    from scripts.validate import flagship_errors

    names = ("dens", "velx", "vely", "velz")
    data = {k: np.asarray(v) for k, v in zip(names, flagship.make_example_fields(n=n))}
    single = fava_tpu.from_arrays(data)
    ref = single.flagship_analysis()

    space = make_device_mesh((4,), ("space",))
    with use_mesh(space):
        sharded = fava_tpu.from_arrays(data)
        if len(sharded.mesh.data("dens").sharding.device_set) != 4:
            raise RuntimeError("volume is not sharded over 4 devices")
        out, cold = _timed(sharded.flagship_analysis)
        out, warm = _timed(sharded.flagship_analysis)
    _line(
        f"sharded flagship {n}^3 over 4 devices",
        cold,
        warm,
        _check("vs one device", max(flagship_errors(out, ref).values()), TOL_SHARDED),
    )

    vols = [single.mesh.data(k) for k in names]
    batch = [np.asarray(jax.numpy.stack([jax.numpy.roll(v, k, axis=0) for k in range(4)])) for v in vols]
    ref_series = {k: np.asarray(v) for k, v in flagship.jitted_series_step()(*batch).items()}
    pod = make_device_mesh((2, 2), ("snap", "space"))
    spec = NamedSharding(pod, P("snap", "space", None, None))
    placed = [jax.device_put(b, spec) for b in batch]
    step = flagship.jitted_sharded_series_step(pod)
    out, cold = _timed(lambda: {k: np.asarray(v) for k, v in step(*placed).items()})
    out, warm = _timed(lambda: {k: np.asarray(v) for k, v in step(*placed).items()})
    del placed, batch
    _line(
        f"snap x space series step 4 x {n}^3 on a 2x2 mesh",
        cold,
        warm,
        _check("vs one device", max(flagship_errors(out, ref_series).values()), TOL_SHARDED),
    )

    block_cells = min(32, n // 4)
    kwargs = synthetic.flame_snapshot_kwargs(n, block_cells, 0.0)
    snap = synthetic.amr_snapshot(**{**kwargs, "fields": ("dens", "velx")})
    meta = snap["metadata"]
    plan = regrid_ops.RegridPlan(
        block_bounds=meta["bounding box"],
        node_type=meta["node type"],
        refine_level=meta["refine level"],
        ncells_vec=np.array([block_cells] * 3),
        nblks_vec=np.array([8, 2, 2]),
        ndim=3,
        subdomain_coords=_window(n),
    )
    names = ["dens", "velx"]
    stacks = {k: snap["fields"][k].astype(np.float32) for k in names}
    one = regrid_ops.regrid_fields(plan, {k: jax.device_put(v) for k, v in stacks.items()}, names)
    one = {k: np.asarray(v) for k, v in one.items()}
    got, cold = _timed(
        lambda: {
            k: np.asarray(v)
            for k, v in regrid_ops.regrid_fields_sharded(plan, stacks, names, space).items()
        }
    )
    if not all(np.array_equal(got[k], one[k]) for k in names):
        raise RuntimeError("sharded regrid differs from the single-device regrid")
    print(
        f"sharded regrid {len(meta['node type'])} blocks -> {one['dens'].shape} over 4 devices: "
        f"cold {cold:.3f} s, peak {_peak()}, bit-exact vs one device",
        flush=True,
    )


def _header() -> None:
    import jax

    from fava_tpu import utils as futils

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
        check=True,
    ).stdout.strip()
    print(
        f"jax {jax.__version__}; devices {jax.devices()}; compile cache "
        f"{futils.enable_compilation_cache()}; h5py "
        f"{h5py.__version__ if h5py is not None else 'not installed'}; nvidia-smi: "
        + smi.replace("\n", " | "),
        flush=True,
    )
    print(smi, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Smoke run of the main path on the GPU.")
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1)
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        sys.stderr.write(f"chip_smoke: needs a GPU, JAX found {devices[0].platform}\n")
        return 2
    if len(devices) < args.chips:
        sys.stderr.write(f"chip_smoke: --chips {args.chips} needs {args.chips} GPUs\n")
        return 2
    from fava_tpu import utils as futils

    futils.timing.VERBOSE = False
    _header()
    if h5py is None:
        print("h5py is not installed: phase 6 (pipeline) does not run; phases 1-4 use in-memory data", flush=True)
    with tempfile.TemporaryDirectory(prefix="fava_smoke_") as tmp:
        workdir = Path(tmp)
        if args.chips == 4:
            phase_sharded(N)
        else:
            uniform = phase_uniform(N, workdir)
            phase_series(N, uniform)
            phase_streamed(N, uniform)
            phase_amr(N, workdir)
            phase_stage4(N, uniform)
            del uniform
            phase_pipeline(N, workdir)
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": devices[0].platform,
                    "kind": devices[0].device_kind,
                    "count": len(devices),
                },
            }
        ),
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
