"""Device times of the plain XLA paths at 512^3, on the GPU.

Times, in one process on one card: a copy (read + write) of 1 GiB for
the achievable bandwidth; the flagship step (single snapshot and the
batch-4 series scan per snapshot) and its stages in isolation (the
three rfftn, the power volumes, the shell binning, the profile
moments); the joint histogram (counts and weighted); the AMR regrid
gather into a 512^3
window; the streamed flagship at each dense-DFT precision, with its
error against the in-core step; f32 matmul error per precision; and
the 1024^3 in-core step's ``memory_analysis`` against the in-core
estimate of ``FlashUniform.flagship_analysis``. Each time is the
median of 5 calls after a warm-up call, each call waited for with
``block_until_ready``.

    python scripts/plain_path_times.py [--out PATH]

Prints one JSON object (and writes it to ``--out`` when given).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def median_time(fn, *args, reps: int = 5) -> float:
    import jax

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def main() -> None:
    import jax
    import jax.numpy as jnp

    from fava_tpu import flagship
    from fava_tpu import utils as futils
    from fava_tpu.io import synthetic
    from fava_tpu.ops import dft, outofcore, profiles, regrid, volume
    from fava_tpu.ops.spectra import rfft_power_volumes, shell_bin_rfft
    from scripts.validate import flagship_errors

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if jax.devices()[0].platform != "gpu":
        sys.exit("plain_path_times: needs a GPU")
    futils.enable_compilation_cache()
    futils.timing.VERBOSE = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    rep = {"device": jax.devices()[0].device_kind, "nvidia_smi": smi, "seconds": {}}
    sec = rep["seconds"]
    n = 512
    nbins = n // 2 - 1
    ntot = n**3

    x = jnp.ones((n, n, 2 * n), jnp.float32)  # 1 GiB
    sec["copy_1GiB"] = median_time(jax.jit(lambda a: a * 2.0), x)
    rep["copy_GBps"] = 2 * x.nbytes / sec["copy_1GiB"] / 1e9
    del x

    vols = flagship.make_example_fields(n=n)
    step = flagship.jitted_analysis_step(None)
    sec["flagship_step"] = median_time(step, *vols)

    t0 = time.perf_counter()
    out = step(*vols)
    sec["flagship_enqueue_only"] = time.perf_counter() - t0
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    np.asarray(step(*vols)["spectra_total"])
    sec["flagship_host_fetch"] = time.perf_counter() - t0

    batch = flagship.make_example_field_batch(4, n=n)
    series = flagship.jitted_series_step()
    sec["series_per_snapshot"] = median_time(series, *batch) / 4
    del batch

    @jax.jit
    def ffts(d, a, b, c):
        sd = jnp.sqrt(d)
        return [jnp.fft.rfftn(sd * v) / ntot for v in (a, b, c)]

    sec["stage_rfftn_x3"] = median_time(ffts, *vols)
    f3 = ffts(*vols)
    powers = jax.jit(lambda fs: rfft_power_volumes(fs, (n, n, n))[:3])
    sec["stage_power_volumes"] = median_time(powers, f3)
    pw = powers(f3)
    del f3
    binning = jax.jit(lambda p: shell_bin_rfft(tuple(p), nbins, n, n))
    sec["stage_shell_binning"] = median_time(binning, pw)
    del pw

    @jax.jit
    def moments(d, a, b, c):
        fields = tuple(v[None] for v in (d, a, b, c))
        raw = profiles.row_moments(fields, raxis=0, nvel=3)
        mu = (raw[1:4] / (n * n)).astype(d.dtype)
        return raw, profiles.centered_row_moments(fields, mu, raxis=0, nvel=3)

    sec["stage_profile_moments"] = median_time(moments, *vols)

    # Joint histogram at 100 x 100 bins over 512^3 samples.
    xv, yv = vols[0], vols[1]
    xe = jnp.asarray(np.linspace(float(xv.min()), float(xv.max()), 101), jnp.float32)
    ye = jnp.asarray(np.linspace(float(yv.min()), float(yv.max()), 101), jnp.float32)
    for counting in (True, False):
        fn = volume._hist2d_fn(100, 100, counting)
        key = f"pdf2d_{'counts' if counting else 'weighted'}"
        sec[key] = median_time(fn, xv, yv, vols[2], xe, ye)

    # Streamed flagship at each dense-DFT precision vs the in-core step.
    host = {k: np.asarray(v) for k, v in zip(("dens", "velx", "vely", "velz"), vols)}
    incore = {k: np.asarray(v) for k, v in step(*vols).items()}
    rep["streamed"] = {}
    default = dft.PRECISION
    for name in ("high", "highest"):
        dft.PRECISION = dft._PRECISIONS[name]

        def streamed():
            return outofcore.streamed_uniform_analysis(
                lambda f, x0, x1: host[f][x0:x1], (n, n, n), slab_rows=n // 8, chunk_rows=n // 8
            )

        got = streamed()
        t0 = time.perf_counter()
        got = streamed()
        wall = time.perf_counter() - t0
        errs = flagship_errors({k: np.asarray(v) for k, v in got.items()}, incore)
        rep["streamed"][name] = {"seconds": wall, "max_scaled_error_vs_incore": max(errs.values())}
    dft.PRECISION = default

    a = jnp.asarray(np.random.default_rng(0).standard_normal((1024, 1024)), jnp.float32)
    ref = np.asarray(a, np.float64) @ np.asarray(a, np.float64)
    rep["f32_matmul_error"] = {
        p: float(np.abs(np.asarray(jnp.dot(a, a, precision=p)) - ref).max() / np.abs(ref).max())
        for p in ("default", "high", "highest")
    }
    del vols, host

    # Regrid gather: flame-band snapshot (4 levels) -> 512^3 window.
    kw = synthetic.flame_snapshot_kwargs(n, 32, 0.0)
    kw["fields"] = ("dens",)
    snap = synthetic.amr_snapshot(**kw)
    meta = snap["metadata"]
    xf, hw = synthetic.flame_front(0.0), synthetic.FLAME_HALF_WIDTH
    plan = regrid.RegridPlan(
        block_bounds=meta["bounding box"],
        node_type=meta["node type"],
        refine_level=meta["refine level"],
        ncells_vec=np.array([32] * 3),
        nblks_vec=np.array([8, 2, 2]),
        ndim=3,
        subdomain_coords=np.array([[xf - hw, xf + hw], [0.0, 1.0], [0.0, 1.0]]),
    )
    stack = {"dens": jax.device_put(snap["fields"]["dens"].astype(np.float32))}
    sec["regrid_gather_512"] = median_time(lambda s: regrid.regrid_fields(plan, s, ["dens"]), stack)
    rep["regrid_source_blocks"] = int(len(meta["node type"]))
    del stack, snap

    # In-core step at 1024^3: compiled memory vs the in-core estimate.
    shp = jax.ShapeDtypeStruct((1024,) * 3, jnp.float32)
    ma = flagship.jitted_analysis_step(None).lower(shp, shp, shp, shp).compile().memory_analysis()
    cells = 1024**3
    rep["incore_1024"] = {
        "temp_bytes": int(ma.temp_size_in_bytes),
        "argument_bytes": int(ma.argument_size_in_bytes),
        "output_bytes": int(ma.output_size_in_bytes),
        "estimate_bytes": 4 * 4 * cells + 3 * 2 * 4 * cells // 2 + 2 * 4 * cells,
        "bytes_limit": int(jax.devices()[0].memory_stats()["bytes_limit"]),
    }

    text = json.dumps(rep)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(rep, indent=2))
    print(text, flush=True)


if __name__ == "__main__":
    main()
