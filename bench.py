"""Headline benchmark: per-snapshot wall-clock for spectra + Reynolds stress.

Times the flagship fused analysis step (KE spectra total/long/trans +
Reynolds/Favre x-profiles) on a synthetic uniform snapshot, and compares
against a float64 NumPy implementation of the reference algorithms
(np.fft.fftn + scipy binned_statistic + per-row covariance loops —
the exact shape of fava/mesh/FLASH/FlashUniform.py:229-304 and
_flash.py:1506-1611 on a single-block uniform mesh).

Prints ONE JSON line:
  {"metric": "...", "value": <seconds>, "unit": "s", "vs_baseline": <speedup>}

The NumPy baseline is expensive (minutes at 512^3), so its timing is
cached in .bench_baseline.json keyed by grid size. Grid size is 512;
override with BENCH_N.
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

import numpy as np

CACHE = Path(__file__).parent / ".bench_baseline.json"


def _grid_size() -> int:
    return int(os.environ.get("BENCH_N", "512"))


def _pack(jnp, out):
    # Pack every small result into ONE array: one output to wait for.
    return jnp.concatenate(
        [
            out["spectra_counts"].ravel(),
            out["spectra_total"].ravel(),
            out["spectra_longitudinal"].ravel(),
            out["spectra_transverse"].ravel(),
            out["reynolds_stress"].ravel(),
            out["favre_mean"].ravel(),
            out["favre_rms"].ravel(),
            out["mean_dens"].ravel(),
            jnp.atleast_1d(out["total_mass"]).ravel(),
        ]
    )


def _device_time(n: int, repeats: int = 3) -> tuple[float, int]:
    """Best per-snapshot wall at grid n; returns (seconds, batch).

    The production number is the batch-4 series scan
    (flagship.series_analysis_step): the per-dispatch host overhead is
    paid once per batch instead of once per snapshot. Falls back batch
    4 -> 3 -> 2 -> single on RESOURCE_EXHAUSTED, mirroring the
    production series driver's graceful OOM fallback
    (analysis/time_series.flagship_series).
    """
    import jax

    from fava_tpu import utils as futils
    from fava_tpu.flagship import (
        jitted_analysis_step,
        jitted_series_step,
        make_example_field_batch,
        make_example_fields,
    )

    futils.timing.VERBOSE = False

    import jax.numpy as jnp

    def timeit(step, args):
        step(*args).block_until_ready()  # compile + first run
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            step(*args).block_until_ready()
            best = min(best, time.perf_counter() - t0)
        return best

    series = jitted_series_step()
    batched_step = jax.jit(lambda *f: _pack(jnp, series(*f)))
    for batch in (4, 3, 2):
        batched = None
        try:
            # Direct batch synthesis (one jit writes the (B, n, n, n)
            # stacks): stacking separately-built snapshots transiently
            # doubles the input footprint.
            batched = make_example_field_batch(batch, n=n)
            best = timeit(batched_step, batched)
            return best / batch, batch
        except Exception as exc:
            if "RESOURCE_EXHAUSTED" not in str(exc):
                raise
            sys.stderr.write(f"bench: batch {batch} OOM; falling back\n")
        finally:
            # Unbind the failed batch in THIS frame either way (the
            # except clause already dropped the traceback): a smaller
            # retry must not allocate on top of the OOMed buffers.
            batched = None

    inner = jitted_analysis_step(None)
    step = jax.jit(lambda *f: _pack(jnp, inner(*f)))
    fields = jax.block_until_ready(make_example_fields(n=n))
    return timeit(step, fields), 1


def _numpy_baseline_time(n: int) -> float:
    """Reference-shaped float64 NumPy implementation, timed once and cached."""
    if CACHE.is_file():
        cache = json.loads(CACHE.read_text())
        if str(n) in cache:
            return float(cache[str(n)])
    else:
        cache = {}

    from scipy.stats import binned_statistic

    rng = np.random.default_rng(0)
    shape = (n, n, n)
    dens = 1.0 + 0.3 * rng.random(shape)
    vels = [rng.standard_normal(shape) for _ in range(3)]

    t0 = time.perf_counter()

    # --- KE spectra (reference algorithm) ---
    k_num = np.array(shape)
    k_start = -k_num // 2
    k = np.meshgrid(
        *(np.linspace(ks, -ks - 1, nn) for ks, nn in zip(k_start, k_num)), indexing="ij"
    )
    k_abs = np.sqrt(sum(kk**2 for kk in k))
    bins = np.arange(np.max(k_num) // 2) - 0.5

    w = np.sqrt(dens)
    total = np.zeros(shape)
    longi = np.zeros(shape, dtype=np.complex128)
    for comp in range(3):
        fft = np.fft.fftshift(np.fft.fftn(w * vels[comp], norm="forward"))
        total += 0.5 * np.abs(fft) ** 2
        longi += k[comp] * fft
        del fft
    long_pow = np.abs(longi / np.maximum(k_abs, 1e-99)) ** 2
    del longi
    trans = total - long_pow
    for val in (total, long_pow, trans):
        binned_statistic(k_abs.ravel(), val.ravel(), bins=bins, statistic="mean")
    del total, long_pow, trans, k_abs, k

    # --- Reynolds stress x-profiles (reference two-pass algorithm) ---
    layer = float(n * n)
    means = {"dens": dens.sum(axis=(1, 2)) / layer}
    for i, v in enumerate(vels):
        means[i] = v.sum(axis=(1, 2)) / layer
    for i in range(3):
        for j in range(i, 3):
            acc = np.empty(n)
            for row in range(n):
                acc[row] = np.sum(
                    dens[row] * (vels[i][row] - means[i][row]) * (vels[j][row] - means[j][row])
                )
            acc /= layer

    elapsed = time.perf_counter() - t0

    cache[str(n)] = elapsed
    CACHE.write_text(json.dumps(cache))
    return elapsed


def main() -> None:
    import jax

    from fava_tpu import utils as futils

    futils.enable_compilation_cache()
    n = _grid_size()
    device_s, batch = _device_time(n)
    try:
        baseline_s = _numpy_baseline_time(n)
        vs = baseline_s / device_s
    except MemoryError:
        vs = float("nan")

    batch_tag = f", batch-{batch} series scan" if batch > 1 else ""
    print(
        json.dumps(
            {
                "metric": f"per-snapshot wall-clock at {n}^3 (spectra + Reynolds stress{batch_tag})",
                "value": round(device_s, 6),
                "unit": "s",
                "vs_baseline": round(vs, 2),
                "device": {
                    "platform": jax.devices()[0].platform,
                    "kind": jax.devices()[0].device_kind,
                    "count": len(jax.devices()),
                },
            }
        )
    )


if __name__ == "__main__":
    main()
