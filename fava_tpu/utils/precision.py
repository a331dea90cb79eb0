"""Floating-point policy.

The reference computes everything in host float64. On an accelerator
the device compute dtype defaults to float32 — it halves memory and
bandwidth against float64 and runs at a far higher rate — while CPU
test runs (with ``jax_enable_x64``) use float64 and validate bit-level
agreement against the NumPy oracles. Profile /
spectrum accumulators are small, so they always use the widest available
float to keep summation error negligible.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

_OVERRIDE: np.dtype | None = None


def set_compute_dtype(dtype) -> None:
    """Force the device compute dtype (None restores the default policy)."""
    global _OVERRIDE
    _OVERRIDE = None if dtype is None else np.dtype(dtype)


def compute_dtype() -> np.dtype:
    """Dtype for bulk field data on device."""
    if _OVERRIDE is not None:
        return _OVERRIDE
    return np.dtype(np.float64) if jax.config.jax_enable_x64 else np.dtype(np.float32)


def accum_dtype() -> np.dtype:
    """Dtype for small accumulators (profiles, spectra, scalars)."""
    return np.dtype(np.float64) if jax.config.jax_enable_x64 else np.dtype(np.float32)


def complex_dtype() -> np.dtype:
    return np.dtype(np.complex128) if jax.config.jax_enable_x64 else np.dtype(np.complex64)


def to_device(array: np.ndarray, dtype=None, sharding=None) -> jax.Array:
    """Host array -> device array in the compute dtype (optionally sharded)."""
    dt = compute_dtype() if dtype is None else np.dtype(dtype)
    arr = np.asarray(array)
    # With no explicit dtype, only FLOAT data is coerced to the compute
    # dtype (integer tags/indices keep their kind); an EXPLICIT dtype is
    # always honored — silently keeping int math for a requested f32
    # gives truncating arithmetic downstream.
    if arr.dtype != dt and (dtype is not None or np.issubdtype(arr.dtype, np.floating)):
        arr = arr.astype(dt)
    if sharding is not None:
        return jax.device_put(arr, sharding)
    return jax.device_put(arr)


def asdevice(x, dtype=None) -> jax.Array:
    dt = compute_dtype() if dtype is None else np.dtype(dtype)
    return jnp.asarray(x, dtype=dt)
