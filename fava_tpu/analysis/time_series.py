"""Multi-snapshot time-series drivers with async ingest.

BASELINE config #3: Favre-averaged profiles + mass-weighted RMS
fluctuations over a plt snapshot series. No reference equivalent —
the reference re-loads every file synchronously per analysis. Here the
SnapshotPrefetcher overlaps HDF5 reads + host->device transfer of
snapshot N+1 with device compute on snapshot N.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, Optional, Sequence

import numpy as np

from fava_tpu.analysis._catalogs import mesh_series_paths
from fava_tpu.io.ingest import Snapshot, SnapshotPrefetcher
from fava_tpu.models.model import Model
from fava_tpu.ops import profiles as profile_ops
from fava_tpu.parallel import runtime as prt


@lru_cache(maxsize=4)
def _pod_stack_fn(mesh):
    """Cached jitted stack+reshard into the P(snap, space) batch.

    Module-level cache: a fresh ``jax.jit`` per flagship_series call
    would retrace/recompile the (tiny) stack step every series.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    sharding = NamedSharding(mesh, P(prt.SNAP_AXIS, prt.SPACE_AXIS, None, None))
    return jax.jit(lambda *v: jnp.stack(v), out_shardings=sharding)


def _geometry_from_snapshot(snap: Snapshot, raxis: int) -> profile_ops.ProfileGeometry:
    ints = snap.scalars["integer"]
    rints = snap.runtime_parameters["integer"]
    reals = snap.runtime_parameters["real"]
    ndim = int(ints["dimensionality"])
    node_type = snap.metadata.get("node type", np.ones(1, dtype=np.int64))
    refine_level = snap.metadata.get("refine level", np.ones(1, dtype=np.int64))
    return profile_ops.ProfileGeometry(
        block_bounds=snap.metadata["bounding box"],
        refine_level=np.asarray(refine_level),
        blocklist=np.nonzero(np.asarray(node_type) == 1)[0],
        domain_bounds=np.array(
            [
                [reals.get("xmin", 0.0), reals.get("xmax", 1.0)],
                [reals.get("ymin", 0.0), reals.get("ymax", 1.0)],
                [reals.get("zmin", 0.0), reals.get("zmax", 1.0)],
            ],
            dtype=np.float64,
        ),
        ncells_vec=np.array([ints["nxb"], ints["nyb"], ints["nzb"]], dtype=np.int64),
        nblks_vec=np.array(
            [rints.get("nblockx", 1), rints.get("nblocky", 1), rints.get("nblockz", 1)],
            dtype=np.int64,
        ),
        ndim=ndim,
        raxis=raxis,
    )


def _ensure_block_axis(fields: Dict) -> Dict:
    return {k: (v[None] if v.ndim == 3 else v) for k, v in fields.items()}


def _uniform_volume(snap: Snapshot, name: str, what: str):
    """A snapshot field as a bare volume (single-block files only)."""
    v = snap.fields.get(name)
    if v is None:
        return None
    if v.ndim == 4:
        if v.shape[0] != 1:
            raise ValueError(
                f"{what} needs single-block uniform volumes; got "
                f"{v.shape[0]} blocks from {snap.path} — use "
                "favre_series/reynolds_series for AMR series, or regrid "
                "with from_amr first."
            )
        v = v[0]
    return v


# ONE catalog lookup for the five series drivers (and a named error for
# an unknown file_type instead of a bare KeyError) — shared with the
# particle-series resolver in analysis/_catalogs.py.
_series_paths = mesh_series_paths


def _packed_stat_series(paths, fields, make_vec, prefetch_depth: int, group: int = 16):
    """Shared packed-vector series loop (summary_series and friends).

    Async-prefetch each snapshot, call ``make_vec(snap) -> (device
    vec, names)``, keep results DEVICE-resident and fetch one stacked
    array per ``group`` snapshots: jit dispatch is async, so the host
    round trip is paid once per group instead of once per snapshot.
    Returns ``(times (nfiles,), names, table (nfiles, nstats)
    or None)``; raises on ragged stat columns (a catalog where some
    files carry optional fields only sometimes would silently misalign
    the stacked columns against "times").
    """
    import jax.numpy as jnp

    times: list = []
    names: Optional[tuple] = None
    pending: list = []  # device-resident packed stat vectors
    rows: list = []  # fetched (group, nstats) blocks

    def flush():
        if pending:
            rows.append(np.asarray(jnp.stack(pending), dtype=np.float64))
            pending.clear()

    for snap in SnapshotPrefetcher(
        paths,
        fields,
        depth=prefetch_depth,
        sharding=prt.ingest_sharding_fn(),
        strict=False,  # optional extras (pres/gamc) may be absent
    ):
        vec, snap_names = make_vec(snap)
        if names is None:
            names = tuple(snap_names)
        elif tuple(snap_names) != names:
            missing = sorted(set(names) - set(snap_names))
            extra = sorted(set(snap_names) - set(names))
            detail = (
                f"missing {missing}, unexpected {extra}"
                if (missing or extra)
                # Same columns permuted: the set difference is empty,
                # which used to print a misleading "got [] only
                # sometimes" — name the order mismatch instead.
                else f"same columns in a different order: got {list(snap_names)}, expected {list(names)}"
            )
            raise ValueError(
                f"{snap.path}: inconsistent stat columns across the series ({detail})"
            )
        times.append(snap.time)
        pending.append(vec)
        if len(pending) >= group:
            flush()
    flush()
    table = np.concatenate(rows, axis=0) if rows else None
    return np.asarray(times), names, table


@Model.register_analysis(use_timer=True)
def favre_series(
    self,
    file_type: str = "plt",
    raxis: int = 0,
    prefetch_depth: int = 2,
    file_indices: Optional[Sequence[int]] = None,
) -> Dict[str, np.ndarray]:
    """Favre means + mass-weighted RMS profiles over a snapshot series.

    Returns stacked (nfiles, nfine) profiles per velocity component plus
    the times and the common span.
    """
    indices, paths = _series_paths(self, file_type, file_indices)

    fields = ["dens", "velx", "vely", "velz"]
    times = []
    stacked: Dict[str, list] = {}
    span = None

    # Prefetch straight into the mesh sharding (one host-link crossing;
    # block stacks shard over "space" when divisible).
    for snap in SnapshotPrefetcher(
        paths, fields, depth=prefetch_depth, sharding=prt.ingest_sharding_fn()
    ):
        geom = _geometry_from_snapshot(snap, raxis)
        ndim = geom.ndim
        data = _ensure_block_axis(snap.fields)
        out = profile_ops.favre_profiles(data, geom)
        times.append(snap.time)
        span = out["span"]
        for a in "xyz"[:ndim]:
            stacked.setdefault(f"favre_mean_vel{a}", []).append(out["favre_mean"][f"vel{a}"])
            stacked.setdefault(f"favre_rms_vel{a}", []).append(out["favre_rms"][f"vel{a}"])
        stacked.setdefault("mean_dens", []).append(out["mean_dens"])

    result: Dict[str, np.ndarray] = {k: np.stack(v) for k, v in stacked.items()}
    result["times"] = np.asarray(times)
    result["span"] = span
    return result


@Model.register_analysis(use_timer=True)
def particle_series(
    self,
    fields: Optional[Sequence[str]] = None,
    file_indices: Optional[Sequence[int]] = None,
) -> Dict[str, np.ndarray]:
    """Per-snapshot particle statistics (mean/RMS/min/max) over a
    particle-file series (BASELINE config #5 particle stats)."""
    indices = (
        sorted(self.prt_files["by index"].keys()) if file_indices is None else list(file_indices)
    )
    times = []
    stacked: Dict[str, list] = {}
    for i in indices:
        self.load(file_index=i, file_type="prt", fields=list(fields) if fields else None)
        times.append(self.particles.time)
        stats = self.particles.statistics(fields)
        for fname, s in stats.items():
            for key, val in s.items():
                stacked.setdefault(f"{fname}_{key}", []).append(val)
    out = {k: np.asarray(v) for k, v in stacked.items()}
    out["times"] = np.asarray(times)
    return out


@Model.register_analysis(use_timer=True)
def reynolds_series(
    self,
    file_type: str = "plt",
    raxis: int = 0,
    prefetch_depth: int = 2,
    file_indices: Optional[Sequence[int]] = None,
) -> Dict[str, np.ndarray]:
    """Reynolds-stress profiles over a snapshot series (async ingest)."""
    indices, paths = _series_paths(self, file_type, file_indices)

    fields = ["dens", "velx", "vely", "velz"]
    times = []
    stacked: Dict[str, list] = {}
    radius = None

    for snap in SnapshotPrefetcher(
        paths, fields, depth=prefetch_depth, sharding=prt.ingest_sharding_fn()
    ):
        geom = _geometry_from_snapshot(snap, raxis)
        data = _ensure_block_axis(snap.fields)
        radius, stress, means = profile_ops.reynolds_stress(data, geom)
        times.append(snap.time)
        for k, v in stress.items():
            stacked.setdefault(k, []).append(v)
        for k, v in means.items():
            stacked.setdefault(f"mean_{k}", []).append(v)

    result: Dict[str, np.ndarray] = {k: np.stack(v) for k, v in stacked.items()}
    result["times"] = np.asarray(times)
    result["radius"] = radius
    return result


@Model.register_analysis(use_timer=True)
def flagship_series(
    self,
    file_type: str = "uni",
    batch: int = 0,
    prefetch_depth: int = 2,
    file_indices: Optional[Sequence[int]] = None,
) -> Dict[str, np.ndarray]:
    """Flagship spectra + Reynolds/Favre profiles over a uniform series,
    ``batch`` snapshots per device dispatch.

    Single chip: ``flagship.series_analysis_step`` scans each batch on
    device in ONE dispatch (the per-dispatch host round trip is paid
    once per batch, not once per snapshot).

    With an active snap x space pod mesh (``parallel.use_mesh`` with
    axes ("snap", "space")), batches additionally shard over the
    "snap" axis and every volume slab-shards over "space":
    ``flagship.sharded_series_analysis_step`` — the production
    BASELINE config #5 path. Prefetch then device_puts each snapshot
    straight into the mesh (x split over all devices; ONE host-link
    crossing), and a tiny jitted stack redistributes to the
    ``P("snap", "space")`` batch over the device interconnect.

    ``batch=0`` sizes the batch from the snapshot footprint against a
    conservative per-device memory input budget (scaled by the snap rows
    on a pod); a short final batch runs through the same scan shape
    (padded by repeating the last snapshot on a pod — outputs are
    trimmed). Outputs carry a leading snapshot axis.
    """
    import jax.numpy as jnp

    from fava_tpu import flagship

    indices, paths = _series_paths(self, file_type, file_indices)
    fields = ["dens", "velx", "vely", "velz"]

    def vol(snap: Snapshot, name: str):
        v = _uniform_volume(snap, name, "flagship_series")
        if v is None:
            raise KeyError(f"{snap.path}: missing required field {name!r}")
        return v

    active_mesh = prt.get_mesh()
    pod = prt.is_pod_mesh(active_mesh)
    n_snap = prt.snap_axis_size(active_mesh)

    def pod_shapes_ok(shape) -> bool:
        # The sharded series step slab-shards x and all_to_all-splits y
        # over "space"; both must divide.
        n_space = active_mesh.shape[prt.SPACE_AXIS]
        return (
            len(shape) == 3 and shape[0] % n_space == 0 and shape[1] % n_space == 0
        )

    if pod:
        step = flagship.jitted_sharded_series_step(active_mesh)

        def stack(vols):
            # On-device stack + redistribution to the snap x space batch
            # (device to device; prefetch already paid the one host crossing).
            return _pod_stack_fn(active_mesh)(*vols)
    else:
        step = flagship.jitted_series_step()

        def stack(vols):
            return jnp.stack(vols)

    times: list = []
    chunks: Dict[str, list] = {}
    pending: list = []
    batch_cap: list = [0]  # safe size discovered after an OOM (0 = none)

    def flush_once(group):
        npad = (-len(group)) % n_snap if pod else 0
        group = list(group) + [group[-1]] * npad
        # NOTE: stacking keeps every per-snapshot buffer alive until the
        # step returns (the OOM fallback below re-stacks halves from
        # them), so a batch transiently costs 2x its footprint — that,
        # plus prefetch residency, is why the auto budget below keeps
        # the resident inputs well under the device memory.
        stacked = []
        try:
            for f in fields:
                stacked.append(stack([vol(s, f) for s in group]))
            out = step(*stacked)
        finally:
            # Drop the stacked batch from this frame before an OOM
            # unwinds (the traceback would pin ~2x the batch footprint
            # in device memory through the fallback's retries) — and, on success,
            # before the result fetch below.
            stacked.clear()
        for k, v in out.items():
            arr = np.asarray(v)
            chunks.setdefault(k, []).append(arr[: len(group) - npad] if npad else arr)

    def flush(group):
        # Graceful OOM fallback: the memory budget heuristic above can
        # overshoot on devices with other resident buffers, and a raw
        # RESOURCE_EXHAUSTED mid-series is unactionable. Halve the
        # batch and retry; remember the cap for the rest of the series.
        if batch_cap[0] and len(group) > batch_cap[0]:
            for k in range(0, len(group), batch_cap[0]):
                flush(group[k : k + batch_cap[0]])
            return
        half = 0
        try:
            flush_once(group)
        except Exception as exc:
            # On a pod, flush_once pads every group to a multiple of
            # n_snap: the dispatched shape only shrinks in snap-row
            # steps, so halve in padded units (a cap below n_snap would
            # re-dispatch the identical failing padded batch forever).
            k_pad = -(-len(group) // n_snap) if pod else len(group)
            if "RESOURCE_EXHAUSTED" not in str(exc) or k_pad <= 1:
                raise
            import logging

            half = (n_snap * ((k_pad + 1) // 2)) if pod else (len(group) + 1) // 2
            batch_cap[0] = half
            logging.getLogger(__name__).warning(
                "flagship_series: batch %d exhausted device memory; "
                "falling back to batches of %d for the rest of the series",
                len(group),
                half,
            )
        if half:
            # Retry OUTSIDE the except block: the live exception's
            # traceback pins the failed dispatch's device buffers (jax
            # call frames hold the stacked arrays); leaving the handler
            # releases them before the halves allocate.
            flush(group[:half])
            flush(group[half:])

    # Pre-sharded prefetch ONLY on the pod path: the single-chip series
    # scan (plain jit + Pallas kernels) cannot consume mesh-sharded
    # inputs, and a space-only mesh takes that scan. The callback's own
    # divisibility rules match pod_shapes_ok, so any snapshot that would
    # trigger the fallback below arrives unsharded.
    ingest_sharding = prt.ingest_sharding_fn(active_mesh) if pod else None

    for snap in SnapshotPrefetcher(
        paths, fields, depth=prefetch_depth, sharding=ingest_sharding
    ):
        if pod and not pod_shapes_ok(tuple(vol(snap, fields[0]).shape)):
            # A shard_map on non-divisible extents would fail with an
            # opaque partitioning error mid-series; fall back loudly to
            # the single-chip scan (mirrors from_amr's fallback).
            import logging

            logging.getLogger(__name__).warning(
                "flagship_series: volume extents %s do not divide the space axis "
                "%d; falling back to the single-chip series scan",
                tuple(vol(snap, fields[0]).shape),
                active_mesh.shape[prt.SPACE_AXIS],
            )
            pod = False
            n_snap = 1
            step = flagship.jitted_series_step()
            stack = jnp.stack
        if batch <= 0:
            # Inputs budget: keep the resident batch under 40% of the
            # device memory so the scan's per-iteration temporaries
            # (about 4 snapshot-sized volumes) fit beside it. Small
            # grids cap at 8. On a pod each snap row holds
            # batch/n_snap snapshots, so the budgeted batch scales by
            # the snap rows.
            per_snap = sum(vol(snap, f).nbytes for f in fields)
            budget = 0.4 * prt.device_memory_bytes()
            batch = int(np.clip(budget // max(per_snap, 1), 1, 8)) * n_snap
        times.append(snap.time)
        pending.append(snap)
        if len(pending) >= batch:
            flush(pending)
            pending = []
    if pending:
        flush(pending)

    result: Dict[str, np.ndarray] = {k: np.concatenate(v) for k, v in chunks.items()}
    result["times"] = np.asarray(times)
    return result


@Model.register_analysis(use_timer=True)
def summary_series(
    self,
    file_type: str = "uni",
    gamma: float = 5.0 / 3.0,
    prefetch_depth: int = 2,
    file_indices: Optional[Sequence[int]] = None,
) -> Dict[str, np.ndarray]:
    """Turbulence-summary time series over a uniform-file catalog.

    The canonical production plot — u_rms(t), Mach(t), integral/Taylor
    scales, solenoidal/compressive fractions, vorticity/dilatation rms
    — one jit dispatch per snapshot (the per-shape trace is cached by
    ops/velocity.turbulence_summary), with async HDF5->device prefetch
    overlapping the next read. Results stay DEVICE-resident and are
    fetched 16 snapshots at a time in one stacked array: dispatch is
    async, so the host round trip is paid once per group instead of
    once per snapshot. ``pres``/``gamc`` ride along
    when the files carry them (Mach columns appear only then;
    ``gamma`` is the fallback ratio). Beyond the reference (no summary
    analysis, and its series loops re-load files synchronously —
    fava/pipeline.py). Returns {"times", <scalar name>: (nfiles,)
    arrays}.
    """
    from fava_tpu.ops import velocity as vel_ops

    indices, paths = _series_paths(self, file_type, file_indices)
    fields = ["dens", "velx", "vely", "velz", "pres", "gamc"]

    def make_vec(snap: Snapshot):
        ints = snap.scalars["integer"]
        reals = snap.runtime_parameters["real"]
        ndim = int(ints["dimensionality"])
        lengths = tuple(
            float(reals.get(f"{a}max", 1.0)) - float(reals.get(f"{a}min", 0.0))
            for a in "xyz"[:ndim]
        )
        vels = [_uniform_volume(snap, f"vel{a}", "summary_series") for a in "xyz"[:ndim]]
        if any(v is None for v in vels):
            raise KeyError(f"{snap.path}: missing velocity components")
        if ndim < 3:
            vels = [v.reshape(v.shape[:ndim]) for v in vels]

        def squeeze(v):
            return None if v is None else (v.reshape(v.shape[:ndim]) if v.ndim > ndim else v)

        dens = squeeze(_uniform_volume(snap, "dens", "summary_series"))
        pres = squeeze(_uniform_volume(snap, "pres", "summary_series"))
        gamc = squeeze(_uniform_volume(snap, "gamc", "summary_series"))
        return vel_ops.turbulence_summary_device(
            *vels,
            dens=dens,
            pres=pres,
            gamma=gamc if (pres is not None and gamc is not None) else gamma,
            lengths=lengths,
        )

    times, names, table = _packed_stat_series(paths, fields, make_vec, prefetch_depth)
    result: Dict[str, np.ndarray] = (
        {k: table[:, i] for i, k in enumerate(names)} if table is not None else {}
    )
    result["times"] = times
    return result


@Model.register_analysis(use_timer=True)
def gradient_series(
    self,
    file_type: str = "uni",
    boundary: str = "periodic",
    prefetch_depth: int = 2,
    file_indices: Optional[Sequence[int]] = None,
) -> Dict[str, np.ndarray]:
    """Velocity-gradient statistics time series over a uniform catalog.

    The intermittency-development plot: derivative skewness/flatness(t),
    pseudo-dissipation(t), finite-difference enstrophy/dilatation mean
    squares(t), Taylor microscales(t) (ops/gradients.py; moments
    centered on device). Same async-prefetch + grouped single-fetch
    machinery as :func:`summary_series` — one packed vector per
    snapshot, host round-trip floor paid once per 16 snapshots. Beyond
    the reference (no gradient diagnostics; its series loops re-load
    files synchronously). Returns {"times": (nfiles,), <scalar>:
    (nfiles,), <table>: (nfiles, nd, nd) / (nfiles, nd) arrays}.
    """
    from fava_tpu.ops import gradients as grad_ops

    indices, paths = _series_paths(self, file_type, file_indices)
    fields = ["velx", "vely", "velz"]

    def make_vec(snap: Snapshot):
        ints = snap.scalars["integer"]
        reals = snap.runtime_parameters["real"]
        ndim = int(ints["dimensionality"])
        lengths = tuple(
            float(reals.get(f"{a}max", 1.0)) - float(reals.get(f"{a}min", 0.0))
            for a in "xyz"[:ndim]
        )
        vels = [_uniform_volume(snap, f"vel{a}", "gradient_series") for a in "xyz"[:ndim]]
        if any(v is None for v in vels):
            raise KeyError(f"{snap.path}: missing velocity components")
        if ndim < 3:
            vels = [v.reshape(v.shape[:ndim]) for v in vels]
        return grad_ops.gradient_stats_device(vels, lengths=lengths, boundary=boundary)

    times, names, table = _packed_stat_series(paths, fields, make_vec, prefetch_depth)
    result: Dict[str, np.ndarray] = {"times": times}
    if table is not None:
        # packed layout length identifies nd (48 entries in 3D, 22 in
        # 2D); anything else means the packed layout changed — fail
        # loudly rather than misassemble the report as 2D.
        if len(names) == len(grad_ops.packed_names(3)):
            nd = 3
        elif len(names) == len(grad_ops.packed_names(2)):
            nd = 2
        else:
            raise RuntimeError(
                f"gradient_series: packed vector length {len(names)} matches "
                f"neither the 3D ({len(grad_ops.packed_names(3))}) nor the 2D "
                f"({len(grad_ops.packed_names(2))}) layout"
            )
        reports = [grad_ops.assemble_gradient_stats(row, nd) for row in table]
        for key in reports[0]:
            result[key] = np.stack([np.asarray(r[key]) for r in reports])
    return result
