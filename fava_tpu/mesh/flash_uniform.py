"""FLASH uniform-grid mesh (single-block ``hdf5_uniform_`` files).

JAX rebuild of the reference FlashUniform
(reference: fava/mesh/FLASH/FlashUniform.py:26-458): a slimmer loader
(no gid/node-type/processor reads) plus the uniform-grid analyses —
kinetic-energy spectra (pod-sharded FFT), fractal dimension, structure
functions, and mass sums — all dispatching to jitted device kernels.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import TYPE_CHECKING, Any, Dict, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from fava_tpu.io import flash_file
from fava_tpu.mesh.flash_amr import FLASH
from fava_tpu.ops import volume as volume_ops
from fava_tpu.models.model import Model
from fava_tpu.ops import fractal as fractal_ops
from fava_tpu.ops import spectra as spectra_ops
from fava_tpu.ops import structure as structure_ops
from fava_tpu.parallel import runtime
from fava_tpu.utils import timer

if TYPE_CHECKING:
    import h5py

logger = logging.getLogger(__name__)


@Model.register_mesh()
class FlashUniform(FLASH):
    """Uniform-grid FLASH mesh; field data is a single 3D volume in device memory."""

    def __init__(self, filename: Optional[str | Path] = None, *args, **kwargs) -> None:
        super().__init__(filename, *args, **kwargs)

    @classmethod
    def is_this_your_mesh(cls, filename: str | Path, *args, **kwargs) -> bool:
        return "hdf5_uniform_" in str(filename)

    @classmethod
    def from_arrays(
        cls,
        fields: Dict[str, np.ndarray],
        domain_bounds: Optional[np.ndarray] = None,
        time: float = 0.0,
    ) -> "FlashUniform":
        """In-memory uniform mesh from plain arrays — no FLASH file.

        Every uniform-grid analysis (spectra, summary, correlations,
        PDFs, projections, SGS flux, ...) works on the result; use
        ``fava_tpu.from_arrays`` for a Model-level handle with the
        registered analysis methods. Beyond the reference, which can
        only read its own HDF5 files: this is the adoption path for
        data from any other code. ``fields`` maps FLASH-style names
        (dens/velx/vely/velz/pres/...) to same-shaped 1D/2D/3D arrays;
        ``domain_bounds`` is (ndim, 2) physical bounds (unit box
        default). File-backed features (streamed=True paths, lazy
        reads, writers) are unavailable — everything is resident.
        """
        shapes = {tuple(int(s) for s in np.shape(v)) for v in fields.values()}
        if not fields or len(shapes) != 1:
            raise ValueError(f"fields must share one shape, got {sorted(shapes)}")
        shape = shapes.pop()
        nd = len(shape)
        if nd not in (1, 2, 3):
            raise ValueError(f"fields must be 1D/2D/3D, got {nd}D")
        full = shape + (1,) * (3 - nd)
        b = np.asarray(
            domain_bounds if domain_bounds is not None else [[0.0, 1.0]] * nd,
            dtype=np.float64,
        )
        if b.shape != (nd, 2):
            raise ValueError(f"domain_bounds must be ({nd}, 2), got {b.shape}")
        bounds3 = np.concatenate([b, np.tile([[0.0, 1.0]], (3 - nd, 1))])

        mesh = cls(None)
        mesh.scalars = {
            "integer": {
                "dimensionality": nd,
                "nxb": full[0],
                "nyb": full[1],
                "nzb": full[2],
                "total blocks": 1,
            },
            "real": {"time": float(time)},
            "string": {"geometry": "cartesian"},
            "logical": {},
        }
        mesh.runtime_parameters = {
            "integer": {"nblockx": 1, "nblocky": 1, "nblockz": 1},
            "real": {
                f"{a}{mm}": float(bounds3[i, j])
                for i, a in enumerate("xyz")
                for j, mm in enumerate(("min", "max"))
            },
            "string": {},
            "logical": {},
        }
        mesh._set_integers()
        mesh._set_reals()
        mesh.fields = list(fields)
        mesh.block_bounds = bounds3[None]
        mesh.node_type = np.ones(1, dtype=np.int64)
        mesh.refine_level = np.ones(1, dtype=np.int64)
        mesh.coordinates = 0.5 * bounds3.sum(axis=1)[None]
        mesh._data = {}
        from fava_tpu.utils import compute_dtype

        for name, v in fields.items():
            host = np.ascontiguousarray(np.asarray(v, dtype=compute_dtype()).reshape(full))
            sharding = runtime.volume_sharding(ndim=3)
            if sharding is not None and full[0] % runtime.space_axis_size() == 0:
                mesh._data[name] = jax.device_put(host, sharding)
            else:
                mesh._data[name] = jax.device_put(host)
        mesh._loaded = True
        return mesh

    def load(self) -> None:
        """Metadata-only load (reference: FlashUniform.py:37-83)."""
        import h5py

        if self._filename is None or not self._filename.is_file():
            # Fail fast like the reference (whose h5py.File open raises
            # OSError); silently returning left a half-initialized mesh
            # that crashed with AttributeError far from the cause.
            raise FileNotFoundError(f"FLASH file does not exist: {self._filename}")

        self._data = {}
        self._delete_cached_properties()

        with h5py.File(self._filename, "r") as f:
            self.scalars = flash_file.read_scalars(f)
            self.runtime_parameters = flash_file.read_runtime_parameters(f)
            self._set_integers()
            self._set_reals()
            self.fields = flash_file.read_unknown_names(f)
            meta = flash_file.read_block_metadata(f)
            self.coordinates = meta.get("coordinates")
            self.block_size = meta.get("block size")
            self.block_bounds = meta.get("bounding box")
            self.refine_level = meta.get("refine level")
            self.node_type = meta.get("node type", np.ones(self.nblocks, dtype=np.int64))
            self.gid = meta.get("gid")
            self.which_child = meta.get("which child")
            self.processors = meta.get("processor number")
            self.bflags = meta.get("bflags")

        self._loaded = True

    def _read_field(self, handle: h5py.File, name: str) -> None:
        from fava_tpu.utils import compute_dtype

        host = flash_file.read_field(handle, name, dtype=compute_dtype())
        # Uniform files hold one block; store the bare 3D volume,
        # slab-sharded over the device mesh when one is active (and the
        # slab axis divides evenly — replicate otherwise).
        if host.ndim == 4 and host.shape[0] == 1:
            host = host[0]
        sharding = runtime.volume_sharding(ndim=host.ndim)
        if sharding is not None and host.shape[0] % runtime.space_axis_size() == 0:
            self._data[name] = jax.device_put(host, sharding)
        else:
            self._data[name] = jax.device_put(host)

    def _volume(self, name: str) -> jax.Array:
        d = self.data(name)
        if d is None:
            raise KeyError(name)
        if d.ndim == 4:
            d = d[0]
        return d

    # ------------------------------------------------------------------
    @timer
    def kinetic_energy_spectra(self) -> Dict[str, np.ndarray]:
        """KE spectra (reference: FlashUniform.py:229-304), sharded FFT."""
        vels = [self._volume(f"vel{a}") for a in "xyz"[: self.ndim]]
        return spectra_ops.kinetic_energy_spectra(self._volume("dens"), vels, ndim=self.ndim)

    @timer
    def scalar_spectra(self, field: str) -> Dict[str, np.ndarray]:
        """Power spectrum of one scalar field (density/flame/...).

        Beyond the reference (KE-only): same transform, binning
        convention, and integral factor as the KE spectra, so slopes
        compare directly."""
        return {field: spectra_ops.scalar_spectrum(self._volume(field), ndim=self.ndim)}

    def _vel_volumes(self):
        """In-plane velocity volumes, singleton trailing axes squeezed
        (2D datasets carry (nx, ny, 1) volumes and 2 components)."""
        nd = self.ndim
        if nd not in (2, 3):
            raise ValueError("spectral velocity diagnostics require a 2D or 3D dataset")
        vols = [self._volume(f"vel{a}") for a in "xyz"[:nd]]
        if nd < 3:
            squeezed = []
            for v in vols:
                if not all(s == 1 for s in v.shape[nd:]):
                    # Named error, not an assert (strips under -O and
                    # the reshape below then dies with a cryptic
                    # element-count mismatch): file data contradicting
                    # its own dimensionality metadata.
                    raise ValueError(
                        f"dataset claims {nd}D but a velocity volume has "
                        f"non-singleton trailing axes: {tuple(v.shape)}"
                    )
                squeezed.append(v.reshape(v.shape[:nd]))
            vols = squeezed
        return vols

    def _scalar_volume(self, name: str) -> jax.Array:
        """Scalar field volume squeezed to ``ndim`` axes (2D datasets
        carry (nx, ny, 1) volumes): scalar companions (dens/pres/gamc/
        progress variables) must match the squeezed velocity shape —
        an unsqueezed (nx, ny, 1) alongside (nx, ny) velocities would
        silently broadcast into a bogus 3D volume downstream."""
        v = self._volume(name)
        nd = self.ndim
        if v.ndim > nd:
            if not all(s == 1 for s in v.shape[nd:]):
                raise ValueError(
                    f"dataset claims {nd}D but field {name!r} has "
                    f"non-singleton trailing axes: {tuple(v.shape)}"
                )
            v = v.reshape(v.shape[:nd])
        return v

    def _domain_lengths(self):
        b = np.asarray(self.domain_bounds, dtype=np.float64)
        return tuple(float(b[i, 1] - b[i, 0]) for i in range(self.ndim))

    def _streamed_loader(self, check_fields: bool = False):
        """HDF5 x-slab loader for the out-of-core paths (one shared
        definition for flagship_analysis / turbulence_summary /
        velocity_correlations). ``check_fields`` raises KeyError for
        fields absent from this file (the streamed summary's gamc
        fallback relies on it)."""
        from fava_tpu.utils import compute_dtype

        if self._filename is None:
            raise ValueError(
                "streamed paths need a file-backed mesh; from_arrays data "
                "is fully resident — use the in-core analyses"
            )

        def loader(name: str, x0: int, x1: int) -> np.ndarray:
            import h5py

            import h5py

            if check_fields and name not in self.fields:
                raise KeyError(name)
            with h5py.File(self._filename, "r") as f:
                return flash_file.read_field_slab(f, name, x0, x1, dtype=compute_dtype())

        return loader

    @staticmethod
    def _largest_divisor(n: int, target) -> int:
        # Largest divisor of n NOT EXCEEDING the request: the
        # slab/chunk knobs exist to shrink memory, so never round up
        # past what the caller asked for.
        target = max(1, min(int(target or 64), n))
        return next(c for c in range(target, 0, -1) if n % c == 0)

    @timer
    def helmholtz_decomposition(self) -> Dict[str, Dict[str, np.ndarray]]:
        """Solenoidal/compressive velocity split (beyond the reference).

        Spectral projection on the physical wavenumber grid of this
        domain; forward + inverse FFTs (ops/velocity.py).
        """
        from fava_tpu.ops import velocity as vel_ops

        out = vel_ops.helmholtz_decompose(*self._vel_volumes(), lengths=self._domain_lengths())
        return {
            part: {name: np.asarray(v) for name, v in comps.items()}
            for part, comps in out.items()
        }

    @timer
    def vorticity(self) -> Dict[str, np.ndarray]:
        """Vorticity via spectral differentiation (2D: the scalar
        out-of-plane component only)."""
        from fava_tpu.ops import velocity as vel_ops

        out = vel_ops.vorticity(*self._vel_volumes(), lengths=self._domain_lengths())
        if self.ndim == 2:
            return {"vortz": np.asarray(out)}
        return {k: np.asarray(v) for k, v in zip(("vortx", "vorty", "vortz"), out)}

    @timer
    def dilatation(self) -> Dict[str, np.ndarray]:
        """Dilatation (velocity divergence) via spectral differentiation."""
        from fava_tpu.ops import velocity as vel_ops

        d = vel_ops.dilatation(*self._vel_volumes(), lengths=self._domain_lengths())
        return {"dilatation": np.asarray(d)}

    @timer
    def enstrophy_spectra(self) -> Dict[str, np.ndarray]:
        """Shell-binned enstrophy spectrum (KE-spectra conventions)."""
        from fava_tpu.ops import velocity as vel_ops

        return vel_ops.enstrophy_spectrum(*self._vel_volumes(), lengths=self._domain_lengths())

    @timer
    def helicity_spectra(self) -> Dict[str, np.ndarray]:
        """Shell-binned (signed) helicity spectrum (3D only: helicity
        vanishes identically for in-plane 2D flows)."""
        from fava_tpu.ops import velocity as vel_ops

        if self.ndim != 3:
            raise ValueError("helicity vanishes identically in 2D flows (3D datasets only)")
        return vel_ops.helicity_spectrum(*self._vel_volumes(), lengths=self._domain_lengths())

    @timer
    def velocity_gradient_statistics(
        self,
        boundary: str = "periodic",
        streamed: bool = False,
        slab_rows: Optional[int] = None,
        wire_dtype=None,
        prefetch_depth: int = 2,
    ) -> Dict[str, Any]:
        """Velocity-gradient tensor statistics (beyond the reference):
        central-difference g_ij fluctuation moments to fourth order —
        derivative skewness/flatness, pseudo-dissipation, FD enstrophy
        and dilatation mean squares, Taylor microscales — in ONE device
        pass with a single packed fetch (ops/gradients.py).
        ``boundary="interior"`` drops the periodic wrap for windowed
        uniform extracts (e.g. the pipeline's flame windows).
        ``streamed=True`` takes the out-of-core halo-slab path for 3D
        volumes beyond one device's memory (periodic only;
        ops/outofcore.streamed_gradient_stats)."""
        from fava_tpu.ops import gradients as grad_ops

        if not streamed:
            self._reject_stream_knobs(
                slab_rows=(slab_rows, None),
                wire_dtype=(wire_dtype, None),
                prefetch_depth=(prefetch_depth, 2),
            )
        if streamed:
            import jax.numpy as jnp

            from fava_tpu.ops import outofcore
            from fava_tpu.utils import compute_dtype

            if self.ndim != 3:
                raise ValueError("streamed gradient statistics require a 3D dataset")
            if boundary != "periodic":
                raise ValueError(
                    "streamed gradient statistics are periodic-only (windowed "
                    "interior extracts fit in core by construction)"
                )
            shape = tuple(int(n) for n in (self.nxb, self.nyb, self.nzb))
            return outofcore.streamed_gradient_stats(
                self._streamed_loader(),
                shape,
                slab_rows=self._largest_divisor(shape[0], slab_rows),
                dtype=jnp.dtype(compute_dtype()),
                lengths=self._domain_lengths(),
                wire_dtype=wire_dtype,
                prefetch_depth=prefetch_depth,
            )

        return grad_ops.velocity_gradient_statistics(
            *self._vel_volumes(),
            lengths=self._domain_lengths(),
            boundary=boundary,
        )

    @timer
    def gradient_invariant_pdfs(
        self,
        nbins=(100, 100),
        qr_range: float = 8.0,
        boundary: str = "periodic",
    ) -> Dict[str, Any]:
        """Joint PDF of the velocity-gradient invariants (Q, R) — the
        Chong-Perry-Cantwell topology teardrop (beyond the reference).
        Full compressible invariant definitions, axes normalized by
        Q_w = <omega^2>/4, exact counts through the fused pdf2d kernel
        (ops/gradients.gradient_invariant_pdfs). 3D datasets only."""
        from fava_tpu.ops import gradients as grad_ops

        return grad_ops.gradient_invariant_pdfs(
            *self._vel_volumes(),
            lengths=self._domain_lengths(),
            nbins=nbins,
            qr_range=qr_range,
            boundary=boundary,
        )

    @timer
    def decomposed_kinetic_energy_spectra(
        self, weighted: bool = False
    ) -> Dict[str, np.ndarray]:
        """Solenoidal/compressive split of the KE spectrum (beyond the
        reference): the Helmholtz projection applied in k-space, so
        total == solenoidal + compressive exactly shell by shell.
        ``weighted=True`` transforms the Kida-Orszag variable
        sqrt(rho) u so the spectra decompose the true compressible KE
        budget (ops/velocity.decomposed_ke_spectra)."""
        from fava_tpu.ops import velocity as vel_ops

        return vel_ops.decomposed_ke_spectra(
            *self._vel_volumes(),
            dens=self._scalar_volume("dens") if weighted else None,
            lengths=self._domain_lengths(),
        )

    @staticmethod
    def _reject_stream_knobs(**knobs):
        """Streaming knobs passed without streamed=True would be
        silently ignored by the in-core path (ADVICE r3 failure mode:
        a user asking for the bf16 wire must not silently get the
        in-core full-precision run instead)."""
        ignored = sorted(
            k
            for k, (v, default) in knobs.items()
            if v is not None and v != default
        )
        if ignored:
            raise TypeError(
                f"{ignored} only apply to the streamed out-of-core path; "
                "pass streamed=True (these knobs have no effect in-core)"
            )

    @timer
    def turbulence_summary(
        self,
        gamma: float = 5.0 / 3.0,
        streamed: bool = False,
        slab_rows: Optional[int] = None,
        chunk_rows: Optional[int] = None,
        wire_dtype=None,
        prefetch_depth: int = 2,
    ) -> Dict[str, float]:
        """One-call scalar turbulence report (beyond the reference):
        u_rms/KE, integral + Taylor scales from spectral moments,
        exact solenoidal/compressive energy fractions, vorticity and
        dilatation rms, log-density moments — plus Mach statistics when
        this file carries ``pres`` (per-cell ``gamc`` is used over the
        scalar ``gamma`` when present). One jit over three forward
        transforms (ops/velocity.turbulence_summary); ``streamed=True``
        takes the out-of-core x-slab path for 3D volumes beyond one
        device's memory (ops/outofcore.streamed_turbulence_summary)."""
        from fava_tpu.ops import velocity as vel_ops

        if not streamed:
            self._reject_stream_knobs(
                slab_rows=(slab_rows, None),
                chunk_rows=(chunk_rows, None),
                wire_dtype=(wire_dtype, None),
                prefetch_depth=(prefetch_depth, 2),
            )
        if streamed:
            import jax.numpy as jnp

            from fava_tpu.ops import outofcore
            from fava_tpu.utils import compute_dtype

            if self.ndim != 3:
                raise ValueError("streamed turbulence_summary requires a 3D dataset")
            shape = tuple(int(n) for n in (self.nxb, self.nyb, self.nzb))
            return outofcore.streamed_turbulence_summary(
                self._streamed_loader(check_fields=True),
                shape,
                slab_rows=self._largest_divisor(shape[0], slab_rows),
                chunk_rows=self._largest_divisor(shape[0], chunk_rows),
                dtype=jnp.dtype(compute_dtype()),
                gamma=gamma,
                lengths=self._domain_lengths(),
                with_mach="pres" in self.fields,
                wire_dtype=wire_dtype,
                prefetch_depth=prefetch_depth,
            )

        def opt(name):
            if self.data(name) is None:
                return None
            return self._scalar_volume(name)

        pres = opt("pres")
        gamc = opt("gamc") if pres is not None else None
        return vel_ops.turbulence_summary(
            *self._vel_volumes(),
            dens=opt("dens"),
            pres=pres,
            gamma=gamc if gamc is not None else gamma,
            lengths=self._domain_lengths(),
        )

    @timer
    def flame_surface(self, field: str = "flam", axis: int = 0) -> Dict[str, np.ndarray]:
        """Flame surface density of a progress variable (beyond the
        reference): coarea-formula front area, wrinkling factor vs the
        axis-normal cross-section, slab-resolved sigma(x) profile, and
        gradient flame thickness (ops/flame.flame_surface). Central
        differences — correct for the non-periodic flame axis."""
        from fava_tpu.ops import flame as flame_ops

        vol = self._scalar_volume(field)
        nd = self.ndim
        lengths = self._domain_lengths()
        deltas = [lengths[a] / vol.shape[a] for a in range(nd)]
        return flame_ops.flame_surface(vol, deltas, axis=axis)

    @timer
    def anisotropic_kinetic_energy_spectra(self, axis: int = 0) -> Dict[str, np.ndarray]:
        """Axis-resolved KE spectra relative to a preferred direction
        (default x — the RT flame-propagation axis the reference's flame
        window marches): parallel E(k_par) and perpendicular E(k_perp)
        sums, each split into axial/transverse velocity-component
        contributions, energy-exact under Parseval
        (ops/velocity.anisotropic_ke_spectra)."""
        from fava_tpu.ops import velocity as vel_ops

        return vel_ops.anisotropic_ke_spectra(
            *self._vel_volumes(), axis=axis, lengths=self._domain_lengths()
        )

    @timer
    def transfer_spectra(self, dealias: bool = False) -> Dict[str, np.ndarray]:
        """Nonlinear kinetic-energy transfer T(k) + flux Π(k) (shell
        sums — they telescope, unlike the mean-based power spectra;
        ops/velocity.transfer_spectrum)."""
        from fava_tpu.ops import velocity as vel_ops

        return vel_ops.transfer_spectrum(
            *self._vel_volumes(), lengths=self._domain_lengths(), dealias=dealias
        )

    @timer
    def filtered_kinetic_energy_flux(
        self,
        cutoffs: Sequence[float] = (4.0, 8.0, 16.0),
        kernel: str = "gaussian",
        with_pressure: bool = False,
    ) -> Dict[str, np.ndarray]:
        """Favre-filtered SGS kinetic-energy flux sweep Pi_l (beyond
        the reference): mean/RMS deformation work across a list of
        filter cutoffs, density-weighted, plus the baropycnal work when
        ``with_pressure`` and a ``pres`` field is on file
        (ops/coarse_grain.py — one scan dispatch for the whole sweep).
        """
        from fava_tpu.ops import coarse_grain as cg_ops

        pres = None
        if with_pressure:
            if "pres" not in self.fields:
                raise KeyError(
                    "with_pressure=True but this file carries no 'pres' field"
                )
            pres = self._scalar_volume("pres")
        return cg_ops.filtered_ke_flux(
            *self._vel_volumes(),
            dens=self._scalar_volume("dens"),
            pres=pres,
            cutoffs=tuple(float(k) for k in cutoffs),
            kernel=kernel,
            lengths=self._domain_lengths(),
        )

    @timer
    def projection(
        self, field: str = "dens", axis: int = 0, weight: Optional[str] = None
    ) -> Dict[str, Any]:
        """Line-of-sight projection map integral(field dl) along
        ``axis`` (column density for field="dens"); ``weight`` gives
        the w-weighted line average (ops/projection.project_uniform;
        beyond the reference). Map is over the kept axes with
        cell-center coordinates (2D datasets give a 1D column
        profile: "map" + "coord1")."""
        from fava_tpu.ops import projection as proj_ops

        vol = self._scalar_volume(field)
        nd = vol.ndim
        lengths = self._domain_lengths()
        deltas = [lengths[a] / vol.shape[a] for a in range(nd)]
        w = self._scalar_volume(weight) if weight is not None else None
        m = proj_ops.project_uniform(vol, deltas, axis=axis, weight=w)
        b = np.asarray(self.domain_bounds, dtype=np.float64)
        keep = [a for a in range(nd) if a != axis]
        out: Dict[str, Any] = {"map": m}
        for i, a in enumerate(keep, start=1):
            out[f"coord{i}"] = b[a, 0] + (np.arange(vol.shape[a]) + 0.5) * deltas[a]
        return out

    @timer
    def two_point_correlation(
        self,
        field: str = "dens",
        streamed: bool = False,
        slab_rows: Optional[int] = None,
        chunk_rows: Optional[int] = None,
        wire_dtype=None,
        prefetch_depth: int = 2,
        **kwargs,
    ) -> Dict[str, Any]:
        """Scalar two-point autocorrelation R(r) = <f'(x)f'(x+r)>/var:
        shell-averaged isotropic curve + per-axis lines with integral
        length scales (ops/twopoint.two_point_correlation; beyond the
        reference — its auto_correlations are TIME correlations).
        ``streamed=True`` takes the out-of-core path for beyond-memory 3D
        volumes: per-axis lines + integral scales only (the shell curve
        needs the full correlation volume;
        ops/outofcore.streamed_two_point_lines)."""
        from fava_tpu.ops import twopoint as tp_ops

        if not streamed:
            self._reject_stream_knobs(
                slab_rows=(slab_rows, None),
                chunk_rows=(chunk_rows, None),
                wire_dtype=(wire_dtype, None),
                prefetch_depth=(prefetch_depth, 2),
            )
        if streamed:
            import jax.numpy as jnp

            from fava_tpu.ops import outofcore
            from fava_tpu.utils import compute_dtype

            if kwargs:
                # silently dropping e.g. nbins= would return a result
                # that ignored the request (ADVICE r3): the streamed
                # path computes axis lines only — no shell-curve knobs
                raise TypeError(
                    f"{sorted(kwargs)} not supported with streamed=True: the "
                    "shell curve (and its nbins) needs the full correlation "
                    "volume; the streamed path returns per-axis lines only"
                )
            if self.ndim != 3:
                raise ValueError("streamed two_point_correlation requires a 3D dataset")
            shape = tuple(int(n) for n in (self.nxb, self.nyb, self.nzb))
            return outofcore.streamed_two_point_lines(
                self._streamed_loader(),
                shape,
                field,
                slab_rows=self._largest_divisor(shape[0], slab_rows),
                chunk_rows=self._largest_divisor(shape[0], chunk_rows),
                dtype=jnp.dtype(compute_dtype()),
                lengths=self._domain_lengths(),
                wire_dtype=wire_dtype,
                prefetch_depth=prefetch_depth,
            )

        return tp_ops.two_point_correlation(
            self._scalar_volume(field), lengths=self._domain_lengths(), **kwargs
        )

    @timer
    def velocity_correlations(
        self,
        streamed: bool = False,
        slab_rows: Optional[int] = None,
        chunk_rows: Optional[int] = None,
        wire_dtype=None,
        prefetch_depth: int = 2,
    ) -> Dict[str, Any]:
        """Karman-Howarth longitudinal f(r) / transverse g(r) velocity
        correlations per axis with L11/L22 integral scales and the
        isotropy ratio L11/(2 L22) (ops/twopoint.velocity_correlations;
        beyond the reference). ``streamed=True`` takes the out-of-core
        x-slab path for 3D volumes beyond one device's memory
        (ops/outofcore.streamed_velocity_correlations)."""
        from fava_tpu.ops import twopoint as tp_ops

        if not streamed:
            self._reject_stream_knobs(
                slab_rows=(slab_rows, None),
                chunk_rows=(chunk_rows, None),
                wire_dtype=(wire_dtype, None),
                prefetch_depth=(prefetch_depth, 2),
            )
        if streamed:
            import jax.numpy as jnp

            from fava_tpu.ops import outofcore
            from fava_tpu.utils import compute_dtype

            if self.ndim != 3:
                raise ValueError("streamed velocity_correlations requires a 3D dataset")
            shape = tuple(int(n) for n in (self.nxb, self.nyb, self.nzb))
            return outofcore.streamed_velocity_correlations(
                self._streamed_loader(),
                shape,
                slab_rows=self._largest_divisor(shape[0], slab_rows),
                chunk_rows=self._largest_divisor(shape[0], chunk_rows),
                dtype=jnp.dtype(compute_dtype()),
                lengths=self._domain_lengths(),
                wire_dtype=wire_dtype,
                prefetch_depth=prefetch_depth,
            )

        return tp_ops.velocity_correlations(
            *self._vel_volumes(), lengths=self._domain_lengths()
        )

    @timer
    def fractal_dimension(self, field: str, contours=0.5) -> Dict[str, Any]:
        """Box-counting dimension (reference: FlashUniform.py:85-227)."""
        result = fractal_ops.fractal_dimension(self._volume(field), contours)
        return {field: result}

    @timer
    def structure_functions(
        self,
        num_seps: int = 100,
        num_points: int = 10000,
        sep_bounds: Optional[Sequence[float]] = None,
        log_scale: bool = True,
        anisotropic: bool = False,
        seed: int = 0,
        resample_per_order: bool = True,
        **kwargs,
    ) -> Dict[str, Any]:
        """Velocity structure functions (reference: FlashUniform.py:306-447).

        Accepts the reference settings-file spelling ``anistropic`` too.
        ``sep_bounds`` defaults to the resolvable separation range (see
        ops.structure.structure_functions). ``resample_per_order=False``
        evaluates all ten orders on one shared pair draw (~10x cheaper;
        see ops.structure.structure_functions).
        """
        if "anistropic" in kwargs:
            anisotropic = kwargs.pop("anistropic")
        if kwargs:
            raise TypeError(
                f"structure_functions got unexpected keyword arguments {sorted(kwargs)}"
            )
        vels = [self._volume(f"vel{a}") for a in "xyz"[: self.ndim]]
        return structure_ops.structure_functions(
            vels,
            domain_bounds=self.domain_bounds,
            num_seps=num_seps,
            num_points=num_points,
            sep_bounds=tuple(sep_bounds) if sep_bounds is not None else None,
            log_scale=log_scale,
            anisotropic=anisotropic,
            seed=seed,
            resample_per_order=resample_per_order,
        )

    @timer
    def structure_function_exponents(
        self,
        vsfs: Optional[Dict[str, Any]] = None,
        reference_order: int = 3,
        fit_range: Optional[Sequence[float]] = None,
        ess: bool = True,
        **sf_kwargs,
    ) -> Dict[str, Any]:
        """Intermittency scaling exponents zeta_p, ESS by default
        (beyond the reference). Pass a precomputed
        :meth:`structure_functions` result as ``vsfs`` to reuse it;
        otherwise one is computed here with ``**sf_kwargs``
        (ops.structure.scaling_exponents has the fit conventions)."""
        if vsfs is None:
            vsfs = self.structure_functions(**sf_kwargs)
        return structure_ops.scaling_exponents(
            vsfs, reference_order=reference_order, fit_range=fit_range, ess=ess
        )

    @timer
    def velocity_increment_pdfs(
        self,
        num_seps: int = 8,
        num_points: int = 65536,
        sep_bounds: Optional[Sequence[float]] = None,
        log_scale: bool = True,
        nbins: int = 101,
        nsigma: float = 10.0,
        anisotropic: bool = False,
        seed: int = 0,
    ) -> Dict[str, Any]:
        """PDFs of signed velocity increments vs separation — the
        intermittency picture behind :meth:`structure_functions`
        (beyond the reference; conventions in
        ops.structure.velocity_increment_pdfs)."""
        vels = [self._volume(f"vel{a}") for a in "xyz"[: self.ndim]]
        return structure_ops.velocity_increment_pdfs(
            vels,
            domain_bounds=self.domain_bounds,
            num_seps=num_seps,
            num_points=num_points,
            sep_bounds=tuple(sep_bounds) if sep_bounds is not None else None,
            log_scale=log_scale,
            nbins=nbins,
            nsigma=nsigma,
            anisotropic=anisotropic,
            seed=seed,
        )

    @timer
    def flagship_analysis(
        self,
        streamed: Optional[bool] = None,
        slab_rows: Optional[int] = None,
        chunk_rows: Optional[int] = None,
        wire_dtype=None,
        prefetch_depth: int = 2,
    ) -> Dict[str, np.ndarray]:
        """Fused spectra + Reynolds/Favre x-profiles in one program.

        The headline BASELINE workload as a public API: one jitted step
        (flagship.uniform_analysis_step) when the volume fits device memory —
        sharded over an active device mesh — or the streamed
        out-of-core path (ops/outofcore.py) when it does not
        (``streamed=None`` auto-detects against the device memory
        budget, ``parallel.runtime.device_memory_bytes``).
        """
        import jax.numpy as jnp

        from fava_tpu import flagship
        from fava_tpu.ops import outofcore

        shape = tuple(int(n) for n in (self.nxb, self.nyb, self.nzb))
        if self.ndim != 3:
            # Same up-front guard as the sibling streamed methods: the
            # in-core path would otherwise die late with KeyError('velz')
            # and the streamed path would run on a degenerate (nx, ny, 1).
            raise ValueError("flagship_analysis requires a 3D dataset")
        if streamed is False:
            # Explicit in-core request: streaming knobs would be
            # silently ignored. (streamed=None auto-resolves — knobs
            # are legitimate there in case the volume streams.)
            self._reject_stream_knobs(
                slab_rows=(slab_rows, None),
                chunk_rows=(chunk_rows, None),
                wire_dtype=(wire_dtype, None),
                prefetch_depth=(prefetch_depth, 2),
            )
        if streamed is None:
            from fava_tpu.utils import compute_dtype

            ntot = int(np.prod(shape))
            # 4 resident fields + 3 half-spectra + working set, in the
            # ACTIVE compute dtype (f64 under x64 doubles every term —
            # a hardcoded 4/8 bytes under-estimated by 2x and the
            # in-core dispatch OOMed instead of streaming).
            item = jnp.dtype(compute_dtype()).itemsize
            need = 4 * item * ntot + 3 * 2 * item * ntot // 2 + 2 * item * ntot
            streamed = need > 0.9 * runtime.device_memory_bytes()

        if streamed:
            from fava_tpu.utils import compute_dtype

            return outofcore.streamed_uniform_analysis(
                self._streamed_loader(),
                shape,
                slab_rows=self._largest_divisor(shape[0], slab_rows),
                chunk_rows=self._largest_divisor(shape[0], chunk_rows),
                dtype=jnp.dtype(compute_dtype()),
                wire_dtype=wire_dtype,
                prefetch_depth=prefetch_depth,
            )

        dmesh = runtime.get_mesh()
        vols = [self._volume(name) for name in ("dens", "velx", "vely", "velz")]
        out = flagship.jitted_analysis_step(dmesh)(*vols)
        return {k: np.asarray(v) for k, v in out.items()}

    def mass_fraction(self, masks: Optional[Dict[str, Any]] = None) -> Dict[str, float]:
        """Total + per-mask mass (reference: FlashUniform.py:449-458).

        One definition (ops/volume.mass_sum) — the inline copy here had
        already dropped the accum-dtype cast the shared helper applies.
        """
        return volume_ops.mass_sum(self._volume("dens"), self.cell_volume_min, masks)

    def _uniform_pdf_weights(self, weight: Optional[str]):
        """Uniform-grid PDF weights: cells share one volume, so
        'volume' weighting is uniform (None); 'mass' weights by dens."""
        if weight in (None, "volume"):
            return None
        if weight == "mass":
            return self._scalar_volume("dens")
        raise ValueError(f"Unknown pdf weight {weight}")

    @timer
    def pdf1d(self, field: str, weight: Optional[str] = "volume", **kwargs):
        """Weighted 1D PDF of a field (declared-but-absent in the
        reference; AMR twin in flash_amr.py)."""
        return volume_ops.pdf1d(
            self._scalar_volume(field), weights=self._uniform_pdf_weights(weight), **kwargs
        )

    @timer
    def pdf2d(self, field1: str, field2: str, weight: Optional[str] = "volume", **kwargs):
        """Weighted joint PDF of two fields."""
        return volume_ops.pdf2d(
            self._scalar_volume(field1),
            self._scalar_volume(field2),
            weights=self._uniform_pdf_weights(weight),
            **kwargs,
        )

    @timer
    def binned_statistic(
        self, xfield: str, yfield: str, weight: Optional[str] = "volume", **kwargs
    ) -> Dict[str, Any]:
        """Per-bin count/mean/std of ``yfield`` conditioned on
        ``xfield`` — a device-side scipy.stats.binned_statistic (one
        fused dispatch; ops/volume.binned_statistic; AMR twin in
        flash_amr.py). Uniform cells share one volume, so
        weight="volume" is the exact unweighted path; "mass" weights
        by dens."""
        return volume_ops.binned_statistic(
            self._scalar_volume(xfield),
            self._scalar_volume(yfield),
            weights=self._uniform_pdf_weights(weight),
            **kwargs,
        )

    @timer
    def density_pdf(self, weight: Optional[str] = "volume", **kwargs) -> Dict[str, Any]:
        """Lognormality diagnostics of s = ln(rho/<rho>): weighted
        s-PDF, exact device moments (sigma_s, skewness, kurtosis), the
        lognormal residual |mean_s + sigma_s^2/2|, and the driving
        parameter b when ``mach`` is given (ops/volume.density_pdf;
        beyond the reference)."""
        return volume_ops.density_pdf(
            self._scalar_volume("dens"), weights=self._uniform_pdf_weights(weight), **kwargs
        )
