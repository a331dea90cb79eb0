"""Registered flagship_analysis: the fused spectra + Reynolds/Favre
profile step on a uniform mesh (no reference equivalent — BASELINE
headline workload as a model-level analysis, with automatic streamed
out-of-core fallback for volumes beyond device memory)."""

from fava_tpu.models.model import Model


@Model.register_analysis(use_timer=True)
def flagship_analysis(self, *args, **kwargs):
    return self.mesh.flagship_analysis(*args, **kwargs)
