"""Registered filtered (coarse-grained) SGS kinetic-energy flux:
forward to the active mesh.

Beyond the reference (which registers only kinetic_energy_spectra,
reference: fava/analysis/kinetic_energy_spectra.py): the Favre
scale-decomposition flux Pi_l — the filtered-equation counterpart of
the spectral transfer — computed with the package's FFTs
(ops/coarse_grain.py).
"""

from fava_tpu.models.model import Model


@Model.register_analysis(use_timer=True)
def filtered_kinetic_energy_flux(self, *args, **kwargs):
    return self.mesh.filtered_kinetic_energy_flux(*args, **kwargs)


@Model.register_analysis(use_timer=True)
def structure_function_exponents(self, *args, **kwargs):
    return self.mesh.structure_function_exponents(*args, **kwargs)
