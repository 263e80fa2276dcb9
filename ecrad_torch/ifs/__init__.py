"""IFS adaptation layer (port of ``ecrad_tpu/ifs``): the parameterizations
the host model uses to derive ecRad inputs, plus the flat-array
``radiation_scheme`` wrapper.

Reference: ifs/ directory of the reference:
liquid_effective_radius.F90, ice_effective_radius.F90,
cloud_overlap_decorr_len.F90, satur.F90, cos_sza.F90,
yoe_spectral_planck.F90, radiation_scheme.F90.
"""

from ecrad_torch.ifs.parameterizations import (
    liquid_effective_radius, ice_effective_radius,
    cloud_overlap_decorr_len, satur, cos_solar_zenith_angle)
from ecrad_torch.ifs.spectral_planck import SpectralPlanck
from ecrad_torch.ifs.scheme import radiation_scheme

__all__ = [
    "liquid_effective_radius", "ice_effective_radius",
    "cloud_overlap_decorr_len", "satur", "cos_solar_zenith_angle",
    "SpectralPlanck", "radiation_scheme",
]
