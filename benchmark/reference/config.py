"""Configuration system.

Mirrors the reference's two-phase config design
(radiation/radiation_config.F90:163-655): a user-settable parameter set
(read from a Fortran namelist or constructed programmatically) followed by a
``consolidate`` step at setup time that derives file names, spectral sizes and
mapping tables.

Split (as in the JAX package, of which this is a copy):
  * :class:`Config` is a **frozen, hashable dataclass** of user parameters
    plus small derived integers.
  * All derived *array* state (k-distribution tables, cloud/aerosol LUTs,
    spectral mappings) lives in the tensors of ``interface.Tables``, built
    at setup time (see ecrad_torch.interface.setup_radiation).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Tuple



class Solver(enum.IntEnum):
    # radiation_config.F90:59-62
    CLOUDLESS = 0
    HOMOGENEOUS = 1
    MCICA = 2
    SPARTACUS = 3
    TRIPLECLOUDS = 4


class GasModel(enum.IntEnum):
    # radiation_config.F90:100-106
    MONOCHROMATIC = 0
    RRTMG = 1
    ECCKD = 2


class LiquidModel(enum.IntEnum):
    # radiation_config.F90:108-119
    MONOCHROMATIC = 0
    SOCRATES = 1
    SLINGO = 2
    JAHANGIR = 3
    NIELSEN = 4


class IceModel(enum.IntEnum):
    # radiation_config.F90:121-137
    MONOCHROMATIC = 0
    FU = 1
    BARAN = 2
    BARAN2016 = 3
    BARAN2017 = 4
    YI = 5


class PdfShape(enum.IntEnum):
    # radiation_config.F90:139-143
    LOGNORMAL = 0
    GAMMA = 1


class Overlap(enum.IntEnum):
    # radiation_cloud_cover.F90 (exported via radiation_config.F90:46-47)
    MAXIMUM_RANDOM = 0
    EXPONENTIAL_RANDOM = 1
    EXPONENTIAL = 2          # "Exp-Exp"


class Entrapment(enum.IntEnum):
    # radiation_config.F90:71-90
    ZERO = 0
    EDGE_ONLY = 1
    EXPLICIT = 2
    EXPLICIT_NON_FRACTAL = 3
    MAXIMUM = 4


@dataclasses.dataclass(frozen=True)
class Config:
    """User configuration + consolidated scalar metadata.

    Field names follow the reference namelist keys
    (radiation_config.F90:730-764) for drop-in namelist compatibility.
    """

    # --- actions
    do_sw: bool = True
    do_lw: bool = True
    do_sw_direct: bool = True
    do_clear: bool = True

    # --- gas model
    gas_model_sw: GasModel = GasModel.RRTMG
    gas_model_lw: GasModel = GasModel.RRTMG

    # --- solvers
    sw_solver: Solver = Solver.MCICA
    lw_solver: Solver = Solver.MCICA

    # --- particle optics models (RRTMG-band path)
    liquid_model: LiquidModel = LiquidModel.SOCRATES
    ice_model: IceModel = IceModel.BARAN
    use_general_cloud_optics: bool = True
    use_general_aerosol_optics: bool = True
    cloud_type_name: Tuple[str, ...] = ()
    use_thick_cloud_spectral_averaging: Tuple[bool, ...] = ()
    do_fu_lw_ice_optics_bug: bool = False

    # --- clouds
    cloud_fraction_threshold: float = 1.0e-6
    cloud_mixing_ratio_threshold: float = 1.0e-9
    overlap_scheme: Overlap = Overlap.EXPONENTIAL_RANDOM
    use_beta_overlap: bool = False
    use_vectorizable_generator: bool = False
    cloud_pdf_shape: PdfShape = PdfShape.GAMMA
    cloud_inhom_decorr_scaling: float = 0.5
    nregions: int = 3
    do_sw_delta_scaling_with_gases: bool = False

    # --- longwave scattering
    do_lw_cloud_scattering: bool = True
    do_lw_aerosol_scattering: bool = True

    # --- monochromatic model parameters
    mono_lw_wavelength: float = -1.0
    mono_lw_total_od: float = 0.0
    mono_sw_total_od: float = 0.0
    mono_sw_single_scattering_albedo: float = 0.999999
    mono_sw_asymmetry_factor: float = 0.86
    mono_lw_single_scattering_albedo: float = 0.538
    mono_lw_asymmetry_factor: float = 0.925

    # --- gas optical depth guards (radiation_config.F90:246-258)
    min_gas_od_lw: float = 1.0e-15
    min_gas_od_sw: float = 0.0
    max_gas_od_3d: float = 8.0
    max_cloud_od: float = 16.0

    # --- SPARTACUS / 3D
    do_3d_effects: bool = True
    do_3d_lw_multilayer_effects: bool = False
    do_lw_side_emissivity: bool = True
    sw_entrapment: Entrapment = Entrapment.EXPLICIT
    clear_to_thick_fraction: float = 0.0
    overhead_sun_factor: float = 0.0
    max_3d_transfer_rate: float = 10.0
    min_cloud_effective_size: float = 100.0
    overhang_factor: float = 0.0
    use_expm_everywhere: bool = False

    # --- aerosols
    use_aerosols: bool = False
    n_aerosol_types: int = 0
    i_aerosol_type_map: Tuple[int, ...] = ()
    # Name-based aerosol selection (resolved against the optics file's
    # metadata registry at setup, optics/aerosol_description.py;
    # reference: radiation_aerosol_optics_description.F90).  Entries
    # like "DD,bin=2,phobic"; non-empty overrides i_aerosol_type_map.
    aerosol_type_name: Tuple[str, ...] = ()
    # "CODE:model" preferences, e.g. "DD:Fouquart"
    aerosol_preferred_optical_model: Tuple[str, ...] = ()

    # --- surface mapping
    do_nearest_spectral_sw_albedo: bool = False
    do_nearest_spectral_lw_emiss: bool = False
    sw_albedo_wavelength_bound: Tuple[float, ...] = ()
    lw_emiss_wavelength_bound: Tuple[float, ...] = ()
    i_sw_albedo_index: Tuple[int, ...] = ()
    i_lw_emiss_index: Tuple[int, ...] = ()
    do_weighted_surface_mapping: bool = True

    # --- canopy
    do_canopy_fluxes_sw: bool = False
    do_canopy_fluxes_lw: bool = False
    use_canopy_full_spectrum_sw: bool = False
    use_canopy_full_spectrum_lw: bool = False
    do_canopy_gases_sw: bool = False
    do_canopy_gases_lw: bool = False

    # --- per-g-point cloud/aerosol/surface optics (ecCKD-era feature,
    # radiation_config.F90:504-507)
    do_cloud_aerosol_per_sw_g_point: bool = True
    do_cloud_aerosol_per_lw_g_point: bool = True

    # --- solar
    use_spectral_solar_scaling: bool = False
    use_spectral_solar_cycle: bool = False
    use_updated_solar_spectrum: bool = False

    # --- outputs
    do_save_radiative_properties: bool = False
    do_save_spectral_flux: bool = False
    do_save_gpoint_flux: bool = False
    do_surface_sw_spectral_flux: bool = True
    do_toa_spectral_flux: bool = False
    do_lw_derivatives: bool = False

    # --- verbosity
    iverbose: int = 1
    iverbosesetup: int = 2

    # --- files
    directory_name: str = "."
    ice_optics_override_file_name: str = ""
    liq_optics_override_file_name: str = ""
    aerosol_optics_override_file_name: str = ""
    gas_optics_sw_override_file_name: str = ""
    gas_optics_lw_override_file_name: str = ""
    ssi_override_file_name: str = ""
    cloud_pdf_override_file_name: str = ""

    # --- COMPUTED at consolidate() (scalars only; arrays live in Tables)
    is_consolidated: bool = False
    n_g_sw: int = 0
    n_g_lw: int = 0
    n_bands_sw: int = 0
    n_bands_lw: int = 0
    n_canopy_bands_sw: int = 1
    n_canopy_bands_lw: int = 1
    n_albedo_intervals: int = 0
    n_emiss_intervals: int = 0
    n_cloud_types: int = 2
    is_homogeneous: bool = False
    do_clouds: bool = True

    # numerical precision of the jitted compute path ("float32"/"float64")
    dtype_name: str = "float32"

    # ----- convenience ---------------------------------------------------

    @property
    def i_solver_sw(self) -> Solver:
        return self.sw_solver

    @property
    def i_solver_lw(self) -> Solver:
        return self.lw_solver

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    @property
    def do_lw_scattering(self) -> bool:
        """Any longwave scattering at all? (controls LW solver path)"""
        return self.do_lw_cloud_scattering or self.do_lw_aerosol_scattering
