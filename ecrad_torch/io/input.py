"""Driver input reader: NetCDF → containers.

Reference: driver/ecrad_driver_read_input.F90:21-622 (variable-name
conventions, unit handling, overlap-parameter derivation) and
driver/ecrad_driver_config.F90:32-133 (the &radiation_driver namelist).
Host-side numpy; callers convert arrays to torch tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ecrad_torch import constants
from ecrad_torch.containers import Thermodynamics
from ecrad_torch.io.netcdf import NcFile
from ecrad_torch.namelist import read_namelist_file


@dataclasses.dataclass
class DriverConfig:
    """&radiation_driver namelist (driver/ecrad_driver_config.F90:32-133)."""
    do_parallel: bool = True
    nblocksize: int = 8
    istartcol: int = 0
    iendcol: int = 0
    nrepeat: int = 1
    iverbose: int = 2
    do_save_inputs: bool = False
    do_save_net_fluxes: bool = False
    do_write_double_precision: bool = False
    do_write_hdf5: bool = False    # ecrad_driver_config.F90:121
    do_correct_unphysical_inputs: bool = False
    # setup-optics diagnostic dumps (ecrad_driver_config.F90:98,227;
    # ecrad_driver.F90:224-230)
    do_save_aerosol_optics: bool = False
    do_save_cloud_optics: bool = False
    experiment_name: str = ""
    # Cloud geometry overrides
    cloud_separation_scale_toa: float = -1.0
    cloud_separation_scale_surface: float = -1.0
    cloud_separation_scale_power: float = 1.0
    cloud_inhom_separation_factor: float = 1.0
    overlap_decorr_length: float = -1.0          # override, m
    overlap_decorr_length_scaling: float = -1.0
    high_inv_effective_size: float = -1.0
    middle_inv_effective_size: float = -1.0
    low_inv_effective_size: float = -1.0
    # Bulk alias: sets all three band overrides unless a specific one is
    # also given (ecrad_driver_config.F90:338-352)
    inv_effective_size: float = -1.0
    effective_size_scaling: float = -1.0
    # Scalar overrides
    fractional_std: float = -1.0
    sw_albedo_override: float = -1.0
    lw_emissivity_override: float = -1.0
    skin_temperature_override: float = -1.0      # "skin_temperature" key
    cos_sza_override: float = -1.0               # "cos_solar_zenith_angle"
    solar_irradiance_override: float = -1.0
    solar_cycle_multiplier_override: float = -2.0e9
    cloud_fraction_override: float = -1.0
    # Cloud perturbation scalings (ecrad_driver_config.F90:165-166,
    # applied at ecrad_driver_read_input.F90:205-229): multiply the
    # read-in fields when >= 0 and != 1
    q_liquid_scaling: float = -1.0
    q_ice_scaling: float = -1.0
    cloud_fraction_scaling: float = -1.0
    # Ignore file-provided inv_inhom_effective_size so inhomogeneity
    # scale == cloud scale (ecrad_driver_config.F90:109, applied at
    # ecrad_driver_read_input.F90:364-371)
    do_ignore_inhom_effective_size: bool = False
    # Shortwave spectral diagnostics (ecrad_driver_config.F90:72-82)
    sw_diag_wavelength_bound: tuple = ()
    sw_diag_file_name: str = "sw_diagnostics.nc"
    # Per-gas scale factors (driver_config "<gas>_scaling")
    gas_scaling: Optional[dict] = None
    vmr_suffix_str: str = "_vmr"

    def __post_init__(self):
        if self.inv_effective_size >= 0.0:
            for band in ("low", "middle", "high"):
                name = f"{band}_inv_effective_size"
                if getattr(self, name) < 0.0:
                    setattr(self, name, self.inv_effective_size)

    @classmethod
    def from_namelist(cls, path: str) -> "DriverConfig":
        groups = read_namelist_file(path)
        nml = groups.get("radiation_driver", {})
        kw = {}
        fields = {f.name for f in dataclasses.fields(cls)}
        for k, v in nml.items():
            if k == "sw_diag_wavelength_bound":
                vals = v if isinstance(v, (list, tuple)) else [v]
                kw[k] = tuple(float(x) for x in vals if float(x) > 0.0)
            elif k in fields:
                kw[k] = v
            elif k == "skin_temperature":
                kw["skin_temperature_override"] = v
            elif k == "sw_albedo":
                kw["sw_albedo_override"] = v
            elif k == "lw_emissivity":
                kw["lw_emissivity_override"] = v
            elif k == "cos_solar_zenith_angle":
                kw["cos_sza_override"] = v
            elif k == "solar_irradiance_override":
                kw["solar_irradiance_override"] = v
        scaling = {}
        for gas in constants.GAS_NAMES:
            key = f"{gas}_scaling"
            if key in nml:
                scaling[gas] = float(nml[key])
        if "h2o_scaling" in nml:
            scaling["h2o"] = float(nml["h2o_scaling"])
        kw["gas_scaling"] = scaling or None
        return cls(**kw)


DECORR_LENGTH_DEFAULT = 2000.0  # m (ecrad_driver_read_input.F90:68)


@dataclasses.dataclass
class RadiationInput:
    """Everything read from one input file, as numpy arrays."""
    thermodynamics: Thermodynamics
    gas_mmr: np.ndarray                # (ncol, nlev, NUM_GASES) mass mixing ratio
    cloud_mixing_ratio: np.ndarray     # (ncol, nlev, 2)
    cloud_effective_radius: np.ndarray
    cloud_fraction: np.ndarray
    fractional_std: np.ndarray
    overlap_param: np.ndarray          # (ncol, nlev-1)
    inv_cloud_effective_size: Optional[np.ndarray]
    inv_inhom_effective_size: Optional[np.ndarray]
    aerosol_mmr: Optional[np.ndarray]  # (ncol, nlev, ntype)
    cos_sza: np.ndarray
    skin_temperature: np.ndarray
    sw_albedo: np.ndarray
    sw_albedo_direct: Optional[np.ndarray]
    lw_emissivity: np.ndarray
    solar_irradiance: float
    iseed: np.ndarray
    # ecrad_driver_read_input.F90:115-125
    spectral_solar_cycle_multiplier: float = 0.0
    # True if the file stored levels surface-first and was flipped to the
    # internal TOA-first order (radiation_interface.F90:519
    # radiation_reverse); the driver flips output profiles back.
    flipped: bool = False

    @property
    def ncol(self):
        return self.cos_sza.shape[0]

    @property
    def nlev(self):
        return self.cloud_fraction.shape[1]


def _eta(pressure_hl):
    """Normalized pressure eta = p / p_surf per half level."""
    psurf = pressure_hl[:, -1:]
    return pressure_hl / np.maximum(psurf, 1.0)


def compute_overlap_param(pressure_hl, temperature_hl, decorr_length_m):
    """Overlap parameter from decorrelation length
    (radiation_cloud.F90 set_overlap_param_approx: alpha =
    exp(-dz/decorr) with dz from hydrostatic balance)."""
    # Layer-midpoint separations: use full levels
    p_fl = 0.5 * (pressure_hl[:, :-1] + pressure_hl[:, 1:])
    t_fl = 0.5 * (temperature_hl[:, :-1] + temperature_hl[:, 1:])
    # dz between successive layer midpoints via hypsometric equation
    r_over_g = constants.R_DRY / constants.ACCEL_GRAVITY
    tbar = 0.5 * (t_fl[:, :-1] + t_fl[:, 1:])
    dz = r_over_g * tbar * np.log(p_fl[:, 1:] / np.maximum(p_fl[:, :-1],
                                                           1e-10))
    return np.exp(-np.maximum(dz, 0.0) / decorr_length_m)


# Cloud effective-size parameterizations live in ecrad_torch.cloud_size
# (radiation_cloud.F90:496-690); re-exported here for the driver.
from ecrad_torch.cloud_size import (                        # noqa: E402
    inv_cloud_effective_size_eta, inv_size_from_separation,
    param_cloud_effective_separation_eta)


def _reverse_levels(inp: "RadiationInput") -> "RadiationInput":
    """Flip every level-dependent array to TOA-first order
    (radiation_interface.F90:519-663 radiation_reverse)."""
    def flip(a):
        return None if a is None else a[:, ::-1].copy()
    inp.thermodynamics = Thermodynamics(
        pressure_hl=flip(inp.thermodynamics.pressure_hl),
        temperature_hl=flip(inp.thermodynamics.temperature_hl))
    for f in ("gas_mmr", "cloud_mixing_ratio", "cloud_effective_radius",
              "cloud_fraction", "fractional_std", "overlap_param",
              "inv_cloud_effective_size", "inv_inhom_effective_size",
              "aerosol_mmr"):
        setattr(inp, f, flip(getattr(inp, f)))
    inp.flipped = True
    return inp


def read_input(path: str, driver_config: Optional[DriverConfig] = None,
               dtype=np.float64, col_range=None) -> RadiationInput:
    """col_range=(start, stop): per-host sharded read — only that
    column slab is read from disk (see io/netcdf.NcFile)."""
    dc = driver_config or DriverConfig()
    with NcFile(path, col_range=col_range) as f:
        pressure_hl = f.get("pressure_hl", dtype)
        temperature_hl = f.get("temperature_hl", dtype)
        ncol, nhl = pressure_hl.shape
        nlev = nhl - 1

        thermo = Thermodynamics(pressure_hl=pressure_hl,
                                temperature_hl=temperature_hl)

        # --- single level
        if f.exists("solar_irradiance"):
            solar_irradiance = f.get_scalar("solar_irradiance")
        else:
            solar_irradiance = 1366.0
        if dc.solar_irradiance_override > 0.0:
            solar_irradiance = dc.solar_irradiance_override

        # ecrad_driver_read_input.F90:115-125
        if dc.solar_cycle_multiplier_override > -1.0e6:
            spectral_solar_cycle_multiplier = \
                dc.solar_cycle_multiplier_override
        elif f.exists("spectral_solar_cycle_multiplier"):
            spectral_solar_cycle_multiplier = f.get_scalar(
                "spectral_solar_cycle_multiplier")
        else:
            spectral_solar_cycle_multiplier = 0.0

        cos_sza = (f.get("cos_solar_zenith_angle", dtype)
                   if f.exists("cos_solar_zenith_angle")
                   else np.zeros(ncol))
        if dc.cos_sza_override >= 0.0:
            cos_sza = np.full(ncol, dc.cos_sza_override)
        skin_t = (f.get("skin_temperature", dtype)
                  if f.exists("skin_temperature")
                  else temperature_hl[:, -1].copy())
        if dc.skin_temperature_override >= 0.0:
            skin_t = np.full(ncol, dc.skin_temperature_override)

        sw_albedo = (f.get("sw_albedo", dtype)
                     if f.exists("sw_albedo")
                     else np.full((ncol, 1), 0.0))
        if sw_albedo.ndim == 1:
            sw_albedo = sw_albedo[:, None]
        if dc.sw_albedo_override >= 0.0:
            sw_albedo = np.full_like(sw_albedo, dc.sw_albedo_override)
        sw_albedo_direct = (f.get("sw_albedo_direct", dtype)
                            if f.exists("sw_albedo_direct") else None)
        if sw_albedo_direct is not None and sw_albedo_direct.ndim == 1:
            sw_albedo_direct = sw_albedo_direct[:, None]
        if sw_albedo_direct is not None and dc.sw_albedo_override >= 0.0:
            sw_albedo_direct = np.full_like(sw_albedo_direct,
                                            dc.sw_albedo_override)
        lw_emissivity = (f.get("lw_emissivity", dtype)
                         if f.exists("lw_emissivity")
                         else np.full((ncol, 1), 1.0))
        if lw_emissivity.ndim == 1:
            lw_emissivity = lw_emissivity[:, None]
        if dc.lw_emissivity_override >= 0.0:
            lw_emissivity = np.full_like(lw_emissivity,
                                         dc.lw_emissivity_override)

        if f.exists("iseed"):
            iseed = f.get("iseed", None).astype(np.int64)
        else:
            # init_seed_simple (radiation_single_level.F90:98) — global
            # column index, so a sharded read keeps identical seeds
            c0 = col_range[0] if col_range is not None else 0
            iseed = np.arange(c0 + 1, c0 + ncol + 1, dtype=np.int64)

        # --- clouds
        cloud_fraction = (f.get("cloud_fraction", dtype)
                          if f.exists("cloud_fraction")
                          else np.zeros((ncol, nlev)))
        if dc.cloud_fraction_override >= 0.0:
            cloud_fraction = np.where(cloud_fraction > 0.0,
                                      dc.cloud_fraction_override,
                                      cloud_fraction)
        if f.exists("q_hydrometeor"):
            q_hydro = f.get("q_hydrometeor", dtype)      # (col,type,lev)
            re_hydro = f.get("re_hydrometeor", dtype)
            q = np.moveaxis(q_hydro, 1, 2)               # → (col,lev,type)
            re = np.moveaxis(re_hydro, 1, 2)
        else:
            q = np.stack([f.get("q_liquid", dtype), f.get("q_ice", dtype)],
                         axis=-1) if f.exists("q_liquid") else \
                np.zeros((ncol, nlev, 2))
            re = np.stack([f.get("re_liquid", dtype),
                           f.get("re_ice", dtype)], axis=-1) \
                if f.exists("re_liquid") else np.full((ncol, nlev, 2), 1e-5)

        # Cloud perturbation scalings (ecrad_driver_read_input.F90:205-229):
        # hydrometeor type 0 is liquid, 1 is ice
        if dc.q_liquid_scaling >= 0.0 and dc.q_liquid_scaling != 1.0:
            q = q.copy()
            q[:, :, 0] *= dc.q_liquid_scaling
        if dc.q_ice_scaling >= 0.0 and dc.q_ice_scaling != 1.0:
            q = q.copy()
            q[:, :, 1] *= dc.q_ice_scaling
        if dc.cloud_fraction_scaling >= 0.0 \
                and dc.cloud_fraction_scaling != 1.0:
            cloud_fraction = cloud_fraction * dc.cloud_fraction_scaling

        if dc.fractional_std >= 0.0:
            fractional_std = np.full((ncol, nlev), dc.fractional_std)
        elif f.exists("fractional_std"):
            fractional_std = f.get("fractional_std", dtype)
        else:
            fractional_std = np.zeros((ncol, nlev))

        if dc.overlap_decorr_length > 0.0:
            overlap_param = compute_overlap_param(
                pressure_hl, temperature_hl, dc.overlap_decorr_length)
        elif f.exists("overlap_param"):
            overlap_param = f.get("overlap_param", dtype)
            # overlap_decorr_length_scaling on a file-provided overlap
            # parameter: alpha = alpha^(1/scaling), zeroed if scaling==0
            # (ecrad_driver_read_input.F90:247-262)
            if dc.overlap_decorr_length_scaling > 0.0:
                pos = overlap_param > 0.0
                overlap_param = np.where(
                    pos,
                    np.where(pos, overlap_param, 1.0)
                    ** (1.0 / dc.overlap_decorr_length_scaling),
                    overlap_param)
            elif dc.overlap_decorr_length_scaling == 0.0:
                overlap_param = np.zeros_like(overlap_param)
        else:
            overlap_param = compute_overlap_param(
                pressure_hl, temperature_hl, DECORR_LENGTH_DEFAULT)

        # --- cloud effective size (SPARTACUS/inhomogeneity geometry)
        # Precedence per ecrad_driver_read_input.F90:290-465: (1) namelist
        # eta-band overrides, (2) namelist separation scales, (3) file
        # inv_cloud_effective_size, (4) file inv_cloud_effective_separation.
        inv_cloud_size = None
        inv_inhom_size = None
        scalable = False
        if (dc.low_inv_effective_size >= 0.0
                or dc.middle_inv_effective_size >= 0.0
                or dc.high_inv_effective_size >= 0.0):
            inv_cloud_size = inv_cloud_effective_size_eta(
                pressure_hl, dc.low_inv_effective_size,
                dc.middle_inv_effective_size,
                dc.high_inv_effective_size, 0.8, 0.45)
        elif dc.cloud_separation_scale_surface > 0.0 \
                and dc.cloud_separation_scale_toa > 0.0:
            inv_cloud_size, inv_inhom_size = \
                param_cloud_effective_separation_eta(
                    pressure_hl, cloud_fraction,
                    dc.cloud_separation_scale_surface,
                    dc.cloud_separation_scale_toa,
                    dc.cloud_separation_scale_power,
                    dc.cloud_inhom_separation_factor)
        elif f.exists("inv_cloud_effective_size"):
            scalable = True
            inv_cloud_size = f.get("inv_cloud_effective_size", dtype)
            if f.exists("inv_inhom_effective_size") \
                    and not dc.do_ignore_inhom_effective_size:
                inv_inhom_size = f.get("inv_inhom_effective_size", dtype)
        elif f.exists("inv_cloud_effective_separation"):
            scalable = True
            sep = f.get("inv_cloud_effective_separation", dtype)
            isep = (f.get("inv_inhom_effective_separation", dtype)
                    if f.exists("inv_inhom_effective_separation")
                    else None)
            inv_cloud_size, inv_inhom_size = inv_size_from_separation(
                cloud_fraction, sep, isep,
                inhom_separation_factor=dc.cloud_inhom_separation_factor)
        if scalable and inv_cloud_size is not None \
                and dc.effective_size_scaling > 0.0:
            inv_cloud_size = inv_cloud_size / dc.effective_size_scaling
            if inv_inhom_size is not None:
                inv_inhom_size = inv_inhom_size / dc.effective_size_scaling

        # --- aerosols
        aerosol_mmr = None
        if f.exists("aerosol_mmr"):
            raw = f.get("aerosol_mmr", dtype)            # (col, type, lev)
            aerosol_mmr = np.moveaxis(raw, 1, 2)         # → (col, lev, type)

        # --- gases: stored as MASS mixing ratios, matching the reference
        # flow (driver reads native units; gas%set_units(IMassMixingRatio)
        # converts VMR inputs with radiation_gas_constants.F90 molar
        # masses before the RRTMG backend)
        gas_mmr = np.zeros((ncol, nlev, constants.NUM_GASES))

        def put(name, mmr):
            gas_mmr[:, :, constants.GAS_INDEX[name]] = mmr

        def vmr_to_mmr(name, vmr):
            return vmr * (constants.MOLAR_MASS[name]
                          / constants.MOLAR_MASS_DRY_AIR)

        # Water vapour: "q" (specific humidity, treated as MMR) or h2o_mmr
        # or h2o_vmr (ecrad_driver_read_input.F90:566-575)
        if f.exists("q"):
            put("h2o", f.get("q", dtype))
        elif f.exists("h2o_mmr"):
            put("h2o", f.get("h2o_mmr", dtype))
        elif f.exists("h2o" + dc.vmr_suffix_str):
            put("h2o", vmr_to_mmr("h2o", f.get("h2o" + dc.vmr_suffix_str,
                                               dtype)))

        if f.exists("o3_mmr"):
            put("o3", f.get("o3_mmr", dtype))
        elif f.exists("o3" + dc.vmr_suffix_str):
            put("o3", vmr_to_mmr("o3", f.get("o3" + dc.vmr_suffix_str,
                                             dtype)))

        for gname in constants.GAS_NAMES:
            if gname in ("h2o", "o3"):
                continue
            var = gname + dc.vmr_suffix_str
            if f.exists(var):
                data = f.get(var, dtype)
                if data.ndim == 0:
                    data = np.full((ncol, nlev), float(data))
                elif data.ndim == 1:
                    # (level,) profile replicated over columns, or (col,)
                    if data.shape[0] == nlev:
                        data = np.broadcast_to(data[None, :], (ncol, nlev))
                    else:
                        data = np.broadcast_to(data[:, None], (ncol, nlev))
                put(gname, vmr_to_mmr(gname, data))

        if dc.gas_scaling:
            for gname, scale in dc.gas_scaling.items():
                gas_mmr[:, :, constants.GAS_INDEX[gname]] *= scale

    out = RadiationInput(
        thermodynamics=thermo,
        gas_mmr=gas_mmr,
        cloud_mixing_ratio=q,
        cloud_effective_radius=re,
        cloud_fraction=cloud_fraction,
        fractional_std=fractional_std,
        overlap_param=overlap_param,
        inv_cloud_effective_size=inv_cloud_size,
        inv_inhom_effective_size=inv_inhom_size,
        aerosol_mmr=aerosol_mmr,
        cos_sza=cos_sza,
        skin_temperature=skin_t,
        sw_albedo=sw_albedo,
        sw_albedo_direct=sw_albedo_direct,
        lw_emissivity=lw_emissivity,
        solar_irradiance=solar_irradiance,
        iseed=iseed,
        spectral_solar_cycle_multiplier=spectral_solar_cycle_multiplier,
    )
    # surface-first files are flipped to internal TOA-first order
    # (radiation_interface.F90 radiation_reverse)
    if pressure_hl[0, 0] > pressure_hl[0, -1]:
        out = _reverse_levels(out)
    return out
