"""Flux output writers (port of ``ecrad_tpu/io/output.py``; reference:
radiation/radiation_save.F90:35-460, 464-714, 1314-1473).

Writes the same variable names, dimensions and attributes as the
reference's ``save_fluxes``, so the reference comparison tooling
(test/common/nccmp.py) works unchanged.  Each writer takes a
``containers.Flux`` on any device and copies it to the host once
(``host_flux``; a Flux of numpy arrays passes through).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ecrad_torch.config import Config
from ecrad_torch.containers import Flux, to_numpy
from ecrad_torch.io.netcdf import NcWriter, make_writer


def host_flux(flux: Flux) -> Flux:
    """The Flux with every field a numpy array on the host."""
    return dataclasses.replace(flux, **{
        k: to_numpy(v) for k, v in flux.fields().items()})


def save_fluxes(path: str, config: Config, flux: Flux, pressure_hl,
                experiment_name: str = "",
                double_precision: bool = False, hdf5: bool = False):
    flux = host_flux(flux)
    dt = "f8" if double_precision else "f4"
    w = make_writer(path, hdf5)
    w.set_global_attr("title",
                      "Radiative flux profiles from the ecrad_torch "
                      "offline radiation scheme")
    if experiment_name:
        w.set_global_attr("experiment", experiment_name)

    def arr(x):
        return np.asarray(x)

    w.write("pressure_hl", arr(pressure_hl), ("column", "half_level"),
            units="Pa", long_name="Pressure on half-levels", dtype=dt)

    if config.do_lw:
        w.write("flux_up_lw", arr(flux.lw_up), ("column", "half_level"),
                units="W m-2", long_name="Upwelling longwave flux", dtype=dt)
        w.write("flux_dn_lw", arr(flux.lw_dn), ("column", "half_level"),
                units="W m-2", long_name="Downwelling longwave flux",
                dtype=dt)
        if config.do_clear:
            w.write("flux_up_lw_clear", arr(flux.lw_up_clear),
                    ("column", "half_level"), units="W m-2",
                    long_name="Upwelling clear-sky longwave flux", dtype=dt)
            w.write("flux_dn_lw_clear", arr(flux.lw_dn_clear),
                    ("column", "half_level"), units="W m-2",
                    long_name="Downwelling clear-sky longwave flux",
                    dtype=dt)
        if config.do_lw_derivatives and flux.lw_derivatives is not None:
            w.write("lw_derivative", arr(flux.lw_derivatives),
                    ("column", "half_level"),
                    long_name="Derivative of upwelling longwave flux "
                              "w.r.t. surface value", dtype=dt)
        if config.do_toa_spectral_flux and flux.lw_up_toa_band is not None:
            w.write("spectral_flux_up_lw_toa", arr(flux.lw_up_toa_band),
                    ("column", "band_lw_toa"), units="W m-2",
                    long_name="Spectral upwelling longwave flux at "
                              "top-of-atmosphere", dtype=dt)
            if config.do_clear and flux.lw_up_toa_clear_band is not None:
                w.write("spectral_flux_up_lw_toa_clear",
                        arr(flux.lw_up_toa_clear_band),
                        ("column", "band_lw_toa"), units="W m-2",
                        long_name="Spectral upwelling clear-sky longwave "
                                  "flux at top-of-atmosphere", dtype=dt)
        if config.do_canopy_fluxes_lw and flux.lw_dn_surf_canopy is not None:
            w.write("canopy_flux_dn_lw_surf", arr(flux.lw_dn_surf_canopy),
                    ("column", "canopy_band_lw"), units="W m-2",
                    long_name="Surface downwelling longwave flux in "
                              "canopy bands", dtype=dt)
        spec_flux = config.do_save_spectral_flux or config.do_save_gpoint_flux
        if spec_flux and flux.lw_up_band is not None:
            w.write("spectral_flux_up_lw", arr(flux.lw_up_band),
                    ("column", "half_level", "band_lw"), units="W m-2",
                    long_name="Spectral upwelling longwave flux", dtype=dt)
            w.write("spectral_flux_dn_lw", arr(flux.lw_dn_band),
                    ("column", "half_level", "band_lw"), units="W m-2",
                    long_name="Spectral downwelling longwave flux", dtype=dt)
            if config.do_clear and flux.lw_up_clear_band is not None:
                w.write("spectral_flux_up_lw_clear",
                        arr(flux.lw_up_clear_band),
                        ("column", "half_level", "band_lw"), units="W m-2",
                        long_name="Spectral upwelling clear-sky longwave "
                                  "flux", dtype=dt)
                w.write("spectral_flux_dn_lw_clear",
                        arr(flux.lw_dn_clear_band),
                        ("column", "half_level", "band_lw"), units="W m-2",
                        long_name="Spectral downwelling clear-sky longwave "
                                  "flux", dtype=dt)

    if config.do_sw:
        w.write("flux_up_sw", arr(flux.sw_up), ("column", "half_level"),
                units="W m-2", long_name="Upwelling shortwave flux",
                dtype=dt)
        w.write("flux_dn_sw", arr(flux.sw_dn), ("column", "half_level"),
                units="W m-2", long_name="Downwelling shortwave flux",
                dtype=dt)
        if config.do_sw_direct:
            w.write("flux_dn_direct_sw", arr(flux.sw_dn_direct),
                    ("column", "half_level"), units="W m-2",
                    long_name="Downwelling direct shortwave flux", dtype=dt)
        if config.do_clear:
            w.write("flux_up_sw_clear", arr(flux.sw_up_clear),
                    ("column", "half_level"), units="W m-2",
                    long_name="Upwelling clear-sky shortwave flux", dtype=dt)
            w.write("flux_dn_sw_clear", arr(flux.sw_dn_clear),
                    ("column", "half_level"), units="W m-2",
                    long_name="Downwelling clear-sky shortwave flux",
                    dtype=dt)
            if config.do_sw_direct:
                w.write("flux_dn_direct_sw_clear",
                        arr(flux.sw_dn_direct_clear),
                        ("column", "half_level"), units="W m-2",
                        long_name="Downwelling clear-sky direct shortwave "
                                  "flux", dtype=dt)
        if config.do_surface_sw_spectral_flux \
                and flux.sw_dn_surf_band is not None:
            w.write("spectral_flux_dn_sw_surf", arr(flux.sw_dn_surf_band),
                    ("column", "band_sw"), units="W m-2",
                    long_name="Spectral downwelling shortwave flux at "
                              "surface", dtype=dt)
            if flux.sw_dn_direct_surf_band is not None:
                w.write("spectral_flux_dn_direct_sw_surf",
                        arr(flux.sw_dn_direct_surf_band),
                        ("column", "band_sw"), units="W m-2",
                        long_name="Spectral downwelling direct shortwave "
                                  "flux at surface", dtype=dt)
            if config.do_clear and flux.sw_dn_surf_clear_band is not None:
                w.write("spectral_flux_dn_sw_surf_clear",
                        arr(flux.sw_dn_surf_clear_band),
                        ("column", "band_sw"), units="W m-2",
                        long_name="Spectral downwelling clear-sky shortwave "
                                  "flux at surface", dtype=dt)
                if flux.sw_dn_direct_surf_clear_band is not None:
                    w.write("spectral_flux_dn_direct_sw_surf_clear",
                            arr(flux.sw_dn_direct_surf_clear_band),
                            ("column", "band_sw"), units="W m-2",
                            long_name="Spectral downwelling clear-sky "
                                      "direct shortwave flux at surface",
                            dtype=dt)
        if spec_flux and flux.sw_up_band is not None:
            w.write("spectral_flux_up_sw", arr(flux.sw_up_band),
                    ("column", "half_level", "band_sw"), units="W m-2",
                    long_name="Spectral upwelling shortwave flux", dtype=dt)
            w.write("spectral_flux_dn_sw", arr(flux.sw_dn_band),
                    ("column", "half_level", "band_sw"), units="W m-2",
                    long_name="Spectral downwelling shortwave flux",
                    dtype=dt)
            if config.do_sw_direct and flux.sw_dn_direct_band is not None:
                w.write("spectral_flux_dn_direct_sw",
                        arr(flux.sw_dn_direct_band),
                        ("column", "half_level", "band_sw"),
                        units="W m-2",
                        long_name="Spectral downwelling direct shortwave "
                                  "flux", dtype=dt)
            if config.do_clear and flux.sw_up_clear_band is not None:
                w.write("spectral_flux_up_sw_clear",
                        arr(flux.sw_up_clear_band),
                        ("column", "half_level", "band_sw"), units="W m-2",
                        long_name="Spectral upwelling clear-sky shortwave "
                                  "flux", dtype=dt)
                w.write("spectral_flux_dn_sw_clear",
                        arr(flux.sw_dn_clear_band),
                        ("column", "half_level", "band_sw"), units="W m-2",
                        long_name="Spectral downwelling clear-sky shortwave "
                                  "flux", dtype=dt)
        if config.do_toa_spectral_flux and flux.sw_up_toa_band is not None:
            w.write("spectral_flux_dn_sw_toa", arr(flux.sw_dn_toa_band),
                    ("column", "band_sw_toa"), units="W m-2",
                    long_name="Spectral downwelling shortwave flux at "
                              "top-of-atmosphere", dtype=dt)
            w.write("spectral_flux_up_sw_toa", arr(flux.sw_up_toa_band),
                    ("column", "band_sw_toa"), units="W m-2",
                    long_name="Spectral upwelling shortwave flux at "
                              "top-of-atmosphere", dtype=dt)
            if config.do_clear and flux.sw_up_toa_clear_band is not None:
                w.write("spectral_flux_up_sw_toa_clear",
                        arr(flux.sw_up_toa_clear_band),
                        ("column", "band_sw_toa"), units="W m-2",
                        long_name="Spectral upwelling clear-sky shortwave "
                                  "flux at top-of-atmosphere", dtype=dt)
        if config.do_canopy_fluxes_sw \
                and flux.sw_dn_diffuse_surf_canopy is not None:
            w.write("canopy_flux_dn_diffuse_sw_surf",
                    arr(flux.sw_dn_diffuse_surf_canopy),
                    ("column", "canopy_band_sw"), units="W m-2",
                    long_name="Surface downwelling diffuse shortwave flux "
                              "in canopy bands", dtype=dt)
            w.write("canopy_flux_dn_direct_sw_surf",
                    arr(flux.sw_dn_direct_surf_canopy),
                    ("column", "canopy_band_sw"), units="W m-2",
                    long_name="Surface downwelling direct shortwave flux "
                              "in canopy bands", dtype=dt)

    if flux.cloud_cover_lw is not None and config.do_lw:
        w.write("cloud_cover_lw", arr(flux.cloud_cover_lw), ("column",),
                long_name="Total cloud cover diagnosed by longwave solver",
                dtype=dt)
    if flux.cloud_cover_sw is not None and config.do_sw:
        w.write("cloud_cover_sw", arr(flux.cloud_cover_sw), ("column",),
                long_name="Total cloud cover diagnosed by shortwave solver",
                dtype=dt)
    w.close()


def save_net_fluxes(path: str, config: Config, flux: Flux, pressure_hl,
                    experiment_name: str = "",
                    double_precision: bool = False, hdf5: bool = False):
    """Net-flux output variant (radiation_save.F90:464-714
    save_net_fluxes): net flux profiles + surface/TOA values, as used by
    the IFS-style driver validation."""
    flux = host_flux(flux)
    dt = "f8" if double_precision else "f4"
    w = make_writer(path, hdf5)
    w.set_global_attr("title",
                      "Radiative flux profiles from the ecrad_torch "
                      "offline radiation scheme")
    if experiment_name:
        w.set_global_attr("experiment", experiment_name)

    def arr(x):
        return np.asarray(x)

    w.write("pressure_hl", arr(pressure_hl), ("column", "half_level"),
            units="Pa", long_name="Pressure", dtype=dt)
    if config.do_lw:
        w.write("flux_net_lw", arr(flux.lw_dn - flux.lw_up),
                ("column", "half_level"), units="W m-2",
                long_name="Net downward longwave flux", dtype=dt)
        w.write("flux_dn_lw_surf", arr(flux.lw_dn[:, -1]), ("column",),
                units="W m-2",
                long_name="Surface downwelling longwave flux", dtype=dt)
        if config.do_clear:
            w.write("flux_net_lw_clear",
                    arr(flux.lw_dn_clear - flux.lw_up_clear),
                    ("column", "half_level"), units="W m-2",
                    long_name="Net downward clear-sky longwave flux",
                    dtype=dt)
            w.write("flux_dn_lw_clear_surf", arr(flux.lw_dn_clear[:, -1]),
                    ("column",), units="W m-2",
                    long_name="Surface downwelling clear-sky longwave "
                              "flux", dtype=dt)
        if config.do_lw_derivatives and flux.lw_derivatives is not None:
            w.write("lw_derivative", arr(flux.lw_derivatives),
                    ("column", "half_level"),
                    long_name="Derivative of upwelling longwave flux "
                              "w.r.t. surface value", dtype=dt)
        if config.do_toa_spectral_flux and flux.lw_up_toa_band is not None:
            w.write("spectral_flux_up_lw_toa", arr(flux.lw_up_toa_band),
                    ("column", "band_lw_toa"), units="W m-2",
                    long_name="Spectral upwelling longwave flux at "
                              "top-of-atmosphere", dtype=dt)
            if config.do_clear and flux.lw_up_toa_clear_band is not None:
                w.write("spectral_flux_up_lw_toa_clear",
                        arr(flux.lw_up_toa_clear_band),
                        ("column", "band_lw_toa"), units="W m-2",
                        long_name="Spectral upwelling clear-sky longwave "
                                  "flux at top-of-atmosphere", dtype=dt)
        if config.do_canopy_fluxes_lw and flux.lw_dn_surf_canopy is not None:
            w.write("canopy_flux_dn_lw_surf", arr(flux.lw_dn_surf_canopy),
                    ("column", "canopy_band_lw"), units="W m-2",
                    long_name="Surface downwelling longwave flux in "
                              "canopy bands", dtype=dt)
    if config.do_sw:
        w.write("flux_net_sw", arr(flux.sw_dn - flux.sw_up),
                ("column", "half_level"), units="W m-2",
                long_name="Net downward shortwave flux", dtype=dt)
        w.write("flux_dn_sw_surf", arr(flux.sw_dn[:, -1]), ("column",),
                units="W m-2",
                long_name="Surface downwelling shortwave flux", dtype=dt)
        w.write("flux_dn_sw_toa", arr(flux.sw_dn[:, 0]), ("column",),
                units="W m-2",
                long_name="TOA downwelling shortwave flux", dtype=dt)
        if config.do_sw_direct and flux.sw_dn_direct is not None:
            w.write("flux_dn_direct_sw_surf",
                    arr(flux.sw_dn_direct[:, -1]), ("column",),
                    units="W m-2",
                    long_name="Surface downwelling direct shortwave "
                              "flux", dtype=dt)
        if config.do_clear:
            w.write("flux_net_sw_clear",
                    arr(flux.sw_dn_clear - flux.sw_up_clear),
                    ("column", "half_level"), units="W m-2",
                    long_name="Net downward clear-sky shortwave flux",
                    dtype=dt)
            w.write("flux_dn_sw_clear_surf", arr(flux.sw_dn_clear[:, -1]),
                    ("column",), units="W m-2",
                    long_name="Surface downwelling clear-sky shortwave "
                              "flux", dtype=dt)
            if config.do_sw_direct and flux.sw_dn_direct_clear is not None:
                w.write("flux_dn_direct_sw_clear_surf",
                        arr(flux.sw_dn_direct_clear[:, -1]), ("column",),
                        units="W m-2",
                        long_name="Surface downwelling clear-sky direct "
                                  "shortwave flux", dtype=dt)
        if config.do_toa_spectral_flux and flux.sw_up_toa_band is not None:
            w.write("spectral_flux_dn_sw_toa", arr(flux.sw_dn_toa_band),
                    ("column", "band_sw_toa"), units="W m-2",
                    long_name="Spectral downwelling shortwave flux at "
                              "top-of-atmosphere", dtype=dt)
            w.write("spectral_flux_up_sw_toa", arr(flux.sw_up_toa_band),
                    ("column", "band_sw_toa"), units="W m-2",
                    long_name="Spectral upwelling shortwave flux at "
                              "top-of-atmosphere", dtype=dt)
            if config.do_clear and flux.sw_up_toa_clear_band is not None:
                w.write("spectral_flux_up_sw_toa_clear",
                        arr(flux.sw_up_toa_clear_band),
                        ("column", "band_sw_toa"), units="W m-2",
                        long_name="Spectral upwelling clear-sky shortwave "
                                  "flux at top-of-atmosphere", dtype=dt)
        if config.do_canopy_fluxes_sw \
                and flux.sw_dn_diffuse_surf_canopy is not None:
            w.write("canopy_flux_dn_diffuse_sw_surf",
                    arr(flux.sw_dn_diffuse_surf_canopy),
                    ("column", "canopy_band_sw"), units="W m-2",
                    long_name="Surface downwelling diffuse shortwave "
                              "flux in canopy bands", dtype=dt)
            w.write("canopy_flux_dn_direct_sw_surf",
                    arr(flux.sw_dn_direct_surf_canopy),
                    ("column", "canopy_band_sw"), units="W m-2",
                    long_name="Surface downwelling direct shortwave flux "
                              "in canopy bands", dtype=dt)
    w.close()


def save_sw_diagnostics(path: str, config: Config, wavelength_bound,
                        mapping, flux: Flux, experiment_name: str = "",
                        double_precision: bool = False):
    """Surface SW fluxes mapped to user wavelength intervals
    (radiation_save.F90:1314-1473 save_sw_diagnostics).

    mapping (nwav, nband) from optics.spectral.get_sw_mapping; the
    surface band fluxes are (ncol, nband)."""
    flux = host_flux(flux)
    dt = "f8" if double_precision else "f4"
    wb = np.asarray(wavelength_bound, float)
    m = np.asarray(mapping)
    w = NcWriter(path)
    w.set_global_attr(
        "title", "Shortwave spectral diagnostics from the ecrad_torch "
        "offline radiation scheme")
    if experiment_name:
        w.set_global_attr("experiment", experiment_name)
    w.write("wavelength1", wb[:-1], ("wavelength",), units="m",
            long_name="Wavelength lower bound", dtype="f8")
    w.write("wavelength2", wb[1:], ("wavelength",), units="m",
            long_name="Wavelength upper bound", dtype="f8")

    def put(name, band_flux, long_name):
        if band_flux is None:
            return
        w.write(name, np.asarray(band_flux) @ m.T,
                ("column", "wavelength"), units="W m-2",
                long_name=long_name, dtype=dt)

    put("flux_dn_sw_surf", flux.sw_dn_surf_band,
        "Surface downwelling shortwave flux")
    put("flux_dn_direct_sw_surf", flux.sw_dn_direct_surf_band,
        "Surface downwelling direct shortwave flux")
    if config.do_clear:
        put("flux_dn_sw_surf_clear", flux.sw_dn_surf_clear_band,
            "Surface downwelling clear-sky shortwave flux")
        put("flux_dn_direct_sw_surf_clear",
            flux.sw_dn_direct_surf_clear_band,
            "Surface downwelling clear-sky direct shortwave flux")
    w.close()
