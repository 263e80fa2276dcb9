"""Setup-time optics diagnostic dumps (port of
``ecrad_tpu/io/save_optics.py``).

The reference driver can dump the consolidated optics LUTs it will run
with:

* ``do_save_aerosol_optics`` writes the band-averaged aerosol
  scattering tables to ``aerosol_optics.nc``
  (driver/ecrad_driver.F90:224-226,
  radiation_aerosol_optics_data.F90:406-503 ``save``);
* ``do_save_cloud_optics`` (general cloud optics only) writes one file
  per hydrometeor type and spectrum,
  ``hydrometeor_optics_{sw,lw}_<type>.nc``
  (driver/ecrad_driver.F90:228-230,
  radiation_general_cloud_optics.F90:294-328 +
  radiation_general_cloud_optics_data.F90:376-415 ``save``).

Variable names/dims mirror the reference writers (Fortran
dimension order reversed for the C-ordered NetCDF layout).  The tables
are the port's setup tables (``interface.Tables.aerosol`` and
``.cloud``), tensors on any device, copied to the host here.
"""

from __future__ import annotations

import numpy as np

from ecrad_torch.containers import to_numpy
from ecrad_torch.io.netcdf import make_writer


def save_aerosol_optics(path: str, aerosol_tables: dict,
                        hdf5: bool = False) -> None:
    """radiation_aerosol_optics_data.F90:406-503 field contract."""
    t = aerosol_tables
    w = make_writer(path, hdf5=hdf5)
    w.set_global_attr(
        "title", "Aerosol optical properties consolidated to the "
        "radiation-scheme band structure")

    def band(x):                           # (nband, ntype) -> C order
        return to_numpy(x).T             # (ntype, nband)

    w.write("mass_ext_sw_hydrophobic", band(t["mass_ext_sw_phobic"]),
            ("hydrophobic", "band_sw"), units="m2 kg-1",
            long_name="Shortwave mass-extinction coefficient of "
                      "hydrophobic aerosols")
    w.write("ssa_sw_hydrophobic", band(t["ssa_sw_phobic"]),
            ("hydrophobic", "band_sw"), units="1",
            long_name="Shortwave single scattering albedo of "
                      "hydrophobic aerosols")
    w.write("asymmetry_sw_hydrophobic", band(t["g_sw_phobic"]),
            ("hydrophobic", "band_sw"), units="1",
            long_name="Shortwave asymmetry factor of hydrophobic "
                      "aerosols")
    w.write("mass_ext_lw_hydrophobic", band(t["mass_ext_lw_phobic"]),
            ("hydrophobic", "band_lw"), units="m2 kg-1",
            long_name="Longwave mass-extinction coefficient of "
                      "hydrophobic aerosols")
    w.write("ssa_lw_hydrophobic", band(t["ssa_lw_phobic"]),
            ("hydrophobic", "band_lw"), units="1",
            long_name="Longwave single scattering albedo of "
                      "hydrophobic aerosols")
    w.write("asymmetry_lw_hydrophobic", band(t["g_lw_phobic"]),
            ("hydrophobic", "band_lw"), units="1",
            long_name="Longwave asymmetry factor of hydrophobic "
                      "aerosols")
    if t.get("use_hydrophilic"):
        def philic(x):                     # (nband, ntype, nrh) -> C
            return np.transpose(to_numpy(x), (1, 2, 0))

        w.write("relative_humidity1", to_numpy(t["rh_lower"]),
                ("relative_humidity",), units="1",
                long_name="Lower bound of relative-humidity bins")
        w.write("mass_ext_sw_hydrophilic",
                philic(t["mass_ext_sw_philic"]),
                ("hydrophilic", "relative_humidity", "band_sw"),
                units="m2 kg-1",
                long_name="Shortwave mass-extinction coefficient of "
                          "hydrophilic aerosols")
        w.write("ssa_sw_hydrophilic", philic(t["ssa_sw_philic"]),
                ("hydrophilic", "relative_humidity", "band_sw"),
                units="1",
                long_name="Shortwave single scattering albedo of "
                          "hydrophilic aerosols")
        w.write("asymmetry_sw_hydrophilic", philic(t["g_sw_philic"]),
                ("hydrophilic", "relative_humidity", "band_sw"),
                units="1",
                long_name="Shortwave asymmetry factor of hydrophilic "
                          "aerosols")
        w.write("mass_ext_lw_hydrophilic",
                philic(t["mass_ext_lw_philic"]),
                ("hydrophilic", "relative_humidity", "band_lw"),
                units="m2 kg-1",
                long_name="Longwave mass-extinction coefficient of "
                          "hydrophilic aerosols")
        w.write("ssa_lw_hydrophilic", philic(t["ssa_lw_philic"]),
                ("hydrophilic", "relative_humidity", "band_lw"),
                units="1",
                long_name="Longwave single scattering albedo of "
                          "hydrophilic aerosols")
        w.write("asymmetry_lw_hydrophilic", philic(t["g_lw_philic"]),
                ("hydrophilic", "relative_humidity", "band_lw"),
                units="1",
                long_name="Longwave asymmetry factor of hydrophilic "
                          "aerosols")
    w.close()


def save_general_cloud_optics(file_prefix: str, cloud_tables: dict,
                              hdf5: bool = False) -> None:
    """One file per (type, spectrum):
    ``<prefix>_{sw,lw}_<type>.nc`` with the spectrally-averaged
    hydrometeor optics (radiation_general_cloud_optics_data.F90:
    376-415).  cloud_tables: general-cloud-optics tables dict
    ({"type_names": [...], "sw": [lut...], "lw": [lut...]})."""
    entries = []
    names = cloud_tables.get("type_names", [])
    for spec in ("sw", "lw"):
        for name, t in zip(names, cloud_tables.get(spec) or []):
            entries.append((name, spec, t))
    for name, spec, t in entries:
        if not isinstance(t, dict) or "mass_ext" not in t:
            continue
        path = f"{file_prefix}_{spec}_{name}.nc"
        w = make_writer(path, hdf5=hdf5)
        w.set_global_attr("title",
                          f"Optical properties of {name}")
        nre = int(t["n_effective_radius"])
        re0 = float(t["effective_radius_0"])
        dre = float(t["d_effective_radius"])
        re_axis = re0 + dre * np.arange(nre)
        w.write("effective_radius", re_axis, ("effective_radius",),
                units="m", long_name="Effective radius")
        me = to_numpy(t["mass_ext"])             # (nspec, nre)
        ssa = to_numpy(t["ssa"])
        g = to_numpy(t["asymmetry"])
        w.write("mass_extinction_coefficient", me.T,
                ("effective_radius", "band"), units="m2 kg-1",
                long_name="Mass-extinction coefficient")
        w.write("single_scattering_albedo", ssa.T,
                ("effective_radius", "band"), units="1",
                long_name="Single scattering albedo")
        w.write("asymmetry_factor", g.T,
                ("effective_radius", "band"), units="1",
                long_name="Asymmetry factor")
        w.close()
