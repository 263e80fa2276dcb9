"""Output files of the port and of the JAX package, compared: the same
variables with the same dimensions and attributes, and values within a
bar (the drivers' and writers' tests)."""

import dataclasses

import numpy as np

# the title names the package that wrote the file
PACKAGE_NAMES = ("ecrad_torch", "ecrad_tpu")
# fields without a unit of W m-2, held to their own bar
DIMLESS = ("lw_derivative", "cloud_cover_lw", "cloud_cover_sw")


def _text(v):
    return v.decode() if isinstance(v, bytes) else str(v)


def read_file(path, hdf5=False):
    """{"global": {attr: str}, "vars": {name: (dims, {attr: str}, array)}}
    of a NetCDF3 file (or an HDF5 one)."""
    if hdf5:
        import h5py
        with h5py.File(path, "r") as f:
            out = {"global": {k: _text(v) for k, v in f.attrs.items()},
                   "vars": {}}
            for name, v in f.items():
                if v.is_scale:
                    continue
                dims = tuple(v.dims[i][0].name.lstrip("/")
                             for i in range(v.ndim))
                attrs = {k: _text(a) for k, a in v.attrs.items()
                         if k in ("units", "long_name")}
                out["vars"][name] = (dims, attrs, np.array(v[()]))
            return out
    from scipy.io import netcdf_file
    with netcdf_file(path, "r", mmap=False) as f:
        return {"global": {k: _text(v) for k, v in f._attributes.items()},
                "vars": {name: (tuple(v.dimensions),
                                {k: _text(a) for k, a in
                                 v._attributes.items()},
                                np.array(v.data))
                         for name, v in f.variables.items()}}


def assert_same_files(port_path, jax_path, atol=0.0, atol_dimless=0.0,
                      hdf5=False, other_dtype=()):
    """The port's file against the JAX package's: the same global
    attributes (the package's name aside), variables, dimensions,
    attributes and dtypes (but for the variables named in other_dtype),
    values within atol (atol_dimless for DIMLESS).  Returns the worst
    error by name."""
    a, b = read_file(port_path, hdf5), read_file(jax_path, hdf5)
    glob_a, glob_b = ({k: v.replace(*PACKAGE_NAMES) for k, v in
                       f["global"].items()} for f in (a, b))
    assert glob_a == glob_b
    assert set(a["vars"]) == set(b["vars"]), \
        set(a["vars"]) ^ set(b["vars"])
    worst = {}
    for name, (dims, attrs, data) in b["vars"].items():
        pdims, pattrs, pdata = a["vars"][name]
        assert pdims == dims, name
        assert pattrs == attrs, name
        assert pdata.shape == data.shape, name
        assert (pdata.dtype == data.dtype) != (name in other_dtype), name
        worst[name] = float(np.abs(pdata.astype(np.float64)
                                   - data.astype(np.float64)).max()) \
            if data.size else 0.0
        if name in other_dtype:
            continue
        bar = atol_dimless if name in DIMLESS else atol
        assert worst[name] <= bar, (name, worst[name], bar)
    return worst


# the meridian columns of the drivers' 4-column cut: night, low, high and
# setting sun
CUT_COLUMNS = [2, 9, 17, 26]


def write_meridian_cut(directory):
    """The 4-column cut of the meridian file (with lat/lon, which the IFS
    driver reads), the same stored surface first, and with out-of-bounds
    values, written by the port's save_inputs into ``directory``:
    {"cut", "flipped", "corrupted": path}."""
    from ecrad_torch import flagship
    from ecrad_torch.data import MERIDIAN_INPUT
    from ecrad_torch.io.input import _reverse_levels, read_input
    from ecrad_torch.io.netcdf import NcFile
    from ecrad_torch.io.save_extras import save_inputs

    inp = read_input(MERIDIAN_INPUT)
    cut = dataclasses.replace(inp, thermodynamics=dataclasses.replace(
        inp.thermodynamics,
        pressure_hl=inp.thermodynamics.pressure_hl[CUT_COLUMNS],
        temperature_hl=inp.thermodynamics.temperature_hl[CUT_COLUMNS]), **{
            f.name: getattr(inp, f.name)[CUT_COLUMNS]
            for f in dataclasses.fields(inp)
            if isinstance(getattr(inp, f.name), np.ndarray)})
    with NcFile(MERIDIAN_INPUT) as f:
        lat, lon = f.get("lat")[CUT_COLUMNS], f.get("lon")[CUT_COLUMNS]
    t = cut.thermodynamics.temperature_hl.copy()
    t[1, 3] = 420.0
    frac = cut.cloud_fraction.copy()
    frac[2, 80] = 1.3
    config = flagship.flagship_config("float64")
    paths = {}
    for name, data in (
            ("cut", cut),
            ("flipped", _reverse_levels(dataclasses.replace(cut))),
            ("corrupted", dataclasses.replace(
                cut, cloud_fraction=frac,
                thermodynamics=dataclasses.replace(cut.thermodynamics,
                                                   temperature_hl=t)))):
        paths[name] = str(directory / f"{name}.nc")
        save_inputs(paths[name], config, data, lat=lat, lon=lon)
    return paths


def write_namelist(path, config_name="mcica_rrtmg", radiation=(),
                   **driver):
    """The drivers' namelist of a named configuration (double-precision
    output), with the &radiation flags named in ``radiation`` on and the
    &radiation_driver entries ``driver``."""
    from ecrad_torch import flagship
    from ecrad_torch.data import DATA_DIR
    text = flagship.namelist_text(config_name, DATA_DIR, iverbose=1,
                                  do_write_double_precision=True, **driver)
    text = text.replace("&radiation\n", "&radiation\n" + "".join(
        f"{k} = true,\n" for k in radiation), 1)
    with open(path, "w") as f:
        f.write(text)
    return path
