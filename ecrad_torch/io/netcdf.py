"""Minimal NetCDF3 reader/writer (equivalent of utilities/easy_netcdf.F90).

All of the reference's data and test files are NetCDF3-classic, which
``scipy.io.netcdf_file`` reads and writes natively — no libnetcdf needed.
Host-side only (setup and I/O ends of the pipeline; never in the jitted
compute path).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
from scipy.io import netcdf_file


class NcFile:
    """Read-only view of a NetCDF3 file with numpy outputs.

    ``col_range=(start, stop)``: per-host sharded read — every variable
    whose leading dimension is the column dimension is read as that
    slab only (lazy mmap slice, so each host touches just its columns;
    the reference's rank-0-read+broadcast,
    utilities/easy_netcdf_read_mpi.F90, turned inside-out: inputs are
    column-sharded so each host reads its own shard)."""

    def __init__(self, path: str, col_range=None):
        self.path = path
        self._f = netcdf_file(path, "r", mmap=col_range is not None)
        self._col_range = col_range
        self._col_dim = None
        if col_range is not None:
            for cand in ("column", "col"):
                if cand in self._f.dimensions:
                    self._col_dim = cand
                    break
            if self._col_dim is None and "pressure_hl" in self._f.variables:
                self._col_dim = \
                    self._f.variables["pressure_hl"].dimensions[0]

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    def exists(self, name: str) -> bool:
        return name in self._f.variables

    def dimensions(self) -> Dict[str, int]:
        return dict(self._f.dimensions)

    def get_rank(self, name: str) -> int:
        return self._f.variables[name].data.ndim

    def get(self, name: str, dtype=np.float64) -> np.ndarray:
        """Read a variable as numpy array (native byte order)."""
        v = self._f.variables[name]
        if (self._col_range is not None and v.dimensions
                and v.dimensions[0] == self._col_dim):
            a, b = self._col_range
            data = np.array(v[a:b], copy=True)
        else:
            data = np.array(v.data, copy=True)
        if data.dtype.kind in "fiu" and dtype is not None:
            data = data.astype(dtype)
        return data

    def get_scalar(self, name: str) -> float:
        return float(np.asarray(self._f.variables[name].data).ravel()[0])

    def get_attr(self, var: str, attr: str):
        v = self._f.variables[var]
        val = getattr(v, attr, None)
        if isinstance(val, bytes):
            val = val.decode()
        return val

    def get_global_attr(self, attr: str):
        val = getattr(self._f, attr, None)
        if isinstance(val, bytes):
            val = val.decode()
        return val

    def get_string(self, name: str) -> str:
        """Read a char-array variable as a python string."""
        data = np.asarray(self._f.variables[name].data)
        return b"".join(data.ravel()).decode().strip("\x00 ")

    def get_string_list(self, name: str) -> list:
        data = np.asarray(self._f.variables[name].data)
        if data.ndim == 1:
            return [b"".join(data).decode().strip("\x00 ")]
        return [b"".join(row).decode().strip("\x00 ") for row in data]

    def variables(self):
        return list(self._f.variables)


class NcWriter:
    """NetCDF3 writer with ecRad-style variable metadata."""

    def __init__(self, path: str):
        self._f = netcdf_file(path, "w")
        self._dims: Dict[str, int] = {}

    def define_dimension(self, name: str, size: int):
        if name not in self._dims:
            self._f.createDimension(name, size)
            self._dims[name] = size

    def write(self, name: str, data: np.ndarray,
              dim_names: Sequence[str],
              units: Optional[str] = None,
              long_name: Optional[str] = None,
              dtype: str = "f4"):
        data = np.asarray(data)
        for dn, sz in zip(dim_names, data.shape):
            self.define_dimension(dn, sz)
        v = self._f.createVariable(name, dtype, tuple(dim_names))
        v[:] = data.astype(v.data.dtype) if data.shape else data
        if data.shape == ():
            v.assignValue(float(data))
        if units is not None:
            v.units = units
        if long_name is not None:
            v.long_name = long_name

    def write_scalar(self, name: str, value: float,
                     units: Optional[str] = None,
                     long_name: Optional[str] = None):
        v = self._f.createVariable(name, "f8", ())
        try:
            v.assignValue(float(value))
        except (IndexError, RuntimeError):
            # scipy's assignValue mishandles 0-d arrays in some versions
            v.data[()] = float(value)
        if units:
            v.units = units
        if long_name:
            v.long_name = long_name

    def set_global_attr(self, name: str, value: str):
        setattr(self._f, name, value)

    def close(self):
        self._f.close()


class Hdf5Writer:
    """HDF5/NetCDF4-style writer (easy_netcdf.F90 HDF5 option,
    driver/ecrad_driver_config.F90:121 do_write_hdf5): same interface
    as NcWriter, backed by h5py, using netCDF4's dimension-scale
    convention so the files are readable by netCDF4/xarray tooling."""

    def __init__(self, path: str):
        import h5py
        self._f = h5py.File(path, "w")
        self._dims: Dict[str, int] = {}

    def define_dimension(self, name: str, size: int):
        if name not in self._dims:
            d = self._f.create_dataset(name, data=np.arange(size, dtype="f4"))
            d.make_scale(name)
            self._dims[name] = size

    def write(self, name: str, data: np.ndarray,
              dim_names: Sequence[str],
              units: Optional[str] = None,
              long_name: Optional[str] = None,
              dtype: str = "f4"):
        data = np.asarray(data)
        for dn, sz in zip(dim_names, data.shape):
            self.define_dimension(dn, sz)
        np_dt = {"f4": np.float32, "f8": np.float64,
                 "i4": np.int32}.get(dtype, np.float32)
        v = self._f.create_dataset(name, data=data.astype(np_dt))
        for i, dn in enumerate(dim_names):
            v.dims[i].attach_scale(self._f[dn])
        if units is not None:
            v.attrs["units"] = units
        if long_name is not None:
            v.attrs["long_name"] = long_name

    def write_scalar(self, name: str, value: float,
                     units: Optional[str] = None,
                     long_name: Optional[str] = None):
        v = self._f.create_dataset(name, data=np.float64(value))
        if units:
            v.attrs["units"] = units
        if long_name:
            v.attrs["long_name"] = long_name

    def set_global_attr(self, name: str, value: str):
        self._f.attrs[name] = value

    def close(self):
        self._f.close()


def make_writer(path: str, hdf5: bool = False):
    """Writer factory: NetCDF3 (default) or HDF5 (do_write_hdf5)."""
    return Hdf5Writer(path) if hdf5 else NcWriter(path)
