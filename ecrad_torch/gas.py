"""Gas composition container (port of ``ecrad_tpu/gas.py``): the
reference's ``gas_type`` (radiation/radiation_gas.F90:36-79) with
``put``/``put_well_mixed``/``scale``/``set_units``/``assert_units``/
``get``/``reverse``/``out_of_physical_bounds``.

:class:`Gas` holds one ``(ncol, nlev, NUM_GASES)`` mixing-ratio tensor
(always batched: no per-gas ragged arrays) and, as plain Python state,
each present gas's units and scale factor.  ``set_units`` is one multiply
by a per-gas vector, whatever number of gases converts.  Methods return
new objects and never write into a tensor they were given.

Units are the reference's two codes (radiation_gas_constants.F90):
``"mmr"`` (IMassMixingRatio) and ``"vmr"`` (IVolumeMixingRatio), plus a
per-gas ``scale_factor``: the stored numbers times ``scale_factor`` are
dimensionless (VMR stored in PPMV carries scale_factor=1e-6).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ecrad_torch import constants

MMR = "mmr"
VMR = "vmr"
_UNITS = (MMR, VMR)


def _unit_conversion(name: str, from_units: str, to_units: str) -> float:
    """Pure-number factor converting a dimensionless mixing ratio of
    ``name`` between mass and volume conventions
    (radiation_gas.F90:440-446)."""
    if from_units == to_units:
        return 1.0
    m_gas = constants.MOLAR_MASS[name]
    m_air = constants.MOLAR_MASS_DRY_AIR
    if to_units == MMR:        # vmr -> mmr
        return m_gas / m_air
    return m_air / m_gas        # mmr -> vmr


class Gas:
    """Gas container.

    Attributes:
      mixing_ratio: (ncol, nlev, NUM_GASES) tensor in per-gas units/scale.
      units: dict name -> "mmr"|"vmr" for present gases.
      scale_factor: dict name -> float (stored * factor = dimensionless).
      well_mixed: frozenset of names that were put as scalars.
    """

    def __init__(self, mixing_ratio, units=None, scale_factor=None,
                 well_mixed=()):
        self.mixing_ratio = mixing_ratio
        self.units: Dict[str, str] = dict(units or {})
        self.scale_factor: Dict[str, float] = dict(scale_factor or {})
        self.well_mixed = frozenset(well_mixed)

    @classmethod
    def allocate(cls, ncol: int, nlev: int, dtype=torch.float32,
                 device="cpu") -> "Gas":
        """radiation_gas.F90:86-108 (allocate): zeroed block, no gases
        present."""
        return cls(torch.zeros((ncol, nlev, constants.NUM_GASES),
                               dtype=dtype, device=device))

    @property
    def ncol(self) -> int:
        return self.mixing_ratio.shape[0]

    @property
    def nlev(self) -> int:
        return self.mixing_ratio.shape[1]

    def is_present(self, name: str) -> bool:
        return name in self.units

    def _check(self, name: str, units: str):
        if name not in constants.GAS_INDEX:
            raise ValueError(
                f"unknown gas '{name}' (valid: {constants.GAS_NAMES})")
        if units not in _UNITS:
            raise ValueError(f"units must be one of {_UNITS}, got {units}")

    def put(self, name: str, units: str, mixing_ratio,
            scale_factor: float = 1.0) -> "Gas":
        """Store a (ncol, nlev) mixing-ratio field for one gas
        (radiation_gas.F90:220-250 put_gas)."""
        self._check(name, units)
        mr = torch.as_tensor(mixing_ratio, dtype=self.mixing_ratio.dtype,
                             device=self.mixing_ratio.device)
        if tuple(mr.shape) != (self.ncol, self.nlev):
            raise ValueError(
                f"gas '{name}': expected shape {(self.ncol, self.nlev)}, "
                f"got {tuple(mr.shape)}")
        block = self.mixing_ratio.clone()
        block[:, :, constants.GAS_INDEX[name]] = mr
        units_d = dict(self.units)
        units_d[name] = units
        scale_d = dict(self.scale_factor)
        scale_d[name] = float(scale_factor)
        return Gas(block, units_d, scale_d, self.well_mixed - {name})

    def put_well_mixed(self, name: str, units: str, mixing_ratio: float,
                       scale_factor: float = 1.0) -> "Gas":
        """Store a globally well-mixed scalar (radiation_gas.F90:295-368)."""
        self._check(name, units)
        mr = torch.full((self.ncol, self.nlev), float(mixing_ratio),
                        dtype=self.mixing_ratio.dtype,
                        device=self.mixing_ratio.device)
        out = self.put(name, units, mr, scale_factor)
        return Gas(out.mixing_ratio, out.units, out.scale_factor,
                   self.well_mixed | {name})

    def scale(self, name: str, factor: float) -> "Gas":
        """Fold an extra concentration scaling into the gas's scale
        factor; applied at the next set_units
        (radiation_gas.F90:377-396)."""
        if name not in self.units:
            return self
        scale_d = dict(self.scale_factor)
        scale_d[name] = scale_d.get(name, 1.0) * float(factor)
        return Gas(self.mixing_ratio, self.units, scale_d, self.well_mixed)

    def set_units(self, units: str, names=None,
                  scale_factor: float = 1.0) -> "Gas":
        """Convert stored numbers so every (selected) gas is in ``units``
        with the given target scale factor
        (radiation_gas.F90:412-464 set_units_gas): one multiply by the
        per-gas factors (1 for absent gases), assembled on the host."""
        if names is None:
            names = list(self.units)
        factors = np.ones(constants.NUM_GASES)
        units_d = dict(self.units)
        scale_d = dict(self.scale_factor)
        for name in names:
            if name not in self.units:
                continue
            sf = (self.scale_factor.get(name, 1.0) / scale_factor) \
                * _unit_conversion(name, self.units[name], units)
            factors[constants.GAS_INDEX[name]] = sf
            units_d[name] = units
            scale_d[name] = float(scale_factor)
        if np.all(factors == 1.0):
            block = self.mixing_ratio
        else:
            block = self.mixing_ratio * torch.as_tensor(
                factors, dtype=self.mixing_ratio.dtype,
                device=self.mixing_ratio.device)
        return Gas(block, units_d, scale_d, self.well_mixed)

    def assert_units(self, units: str, names=None,
                     scale_factor: float = 1.0):
        """Raise unless every (selected) present gas is stored in
        ``units`` with the given scale factor
        (radiation_gas.F90 assert_units_gas)."""
        for name in (names if names is not None else self.units):
            if name not in self.units:
                continue
            if self.units[name] != units or not np.isclose(
                    self.scale_factor.get(name, 1.0), scale_factor):
                raise AssertionError(
                    f"gas '{name}' stored as {self.units[name]} x "
                    f"{self.scale_factor.get(name, 1.0)}, expected "
                    f"{units} x {scale_factor}")

    def get(self, name: str, units: str, scale_factor: float = 1.0):
        """Return one gas as (ncol, nlev) in the requested units
        (radiation_gas.F90 get_gas); zeros if absent."""
        self._check(name, units)
        mr = self.mixing_ratio[:, :, constants.GAS_INDEX[name]]
        if name not in self.units:
            return torch.zeros_like(mr)
        sf = (self.scale_factor.get(name, 1.0) / scale_factor) \
            * _unit_conversion(name, self.units[name], units)
        return mr * sf if sf != 1.0 else mr

    def to_mmr(self):
        """The (ncol, nlev, NUM_GASES) dimensionless mass-mixing-ratio
        block that interface.radiation takes as gas_mmr; self is left
        as it is."""
        return self.set_units(MMR).mixing_ratio

    def reverse(self) -> "Gas":
        """Flip the level axis (radiation_gas.F90 reverse_gas)."""
        return Gas(self.mixing_ratio.flip(1), self.units,
                   self.scale_factor, self.well_mixed)

    def out_of_physical_bounds(self, correct: bool = False):
        """Check 0 <= dimensionless mixing ratio <= 1
        (radiation_gas.F90 out_of_physical_bounds).  Returns (bad, gas):
        bad a 0-d bool tensor; with ``correct`` the gas has its values
        clamped, in its original per-gas units."""
        dimless = self.set_units(MMR)
        mr = dimless.mixing_ratio
        bad = ((mr < 0.0) | (mr > 1.0)).any()
        if not correct:
            return bad, self
        out = Gas(mr.clamp(0.0, 1.0), dimless.units, dimless.scale_factor,
                  dimless.well_mixed)
        for name in self.units:
            out = out.set_units(self.units[name], [name],
                                self.scale_factor.get(name, 1.0))
        return bad, out
