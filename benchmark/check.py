"""The comparison that decides ``correct``: the program's fluxes on columns
of calls from the timed window against the plain reference's on the same
inputs.

Every field of the Flux is compared, in groups whose float32 rounding
differs by orders of magnitude, each with the limit its configuration file
sets (``limits``):

* ``lw_gap_wm2``: the largest absolute gap over the LW fluxes (the four
  broadband profiles, the canopy band fluxes), in W m-2;
* ``sw_direct_gap_wm2``: the same over the SW direct-beam fluxes (the two
  direct profiles, the surface direct band and canopy fluxes);
* ``sw_gap_wm2``: the same over the other SW fluxes (the up and total
  down profiles, the surface band totals, the diffuse canopy fluxes),
  whose diffuse part carries float32's largest rounding;
* ``fraction_gap``: the largest absolute gap over the dimensionless
  fields, the LW derivatives and the two cloud covers (0 to 1; a night
  column's SW cover is -1 on both sides);

each over the values both sides give as finite numbers, and

* ``nonfinite``: the number of values the program gives as a NaN or an
  infinity where the reference's is finite (an exact comparison).

A field the reference gives and the program does not, or the reverse,
fails the comparison.
"""

from __future__ import annotations

import random

import torch

DIMENSIONLESS = ("lw_derivatives", "cloud_cover_lw", "cloud_cover_sw")
NUMBERS = ("lw_gap_wm2", "sw_direct_gap_wm2", "sw_gap_wm2", "fraction_gap",
           "nonfinite")


def group(field: str) -> str:
    """The number a field's gap goes to."""
    if field in DIMENSIONLESS:
        return "fraction_gap"
    if field.startswith("lw_"):
        return "lw_gap_wm2"
    if field.startswith("sw_"):
        return "sw_direct_gap_wm2" if "direct" in field else "sw_gap_wm2"
    raise ValueError(f"no group for the field {field!r}")


def _gap(got, ref):
    """The largest absolute gap over the values both give as finite
    numbers, and the count of the program's non-finite values where the
    reference's is finite."""
    got, ref = got.to(device=ref.device, dtype=torch.float64), ref.double()
    finite = torch.isfinite(got)
    ref_finite = torch.isfinite(ref)
    d = torch.where(finite & ref_finite, (got - ref).abs(),
                    torch.zeros_like(ref))
    return (float(d.max()) if d.numel() else 0.0,
            int((~finite & ref_finite).sum()))


def field_gaps(program: dict, reference: dict) -> dict:
    """{field: largest absolute gap over the values both sides give as
    finite numbers}, for a closer look than ``gaps``."""
    return {k: _gap(program[k], ref)[0] for k, ref in reference.items()}


def gaps(program: dict, reference: dict) -> dict:
    """{number: its reading} of two {field: tensor} dicts on the same
    columns."""
    if set(program) != set(reference):
        raise ValueError(f"fields differ: the program gives "
                         f"{sorted(program)}, the reference "
                         f"{sorted(reference)}")
    out = dict.fromkeys(NUMBERS, 0.0)
    out["nonfinite"] = 0
    for name, ref in reference.items():
        gap, nonfinite = _gap(program[name], ref)
        out["nonfinite"] += nonfinite
        out[group(name)] = max(out[group(name)], gap)
    return out


def worst(readings: list) -> dict:
    """The largest of each number over several readings."""
    return {k: max(r[k] for r in readings) for k in NUMBERS}


def verdict(numbers: dict, limits: dict) -> bool:
    return all(numbers[k] <= limits[k] for k in NUMBERS)


def report(numbers: dict, limits: dict) -> dict:
    return {k: {"value": numbers[k], "limit": limits[k]} for k in NUMBERS}


class Reservoir:
    """A uniform sample of ``size`` of the calls offered to it, drawn with
    a generator seeded from the run's seed (Algorithm R): it holds each
    chosen call's pool index and output, and lets go of the others."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = random.Random(seed)
        self.seen = 0
        self.kept = []              # [(call number, pool index, output)]

    def offer(self, pool_index: int, output) -> None:
        n = self.seen
        self.seen += 1
        if n < self.size:
            self.kept.append((n, pool_index, output))
            return
        j = self.rng.randrange(n + 1)
        if j < self.size:
            self.kept[j] = (n, pool_index, output)
