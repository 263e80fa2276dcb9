"""Aerosol optics metadata registry: select aerosol types by family
code, size bin and optical model instead of raw file indices (a copy of
``ecrad_tpu/optics/aerosol_description.py``: the port imports nothing of
the JAX package).

Re-implementation of
radiation/radiation_aerosol_optics_description.F90:1-388: the optics
file carries per-type metadata (two-letter family code such as SS/DD/BC,
size bin, optical-model name); ``get_index`` scores candidate types by
closeness of match exactly as the reference (bin match 4 / no-request 2,
model match 4 / no-request 2, preferred +1; any mismatch disqualifies)
and returns a 1-based index — positive for hydrophobic, negative for
hydrophilic, 0 if not found — ready for ``Config.i_aerosol_type_map``.

Name strings for config use (``parse_type_name``,
``resolve_aerosol_type_names``): each entry is
``CODE[,bin=N][,model=NAME][,philic|phobic]``, e.g. ``"DD,bin=2,phobic"``
or ``"SS,bin=1,philic"``.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field
from typing import List, Optional


def _to_str(row) -> str:
    """Decode a row of single characters (|S1), NULs → spaces, trimmed
    (the reference's to_string + trim)."""
    out = []
    for c in row:
        if isinstance(c, bytes):
            c = c.decode("latin-1")
        out.append(" " if c == "\x00" else c)
    return "".join(out).strip()


@dataclass
class AerosolOpticsDescription:
    """Metadata of one optics file
    (radiation_aerosol_optics_description.F90:33-72)."""
    code_phobic: List[str] = field(default_factory=list)
    code_philic: List[str] = field(default_factory=list)
    bin_phobic: List[int] = field(default_factory=list)
    bin_philic: List[int] = field(default_factory=list)
    model_phobic: List[str] = field(default_factory=list)
    model_philic: List[str] = field(default_factory=list)
    preferred_phobic: List[bool] = field(default_factory=list)
    preferred_philic: List[bool] = field(default_factory=list)

    @classmethod
    def read(cls, file_name: str) -> "AerosolOpticsDescription":
        """Load the description metadata from an aerosol optics NetCDF
        (radiation_aerosol_optics_description.F90:79-127)."""
        from ecrad_torch.io.netcdf import NcFile

        self = cls()
        with NcFile(file_name) as f:
            self.code_phobic = [_to_str(r)
                                for r in f.get("code_hydrophobic")]
            self.code_philic = [_to_str(r)
                                for r in f.get("code_hydrophilic")]
            self.bin_phobic = [int(b) for b in f.get("bin_hydrophobic")]
            self.bin_philic = [int(b) for b in f.get("bin_hydrophilic")]
            self.model_phobic = [
                _to_str(r) for r in f.get("optical_model_hydrophobic")]
            self.model_philic = [
                _to_str(r) for r in f.get("optical_model_hydrophilic")]
        self.preferred_phobic = [False] * len(self.code_phobic)
        self.preferred_philic = [False] * len(self.code_philic)
        return self

    def preferred_optical_model(self, code: str, model: str) -> None:
        """Mark an optical model as preferred for an aerosol family
        (radiation_aerosol_optics_description.F90:139-208); prefix
        match on the model name as in the reference."""
        if not model or model.isspace():
            return
        found = False
        for i, (c, m) in enumerate(zip(self.code_philic,
                                       self.model_philic)):
            if c == code and m[:len(model)] == model:
                self.preferred_philic[i] = True
                found = True
        for i, (c, m) in enumerate(zip(self.code_phobic,
                                       self.model_phobic)):
            if c == code and m[:len(model)] == model:
                self.preferred_phobic[i] = True
                found = True
        if not found:
            raise ValueError(
                f'Preferred "{code}" aerosol optical model "{model}" '
                "not found in file")

    def get_index(self, code: str, hydrophilic: bool,
                  bin: Optional[int] = None,
                  optical_model: Optional[str] = None,
                  out=sys.stderr) -> int:
        """1-based type index: >0 hydrophobic, <0 hydrophilic, 0 not
        found (radiation_aerosol_optics_description.F90:220-368)."""
        if hydrophilic:
            codes, bins, models, pref, sign = (
                self.code_philic, self.bin_philic, self.model_philic,
                self.preferred_philic, -1)
        else:
            codes, bins, models, pref, sign = (
                self.code_phobic, self.bin_phobic, self.model_phobic,
                self.preferred_phobic, +1)

        best, score, ambiguous = 0, 0, False
        for ja, (c, b, m, p) in enumerate(zip(codes, bins, models, pref),
                                          start=1):
            if c != code:
                continue
            cur = 0
            if bin is not None and b > 0:
                if bin > 0:
                    cur = 4 if bin == b else -1
                else:
                    cur = 2
            else:
                cur = 2
            if optical_model is not None:
                if m == optical_model:
                    if cur >= 0:
                        cur += 4
                else:
                    cur = -1
            elif cur >= 0:
                cur += 2
            if cur > 0 and p:
                cur += 1
            if cur > score:
                best, score, ambiguous = sign * ja, cur, False
            elif cur > 0 and cur == score:
                ambiguous = True
        if ambiguous:
            print(f'Warning: get_index("{code}", '
                  f"hydrophilic={hydrophilic}, ...) does not "
                  "unambiguously identify an aerosol optical property "
                  "index", file=out)
        return best

    def parse_type_name(self, name: str) -> int:
        """Resolve a config name string like ``"DD,bin=2,phobic"`` or
        ``"SS,bin=1,model=OPAC,philic"`` to a signed type index."""
        parts = [p.strip() for p in name.split(",") if p.strip()]
        if not parts:
            return 0
        code = parts[0]
        bin_ = None
        model = None
        hydrophilic = False
        for p in parts[1:]:
            if p.startswith("bin="):
                bin_ = int(p[4:])
            elif p.startswith("model="):
                model = p[6:]
            elif p in ("philic", "hydrophilic"):
                hydrophilic = True
            elif p in ("phobic", "hydrophobic"):
                hydrophilic = False
            else:
                raise ValueError(f"bad aerosol type name component: {p}"
                                 f" (in {name!r})")
        return self.get_index(code, hydrophilic, bin=bin_,
                              optical_model=model)


def resolve_aerosol_type_names(names, file_name: str,
                               preferred_models=()) -> tuple:
    """Map config ``aerosol_type_name`` strings to an
    ``i_aerosol_type_map`` tuple (positions with unrecognized names get
    0 = ignored, as in the reference's i_aerosol_map contract)."""
    desc = AerosolOpticsDescription.read(file_name)
    for spec in preferred_models:
        code, model = spec.split(":", 1)
        desc.preferred_optical_model(code.strip(), model.strip())
    return tuple(desc.parse_type_name(n) for n in names)
