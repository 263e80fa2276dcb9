"""The adding sweeps' result containers and level stacking (frozen copy
of the port's ``solvers/adding.py``, the part the fused McICA route
uses).  Level axis: index 0 = top of atmosphere; profiles are broadband
``(ncol, nlev+1)``, g-resolved data exists at the surface and TOA.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch



class SwAdding(NamedTuple):
    """Reduced SW adding output: broadband profiles + boundary g slices."""
    up: torch.Tensor                 # (ncol, nlev+1) broadband
    dn_diffuse: torch.Tensor
    dn_direct: torch.Tensor
    up_toa_g: torch.Tensor           # (ncol, ng)
    dn_diffuse_surf_g: torch.Tensor
    dn_direct_surf_g: torch.Tensor
    up_s: Optional[torch.Tensor] = None      # (ncol, nlev+1, nspec)
    dn_diffuse_s: Optional[torch.Tensor] = None
    dn_direct_s: Optional[torch.Tensor] = None


class LwAdding(NamedTuple):
    up: torch.Tensor                 # (ncol, nlev+1) broadband
    dn: torch.Tensor
    up_toa_g: torch.Tensor           # (ncol, ng)
    dn_surf_g: torch.Tensor
    up_surf_g: torch.Tensor          # for LW derivatives
    up_s: Optional[torch.Tensor] = None      # (ncol, nlev+1, nspec)
    dn_s: Optional[torch.Tensor] = None


def _stack_top(top, levels):
    """top (ncol,) + levels (ncol, nlev) -> (ncol, nlev+1)."""
    return torch.cat([top[:, None], levels], dim=1)


def _stack_bot(levels, bottom):
    return torch.cat([levels, bottom[:, None]], dim=1)
