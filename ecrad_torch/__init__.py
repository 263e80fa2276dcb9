"""ecrad_torch: the PyTorch/CUDA port of ecrad_tpu.

RRTMG, ecCKD or monochromatic gas optics, IFS general or legacy band-wise aerosols (types
by index or by name) or directly specified aerosol optics, the band-wise
cloud optics models (SOCRATES or Slingo/Lindner-Li liquid; Fu, Baran,
Baran2016, Baran2017 or Yi ice) or general cloud optics, LW
derivatives and canopy fluxes with the Cloudless, Homogeneous, McICA,
Tripleclouds and SPARTACUS solvers run as plain torch on tensors of any
device, with ten hand-written CUDA kernels (``csrc/``): the McICA
cloud-generator level scan, the fused LW/SW McICA and Tripleclouds sweeps,
the generic LW/SW adding sweeps behind Cloudless, Homogeneous LW and the
unfused paths, and the SPARTACUS LW/SW adding sweeps.  On CPU tensors each
kernel's wrapper runs its plain torch version instead.

Entry points, each on the card unless told otherwise:

* ``python -m ecrad_torch.driver config.nam input.nc output.nc`` (the
  offline driver, :mod:`ecrad_torch.driver`; ``--device cpu`` on the
  CPU), with the bit-exact host McICA generator or the device one;
* ``python -m ecrad_torch.ifs.driver config.nam input.nc output.nc``
  (the IFS layer, :mod:`ecrad_torch.ifs`; ``--nproma``,
  ``--bitidentity``);
* :func:`ecrad_torch.flagship.build`, the step of a named configuration:
  ``mcica_rrtmg`` (the flagship), ``tripleclouds_rrtmg``,
  ``cloudless_rrtmg``, ``homogeneous_rrtmg``, ``spartacus_3d``,
  ``tripleclouds_ecckd``, ``ecckd_mcica``, ``tripleclouds_baran2016``,
  ``mcica_rrtmg_spectral``, ``tripleclouds_ecckd_gpoint``,
  ``cloudless_rrtmg_spectral``, ``homogeneous_rrtmg_spectral`` and
  ``monochromatic_homogeneous``, ``spartacus_ecckd``
  (``flagship.namelist_text`` writes any of them as the drivers'
  namelist);
* :func:`ecrad_torch.pipeline.radiation_sharded`, columns over several
  devices, and :mod:`ecrad_torch.distributed`, over processes;
* ``python -m ecrad_torch.evaluate.compare_output out.nc ref.nc`` and
  ``python -m ecrad_torch.evaluate.plot_input in.nc`` (host tools on
  NetCDF files, :mod:`ecrad_torch.evaluate`).
The JAX package ``ecrad_tpu`` is the reference; this package imports
nothing of it.
"""

from ecrad_torch.config import Config
from ecrad_torch.containers import Flux

__version__ = "0.1.0"
