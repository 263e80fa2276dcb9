"""ecrad_torch: the PyTorch/CUDA port of ecrad_tpu.

The flagship configuration (RRTMG gas optics, McICA SW and LW, IFS
general aerosols, SOCRATES liquid and Fu ice, LW derivatives, canopy
fluxes) runs as plain torch on tensors of any device, with hand-written
CUDA kernels (``csrc/``) for the McICA cloud-generator level scan and
the fused LW/SW McICA sweeps.  On CPU tensors each kernel's wrapper runs
its plain torch version instead.

Entry point: :func:`ecrad_torch.flagship.build`.  The JAX package
``ecrad_tpu`` is the reference; this package imports nothing of it.
"""

from ecrad_torch.config import Config
from ecrad_torch.containers import Flux

__version__ = "0.1.0"
