"""The plain reference of the benchmark's configurations.

A frozen copy, in plain PyTorch, of the forward passes of the ``charm``
codecs the benchmark runs (``source_net`` and ``net_unet_ha_hs_dec``),
with every hand-written kernel replaced by its plain version.  It was
copied from ``lic_tpu_torch`` at commit a087453 (each module names its
source files) and imports nothing of that package, so a later change to
the program cannot move the yardstick.  Parameters are created empty:
``benchmark.weights`` fills them from the run's seed, and the same values
are loaded into the program's model.  A configuration file names its
class (``"reference": "<module>:<class>"``); a new model is a module of
its own here.
"""

from .model import ReferenceCodec

__all__ = ["ReferenceCodec"]
