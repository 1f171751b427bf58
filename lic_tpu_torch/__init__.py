"""lic_tpu_torch — the PyTorch/CUDA port of ``lic_tpu``.

A second package beside the JAX one, which stays the reference every
module here is tested against.  It covers the ``source_net`` serving path:
the eval-mode forward and the real bitstream roundtrip
(``models.compress.ChannelCoder``).  Two kernels on that path are written
by hand for Hopper and built from this package's sources at first use:

* the interleaved rANS drain, CUDA C++ (``csrc/rans_drain.cu``, wrapper
  ``coding.drain``);
* the GDN/IGDN forward, Triton (``layers.gdn``).

Each kernel has a plain PyTorch version beside it; a wrapper takes the
plain version only for tensors on the CPU and launches the kernel (or
raises) for CUDA tensors.

Layout: modules take NCHW tensors in ``channels_last`` memory, the same
bytes as the JAX package's NHWC.  This package imports ``torch`` and never
``jax``; the host rANS code it reuses from ``lic_tpu`` imports no jax.
"""

__version__ = "0.1.0"
