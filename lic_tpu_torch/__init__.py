"""lic_tpu_torch — the PyTorch/CUDA port of ``lic_tpu``.

A second package beside the JAX one, which stays the reference every
module here is tested against.  It covers the ``source_net``,
``source_net_wam``, ``net_ga``, ``net_unet_ha_hs_dec``, ``entroformer_cb``,
``entroformer_cb_full``, ``neural_syntax`` and ``source_net_vr`` presets:
the eval-mode forward, the real bitstream roundtrip
(``models.compress.ChannelCoder``), training (``training``,
``cli.train``), eval, the CLIs and, for the variable-rate
``source_net_vr``, rate control and the dynamic-batching
``serving.CodecService``; and the forward, training and eval of the six
presets no coder takes (``net_ha``, ``net_unet_ha_hs``,
``net_unet_ha_hs_1``: the U-Net hyper whose decoder reads the encoder's
skips; ``net_unet``, ``net_unet_1``, ``net_unet_005_5``: the uncoded
latent U-Net).  The kernels on those paths are written by hand
for Hopper and built from this package's sources at first use:

* B1, the interleaved rANS drain, CUDA C++ (``csrc/rans_drain.cu``, wrapper
  ``coding.drain``), at 8 to 256 lanes, its table in shared memory or,
  when too large, read from device memory;
* B2, the GDN/IGDN forward, CUDA C++ (``csrc/gdn.cu``, wrapper
  ``layers.gdn``);
* B3 and B6, the 5×5 stride-2 conv and the stride-1 k×k conv with its
  bias/LeakyReLU/residual epilogue, CUDA C++ (``csrc/conv_direct.cu``,
  wrappers ``layers.conv_direct``);
* B4 and B5, window attention without and with the projections inside,
  CUDA C++ (``csrc/window_attn.cu``, wrappers ``layers.window_attn``).

Each kernel has a plain PyTorch version beside it; a wrapper takes the
plain version only for tensors on the CPU and launches the kernel (or
raises) for CUDA tensors.  Under autograd, B2-B6 run through a
``torch.autograd.Function`` each: the kernel forward, the plain gradient
backward.  The host rANS coder is the port's own copy of
the C++ coder (``csrc/rans.cpp``), built with ``g++``.

Layout: modules take NCHW tensors in ``channels_last`` memory, the same
bytes as the JAX package's NHWC.  This package imports ``torch`` and never
``jax`` nor any module of ``lic_tpu``.
"""

__version__ = "0.2.0"
