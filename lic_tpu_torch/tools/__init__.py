"""Measurement scripts for the port on a GPU host (``python -m
lic_tpu_torch.tools.<name>``): ``profile_path`` (where the main path's time
goes), ``deconv_probe`` (the g_s transposed convs under other lowerings),
``kernel_probe``, ``roundtrip_ab`` (this checkout against another) and
``ddp_check`` (DDP over processes against one process's gradient).
"""
