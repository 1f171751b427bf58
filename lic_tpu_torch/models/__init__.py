"""Codec models of the port (counterpart of ``lic_tpu.models``)."""

from .codec import CodecModel, CodecOutput
from .presets import PRESETS, build_model, get_config

__all__ = ["CodecModel", "CodecOutput", "PRESETS", "build_model", "get_config"]
