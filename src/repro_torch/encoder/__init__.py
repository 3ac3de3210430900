"""The CCFT query encoder of the port (counterpart of ``repro.encoder``)."""
from .model import EncoderConfig, encode, init_encoder

__all__ = ["EncoderConfig", "encode", "init_encoder"]
