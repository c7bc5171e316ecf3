"""The LM stack of the port, dense family: layers, the block stack and the
model facade (``build_model``)."""
from .model import Model, build_model  # noqa: F401
