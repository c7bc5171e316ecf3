"""The LM stack of the port, dense and MoE families: layers, the MoE layer,
the block stack and the model facade (``build_model``)."""
from .model import Model, build_model  # noqa: F401
