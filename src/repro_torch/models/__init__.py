"""The port's model stack (the dense family): layers, attention, Model."""
from repro_torch.models.transformer import Model

__all__ = ["Model"]
