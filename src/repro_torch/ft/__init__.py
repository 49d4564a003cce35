"""Host-side fault tolerance: failure injection and straggler deadlines
(numpy ports of ``repro.ft.failures`` / ``repro.ft.straggler``)."""
from repro_torch.ft.failures import FailureInjector
from repro_torch.ft.straggler import StragglerPolicy, arrivals, over_select

__all__ = ["FailureInjector", "StragglerPolicy", "arrivals", "over_select"]
