"""Fault tolerance: failure injection, elastic cohorts, straggler deadlines
and the async engine's arrival process (torch port of ``repro.ft``; host
numpy plus the device twins of the in-program sampling path)."""
# the arrival-process module first: the straggler function ``arrivals``
# imported after it takes the package attribute, as in the reference
from repro_torch.ft.arrivals import ArrivalProcess, UploadEvent, failure_fracs
from repro_torch.ft.failures import ElasticPool, FailureInjector
from repro_torch.ft.straggler import (StragglerPolicy, arrivals, over_select,
                                      renormalize_coefficients)

__all__ = ["FailureInjector", "ElasticPool", "StragglerPolicy", "arrivals",
           "over_select", "renormalize_coefficients", "ArrivalProcess",
           "UploadEvent", "failure_fracs"]
