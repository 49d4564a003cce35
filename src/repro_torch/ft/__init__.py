"""Fault tolerance: failure injection, elastic cohorts and straggler
deadlines (torch port of ``repro.ft``; host numpy plus the device twins of
the in-program sampling path)."""
from repro_torch.ft.failures import ElasticPool, FailureInjector
from repro_torch.ft.straggler import (StragglerPolicy, arrivals, over_select,
                                      renormalize_coefficients)

__all__ = ["FailureInjector", "ElasticPool", "StragglerPolicy", "arrivals",
           "over_select", "renormalize_coefficients"]
