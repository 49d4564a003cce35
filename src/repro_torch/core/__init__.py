"""Host-side BCRS scheduling, strategies, compression and OPWA (torch port
of ``repro.core``)."""
