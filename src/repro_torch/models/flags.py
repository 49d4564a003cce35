"""Global model-lowering flags (torch port of ``repro.models.flags``).

The reference sets ``COST_EXACT`` only in its dry run's cost compiles: XLA
counts a while-loop body once, so every ``lax.scan`` is then unrolled
(``scan_unroll``). Nothing in the port scans: its layers, attention
chunks, GLA chunks and local steps are Python loops that run every
iteration, and its dry run counts each op as it runs
(``roofline.op_cost``). The two names are kept for callers of the
reference's API; they change nothing in the port.
"""

COST_EXACT = False


def scan_unroll(length: int) -> int:
    """The reference's ``unroll`` for ``lax.scan`` at ``length`` (1 unless
    ``COST_EXACT``); no port code reads it."""
    return length if COST_EXACT else 1
