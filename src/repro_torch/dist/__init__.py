"""Train steps (torch port of ``repro.dist``). ``grad_sync`` is
ported; ``sharding`` (logical-axis rules lowered to a device mesh) waits for
the multi-card layout, ROADMAP queue 1 item 4."""
from repro_torch.dist import grad_sync

__all__ = ["grad_sync"]
