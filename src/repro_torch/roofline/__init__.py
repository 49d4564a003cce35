"""Roofline accounting of the port's steps and kernels (torch port of
``repro.roofline``): the H100's constants and ``model_flops``
(``analysis``), a per-rank op counter in place of the HLO cost model
(``op_cost``), and the byte and operation counts of the merge pipeline and
of every kernel's bound (``kernel_bytes``)."""
from repro_torch.roofline.analysis import (DCN_BW, DEVICE_MEMORY_BYTES,
                                           HBM_BW, ICI_BW, PEAK_FLOPS,
                                           PEAK_FLOPS_F32, CollectiveSummary,
                                           Roofline, analyze, model_flops,
                                           summarize_collectives)

__all__ = ["analyze", "summarize_collectives", "model_flops", "Roofline",
           "CollectiveSummary", "PEAK_FLOPS", "PEAK_FLOPS_F32", "HBM_BW",
           "ICI_BW", "DCN_BW", "DEVICE_MEMORY_BYTES"]
