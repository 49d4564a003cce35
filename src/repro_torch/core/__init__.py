"""The paper's primary contribution, BCRS + OPWA compressed aggregation
(torch port of ``repro.core``: host-side BCRS scheduling, strategies,
compression and OPWA), with the reference's exports."""
from repro_torch.core.aggregation import AggregationConfig, aggregate
from repro_torch.core.bcrs import (BCRSSchedule, ClientLink,
                                   client_coefficients, comm_time,
                                   make_schedule, pod_link_schedule,
                                   schedule_crs)
from repro_torch.core.compression import (Compressed, block_topk_compress,
                                          ef_compress, flatten_tree,
                                          from_sparse, k_for_ratio,
                                          quantize_stochastic,
                                          randk_compress, to_sparse,
                                          topk_compress,
                                          topk_compress_dynamic)
from repro_torch.core.cost_model import (RoundTime, TimeAccumulator,
                                         round_times, sample_links,
                                         uncompressed_round)
from repro_torch.core.opwa import (bcrs_aggregate, opwa_aggregate, opwa_mask,
                                   overlap_counts, overlap_histogram)

__all__ = [
    "AggregationConfig", "aggregate", "BCRSSchedule", "ClientLink",
    "client_coefficients", "comm_time", "make_schedule", "pod_link_schedule",
    "schedule_crs", "Compressed", "block_topk_compress", "ef_compress",
    "flatten_tree", "from_sparse", "k_for_ratio", "quantize_stochastic",
    "randk_compress", "to_sparse", "topk_compress", "topk_compress_dynamic",
    "RoundTime",
    "TimeAccumulator", "round_times", "sample_links", "uncompressed_round",
    "bcrs_aggregate", "opwa_aggregate", "opwa_mask", "overlap_counts",
    "overlap_histogram",
]
