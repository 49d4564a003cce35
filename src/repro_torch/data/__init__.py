"""Synthetic data, Dirichlet partitioning and client datasets (numpy copies
of ``repro.data``, so seeded draws match the reference bit for bit)."""
from repro_torch.data.partition import (client_label_histogram,
                                        data_fractions, dirichlet_partition)
from repro_torch.data.pipeline import ClientDataset, build_client_datasets
from repro_torch.data.synthetic import (lm_batch, synthetic_classification,
                                        synthetic_lm_tokens)

__all__ = [
    "dirichlet_partition", "client_label_histogram", "data_fractions",
    "ClientDataset", "build_client_datasets", "synthetic_classification",
    "synthetic_lm_tokens", "lm_batch",
]
