"""Synthetic data, Dirichlet partitioning and client datasets (numpy copies
of ``repro.data``, so seeded draws match the reference bit for bit)."""
from repro_torch.data.partition import data_fractions, dirichlet_partition
from repro_torch.data.pipeline import ClientDataset, build_client_datasets
from repro_torch.data.synthetic import synthetic_classification

__all__ = ["dirichlet_partition", "data_fractions", "ClientDataset",
           "build_client_datasets", "synthetic_classification"]
