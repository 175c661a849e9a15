"""Synthetic datasets and the per-agent partitioner."""

from repro_torch.data.synthetic import AgentPartitioner, Dataset, make_classification

__all__ = ["AgentPartitioner", "Dataset", "make_classification"]
