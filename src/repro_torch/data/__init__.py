"""Synthetic datasets, LM token streams and the per-agent partitioner."""

from repro_torch.data.synthetic import (
    AgentPartitioner,
    Dataset,
    lm_agent_batches,
    lm_batches,
    make_classification,
    make_lm_tokens,
)

__all__ = ["AgentPartitioner", "Dataset", "lm_agent_batches", "lm_batches",
           "make_classification", "make_lm_tokens"]
