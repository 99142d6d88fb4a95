"""Distributed runtime of the LM stack: checkpointing (atomic, asynchronous,
plain data, collective and resharding under a mesh) and int8 hierarchical
gradient compression (``distributed.compression``)."""
from repro_torch.distributed.checkpoint import CheckpointManager  # noqa: F401
