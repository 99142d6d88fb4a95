"""Distributed runtime of the LM stack: checkpointing (atomic, asynchronous,
plain data). Sharded restore and gradient compression come with the mesh
(ROADMAP A9.4)."""
from repro_torch.distributed.checkpoint import CheckpointManager  # noqa: F401
