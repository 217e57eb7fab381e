"""Consistency-aware distributed checkpointing (the paper, integrated).

Ported from ``repro.checkpoint``.  The checkpoint tier IS a parallel file
system with a consistency model: every shard write goes through CommitFS or
SessionFS from :mod:`repro_torch.core.consistency`, so the paper's
RPC-placement difference is *measured* on real training state, and restart
correctness is guaranteed by the model's MSC (writers commit/close before
the manifest publishes; readers query/open before reading).
"""

from repro_torch.checkpoint.serialization import (
    deserialize_tree,
    serialize_tree,
    tree_manifest,
)
from repro_torch.checkpoint.manager import CheckpointManager

__all__ = [
    "CheckpointManager",
    "serialize_tree",
    "deserialize_tree",
    "tree_manifest",
]
