"""FF-RAFT and FF-FlowFormer models, configurations and mask preparation."""

from .config import FFRaftConfig, FlowFormerConfig
from .ff_flowformer import FFFlowFormer
from .ff_raft import FFRaft, RAFT

__all__ = ["FFRaftConfig", "FlowFormerConfig", "FFFlowFormer", "FFRaft", "RAFT"]
