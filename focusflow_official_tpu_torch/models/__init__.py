"""FF-RAFT, FF-PWCNet and FF-FlowFormer models, configurations and mask
preparation."""

from .config import FFPWCNetConfig, FFRaftConfig, FlowFormerConfig
from .ff_flowformer import FFFlowFormer
from .ff_pwcnet import FFPWCNet, PWCNet
from .ff_raft import FFRaft, RAFT

__all__ = ["FFPWCNetConfig", "FFRaftConfig", "FlowFormerConfig", "FFFlowFormer",
           "FFPWCNet", "PWCNet", "FFRaft", "RAFT"]
