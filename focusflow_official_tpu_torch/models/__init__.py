"""FF-RAFT (and plain RAFT), FF-PWCNet (and PWC-Net), FF-FlowFormer (and
vanilla FlowFormer): models, configurations and mask preparation."""

from .config import FFPWCNetConfig, FFRaftConfig, FlowFormerConfig
from .ff_flowformer import FFFlowFormer, FlowFormer
from .ff_pwcnet import FFPWCNet, PWCNet
from .ff_raft import FFRaft, RAFT

__all__ = ["FFPWCNetConfig", "FFRaftConfig", "FlowFormerConfig", "FFFlowFormer", "FlowFormer",
           "FFPWCNet", "PWCNet", "FFRaft", "RAFT"]
