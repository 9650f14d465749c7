"""FocusFlow in PyTorch for NVIDIA Hopper.

A port of `focusflow_official_tpu` (JAX) that keeps its public layouts
(NHWC images and masks, (B, H, W, 2) flow) and its reference numerics.
The hot loops run in hand-written CUDA kernels (`kernels/`); every kernel
has a plain PyTorch twin that CPU tensors take.

It carries FF-RAFT, FF-FlowFormer and FF-PWCNet inference, the reference
YAML configs and `.pth` checkpoints, the host data path and the
validation protocol:

    from focusflow_official_tpu_torch.models import FFRaftConfig, FlowFormerConfig
    from focusflow_official_tpu_torch.predict import FlowPredictor
    p = FlowPredictor(FFRaftConfig(fuse_cnet=True), "weights.npz")
    flow = p(img1, img2, mask1, mask2)   # (H, W, 2) float32, on the card
    p = FlowPredictor(FlowFormerConfig(), "weights_ff.npz")
    p = FlowPredictor("configs/ff-raft/experiment/ffraft_chairs_orb.yaml", "raft.pth")
    flows = p.sequence(frames)           # warm-started, (T-1, H, W, 2)

    python -m focusflow_official_tpu_torch.cli.evaluate --yaml <config> \
        --checkpoint <weights> --datasets chairs sintel kitti
"""
