"""FocusFlow in PyTorch for NVIDIA Hopper.

A port of `focusflow_official_tpu` (JAX) that keeps its public layouts
(NHWC images and masks, (B, H, W, 2) flow) and its reference numerics.
The hot loops run in hand-written CUDA kernels (`kernels/`); every kernel
has a plain PyTorch twin that CPU tensors take.

It carries FF-RAFT and FF-FlowFormer inference:

    from focusflow_official_tpu_torch.models import FFRaftConfig, FlowFormerConfig
    from focusflow_official_tpu_torch.predict import FlowPredictor
    p = FlowPredictor(FFRaftConfig(fuse_cnet=True), "weights.npz")
    flow = p(img1, img2, mask1, mask2)   # (H, W, 2) float32, on the card
    p = FlowPredictor(FlowFormerConfig(), "weights_ff.npz")
"""
