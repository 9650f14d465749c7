"""The data path on the host: flow and image codecs, keypoint masks, the
flow colour wheel, the augmentors and the datasets. Samples are NHWC
numpy dicts. cv2, PIL and PyYAML are imported by the functions that use
them, not with these modules."""
