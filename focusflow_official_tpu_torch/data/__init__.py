"""The data path: on the host, flow and image codecs, keypoint masks, the
flow colour wheel, the augmentors, the datasets and the loader (samples
as NHWC numpy dicts); on the card, the augmentation of raw batches inside
the training step (`device_aug.py`). cv2, PIL and PyYAML are imported by the functions that use
them, not with these modules."""
