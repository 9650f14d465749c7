"""Frozen copies of the port's FF-RAFT and FF-FlowFormer, their loss, the
on-card augmentation and the schedule, in plain PyTorch: every kernel is
its plain version (`plain.py`). They import nothing of the port, so a
later change to the port does not move the reference.
"""
