"""Training of both stages: losses, optimizer, the refinement train steps
(seg.py, cls.py), the device-resident epoch runner, checkpoints."""
