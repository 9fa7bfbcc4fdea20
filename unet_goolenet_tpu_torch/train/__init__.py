"""Stage-1 (segmentation) training: losses, optimizer, the refinement train
step, checkpoints."""
