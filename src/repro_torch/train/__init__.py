"""Training stack of the port: train step and fused window, checkpoints,
straggler monitor (torch counterpart of ``repro/train``)."""
