"""repro_torch.checkpoint — atomic, versioned checkpoints in the
reference's layout (``ckpt``)."""
