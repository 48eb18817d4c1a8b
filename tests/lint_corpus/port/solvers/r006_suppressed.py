"""R006 suppressed inline, with its reason."""
import torch


def report():
    # a diagnostic line, not a choice of device
    return {"cuda": torch.cuda.is_available()}  # repro: allow[R006]
