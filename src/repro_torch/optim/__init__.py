"""Optimizers and solver heads of the LM framework (the port's
counterpart of ``repro.optim``): the APC probe head (``apc_head``).
AdamW, the schedule and gradient compression are ROADMAP A19c."""
