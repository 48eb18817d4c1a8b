"""Optimizers and solver heads of the LM framework (the port's
counterpart of ``repro.optim``): AdamW (``adamw``), the LR schedules
(``schedule``), int8 gradient compression with error feedback
(``compress``) and the APC probe head (``apc_head``)."""
