"""Model zoo of the port: the ten architectures' configs, shapes and
parameter counts, and the serving forward of the GQA decoders (the
``dense`` and ``vlm`` families; ROADMAP A19a).

The counterpart of ``repro.models``: ``model.py`` turns a ``ModelConfig``
(``repro_torch.configs``) into abstract parameters, caches, ``forward``,
``prefill`` and ``decode_step``.
"""
from . import model  # noqa: F401
