"""The rules of portlint, one module each: a new rule is a module, an
entry here and a bad/conforming pair under tests/lint_corpus/port/."""
from __future__ import annotations

from repro_torch.analysis.rules.r001_capture_scope import R001CaptureInFunction
from repro_torch.analysis.rules.r002_captured_host import R002CapturedHost
from repro_torch.analysis.rules.r003_store_bypass import R003StoreBypass
from repro_torch.analysis.rules.r004_registry import R004RegistryComplete
from repro_torch.analysis.rules.r005_layering import R005CoreLayering
from repro_torch.analysis.rules.r006_device import R006DeviceAndFallback
from repro_torch.analysis.rules.r007_broad_except import R007BroadExcept
from repro_torch.analysis.rules.r008_modes import R008ModeHooks
from repro_torch.analysis.rules.r009_plan_kwargs import R009PlanKwargs

ALL_RULES = (
    R001CaptureInFunction,
    R002CapturedHost,
    R003StoreBypass,
    R004RegistryComplete,
    R005CoreLayering,
    R006DeviceAndFallback,
    R007BroadExcept,
    R008ModeHooks,
    R009PlanKwargs,
)

__all__ = ["ALL_RULES"] + [c.__name__ for c in ALL_RULES]
