"""repro_torch.models — the decoder LM (dense, MoE, SSM, hybrid), ported from
``repro.models``."""
from .common import init_params
from .lm import Model, build_model, stack_plan

__all__ = ["Model", "build_model", "init_params", "stack_plan"]
