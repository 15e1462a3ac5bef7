# Copy of trinity_tpu/plan/__init__.py; only its imports name the port.
"""Compiler layer (SURVEY §1 L4): normalized AST -> executable device plan."""

from trinity_tpu_torch.plan.compile import CompiledPlan, compile_plan

__all__ = ["CompiledPlan", "compile_plan"]
