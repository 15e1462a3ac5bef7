"""Execution engine of the port (counterpart of trinity_tpu.exec)."""

from trinity_tpu_torch.exec.executor import ExecFlags, Executor, SearchResult

__all__ = ["Executor", "ExecFlags", "SearchResult"]
