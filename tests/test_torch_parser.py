"""Twin of tests/test_parser.py: its cases, run on the port's copy of the
query parser and AST (trinity_tpu_torch/query/)."""

from torch_twins import port_cases

globals().update(port_cases("test_parser"))
