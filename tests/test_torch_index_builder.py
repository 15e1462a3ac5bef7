"""Twin of tests/test_index_builder.py: its cases, run on the port's copy
of the segment builder, format and term dictionary
(trinity_tpu_torch/index/)."""

from torch_twins import port_cases

globals().update(port_cases("test_index_builder"))
