"""Twin of tests/test_bitpack.py: its cases, run on the port's copy of
the bit-plane packing (trinity_tpu_torch/utils/bitpack.py)."""

from torch_twins import port_cases

globals().update(port_cases("test_bitpack"))
