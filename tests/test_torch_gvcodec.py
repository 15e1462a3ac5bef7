"""Twin of tests/test_gvcodec.py: its cases, run on the port's copy of the
group-varint codec and the segment persistence (trinity_tpu_torch/index/);
the engine-equivalence step searches with the port's CPU executors."""

from torch_twins import port_cases

globals().update(port_cases("test_gvcodec", edits=[
    ("ea, eb = Executor(a), Executor(b)",
     "ea, eb = Executor(a, 'cpu'), Executor(b, 'cpu')")]))
