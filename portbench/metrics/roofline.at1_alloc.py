"""The ATRAC1 rate control (kernel E, ``at1_allocate_block``, or the tensor
ops of ``bitalloc.allocate``): its least time on the card
(``portbench/work.py::at1_alloc``) over its device time between CUDA
events, in %."""
SPANS = [{"name": "at1_alloc", "target": "{encoder}:at1_allocate_block",
          "clock": "events", "work": "at1_alloc"},
         {"name": "at1_alloc", "target": "{bitalloc}:allocate",
          "clock": "events", "work": "at1_alloc"}]


def read(trace):
    return trace.roofline("at1_alloc")
