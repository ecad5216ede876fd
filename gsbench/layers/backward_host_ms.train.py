"""Host ms a traced training step spends in the program's ``gs.backward``
span, the one ``torch.autograd.grad`` call of the step: the caller waits
there while the autograd engine launches the backward's kernels."""
from gsbench import program_totals

UNIT = "ms/step"


def read(rec):
    return program_totals.host_ms(rec, "train", ("gs.backward",), "host_s")
