"""Host milliseconds per decomposition in the port's call set-up: the spans
``repro_torch.decompose.guard`` (the int16 overflow guard), ``.start`` (the
start state and its upload) and ``.cand`` (``hindex_of_sequence``, the host
sort of the start values) of ``core/decompose.py``, traced window, mean over
decompositions."""
from perfbench import spans


def read(ctx):
    return spans.ms_per_call(ctx, spans.PREP)
