"""Host seconds of the set-up's ``graph/build.py::bucketize`` of the part
(the layout pass, numpy on the host), as the runner timed it."""


def read(ctx):
    return ctx.facts.get("layout_s")
