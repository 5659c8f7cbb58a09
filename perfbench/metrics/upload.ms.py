"""Device milliseconds of host-to-device copies per decomposition in the
traced window: the upload of the part's tiles and state
(``decompose.py::_Tiles`` / ``_FusedGroups``)."""


def read(ctx):
    if ctx.trace is None or not ctx.results or ctx.trace.upload_s <= 0:
        return None
    return 1e3 * ctx.trace.upload_s / len(ctx.results)
