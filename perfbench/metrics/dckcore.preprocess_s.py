"""Host seconds of the set-up's ``dc_kcore`` outside its conquer: the divide
passes, the shrink with its E(v) fold and each part's layout
(``DCKCoreReport.preprocess_time_s``), as the runner kept it."""


def read(ctx):
    return ctx.facts.get("dckcore_preprocess_s")
