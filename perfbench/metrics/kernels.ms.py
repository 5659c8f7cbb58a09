"""Device milliseconds of all kernels per decomposition in the traced
window (the fused sweep kernels of ``kernels/csrc/fused.cu`` and the
PyTorch kernels around them; copies and sets left out)."""


def read(ctx):
    if ctx.trace is None or not ctx.results or ctx.trace.kernel_s <= 0:
        return None
    return 1e3 * ctx.trace.kernel_s / len(ctx.results)
