"""The whole step: the least time of the trees that came back in the window
at the card's peaks, the larger of their least bytes at the memory rate and
their operations at the float32 rate (``counts/tree_level.py``; the bytes
bound it), over the rate's window (its start to its last result), in
percent."""


def read(ctx):
    w = ctx.window
    span = w.t_last - w.t_begin
    if ctx.work is None or span <= 0 or not w.fits:
        return None
    p = ctx.peaks
    least = max(ctx.work.bytes / p["hbm_bytes_per_s"], ctx.work.flops / p["f32_flop_per_s"])
    return 100.0 * least / span
