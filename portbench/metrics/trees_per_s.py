"""End to end: trees (boosting rounds, forest trees) of the fits whose
scored result came back in the window, over the time from the window's
start to the last such result, by the host's clock: no fit is counted in
part."""


def read(ctx):
    w = ctx.window
    span = w.t_last - w.t_begin
    return w.trees / span if span > 0 and w.trees else None
