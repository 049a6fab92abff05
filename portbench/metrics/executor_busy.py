"""Executors: the share of the executors' time in the rate's window (the
window's start to its last result) spent training and scoring the fits
that came back, in percent."""


def read(ctx):
    w = ctx.window
    span = (w.t_last - w.t_begin) * w.n_executors
    if span <= 0 or not w.fits:
        return None
    return 100.0 * sum(f.train_s + f.eval_s for f in w.fits) / span
