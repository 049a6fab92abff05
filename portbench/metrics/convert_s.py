"""Data format (core/data_format.py): the seconds set-up spent converting
the training rows into the cell's ``quantized_bins`` formats, as
``prepare_cached`` reports them."""


def read(ctx):
    return ctx.setup["convert_s"]
