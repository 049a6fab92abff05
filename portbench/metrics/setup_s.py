"""End to end: seconds from the process's start to the window (imports, the
rows drawn, the kernels loaded or built, the prepared-data cache filled,
every shape of the cell warmed up), by the host's clock."""


def read(ctx):
    return ctx.setup["setup_s"]
