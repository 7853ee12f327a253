"""Share of the window's ``cli.compress`` calls in which no device
operation ran (the ``device`` layer; moves ``compress_GBps``)."""


def read(trace):
    return trace.idle_share("cli.compress")
