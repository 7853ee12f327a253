"""Share of the window's ``cli.decompress`` calls in which no device
operation ran (the ``device`` layer; moves ``decompress_GBps``)."""


def read(trace):
    return trace.idle_share("cli.decompress")
