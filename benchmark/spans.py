"""The program's own spans, paired with the trace, inside the window.

While a ``torch.profiler`` session records, the program keeps a span
log (``tudocomp_tpu_torch.stats.StatPhase.recorded()``): one record per
phase that closed, with its name, thread, host times and counters. Each
phase is also a ``record_function`` range in the trace. This module
pairs the two by name and order, takes the times from the trace (the
clock of the device's operations) and the counters from the log, and
keeps the spans that lie inside the harness's ``window`` range.

Every reader returns ``None`` where the program keeps no log (a version
without one), where a span it needs is missing, or where the log and
the trace do not pair one to one: the same count of each name, all on
one thread.
"""

from __future__ import annotations

from benchmark.trace import Cover


def program_log():
    """The program's span log, or ``None`` where it keeps none."""
    try:
        from tudocomp_tpu_torch.stats import StatPhase
    except ImportError:
        return None
    recorded = getattr(StatPhase, "recorded", None)
    return None if recorded is None else recorded()


def paired(trace, names, log=None):
    """``{name: [(stats, start, end), ...]}`` in start order for each of
    ``names``, the times the trace's and the stats the log's; ``None``
    where the two do not pair one to one."""
    log = program_log() if log is None else log
    if not log:
        return None
    out = {}
    for name in names:
        recs = sorted((r for r in log if r["name"] == name),
                      key=lambda r: r["start"])
        ranges = trace.spans.get(name, [])
        if len(recs) != len(ranges) or len({r["thread"]
                                            for r in recs}) > 1:
            return None
        out[name] = [(r["stats"], a, b) for r, (a, b) in zip(recs, ranges)]
    return out


def in_window(trace, spans):
    """The spans ``(stats, start, end)`` inside the ``window`` range."""
    window = trace.spans.get("window")
    if not window:
        return []
    w0, w1 = window[0]
    return [s for s in spans if s[1] >= w0 and s[2] <= w1]


def names(log, keep) -> list:
    """The span names of ``log`` for which ``keep(name)`` holds."""
    return sorted({r["name"] for r in log if keep(r["name"])})


def rate(trace, name: str, counter: str, log=None):
    """GB/s: the counter ``counter`` of the window's ``name`` spans over
    their seconds."""
    got = paired(trace, [name], log)
    spans = in_window(trace, got[name]) if got else []
    seconds = sum(b - a for _, a, b in spans)
    if not spans or seconds <= 0:
        return None
    return sum(s[counter] for s, _, _ in spans) / seconds / 1e9


def inner_rate(trace, outer: str, counter: str, keep, inner_counter=None,
               log=None):
    """GB/s over the window's ``outer`` spans: the counter ``counter`` of
    the ``outer`` spans (or, with ``inner_counter``, that counter of the
    inner spans) over the time inside them that spans whose name
    ``keep`` accepts cover, overlaps counted once."""
    log = program_log() if log is None else log
    if not log:
        return None
    inner_names = names(log, keep)
    got = paired(trace, [outer, *inner_names], log)
    if got is None:
        return None
    outers = in_window(trace, got[outer])
    inner = [s for n in inner_names for s in got[n]
             if any(a <= s[1] and s[2] <= b for _, a, b in outers)]
    cover = Cover((a, b) for _, a, b in inner)
    seconds = sum(cover.within(a, b) for _, a, b in outers)
    if not outers or not inner or seconds <= 0:
        return None
    if inner_counter is None:
        moved = sum(s[counter] for s, _, _ in outers)
    else:
        moved = sum(s[inner_counter] for s, _, _ in inner)
    return moved / seconds / 1e9


def front_rate(trace, outer: str, counter: str, log=None):
    """The CLI front end's ``front.*`` spans inside ``outer``."""
    return inner_rate(trace, outer, counter,
                      lambda n: n.startswith("front."), log=log)


def copy_rate(trace, outer: str, log=None):
    """The host<->device copies (``*.upload``, ``*.download``) inside
    ``outer``: their ``bytes`` over their seconds."""
    return inner_rate(trace, outer, None,
                      lambda n: n.endswith((".upload", ".download")),
                      inner_counter="bytes", log=log)
