"""``idle_in_dispatch.search``: the device's idle time inside the program's
``search.dispatch`` spans (a batch's wire, copy and queued plan), in
percent of the window."""

from bench_port.lib.spans import idle_in_pct


def read(facts):
    return idle_in_pct(facts, "search.dispatch")
