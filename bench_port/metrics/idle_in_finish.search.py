"""``idle_in_finish.search``: the device's idle time inside the program's
``search.finish`` spans (a batch's results fetched from the card and
assembled on the host), in percent of the window."""

from bench_port.lib.spans import idle_in_pct


def read(facts):
    return idle_in_pct(facts, "search.finish")
