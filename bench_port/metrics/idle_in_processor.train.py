"""``idle_in_processor.train``: the device's idle time inside the program's
``processor.images`` spans (the pages' host processing), in percent of the
window."""

from bench_port.lib.spans import idle_in_pct


def read(facts):
    return idle_in_pct(facts, "processor.images")
