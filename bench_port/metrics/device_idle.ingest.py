"""``device_idle.ingest``: the share of the window the device was idle."""

from bench_port.lib.readers import idle_pct


def read(facts):
    return idle_pct(facts)
