"""``processor_ms_per_page.ingest``: the host milliseconds of the program's
``processor.images`` spans in the window over the pages they counted."""

from bench_port.lib.spans import host_ms_per_page


def read(facts):
    return host_ms_per_page(facts, "processor.images")
