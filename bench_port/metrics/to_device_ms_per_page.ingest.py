"""``to_device_ms_per_page.ingest``: the host milliseconds of the program's
``embed.to_device`` spans in the window (each batch's patches cast to f16
on the host and copied to the card) over the pages they counted."""

from bench_port.lib.spans import host_ms_per_page


def read(facts):
    return host_ms_per_page(facts, "embed.to_device")
