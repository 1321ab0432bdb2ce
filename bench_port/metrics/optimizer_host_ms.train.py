"""``optimizer_host_ms.train``: the host milliseconds of the program's
``train.optimizer`` spans (``AdamW.update`` over every leaf) a training
step of the window, the steps counted by its ``train.step`` spans."""

from bench_port.lib.spans import host_ms, window_spans


def read(facts):
    tr = facts.get("trace")
    if tr is None:
        return None
    steps, updates = window_spans(tr, "train.step"), window_spans(tr, "train.optimizer")
    if not steps or not updates:
        return None
    return host_ms(updates) / len(steps)
