"""``launches_per_step.train``: device operations (kernels, copies, sets)
in the trace a training step of the window, most of them the optimizer's
per-leaf passes."""


def read(facts):
    tr = facts.get("trace")
    if tr is None or not tr.events or not facts.get("steps"):
        return None
    return tr.launches / facts["steps"]
