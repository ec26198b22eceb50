"""Device-clock ms of one ``densify`` stage (`densify_and_prune` at an
event iteration): the program's own mark table after the run (each
mark's ``%globaltimer`` nanoseconds since the previous one), over the
densify entries of the whole run, set-up's included."""

from omnibench.metrics import _stages


def read(trace):
    if not trace or trace.get("kind") != "train":
        return None
    totals = _stages.program_totals()
    if not totals:
        return None
    ms, entries = totals.get("densify", (0.0, 0))
    return ms / entries if entries else None
