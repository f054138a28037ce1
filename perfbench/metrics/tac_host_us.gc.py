"""Mean host microseconds to dispatch one TAC: the duration of the
``forward.tac`` spans of ``groupcomm_forward_fast``. None where the program
records no such span."""

from perfbench import spans


def read(tr):
    recs = spans.records()
    if recs is None:
        return None
    spans.root_count(recs, tr)
    tacs = [r.end_ns - r.start_ns for r in recs if r.name == "forward.tac"]
    return sum(tacs) / len(tacs) / 1e3 if tacs else None
