"""Per serve call: wall time less Bank.execute, the operand copies and the
device wait, i.e. the worker's own host loop (ms)."""


def read(rec):
    if rec.spans is None:
        return None
    other = sum(rec.span_s(n) for n in ("execute", "copy", "wait"))
    return rec.per_call_ms(sum(rec.call_s) - other)
