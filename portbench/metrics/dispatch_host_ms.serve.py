"""Per serve call: host time in Bank.execute less Bank.report: dispatch
builds for new buckets, the gathers' and the custom op's enqueue (ms)."""


def read(rec):
    if rec.spans is None:
        return None
    return rec.per_call_ms(rec.span_s("execute") - rec.span_s("report"))
