"""Per serve call: the from_numpy operand copies to the card plus the wait
for each round's products (ms)."""


def read(rec):
    if rec.spans is None:
        return None
    return rec.per_call_ms(rec.span_s("copy") + rec.span_s("wait"))
