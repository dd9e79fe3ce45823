"""Host time in Bank.report per mul call (ms)."""


def read(rec):
    return rec.per_call_ms(rec.span_s("report"))
