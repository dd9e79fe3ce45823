"""Per serve call: the worker's admissions and steal passes, one span a
dispatch window, from the program's span ``worker.admit`` (ms)."""
from portbench import program_spans


def read(rec):
    return program_spans.span_ms(rec, "worker.admit")
