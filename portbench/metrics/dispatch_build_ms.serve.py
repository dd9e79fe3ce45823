"""Per serve call: host time building a batch size's dispatch on a miss
of the bank's cache, from the program's span ``bank.dispatch_build`` (ms)."""
from portbench import program_spans


def read(rec):
    return program_spans.span_ms(rec, "bank.dispatch_build")
