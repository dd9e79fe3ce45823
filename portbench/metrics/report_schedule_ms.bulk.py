"""Per mul call: host time in Bank.report's scheduler pass, from the
program's span ``bank.schedule`` (ms)."""
from portbench import program_spans


def read(rec):
    return program_spans.span_ms(rec, "bank.schedule")
