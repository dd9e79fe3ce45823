"""Per mul call: host time in Bank.report's completion cycles and latency
histogram, from the program's span ``bank.latency`` (ms)."""
from portbench import program_spans


def read(rec):
    return program_spans.span_ms(rec, "bank.latency")
