"""Per serve call: the worker's packing of operands into numpy and turning
products into responses, each round, without the copies or execute, from
the program's span ``worker.round_host`` (ms)."""
from portbench import program_spans


def read(rec):
    return program_spans.span_ms(rec, "worker.round_host")
