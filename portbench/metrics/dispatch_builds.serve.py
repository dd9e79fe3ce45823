"""Per serve call: dispatch builds, one a batch size the bank's cache
missed, from the program's counter ``bank.dispatch_builds``."""
from portbench import program_spans


def read(rec):
    return program_spans.counter_per_call(rec, "bank.dispatch_builds")
