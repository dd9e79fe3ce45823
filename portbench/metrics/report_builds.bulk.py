"""Per mul call: reports Bank.report built for the bank's own policy, one
a batch size its report cache missed, from the program's counter
``bank.report_builds``; nothing where the program has no such counter."""
from portbench import program_spans


def read(rec):
    return program_spans.counter_per_call(rec, "bank.report_builds")
