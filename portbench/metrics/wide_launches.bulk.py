"""Per mul call: launches of rows wider than 16 limbs of the fused round's
kernel, from the program's counter ``launch.bank_fold.wide``; nothing
where the program has no such counter."""
from portbench import program_spans


def read(rec):
    return program_spans.counter_per_call(rec, "launch.bank_fold.wide")
