"""Per serve call: host time in the fused dispatch's bank_fold custom op
(dispatch and launch, not the gathers), from the program's span
``bank_fold.launch`` (ms)."""
from portbench import program_spans


def read(rec):
    return program_spans.span_ms(rec, "bank_fold.launch")
