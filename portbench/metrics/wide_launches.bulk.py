"""Per mul call: launches of rows wider than 16 limbs of the fused round's
kernel, from the program's counter ``launch.bank_fold.wide``; nothing
where the program has no such counter."""
from portbench import program_spans

COUNTER = "launch.bank_fold.wide"


def read(rec):
    rows = program_spans.window_rows(rec)
    if rows is None or COUNTER not in rows[0].counters:
        return None
    return sum(r.counters[COUNTER] for r in rows) / rec.n_calls
