"""Per mul call: reports Bank.report built for the bank's own policy, one
a batch size its report cache missed, from the program's counter
``bank.report_builds``; nothing where the program has no such counter."""
from portbench import program_spans


def read(rec):
    rows = program_spans.window_rows(rec)
    if rows is None or "bank.report_builds" not in rows[0].counters:
        return None
    return sum(r.counters["bank.report_builds"] for r in rows) / rec.n_calls
